"""Self-contained interactive HTML point-cloud viewer (port of
``mrcc_tpu/viz/html_viewer.py``).

The reference's interactive tooling is an Open3D GUI, which needs a
display server; on a headless host the equivalent is one HTML file with an
embedded WebGL orbit viewer: open it in any browser, drag to rotate,
scroll to zoom, press ``k`` to toggle the segmentation colours (the
reference viewer's key binding).  numpy only; tensors are accepted.
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>mrcc_tpu viewer</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px}</style></head>
<body><canvas id="c"></canvas><div id="hud">drag: rotate &middot; wheel:
zoom &middot; k: toggle seg colors</div>
<script>
const PTS = new Float32Array(Uint8Array.from(atob("%(pts)s"),
    c => c.charCodeAt(0)).buffer);
const RGB = new Uint8Array(Uint8Array.from(atob("%(rgb)s"),
    c => c.charCodeAt(0)).buffer);
const SEG = new Uint8Array(Uint8Array.from(atob("%(seg)s"),
    c => c.charCodeAt(0)).buffer);
const SEGC = [[44,62,80],[231,76,60],[241,196,15],
              [46,204,113],[155,89,182],[52,152,219]];
const N = PTS.length / 3;
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl");
let rx = -1.2, ry = 0.0, zoom = %(zoom)s, useSeg = %(use_seg)s;
const center = [%(cx)s, %(cy)s, %(cz)s];

const vsrc = `attribute vec3 p; attribute vec3 col; uniform mat4 mvp;
varying vec3 vc; void main(){ gl_Position = mvp * vec4(p, 1.0);
gl_PointSize = 2.0; vc = col; }`;
const fsrc = `precision mediump float; varying vec3 vc;
void main(){ gl_FragColor = vec4(vc, 1.0); }`;
function sh(t, s){ const o = gl.createShader(t); gl.shaderSource(o, s);
gl.compileShader(o); return o; }
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, vsrc));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, fsrc));
gl.linkProgram(prog); gl.useProgram(prog);

const pbuf = gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER, pbuf);
gl.bufferData(gl.ARRAY_BUFFER, PTS, gl.STATIC_DRAW);
const pa = gl.getAttribLocation(prog, "p");
gl.enableVertexAttribArray(pa);
gl.vertexAttribPointer(pa, 3, gl.FLOAT, false, 0, 0);

const cbuf = gl.createBuffer();
function colors(){
  const out = new Float32Array(N * 3);
  for (let i = 0; i < N; i++){
    if (useSeg && SEG.length){ const s = SEGC[SEG[i] %% 6];
      out[3*i] = s[0]/255; out[3*i+1] = s[1]/255; out[3*i+2] = s[2]/255;
    } else { out[3*i] = RGB[3*i]/255; out[3*i+1] = RGB[3*i+1]/255;
      out[3*i+2] = RGB[3*i+2]/255; } }
  gl.bindBuffer(gl.ARRAY_BUFFER, cbuf);
  gl.bufferData(gl.ARRAY_BUFFER, out, gl.STATIC_DRAW);
  const ca = gl.getAttribLocation(prog, "col");
  gl.enableVertexAttribArray(ca);
  gl.vertexAttribPointer(ca, 3, gl.FLOAT, false, 0, 0);
}
colors();

function mat(){
  const cx = Math.cos(rx), sx = Math.sin(rx);
  const cy = Math.cos(ry), sy = Math.sin(ry);
  const a = canvas.width / canvas.height;
  const s = zoom;
  // rotate-then-orthographic; z mapped for depth test
  return [s*cy/a, s*sx*sy, 0.2*cx*sy, 0,
          0, s*cx, -0.2*sx, 0,
          -s*sy/a, s*sx*cy, 0.2*cx*cy, 0,
          s*(center[2]*sy - center[0]*cy)/a,
          -s*(center[0]*sx*sy + center[1]*cx + center[2]*sx*cy),
          -0.2*(center[0]*cx*sy - center[1]*sx + center[2]*cx*cy), 1];
}
function draw(){
  canvas.width = innerWidth; canvas.height = innerHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.enable(gl.DEPTH_TEST);
  gl.clearColor(0.07, 0.07, 0.07, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(gl.getUniformLocation(prog, "mvp"), false, mat());
  gl.drawArrays(gl.POINTS, 0, N);
}
let drag = null;
canvas.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => { if (!drag) return;
  ry += (e.clientX - drag[0]) * 0.01; rx += (e.clientY - drag[1]) * 0.01;
  drag = [e.clientX, e.clientY]; draw(); };
window.onwheel = e => { zoom *= e.deltaY > 0 ? 0.9 : 1.1; draw(); };
window.onkeydown = e => { if (e.key === "k"){ useSeg = !useSeg; colors();
  draw(); } };
window.onresize = draw;
draw();
</script></body></html>
"""


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def write_html_viewer(path, points, rgb=None, segmentation=None,
                      max_points=200000, use_seg=False):
    """Write a standalone interactive viewer for one cloud.

    Args:
      points: [N, 3] float.
      rgb: [N, 3] float in [0, 1] (grey when absent).
      segmentation: [N] int class labels (k-toggle palette).
      max_points: uniform subsample bound to keep files small.
    Returns the path.
    """
    points, rgb, segmentation = (
        None if a is None else _np(a) for a in (points, rgb, segmentation))
    points = np.asarray(points, np.float32)
    n = len(points)
    if n > max_points:
        sel = np.random.default_rng(0).choice(n, max_points, replace=False)
        points = points[sel]
        rgb = None if rgb is None else np.asarray(rgb)[sel]
        segmentation = (None if segmentation is None
                        else np.asarray(segmentation)[sel])
    if rgb is None:
        rgb = np.full((len(points), 3), 0.7, np.float32)
    rgb8 = np.clip(np.asarray(rgb) * 255, 0, 255).astype(np.uint8)
    seg8 = (np.zeros(0, np.uint8) if segmentation is None
            else np.asarray(segmentation).astype(np.uint8))
    center = points.mean(axis=0)
    extent = float(np.abs(points - center).max()) or 1.0

    html = _TEMPLATE % {
        "pts": base64.b64encode(points.tobytes()).decode(),
        "rgb": base64.b64encode(rgb8.tobytes()).decode(),
        "seg": base64.b64encode(seg8.tobytes()).decode(),
        "zoom": json.dumps(round(1.0 / extent, 4)),
        "use_seg": "true" if (use_seg and len(seg8)) else "false",
        "cx": round(float(center[0]), 5),
        "cy": round(float(center[1]), 5),
        "cz": round(float(center[2]), 5),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(html)
    return path
