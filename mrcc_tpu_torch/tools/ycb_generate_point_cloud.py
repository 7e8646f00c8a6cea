"""XYZRGB point clouds from the YCB turntable RGB-D dataset (port of
``scripts/ycb_generate_point_cloud.py``, on the numpy pipeline of
``data/rgbd``).  Expects the standard YCB layout:

  <ycb>/<object>/{NP1..NP5}_<angle>.jpg                (RGB)
  <ycb>/<object>/{NP1..NP5}_<angle>.h5                 (depth)
  <ycb>/<object>/calibration.h5                        (K matrices + H)

and writes ``<ycb>/<object>/clouds/pc_<cam>_<angle>.ply``.  Needs h5py and
imageio (imported where a view is read).

  python -m mrcc_tpu_torch.tools.ycb_generate_point_cloud <ycb> [objects...]
"""

import argparse
import os
import sys

import numpy as np

from ..data.rgbd import (depth_to_cloud, filter_discontinuities,
                         register_depth_map, write_ply)

VIEWPOINT_CAMERAS = ["NP1", "NP2", "NP3", "NP4", "NP5"]
VIEWPOINT_ANGLES = [str(i) for i in range(0, 360, 3)]


def view_cloud(rgb, depth, depth_k, rgb_k, d_scale, h_rgb_from_ref,
               h_ir_from_ref, filter_depth=True):
    """One view's flat XYZRGB cloud ``[1, M, 6]`` from its arrays: the
    depth map (in the calibration's units, times ``d_scale`` to metres)
    registered into the RGB camera and unprojected."""
    h_rgb_from_depth = h_rgb_from_ref @ np.linalg.inv(h_ir_from_ref)
    if filter_depth:
        depth = filter_discontinuities(depth)
    registered = register_depth_map(depth * d_scale, rgb.shape, depth_k,
                                    rgb_k, h_rgb_from_depth)
    return depth_to_cloud(registered, rgb, rgb_k, organized=False)


def process_view(folder, target, cam, angle, filter_depth=True):
    """Write one view's cloud; returns :func:`write_ply`'s result, or None
    where the view's files are missing."""
    import h5py
    from imageio import imread

    base = os.path.join(folder, target)
    depth_path = os.path.join(base, f"{cam}_{angle}.h5")
    rgb_path = os.path.join(base, f"{cam}_{angle}.jpg")
    calib_path = os.path.join(base, "calibration.h5")
    if not (os.path.isfile(depth_path) and os.path.isfile(rgb_path)):
        return None

    rgb = np.asarray(imread(rgb_path))
    with h5py.File(depth_path, "r") as f:
        depth = np.asarray(f["depth"])
    with h5py.File(calib_path, "r") as cal:
        arrays = (np.asarray(cal[f"{cam}_depth_K"]),
                  np.asarray(cal[f"{cam}_rgb_K"]),
                  np.asarray(cal[f"{cam}_ir_depth_scale"]) * 1e-4,
                  np.asarray(cal[f"H_{cam}_from_NP5"]),
                  np.asarray(cal[f"H_{cam}_ir_from_NP5"]))
    cloud = view_cloud(rgb, depth, *arrays, filter_depth=filter_depth)
    out = os.path.join(base, "clouds")
    os.makedirs(out, exist_ok=True)
    return write_ply(os.path.join(out, f"pc_{cam}_{angle}.ply"), cloud)


def main(argv=None):
    """Returns the number of views written."""
    p = argparse.ArgumentParser(description="YCB RGB-D to point clouds")
    p.add_argument("folder")
    p.add_argument("targets", nargs="*")
    args = p.parse_args(argv)
    targets = args.targets or sorted(
        d for d in os.listdir(args.folder)
        if os.path.isdir(os.path.join(args.folder, d)))
    try:
        import h5py  # noqa: F401
        from imageio import imread  # noqa: F401
    except ImportError as e:
        print(f"missing dependency: {e} (install h5py + imageio)")
        sys.exit(1)
    done = 0
    for target in targets:
        for cam in VIEWPOINT_CAMERAS:
            for angle in VIEWPOINT_ANGLES:
                if process_view(args.folder, target, cam, angle):
                    done += 1
        print(f"{target}: {done} views so far")
    return done


if __name__ == "__main__":
    main()
