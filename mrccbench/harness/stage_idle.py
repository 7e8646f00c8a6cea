"""The card's idle time inside the program's own spans: the traced window's
idle intervals (the window less the union of the device's intervals)
intersected with the union of one stage's host spans
(``mrcc.train.<stage>``, ``mrcc_tpu_torch/tracing.py``), in ms per train
step (``mrcc.train.step`` spans inside the window).

The spans are the profiler's annotations on the window's thread, so they
share the device trace's clock.  A trace without a step span (a program
without the spans) reads no number.
"""

from __future__ import annotations

from mrccbench.harness import profiling

STEP = "mrcc.train.step"
STAGE = "mrcc.train."


def idle_intervals(parsed):
    """The window's intervals, in us, in which nothing ran on the card."""
    w0, w1 = parsed["window"]
    out, at = [], w0
    for a, b in profiling._union([(a, b) for _, a, b in parsed["device"]]):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if w1 > at:
        out.append((at, w1))
    return out


def _overlap_us(xs, ys):
    """Summed length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def steps(parsed) -> int:
    """Train steps whose span lies inside the window."""
    w0, w1 = parsed["window"]
    return sum(1 for n, a, b, _ in parsed["host"]
               if n == STEP and a >= w0 and b <= w1)


def stage_idle_ms(parsed, stage: str):
    """Idle ms of the card per step while the host is inside the stage's
    spans; None without a trace or without a step span."""
    n_steps = steps(parsed) if parsed else 0
    if not n_steps:
        return None
    w0, w1 = parsed["window"]
    spans = profiling._union([(max(a, w0), min(b, w1))
                              for n, a, b, _ in parsed["host"]
                              if n == STAGE + stage and b > w0 and a < w1])
    return 1e-3 * _overlap_us(idle_intervals(parsed), spans) / n_steps
