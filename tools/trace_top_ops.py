"""Reduce a JAX profiler trace to device metrics: the top operations by
total device time, the device's busy time, and its idle share within the
traced window.

    RS_PROFILE_DIR=prof BENCH_CONFIGS=path python bench.py
    python tools/trace_top_ops.py prof [--top 5]

The window is the span from the first to the last device event, so idle
time before the first kernel (dispatch) and after the last is not counted.
Tracing stretches that window (on an H100 a `path` render traced over
185 ms against 149 ms untraced), so `traced_idle_share` overstates the
idle share of an untraced run: compare `busy_ms` with the untraced
render time of the same row instead.
Kernels are the events on the device plane's stream lines (or on all its
lines, where the trace names no streams).
"""

import argparse
import glob
import json
import os
from collections import defaultdict


def _device_lines(plane):
    lines = list(plane.lines)
    streams = [ln for ln in lines if ln.name.startswith("Stream")]
    return streams or lines


def busy_time(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(xplane_path, plane_prefix="/device:GPU", top=5):
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    per_op = defaultdict(lambda: [0.0, 0])
    intervals = []
    planes = []
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        planes.append(plane.name)
        for line in _device_lines(plane):
            for ev in line.events:
                if ev.duration_ns <= 0:
                    continue
                per_op[ev.name][0] += ev.duration_ns
                per_op[ev.name][1] += 1
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise ValueError(f"no events on planes {plane_prefix}* in {xplane_path}")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = busy_time(intervals)
    kernel_total = sum(v[0] for v in per_op.values())
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "planes": planes,
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "traced_idle_share": 1.0 - busy / window if window else 0.0,
        "top_ops": [
            {"name": name, "total_ms": t / 1e6, "count": n,
             "share_of_kernel_time": t / kernel_total}
            for name, (t, n) in ranked
        ],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--plane", default="/device:GPU")
    args = ap.parse_args()
    paths = sorted(
        glob.glob(os.path.join(args.trace_dir, "**", "*.xplane.pb"),
                  recursive=True)
    )
    if not paths:
        raise SystemExit(f"no .xplane.pb under {args.trace_dir}")
    for path in paths:
        out = summarize(path, args.plane, args.top)
        print(json.dumps({"trace": os.path.relpath(path, args.trace_dir),
                          **out}))


if __name__ == "__main__":
    main()
