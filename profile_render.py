#!/usr/bin/env python3
"""Device profile of one exact 1920×1080 frame of the port on one NVIDIA GPU.

Run from the root of a checkout:  python3 profile_render.py [--out FILE] [--edited]

Trains the model of ``chip_smoke.py`` (default config, 256 steps on the
analytic sphere), renders one warm-up frame, times 3 unprofiled frames on
the host clock, then renders one frame under ``torch.profiler`` and
reports, for that same profiled frame, its host wall time, the device busy
time (the union of the intervals of every device event: kernels and
copies) and the idle share 1 − busy / wall. Then the device time by
kernel name (the 20 largest here, all of them in ``--out``) and, from one
Cost-mode frame, how many of the evaluated sample slots were composited.

With ``--edited`` it builds the edit of ``chip_smoke.py`` (scribble → cage
moved +0.18 in x → an affine duplicate on top), profiles the unedited and
the edited frame of the same side view the same way, and prints the device
time the edit adds, by kernel name.
"""

from __future__ import annotations

import argparse
import statistics
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

import chip_smoke

W, H = 1920, 1080


def busy_ms(intervals) -> float:
    """Length of the union of (start, end) intervals, in ms (inputs in µs)."""
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
    return total / 1e3


def profile_frame(tb, label: str, out: Path | None = None):
    """Warm-up, 3 unprofiled frames, one profiled frame → device ms by
    kernel name {name: [ms, count]}; prints the frame's line and its 20
    largest kernels, and writes all of them to ``out``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tb.render(W, H, exact=True)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        tb.render(W, H, exact=True)
        times.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb.render(W, H, exact=True)
        prof_wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in events])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    total = sum(v[0] for _, v in rows)
    print(
        f"[profile] {label} {W}x{H} exact frame: unprofiled median of 3 {statistics.median(times):.1f} ms "
        f"({[round(t, 1) for t in times]}); profiled frame wall {prof_wall:.1f} ms, {len(events)} device events, "
        f"device busy {busy:.1f} ms (union of event intervals), idle share of the profiled frame "
        f"{1.0 - busy / prof_wall:.3f}; busy / unprofiled median {busy / statistics.median(times):.3f}",
        flush=True,
    )
    lines = [f"{ms:10.3f} ms {100 * ms / total:5.1f}% {n:7d}  {name}" for name, (ms, n) in rows]
    for line in lines[:20]:
        print("   ", line[:150])
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(lines) + "\n")
    return dict(by_name)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None, help="write the full per-kernel table here")
    ap.add_argument("--edited", action="store_true", help="also profile the frame of chip_smoke.py's edit")
    args = ap.parse_args()

    from nerfshop_tpu_torch.common import RenderMode

    smi = chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    chip_smoke.phase_build()
    tb, focal, principal, _ = chip_smoke.phase_main_path(dev)
    print(f"[profile] card: {smi}")
    if args.edited:
        gs, _, _, summary = chip_smoke.scribble_cage(tb, focal, principal)
        print(f"[profile] edit: {summary}", flush=True)
        tb.set_look_at(eye=chip_smoke.SIDE_EYE)
        tb.refresh_grid_for_edits()
        plain = profile_frame(tb, "unedited")
        gs.translate_cage(chip_smoke.CAGE_SHIFT)
        tb.add_edit_operator(gs.make_operator())
        tb.add_edit_operator(chip_smoke.duplicate_op(dev))
        edited = profile_frame(tb, "edited (cage + affine)", args.out)
        delta = sorted(
            ((n, edited.get(n, [0.0, 0])[0] - plain.get(n, [0.0, 0])[0], edited.get(n, [0.0, 0])[1] - plain.get(n, [0.0, 0])[1])
             for n in set(plain) | set(edited)),
            key=lambda r: -r[1],
        )
        print(f"[profile] device time the edit adds: {sum(d for _, d, _ in delta):.1f} ms; by kernel name (ms, launches):")
        for name, d, n in delta[:20]:
            print(f"    {d:10.3f} ms {n:7d}  {name[:130]}")
        return
    tb.set_look_at(eye=chip_smoke.CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    profile_frame(tb, "unedited", args.out)

    # Cost mode shades n_used / K_total; the model predicts sRGB-space
    # radiance, so the default (non-linear) output leaves the value as is
    tb.render_mode = RenderMode.Cost
    cost = tb.render(W, H, exact=True)[..., 0]
    k_total = 2 * (64 if float(tb.grid.occupancy.float().mean()) < 0.15 else 256)  # Testbed.render's K rule
    used = np.rint(cost * k_total)
    print(
        f"[profile] composited samples {int(used.sum())} of {tb.stats.render_samples} slots evaluated, "
        f"pixels with a composited sample {int((used > 0).sum())} of {W * H}",
        flush=True,
    )


if __name__ == "__main__":
    main()
