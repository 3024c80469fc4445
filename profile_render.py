#!/usr/bin/env python3
"""Device profile of one exact 1920×1080 frame of the port on one NVIDIA GPU.

Run from the root of a checkout:
  python3 profile_render.py [--out FILE] [--compact FRAC | --edited | --normals | --train | --distill | --sdf | --volume
                             | --baked]
  python3 profile_render.py --save-chunk FILE
  python3 profile_render.py --kernels --chunk FILE [--root DIR]
  python3 profile_render.py --save-edit DIR
  python3 profile_render.py --warp --edit DIR [--root DIR]
  python3 profile_render.py --composite --parent FILE

Trains the model of ``chip_smoke.py`` (default config, 256 steps on the
analytic sphere), renders one warm-up frame, times 3 unprofiled frames on
the host clock, then renders one frame under ``torch.profiler`` and
reports, for that same profiled frame, its host wall time, the device busy
time (the union of the intervals of every device event: kernels and
copies) and the idle share 1 − busy / wall. Then the device time by
kernel name (the 20 largest here, all of them in ``--out``), the shares
of kernels B and F in it, and, from one Cost-mode frame, how many of the evaluated
sample slots were composited.

With ``--compact FRAC`` it then profiles the same frame through
``render_frame`` (no host copy) with ``compact_frac`` 0 and FRAC (the field
on the valid slots only) and prints the device time that changes, by
kernel name.

With ``--edited`` it builds the edit of ``chip_smoke.py`` (scribble → cage
moved +0.18 in x → an affine duplicate on top), profiles the unedited and
the edited frame of the same side view the same way, and prints the device
time the edit adds, by kernel name; then it computes the moved cage's
Poisson membrane, profiles the edited frame with it ("target" blend) and
prints the device time the membrane adds, by kernel name.

With ``--normals`` it profiles the same view's frame shaded and then in
``RenderMode.Normals`` (the density's gradient per chunk, through kernel F),
prints the device time the Normals frame adds, by kernel name, and the
Normals frame's peak device memory.

With ``--distill`` it builds that edit with the membrane, refreshes the
grid through the stack, runs 8 distillation steps of the default
``DistillConfig`` at the trained scale as a warm-up and profiles 8 more:
per step, wall, device busy, idle share, launches, and device ms and
launches by kernel name.

With ``--train`` it profiles training of that model instead (after its
256 steps): one 16-step call of the eager loop and one of the captured loop
(one CUDA graph replay), each after a warm-up call, and prints for each,
per step, the host wall time, the device busy time, the idle share, the
device launches, and the device time and launches of each kernel name (the
share of kernel A, ``segsum``, among them; the full tables go to ``--out``
and, for the eager loop, to its ``_eager`` sibling); then kernel A alone at
``chip_smoke.py``'s hash, dense, skewed and spread-under-a-pile cases, each
launch's device time and the span of a call.

With ``--sdf`` it trains the SDF testbed of ``chip_smoke.py``'s [sdf] phase
instead (the 81920-face bumpy icosphere, configs/sdf/base.json, 1000 steps
at batch 2^16), prints its IoU, profiles one 1920×1080 sphere-traced frame
the same way (busy, idle share, device time by kernel name), then 16 eager
training steps of batch 2^16 after a warm-up call, their draws from the
generator reseeded with ``chip_smoke.G_SEED``: per step, wall, device busy,
idle share, launches, and kernel G's device time (``bvh`` in the
kernel's name) and share; with ``--volume`` the
Volume testbed of its [volume] phase (``synthetic_smoke(256)``, 1000 steps)
and one 1920×1080 delta-tracked frame at spp 4.

With ``--baked`` it bakes that model for the interactive preview (256³)
and profiles one 1920×1080 ``render_interactive`` frame the same way
(kernels H and I, the frame's copy to the host); then it builds the edit of
``--edited``, bakes it, and profiles one incremental rebake after a drag of
the cage by ``chip_smoke.BAKE_DRAG`` (each timed rebake swaps between the
cage and its dragged copy, without a grid refresh).

With ``--composite --parent FILE`` it bakes that model as ``--baked`` does
and times kernel H of ``FILE`` (an older ``csrc/baked.cu`` with the same
``FrameArgs`` and ``nst_shear_composite`` entry, e.g. ``git show
591ac5e:nerfshop_tpu_torch/csrc/baked.cu > build/baked_parent.cu``) against
this checkout's on chip_smoke.py's eight [baked] views: both built into
libraries of their own under ``build/baked_versions/`` (``time_bvh.
build_versions``, each kernel's registers, spills and shared memory
printed), each view's raster with depth compared bit for bit, then each
version timed without depth (as the preview calls it) by both of
``chip_smoke.both_ms``'s methods, old, new, new, old.

With ``--save-chunk FILE`` it trains that model, renders one 1080p frame
and saves the positions the frame's middle chunk encoded (8192 rays × K
slots) and the trained table: kernel B's frame shape.

With ``--kernels --chunk FILE`` it trains nothing: it times kernels A and D
of the ``nerfshop_tpu_torch`` package found under ``--root`` (default: this
checkout) at ``KERNEL_CASES``, kernel B at ``chip_smoke.py``'s training
shape and at the saved frame shape, in each mode its wrapper has, and
kernel F (the encode's position gradient) at the same two shapes, with
the training shape's boundary points and a seeded dout, all from the same
inputs every run, each by both of ``chip_smoke.median_ms``'s
methods (events around one call, and queued behind a spin), with the
library call beside it and the wrapper's host µs per call. Pointed at an
unpacked older commit, it times that commit's kernels on the same inputs:
run old, new, new, old one after the other on one card to compare two
versions.

With ``--save-edit DIR`` it trains that model, builds its edit, renders the
edited frame and saves the edits file and the positions and directions the
frame's middle chunk sent through the moved cage. With ``--warp --edit DIR``
it trains nothing: it loads that edit with the package under ``--root`` and
times the cage operator's sample warp, position warp and inclusive lookup
at the saved chunk and at 2^20 random points, by both methods; run old,
new, new, old to compare two versions of kernel E and the warp around it.

  python3 profile_render.py --save-chunk build/chunk.pt
  python3 profile_render.py --kernels --chunk build/chunk.pt [--root DIR]
  python3 profile_render.py --save-edit build/edit
  python3 profile_render.py --warp --edit build/edit [--root DIR]
"""

from __future__ import annotations

import argparse
import re
import statistics
import sys
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


def device_events(prof):
    """The profile's device events → (events, busy ms, {name: [ms, count]})."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in events])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    return events, busy, dict(by_name)


def write_table(by_name, out: Path | None, per: int = 1, top: int = 20) -> None:
    """Print the ``top`` kernel names by device time and write all of them to
    ``out``: ms, share, launches, each divided by ``per``."""
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    total = sum(v[0] for _, v in rows)
    lines = [f"{ms / per:10.3f} ms {100 * ms / total:5.1f}% {n / per:9.2f}  {name}" for name, (ms, n) in rows]
    for line in lines[:top]:
        print("   ", line[:150])
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(lines) + "\n")


def compact_render(tb, frac: float):
    """→ a callable that renders ``tb``'s 1080p view through ``render_frame``
    with the testbed's options and ``compact_frac`` = ``frac``, synchronized
    (the frame of ``chip_smoke.py``'s [render-compact])."""
    import dataclasses

    from nerfshop_tpu_torch.render import renderer

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=tb.device)

    opts = dataclasses.replace(tb._render_options(), compact_frac=frac)

    def render():
        renderer.render_frame(tb.model, tb.inference_params, tb.grid, (W, H), t(tb.camera_matrix),
                              t(tb._focal_for(W, H)), t(tb.screen_center), opts=opts)
        torch.cuda.synchronize()

    return render


def profile_frame(tb, label: str, out: Path | None = None, render=None):
    """Warm-up, 3 unprofiled frames, one profiled frame → device ms by
    kernel name {name: [ms, count]}; prints the frame's line and its 20
    largest kernels, and writes all of them to ``out``. ``render``: a
    callable that renders the frame (default ``tb.render(W, H,
    exact=True)``)."""
    from torch.profiler import ProfilerActivity, profile

    render = render or (lambda: tb.render(W, H, exact=True))
    render()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        render()
        times.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        prof_wall = (time.perf_counter() - t0) * 1e3
    events, busy, by_name = device_events(prof)
    print(
        f"[profile] {label} {W}x{H} frame: unprofiled median of 3 {statistics.median(times):.1f} ms "
        f"({[round(t, 1) for t in times]}); profiled frame wall {prof_wall:.1f} ms, {len(events)} device events, "
        f"device busy {busy:.1f} ms (union of event intervals), idle share of the profiled frame "
        f"{1.0 - busy / prof_wall:.3f}; busy / unprofiled median {busy / statistics.median(times):.3f}",
        flush=True,
    )
    write_table(by_name, out)
    total = sum(ms for ms, _ in by_name.values())
    for kernel, picks in (("B", lambda name: "grid_encode" in name and "grid_encode_dx" not in name),
                          ("F", lambda name: "grid_encode_dx" in name)):
        k_ms = sum(ms for name, (ms, _) in by_name.items() if picks(name))
        k_n = sum(n for name, (_, n) in by_name.items() if picks(name))
        if k_n:
            print(
                f"[profile] {label}: kernel {kernel} {k_ms:.3f} ms in {k_n} launches, {100 * k_ms / total:.2f}% of the "
                f"frame's {total:.1f} ms of kernel and copy time, {100 * k_ms / busy:.2f}% of its busy time",
                flush=True,
            )
    return by_name


def profile_train(tb, out: Path | None = None, steps: int = 16) -> None:
    """Profile one ``steps``-step call of the eager training loop and one of
    the captured loop (``make_train_loop(..., captured=False)`` and its
    default on the card), each after a warm-up call (the captured loop's
    capture): per step, wall, device busy, idle share, launches, and device
    ms and launches by kernel name. A call draws its steps' inputs first;
    the grid refresh is not in it."""
    from torch.profiler import ProfilerActivity, profile

    from nerfshop_tpu_torch.train import nerf as nerf_train

    for captured in (False, True):
        label = "captured" if captured else "eager"
        loop = nerf_train.make_train_loop(tb._state, tb.grid, tb._device_data, tb.train_config, steps, captured=captured)
        loop(tb.grid, tb.generator)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loop(tb.grid, tb.generator)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events, busy, by_name = device_events(prof)
        seg = [e for e in events if "segsum" in e.name]
        # kernel A's second launch may start before its first ends (programmatic
        # dependent launch), so its time is the union of its intervals
        seg_ms = busy_ms([(e.time_range.start, e.time_range.end) for e in seg])
        print(
            f"[profile] training, {label} loop, {steps} steps of batch {tb.train_config.n_rays_per_batch} x "
            f"{tb.train_config.k_samples}: per step wall {wall / steps:.3f} ms, device busy {busy / steps:.3f} ms "
            f"(union of event intervals), idle share {1.0 - busy / wall:.3f}, {len(events) / steps:.1f} device "
            f"launches; kernel A (segsum) {seg_ms / steps:.4f} ms busy (union of its intervals) and "
            f"{len(seg) / steps:.1f} launches per step, {100 * seg_ms / max(busy, 1e-9):.2f}% of the device busy time",
            flush=True,
        )
        print(f"[profile] {label} loop, per step, by kernel name (device ms, share, launches):")
        write_table(by_name, out if captured or out is None else out.with_name(f"{out.stem}_eager{out.suffix}"),
                    per=steps)


def profile_sdf_train(tb, out: Path | None = None, steps: int = 16) -> None:
    """Profile one ``steps``-step call of the SDF testbed's eager training
    after a warm-up call, the generator reseeded with ``chip_smoke.G_SEED``
    (so two versions profile the same batches): per step, wall, device busy,
    idle share, launches, and kernel G's device time and share."""
    from torch.profiler import ProfilerActivity, profile

    tb.train(steps, 1 << 16)
    torch.cuda.synchronize()
    tb.sdf.generator.manual_seed(chip_smoke.G_SEED)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tb.train(steps, 1 << 16)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events, busy, by_name = device_events(prof)
    g = [e for e in events if "bvh" in e.name]
    g_ms = sum(e.time_range.end - e.time_range.start for e in g) / 1e3
    print(
        f"[profile] SDF training, eager, {steps} steps of batch {1 << 16}: per step wall {wall / steps:.3f} ms, device "
        f"busy {busy / steps:.3f} ms (union of event intervals), idle share {1.0 - busy / wall:.3f}, "
        f"{len(events) / steps:.1f} device launches; kernel G (the bvh kernel) {g_ms / steps:.4f} ms and "
        f"{len(g) / steps:.1f} launches per step, {100 * g_ms / max(busy, 1e-9):.2f}% of the device busy time and "
        f"{100 * g_ms / wall:.2f}% of the wall time",
        flush=True,
    )
    print("[profile] SDF training, per step, by kernel name (device ms, share, launches):")
    write_table(by_name, out if out is None else out.with_name(f"{out.stem}_sdf_train{out.suffix}"), per=steps)


def build_edit(tb, focal, principal, dev):
    """The smoke's edit on ``tb``: scribble cage moved +0.18 in x, an
    affine duplicate on top, seen from the side → (selection, cage operator)."""
    gs, _, _, summary = chip_smoke.scribble_cage(tb, focal, principal)
    print(f"[profile] edit: {summary}", flush=True)
    tb.set_look_at(eye=chip_smoke.SIDE_EYE)
    gs.translate_cage(chip_smoke.CAGE_SHIFT)
    op = gs.make_operator()
    tb.add_edit_operator(op)
    tb.add_edit_operator(chip_smoke.duplicate_op(dev))
    return gs, op


def with_membrane(tb, gs, op):
    """Compute the selection's membrane and put ``op`` with it at the
    bottom of the stack."""
    gs.compute_membrane(tb.inference_params, tb.generator, grid=tb.grid)
    tb.replace_edit_operator(0, op._replace(membrane=gs.membrane))


def print_delta(label: str, before, after, top: int = 20) -> None:
    """The device time ``after`` adds to ``before`` ({name: [ms, count]}), by
    kernel name, the largest changes (up or down) first."""
    delta = sorted(
        ((n, after.get(n, [0.0, 0])[0] - before.get(n, [0.0, 0])[0], after.get(n, [0.0, 0])[1] - before.get(n, [0.0, 0])[1])
         for n in set(before) | set(after)),
        key=lambda r: -abs(r[1]),
    )
    print(f"[profile] device time {label} adds: {sum(d for _, d, _ in delta):.1f} ms; by kernel name (ms, launches):")
    for name, d, n in delta[:top]:
        print(f"    {d:10.3f} ms {n:7d}  {name[:130]}")


def profile_baked(tb, focal, principal, dev, out: Path | None = None) -> None:
    """The baked preview: one 1080p ``render_interactive`` frame of the
    trained model, then one incremental rebake of the smoke's edit after a
    drag of its cage."""
    tb.set_look_at(eye=chip_smoke.CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    tb.interactive_bake_resolution = chip_smoke.BAKE_RES
    t0 = time.perf_counter()
    tb.bake_interactive()
    torch.cuda.synchronize()
    print(f"[profile] bake_interactive {chip_smoke.BAKE_RES}^3: {time.perf_counter() - t0:.3f} s", flush=True)
    profile_frame(tb, "baked preview (render_interactive)", out, render=lambda: tb.render_interactive(W, H))
    gs, op = build_edit(tb, focal, principal, dev)
    tb.bake_interactive()
    gs.translate_cage(chip_smoke.BAKE_DRAG)
    ops = [gs.make_operator(), op]

    def rebake():
        tb.replace_edit_operator(0, ops[0], refresh_grid=False)
        ops.reverse()
        tb.bake_interactive()
        torch.cuda.synchronize()
        if not tb.last_bake_incremental:
            raise AssertionError("the drag did not rebake incrementally")

    profile_frame(tb, "incremental rebake after a cage drag", render=rebake)


def time_composite(tb, parent: Path) -> None:
    """Kernel H of ``parent`` (v1) against this checkout's (v2) on the
    smoke's 256³ bake of ``tb`` and its eight [baked] views."""
    import ctypes

    import time_bvh
    from nerfshop_tpu_torch import kernels
    from nerfshop_tpu_torch.render import baked as baked_lib

    v1, v2 = "v1 (parent)", "v2 (this checkout)"
    libs = time_bvh.build_versions({v1: parent, v2: kernels.CSRC / "baked.cu"},
                                   kernels.BUILD_DIR.parent / "baked_versions", "baked")
    for label, (lib, log) in libs.items():
        lib.nst_shear_composite.argtypes = [ctypes.POINTER(kernels.FrameArgs)] + [ctypes.c_void_p] * 3
        lib.nst_shear_composite.restype = ctypes.c_int
        print(f"[composite] ptxas {label}: {' | '.join(time_bvh.ptxas_lines(log, 'composite_kernel'))}", flush=True)
    print(f"[composite] v2's dynamic shared memory a block at B = {chip_smoke.BAKE_RES}: "
          f"{baked_lib.composite_smem(chip_smoke.BAKE_RES)} bytes; v1 none", flush=True)
    tb.set_look_at(eye=chip_smoke.CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    tb.interactive_bake_resolution = chip_smoke.BAKE_RES
    tb.bake_interactive()
    vol = tb._baked
    focal = tb._focal_for(W, H)
    dev = vol.canonical.device
    stream = kernels.stream_ptr(dev)

    def launch(label, field, fp, raster):
        args = baked_lib._frame_args(fp)
        kernels.check(libs[label][0].nst_shear_composite(ctypes.byref(args), field.data_ptr(), raster.data_ptr(),
                                                          stream), label)

    views = {**chip_smoke.baked_views(), **chip_smoke.baked_extra_views()}
    ratios = {}
    for name, xf in views.items():
        fp = baked_lib.frame_params(vol.resolution, vol.aabb_lo, vol.aabb_hi, (W, H), xf, focal, None,
                                    (0.0, 0.0, 0.0, 0.0), chip_smoke.BAKED_BI, with_depth=True)
        field = vol.fields[fp.major]
        out = {label: torch.empty((fp.Bi, fp.Bi, 5), dtype=torch.float32, device=dev) for label in libs}
        for label in libs:
            launch(label, field, fp, out[label])
        torch.cuda.synchronize()
        differ = int((out[v2] != out[v1]).sum())
        chip_smoke.check(differ == 0, f"view {name}: v2's raster differs from v1's in {differ} values")
        fp = fp._replace(with_depth=False)
        raster = torch.empty((fp.Bi, fp.Bi, 5), dtype=torch.float32, device=dev)
        times = {label: [] for label in libs}
        for order in ((v1, v2), (v2, v1)):
            for label in order:
                times[label].append(chip_smoke.both_ms(lambda: launch(label, field, fp, raster)))
        b_ms, b_by = chip_smoke.bound(fp.B**3 * 8 + fp.Bi * fp.Bi * 5 * 4, 50.0 * fp.B * fp.Bi * fp.Bi)
        med = {label: statistics.median(t[1] for t in times[label]) for label in libs}
        ratios[name] = med[v1] / med[v2]
        for label in libs:
            print(f"[composite] view {name} {label}: device {' / '.join(f'{t[1]:.4f}' for t in times[label])} ms, "
                  f"events {' / '.join(f'{t[0]:.4f}' for t in times[label])} ms (forward / reversed pass); "
                  f"device/bound {med[label] / b_ms:.2f}", flush=True)
        print(f"[composite] view {name}: v2 bit-equal to v1 (raster with depth); v1/v2 (device medians) "
              f"{ratios[name]:.2f}x; bound {b_ms:.4f} ms ({b_by}); H's tile-slices "
              f"{baked_lib.composite_plan(fp).counts()}", flush=True)
    print(f"[composite] v1/v2 over the views: {min(ratios.values()):.2f}-{max(ratios.values()):.2f}x", flush=True)


def profile_distill(tb, out: Path | None = None, steps: int = 8) -> None:
    """Profile ``steps`` distillation steps of the edited scene after as
    many warm-up steps: per step, wall, device busy, idle share, launches,
    and device ms and launches by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from nerfshop_tpu_torch.train import distill as distill_lib

    cfg = distill_lib.DistillConfig(aabb_scale=tb.train_config.aabb_scale, cone_angle=tb.train_config.cone_angle)
    ops = tuple(tb.edit_operators)
    tb.refresh_grid_for_edits()
    state = distill_lib.distill(tb.model, tb.inference_params, ops, tb._device_data, tb.grid, tb.generator,
                                n_steps=steps, cfg=cfg)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            distill_lib.distill_step(state, tb.inference_params, ops, tb.grid, tb._device_data, cfg, tb.generator)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events, busy, by_name = device_events(prof)
    print(
        f"[profile] distillation, {steps} steps (rays {cfg.n_rays_per_batch} x {cfg.k_samples}, "
        f"{cfg.n_free_samples} free, {cfg.n_edit_samples} edit samples): per step wall {wall / steps:.3f} ms, device "
        f"busy {busy / steps:.3f} ms (union of event intervals), idle share {1.0 - busy / wall:.3f}, "
        f"{len(events) / steps:.1f} device launches",
        flush=True,
    )
    print("[profile] per step, by kernel name (device ms, share, launches):")
    write_table(by_name, out, per=steps)


def profile_segsum(dev, calls: int = 20) -> None:
    """Kernel A alone at ``chip_smoke.py``'s hash, dense and skewed cases:
    per call, the median device time of each of its launches and the span
    from the first launch's start to the last one's end."""
    from torch.profiler import ProfilerActivity, profile

    from nerfshop_tpu_torch.ops import segsum

    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    for label, m, N in chip_smoke.SEGSUM_CASES[:4]:
        key = chip_smoke.segsum_keys(label, m, N, g, dev)
        w1 = torch.rand((N, 3), generator=g, device=dev)
        dout = torch.randn((N, 2), generator=g, device=dev)
        for _ in range(3):
            segsum.sorted_segment_rowsum_cuda(key, w1, dout, m)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                torch.cuda._sleep(chip_smoke.SLEEP_CYCLES)  # the launches queue behind it, as in chip_smoke.py
                segsum.sorted_segment_rowsum_cuda(key, w1, dout, m)
            torch.cuda.synchronize()
        seg = sorted((e for e in device_events(prof)[0] if "segsum" in e.name), key=lambda e: e.time_range.start)
        per = len(seg) // calls
        by_name = defaultdict(list)
        for e in seg:
            by_name[re.search(r"segsum_\w+", e.name).group(0)].append((e.time_range.end - e.time_range.start) / 1e3)
        spans = [
            (max(e.time_range.end for e in seg[i:i + per]) - seg[i].time_range.start) / 1e3
            for i in range(0, per * calls, per)
        ]
        parts = ", ".join(f"{n} {statistics.median(v):.4f} ms" for n, v in by_name.items())
        print(
            f"[profile] kernel A {label} m={m} N={N}: {per} launches per call; median {parts}; span of a call "
            f"{statistics.median(spans):.4f} ms (first start to last end)",
            flush=True,
        )


#: the [segsum] cases (by label) and the [gather] cases of ``--kernels``:
#: (label, form, x shape, idx shape, index range, idx dtype, 4-byte offset)
KERNEL_CASES = (
    ("hash", "dense", "skewed", "spread keys under a masked pile", "N=1", "one run spans all N"),
    (
        ("march fine-sort payload", "axis1", (8192, 512), (8192, 512), 512, torch.int64, False),
        ("ax1 [2^16,128]", "axis1", (1 << 16, 128), (1 << 16, 128), 128, torch.int32, False),
        ("ax1 [2^16,128] at a 4-byte offset", "axis1", (1 << 16, 128), (1 << 16, 128), 128, torch.int32, True),
        ("warp row take [5260,12]", "rows", (5260, 12), (1 << 20,), 5260, torch.int32, False),
        ("rows C=9", "rows", (5239, 9), (1 << 20,), 5239, torch.int32, False),
        ("ax0 [8192,128]", "axis0", (8192, 128), (8192, 128), 8192, torch.int32, False),
    ),
)


def encode_inputs(dev, chunk: Path):
    """Kernel B's two shapes: (label, encoding, table, x) at the training
    shape (``chip_smoke.py``'s [encode] inputs) and at the frame shape (the
    positions and the trained table saved by ``--save-chunk``)."""
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    enc, x = chip_smoke._encoding(dev, g)
    saved = torch.load(chunk, map_location=dev)
    return (("training shape", enc, enc.table.detach(), x), ("1080p march chunk", enc, saved["table"], saved["x"]))


def time_encode(dev, chunk: Path) -> None:
    """Kernel B of the package at both shapes, in each mode its wrapper has
    (an older wrapper without ``with_fracs`` always writes the fracs)."""
    import inspect

    from nerfshop_tpu_torch.ops import table_ops

    modes = (True, False) if "with_fracs" in inspect.signature(table_ops.grid_encode_cuda).parameters else (None,)
    for label, enc, table, x in encode_inputs(dev, chunk):
        plain = table_ops.grid_encode_plain(table, x, enc)[0]
        for mode in modes:
            args = (table, x, enc) if mode is None else (table, x, enc, mode)
            out = table_ops.grid_encode_cuda(*args)[0]
            chip_smoke.check(float((out - plain).abs().max()) <= 1e-6, f"kernel B disagrees ({label})")
            ms, dev_ms = chip_smoke.both_ms(lambda: table_ops.grid_encode_cuda(*args))
            us = chip_smoke.host_us(lambda: table_ops.grid_encode_cuda(*args))
            fracs = "with fracs" if mode in (None, True) else "without fracs"
            print(
                f"[kernels] B {label} N={x.shape[0]} {fracs}: events {ms:.4f} ms device {dev_ms:.4f} ms; "
                f"wrapper host {us:.1f} us per call",
                flush=True,
            )


def time_encode_dx(dev, chunk: Path) -> None:
    """Kernel F of the package at ``chip_smoke.py``'s training shape (with
    every level's boundary points) and at the saved frame shape, each with a
    dout drawn from a generator seeded the same way every run; checked
    against its plain version (max |Δ| within 1e-5 of max |d_x|), then
    timed by both methods."""
    from nerfshop_tpu_torch.ops import table_ops

    for label, enc, table, x in encode_inputs(dev, chunk):
        if label == "training shape":
            label = "training shape (boundary points included)"
            x = torch.cat([chip_smoke.boundary_points(enc, dev), x[: x.shape[0] - 3 * enc.n_levels]])
        g = torch.Generator(device=dev)
        g.manual_seed(4321)
        dout = torch.randn((x.shape[0], 2 * enc.n_levels), generator=g, device=dev)
        got = table_ops.grid_encode_dx_cuda(table, x, dout, enc)
        ref = table_ops.grid_encode_dx_plain(table, x, dout, enc)
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        chip_smoke.check(err <= 1e-5 * scale, f"kernel F disagrees ({label}): {err:.3e} vs max |d_x| {scale:.3e}")
        ms, dev_ms = chip_smoke.both_ms(lambda: table_ops.grid_encode_dx_cuda(table, x, dout, enc))
        us = chip_smoke.host_us(lambda: table_ops.grid_encode_dx_cuda(table, x, dout, enc))
        print(
            f"[kernels] F {label} N={x.shape[0]}: max |delta| {err / scale:.3e} of max |d_x|; events {ms:.4f} ms "
            f"device {dev_ms:.4f} ms; wrapper host {us:.1f} us per call",
            flush=True,
        )


def save_chunk(dev, path: Path) -> None:
    """``--save-chunk``: train the smoke's model, render one 1080p frame of the
    render view and save the positions its middle chunk encoded, with the
    trained table."""
    tb, *_ = chip_smoke.phase_main_path(dev)
    tb.set_look_at(eye=chip_smoke.CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    enc = tb.model.pos_encoding
    with chip_smoke.encode_input_of_call(enc, chip_smoke.middle_chunk(W, H)) as kept:
        tb.render(W, H, exact=True)
    chip_smoke.check(len(kept) == 1, "the middle chunk's positions were not captured")
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"x": kept[0], "table": enc.table.detach().clone()}, path)
    print(f"[profile] saved the {tuple(kept[0].shape)} positions of the middle 1080p chunk to {path}", flush=True)


def time_kernels(dev, root: str, chunk: Path) -> None:
    """``--kernels``: kernels A and D of the package under ``root`` at
    KERNEL_CASES and kernels B and F at their two shapes, each checked
    against its plain version, then timed."""
    from nerfshop_tpu_torch.ops import gather, segsum

    print(f"[kernels] package {Path(segsum.__file__).resolve().parent.parent} (root {root})", flush=True)
    time_encode(dev, chunk)
    time_encode_dx(dev, chunk)
    seg_labels, gather_cases = KERNEL_CASES
    for label, m, N in chip_smoke.SEGSUM_CASES:
        if label not in seg_labels:
            continue
        g = torch.Generator(device=dev)
        g.manual_seed(99)
        key = chip_smoke.segsum_keys(label, m, N, g, dev)
        N = key.shape[0]
        w1 = torch.rand((N, 3), generator=g, device=dev)
        dout = torch.randn((N, 2), generator=g, device=dev)
        ker = segsum.sorted_segment_rowsum_cuda(key, w1, dout, m)
        plain = segsum.sorted_segment_rowsum_plain(key, w1, dout, m)
        absum = segsum.sorted_segment_rowsum_plain(key, w1, dout.abs(), m)
        chip_smoke.check(bool(((ker - plain).abs() <= 1e-5 * absum + 1e-30).all()), f"kernel A disagrees ({label})")
        ct = (segsum.corner_products(w1)[:, :, None] * dout[:, None, :]).reshape(N, 16)
        key64 = key.long()
        ms, dev_ms = chip_smoke.both_ms(lambda: segsum.sorted_segment_rowsum_cuda(key, w1, dout, m))
        lib_ms, lib_dev_ms = chip_smoke.both_ms(lambda: torch.zeros((m, 16), device=dev).index_add_(0, key64, ct))
        us = chip_smoke.host_us(lambda: segsum.sorted_segment_rowsum_cuda(key, w1, dout, m))
        print(
            f"[kernels] A {label} m={m} N={N}: events {ms:.4f} ms device {dev_ms:.4f} ms; index_add_ events "
            f"{lib_ms:.4f} ms device {lib_dev_ms:.4f} ms; wrapper host {us:.1f} us per call",
            flush=True,
        )
    for label, form, xs, ids, hi, idt, offset in gather_cases:
        g = torch.Generator(device=dev)
        g.manual_seed(99)
        x = torch.randn(xs, generator=g, device=dev)
        idx = torch.randint(0, hi, ids, generator=g, device=dev, dtype=idt)
        if offset:
            x, idx = chip_smoke.offset_view(x), chip_smoke.offset_view(idx)
        idx64 = idx.long()
        if form == "rows":
            lib_fn = lambda: torch.index_select(x, 0, idx64)  # noqa: E731
        else:
            lib_fn = lambda: torch.gather(x, 1 if form == "axis1" else 0, idx64)  # noqa: E731
        chip_smoke.check(torch.equal(gather.gather_cuda(x, idx, form), lib_fn()), f"kernel D disagrees ({label})")
        ms, dev_ms = chip_smoke.both_ms(lambda: gather.gather_cuda(x, idx, form))
        lib_ms, lib_dev_ms = chip_smoke.both_ms(lib_fn)
        us, lib_us = chip_smoke.host_us(lambda: gather.gather_cuda(x, idx, form)), chip_smoke.host_us(lib_fn)
        print(
            f"[kernels] D {label} {form} x{xs} idx{ids} {str(idt)[6:]}: events {ms:.4f} ms device {dev_ms:.4f} ms; "
            f"library events {lib_ms:.4f} ms device {lib_dev_ms:.4f} ms; host per call: wrapper {us:.1f} us "
            f"library {lib_us:.1f} us",
            flush=True,
        )


def save_edit(dev, out: Path) -> None:
    """``--save-edit``: train the smoke's model, build its edit (the scribble
    cage moved +0.18 in x, an affine duplicate on top, seen from the side),
    render the edited frame and save the edits file and the positions and
    directions its middle chunk sent through the moved cage."""
    tb, focal, principal, *_ = chip_smoke.phase_main_path(dev)
    gs, _, _, summary = chip_smoke.scribble_cage(tb, focal, principal)
    print(f"[profile] edit: {summary}", flush=True)
    tb.set_look_at(eye=chip_smoke.SIDE_EYE)
    gs.translate_cage(chip_smoke.CAGE_SHIFT)
    op = gs.make_operator()
    tb.add_edit_operator(op)
    tb.add_edit_operator(chip_smoke.duplicate_op(dev))
    with chip_smoke.cage_input_of_call(op, chip_smoke.middle_chunk(W, H)) as kept:
        tb.render(W, H, exact=True)
    chip_smoke.check(len(kept) == 1, "the middle chunk's warp was not captured")
    out.mkdir(parents=True, exist_ok=True)
    tb.save_edits(str(out / "edits.json"))
    torch.save({"pos": kept[0][0], "dir": kept[0][1]}, out / "warp_chunk.pt")
    print(f"[profile] saved the edits and the {tuple(kept[0][0].shape)} warp inputs of the middle chunk to {out}", flush=True)


def time_warp(dev, root: str, edit: Path, N: int = 1 << 20) -> None:
    """``--warp``: the cage operator of the saved edit, loaded by the package
    under ``root``, at the saved chunk and at 2^20 random points (90% in the
    deformed LUT's box, as ``chip_smoke.py``): its sample warp, its position
    warp and its inclusive lookup in the deformed LUT, by both methods, and
    the lookup's disagreements with the package's plain lookup."""
    from nerfshop_tpu_torch.editing import operators, serialization

    print(f"[warp] package {Path(operators.__file__).resolve().parents[1]} (root {root})", flush=True)
    op = next(o for o in serialization.load_edits(edit / "edits.json", dev) if hasattr(o, "lut_def"))
    chunk = torch.load(edit / "warp_chunk.pt", map_location=dev)
    lut = op.lut_def
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    size = lut.res / lut.inv_cell
    n_in = (N * 9) // 10
    p = torch.cat([
        lut.bbox_lo + torch.rand((n_in, 3), generator=g, device=dev) * size,
        lut.bbox_lo + size * (1.05 + torch.rand((N - n_in, 3), generator=g, device=dev)),
    ])
    d = torch.nn.functional.normalize(torch.randn((N, 3), generator=g, device=dev), dim=1)
    table = torch.cat([op.v0_def, op.inv_def.reshape(-1, 9)], 1).contiguous()
    thr = -0.08
    if hasattr(operators, "REC_DEF"):  # the packed form of this commit
        rows = op.packed.records[operators.REC_DEF]
        lookup = lambda x: operators.tet_lookup_cuda(op.packed.lut_def, rows, x, thr)  # noqa: E731
    else:
        lookup = lambda x: operators.tet_lookup_cuda(lut, table, x, thr)  # noqa: E731
    for label, pos, direction in (("edited 1080p frame's middle chunk", chunk["pos"], chunk["dir"]), ("random points", p, d)):
        fk, tk, _ = lookup(pos)
        fp, tp, _ = operators.tet_lookup_plain(lut, table, pos, thr)
        diff = int(((fk != fp) | (tk != tp)).sum())
        for name, fn in (
            ("cage_map_samples", lambda: operators.cage_map_samples(op, pos, direction)),
            ("cage_map_positions", lambda: operators.cage_map_positions(op, pos)),
            ("lookup (deformed LUT, inclusive)", lambda: lookup(pos)),
        ):
            ms, dev_ms = chip_smoke.both_ms(fn)
            print(f"[warp] {label} N={pos.shape[0]} {name}: events {ms:.4f} ms device {dev_ms:.4f} ms", flush=True)
        print(f"[warp] {label}: the lookup differs from the plain one at {diff} points", flush=True)


def field_testbed(dev, mode: str, steps: int = 1000):
    """The SDF or Volume testbed of ``chip_smoke.py``'s [sdf] / [volume]
    phase, trained ``steps`` steps at batch 2^16."""
    import tempfile

    from nerfshop_tpu_torch.geometry import mesh_io
    from nerfshop_tpu_torch.testbed import Testbed
    from nerfshop_tpu_torch.train import volume as volume_train

    tb = Testbed(mode, device=dev, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        if mode == "sdf":
            path = Path(tmp) / "bumpy.obj"
            mesh_io.save_obj(path, chip_smoke.bumpy_mesh())
        else:
            path = Path(tmp) / "smoke.npy"
            np.save(path, volume_train.synthetic_smoke(256))
        tb.load_training_data(str(path))
    t0 = time.perf_counter()
    loss = tb.train(steps, 1 << 16)
    print(f"[profile] {mode} testbed: {steps} steps in {time.perf_counter() - t0:.3f} s, loss {loss:.6f}", flush=True)
    return tb


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None, help="write the full per-kernel table here")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--edited", action="store_true", help="also profile the frame of chip_smoke.py's edit")
    mode.add_argument("--normals", action="store_true", help="also profile the frame in RenderMode.Normals")
    mode.add_argument("--train", action="store_true", help="profile the eager and the captured training loop instead of a frame")
    mode.add_argument("--distill", action="store_true", help="profile 8 distillation steps of the edit with a membrane")
    mode.add_argument("--kernels", action="store_true", help="time kernels A, B, D and F alone (no training)")
    mode.add_argument("--save-chunk", type=Path, default=None, help="train, then save one 1080p chunk's positions here")
    mode.add_argument("--save-edit", type=Path, default=None, help="train, edit, then save the edits and a warp chunk here")
    mode.add_argument("--warp", action="store_true", help="time the cage warp of a saved edit (no training)")
    mode.add_argument("--sdf", action="store_true", help="profile a sphere-traced frame of the SDF testbed instead")
    mode.add_argument("--volume", action="store_true", help="profile a delta-tracked frame of the Volume testbed instead")
    mode.add_argument("--baked", action="store_true", help="profile a baked preview frame and an incremental rebake")
    mode.add_argument("--composite", action="store_true", help="time kernel H of --parent against this checkout's")
    ap.add_argument("--compact", type=float, default=None,
                    help="in the frame mode: also profile the frame with this compact_frac")
    ap.add_argument("--root", default=None, help="with --kernels or --warp: the checkout whose package is timed")
    ap.add_argument("--chunk", type=Path, default=None, help="with --kernels: the file --save-chunk wrote")
    ap.add_argument("--edit", type=Path, default=None, help="with --warp: the directory --save-edit wrote")
    ap.add_argument("--parent", type=Path, default=None, help="with --composite: the older csrc/baked.cu")
    args = ap.parse_args()
    if (args.parent is not None) != args.composite:
        ap.error("--composite needs --parent, and --parent goes with --composite")
    if args.compact is not None and (args.edited or args.normals or args.train or args.distill or args.kernels or args.warp
                                     or args.sdf or args.volume or args.baked or args.composite
                                     or args.save_chunk is not None
                                     or args.save_edit is not None):
        ap.error("--compact goes with the frame mode only")
    if args.root is not None and not (args.kernels or args.warp):
        ap.error("--root goes with --kernels or --warp")
    if (args.chunk is not None) != args.kernels:
        ap.error("--kernels needs --chunk (written by --save-chunk), and --chunk goes with --kernels")
    if (args.edit is not None) != args.warp:
        ap.error("--warp needs --edit (written by --save-edit), and --edit goes with --warp")
    if args.root is not None:
        sys.path.insert(0, str(Path(args.root).resolve()))  # before the package is first imported
    if args.kernels or args.warp or args.save_chunk is not None or args.save_edit is not None:
        smi = chip_smoke.phase_device()
        chip_smoke.phase_build()
        print(f"[profile] card: {smi}")
        dev = torch.device("cuda", 0)
        if args.save_chunk is not None:
            save_chunk(dev, args.save_chunk)
        elif args.save_edit is not None:
            save_edit(dev, args.save_edit)
        elif args.warp:
            time_warp(dev, args.root or ".", args.edit)
        else:
            time_kernels(dev, args.root or ".", args.chunk)
        return

    from nerfshop_tpu_torch.common import RenderMode

    smi = chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    chip_smoke.phase_build()
    if args.sdf or args.volume:
        print(f"[profile] card: {smi}")
        mode = "sdf" if args.sdf else "volume"
        tb = field_testbed(dev, mode)
        if args.sdf:
            print(f"[profile] sdf testbed: calculate_iou {tb.calculate_iou():.5f}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        profile_frame(tb, "SDF, sphere-traced" if args.sdf else "Volume, delta-tracked spp 4", args.out,
                      render=lambda: (tb.render(W, H), torch.cuda.synchronize()))
        print(f"[profile] {mode} frame: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
              flush=True)
        if args.sdf:
            profile_sdf_train(tb, args.out)
        return
    tb, focal, principal, *_ = chip_smoke.phase_main_path(dev)
    print(f"[profile] card: {smi}")
    if args.train:
        profile_train(tb, args.out)
        profile_segsum(dev)
        return
    if args.distill:
        gs, op = build_edit(tb, focal, principal, dev)
        with_membrane(tb, gs, op)
        profile_distill(tb, args.out)
        return
    if args.baked:
        profile_baked(tb, focal, principal, dev, args.out)
        return
    if args.composite:
        time_composite(tb, args.parent.resolve())
        return
    if args.edited:
        tb.set_look_at(eye=chip_smoke.SIDE_EYE)
        tb.refresh_grid_for_edits()
        plain = profile_frame(tb, "unedited")
        gs, op = build_edit(tb, focal, principal, dev)
        edited = profile_frame(tb, "edited (cage + affine)", args.out)
        print_delta("the edit", plain, edited)
        with_membrane(tb, gs, op)
        membrane = profile_frame(tb, "edited with the membrane (target blend)")
        print_delta("the membrane", edited, membrane)
        return
    tb.set_look_at(eye=chip_smoke.CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    if args.normals:
        shaded = profile_frame(tb, "shaded")
        tb.render_mode = RenderMode.Normals
        torch.cuda.reset_peak_memory_stats()
        normals = profile_frame(tb, "Normals", args.out)
        print(f"[profile] Normals frame: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
              flush=True)
        print_delta("RenderMode.Normals", shaded, normals)
        return
    profile_frame(tb, "unedited", args.out)
    if args.compact is not None:
        plain = profile_frame(tb, "render_frame, compact_frac 0", render=compact_render(tb, 0.0))
        compact = profile_frame(tb, f"render_frame, compact_frac {args.compact}", render=compact_render(tb, args.compact))
        print_delta(f"compact_frac {args.compact}", plain, compact)

    # Cost mode shades n_used / K_total; the model predicts sRGB-space
    # radiance, so the default (non-linear) output leaves the value as is
    tb.render_mode = RenderMode.Cost
    cost = tb.render(W, H, exact=True)[..., 0]
    opts = tb._render_options()
    k_total = opts.k_samples * opts.n_windows
    used = np.rint(cost * k_total)
    print(
        f"[profile] composited samples {int(used.sum())} of {tb.stats.render_samples} slots evaluated, "
        f"pixels with a composited sample {int((used > 0).sum())} of {W * H}",
        flush=True,
    )


if __name__ == "__main__":
    main()
