#!/usr/bin/env python3
"""Device profile of one exact 1920×1080 frame of the port on one NVIDIA GPU.

Run from the root of a checkout:
  python3 profile_render.py [--out FILE] [--compact FRAC | --edited | --normals | --train | --distill | --sdf | --volume
                             | --takikawa | --baked]
  python3 profile_render.py --save-chunk FILE
  python3 profile_render.py --kernels --chunk FILE [--root DIR]
  python3 profile_render.py --save-edit DIR
  python3 profile_render.py --warp --edit DIR [--root DIR]
  python3 profile_render.py --composite --parent FILE
  python3 profile_render.py --dx-bwd --parent FILE
  python3 profile_render.py --density [--out FILE]
  python3 profile_render.py --xor --parent FILE

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
and one 1920×1080 delta-tracked frame at spp 4; with ``--takikawa`` the
Takikawa SDF of its [takikawa] phase (the same mesh, JAX's default
Takikawa encoding, 1000 steps) and one 1920×1080 sphere-traced frame
(kernels K, C, and L for the analytic normals).

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

With ``--dx-bwd --parent FILE`` it times kernel J (the encode's second
order) of ``FILE`` (an older ``csrc/grid_encode.cu`` with the same
``nst_grid_encode_dx_bwd`` entry, e.g. ``git show
9fc2711:nerfshop_tpu_torch/csrc/grid_encode.cu >
build/grid_encode_parent.cu``, the first version) against this
checkout's on the inputs of [density]'s double backward (327,680
positions, ``chip_smoke.density_inputs``) and on its 2^16 near-surface
positions alone: both built into libraries of their own under
``build/dx_bwd_versions/`` (``time_bvh.build_versions``, each kernel's
registers, spills and shared memory printed), this checkout's held to the
parent's within ``chip_smoke.J_TOL`` of max, each bit-equal over two runs,
then timed by both of ``chip_smoke.both_ms``'s methods, old, new, new,
old.

With ``--density`` it profiles one eikonal step of [density]
(``chip_smoke.eikonal_step`` at its 327,680 positions: the density
module's double backward, kernel J once) after a warm-up step, as a frame
is profiled (host wall, device busy, idle share, device time by kernel
name), and prints the host operators with the most self time.

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

With ``--xor`` it trains nothing: it builds kernels K and L (the xor-hash
corner encode and its backward) from ``--parent`` (an older
``csrc/xor_encode.cu``, e.g. ``git show HEAD~:nerfshop_tpu_torch/csrc/
xor_encode.cu > build/xor_parent.cu``) and from this checkout, prints their
registers and spills, holds them to each other and to the plain versions
and times them in turns at the default config's plain grid (2^18 uniform
samples; 2^20 samples of 2^16 distinct positions; 2^18 along rays) and at
Takikawa's defaults (2^16 points; K alone at 2^21).

  python3 profile_render.py --xor --parent FILE
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


def time_dx_bwd(tb, parent: Path) -> None:
    """Kernel J of ``parent`` (v1) against this checkout's (v2) on
    [density]'s double-backward inputs of ``tb``."""
    import ctypes

    import time_bvh
    from nerfshop_tpu_torch import kernels

    v1, v2 = "v1 (parent)", "v2 (this checkout)"
    libs = time_bvh.build_versions({v1: parent, v2: kernels.CSRC / "grid_encode.cu"},
                                   kernels.BUILD_DIR.parent / "dx_bwd_versions", "dx_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    for label, (lib, log) in libs.items():
        lib.nst_grid_encode_dx_bwd.argtypes = [p] * 7 + [i, i, p]
        lib.nst_grid_encode_dx_bwd.restype = i
        print(f"[dx-bwd] ptxas {label}: {' | '.join(time_bvh.ptxas_lines(log, 'grid_encode_dx_bwd_kernel'))}",
              flush=True)

    x, _, _, mod, d_out, d_dpos = chip_smoke.density_inputs(tb)
    with chip_smoke.j_spy() as calls:
        mod.fns.bwd_bwd_input_density(x, d_out, d_dpos)
    table, xx, g, v = calls[0]
    enc = tb.model.pos_encoding
    rec = enc.kernel_records()
    dev = xx.device
    stream = kernels.stream_ptr(dev)
    n_near = 1 << 16  # density_positions: the near-surface positions come last

    def run(label, x_, g_, v_, dh, dx2):
        err = libs[label][0].nst_grid_encode_dx_bwd(
            x_.data_ptr(), rec.data_ptr(), table.data_ptr(), g_.data_ptr(), v_.data_ptr(), dh.data_ptr(),
            dx2.data_ptr(), x_.shape[0], enc.n_levels, stream)
        kernels.check(err, label)

    def outputs(n):
        return torch.empty((n, 2 * enc.n_levels), device=dev), torch.empty((n, 3), device=dev)

    cases = {f"[density]'s {xx.shape[0]} positions": (xx, g, v),
             f"its {n_near} near-surface positions alone": tuple(t[-n_near:] for t in (xx, g, v))}
    for case, (x_, g_, v_) in cases.items():
        N = x_.shape[0]
        outs = {}
        for label in libs:
            first, again = outputs(N), outputs(N)
            run(label, x_, g_, v_, *first)
            run(label, x_, g_, v_, *again)
            torch.cuda.synchronize()
            chip_smoke.check(all(torch.equal(a, b) for a, b in zip(first, again)), f"{label}: two runs differ ({case})")
            outs[label] = first
        ref_h, ref_x = outs[v1]
        scale_h, scale_x = float(ref_h.abs().max()), float(ref_x.abs().max())
        err_h = float((outs[v2][0] - ref_h).abs().max()) / scale_h
        err_x = float((outs[v2][1] - ref_x).abs().max()) / scale_x
        chip_smoke.check(max(err_h, err_x) <= chip_smoke.J_TOL, f"v2 differs from v1 ({case}): {err_h}, {err_x}")
        times = {label: [] for label in libs}
        for label in (v1, v2, v2, v1):
            dh, dx2 = outputs(N)
            times[label].append(chip_smoke.both_ms(lambda: run(label, x_, g_, v_, dh, dx2)))
        touched = chip_smoke.touched_rows(enc, enc.brick_fracs(x_)[0])
        b_ms, b_by = chip_smoke.bound(chip_smoke.nbytes(x_, g_, v_, *outs[v1]) + touched * 2 * 4)
        med = {label: statistics.median(t[1] for t in times[label]) for label in libs}
        for label in libs:
            print(f"[dx-bwd] {case}, {label}: device {' / '.join(f'{t[1]:.4f}' for t in times[label])} ms, events "
                  f"{' / '.join(f'{t[0]:.4f}' for t in times[label])} ms (forward / reversed pass); device/bound "
                  f"{med[label] / b_ms:.2f}", flush=True)
        print(f"[dx-bwd] {case}: bound {b_ms:.4f} ms ({b_by}, {touched} of {enc.table_size} table rows touched); "
              f"v1/v2 {med[v1] / med[v2]:.3f}x; v2 within {err_h:.2e} of max |dh|, {err_x:.2e} of max |d_x2| of "
              "v1; both bit-equal over two runs", flush=True)


def profile_density(tb, out: Path | None = None) -> None:
    """One eikonal step of [density] (its double backward) under the
    profiler after a warm-up step: wall, busy, idle share, launches, device
    ms by kernel name, and the host operators with the most self time."""
    from torch.profiler import ProfilerActivity, profile

    x, _, _, mod, _, _ = chip_smoke.density_inputs(tb)

    def step():
        chip_smoke.eikonal_step(mod, x)
        torch.cuda.synchronize()

    step()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        wall = (time.perf_counter() - t0) * 1e3
    events, busy, by_name = device_events(prof)
    print(f"[density-profile] eikonal step at {x.shape[0]} positions: unprofiled {[round(t, 2) for t in times]} ms; "
          f"profiled wall {wall:.2f} ms, {len(events)} device events, device busy {busy:.2f} ms, idle share "
          f"{1.0 - busy / wall:.3f}", flush=True)
    write_table(by_name, out)
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:15]
    print("[density-profile] host operators by self time (ms, calls):", flush=True)
    for e in host:
        print(f"    {e.self_cpu_time_total / 1e3:10.3f} ms {e.count:6d}  {e.key[:110]}", flush=True)


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


#: kernels K and L's versions in ``--xor``: the parent's and this checkout's
XOR_V1, XOR_V2 = "v1 (parent)", "v2 (this checkout)"


def xor_shapes(dev):
    """{shape: (encoding, table, x, dout)}: the default config's plain grid
    (a table uniform in ±1, seeded) at 2^18 uniform samples (a training
    batch), at 2^20 samples of 2^16 distinct positions in the middle of
    the box, each repeated 16 times in a row (a frame chunk's repetition),
    and at 2^18 samples in order along 2^12 rays through the box, 64 a ray
    1.4/64 apart (a training batch's order); the Takikawa encoding at JAX's
    defaults (F = 8, 10 levels) over the [sdf] mesh's octree at 2^16
    points, half within a finest cell of the surface (chip_smoke.py's [xor]
    inputs), and at 2^21 such points (a 1080p frame's count, an output
    larger than the L2; K alone)."""
    from nerfshop_tpu_torch.config import default_nerf_config
    from nerfshop_tpu_torch.geometry.triangle_octree import TriangleOctree
    from nerfshop_tpu_torch.models.encodings import TakikawaEncoding
    from nerfshop_tpu_torch.models.nerf_network import build_nerf_network

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    cfg = default_nerf_config()
    cfg["encoding"] = {**cfg["encoding"], "layout": "plain"}
    enc = build_nerf_network(cfg, device=dev, generator=g).pos_encoding
    v, f = chip_smoke.unit_mesh(chip_smoke.bumpy_mesh())
    te = TakikawaEncoding(TriangleOctree.build(v, f, 14), n_features_per_level=8, device=dev, generator=g)
    with torch.no_grad():
        enc.table.uniform_(-1.0, 1.0, generator=g)
        te.table.uniform_(-1.0, 1.0, generator=g)
    repeated = (torch.rand((1 << 16, 3), generator=g, device=dev) * 0.4 + 0.3).repeat_interleave(16, 0).contiguous()
    xt = torch.cat([chip_smoke.near_surface(v, f, 1 << 15, g, dev, 1.0 / (1 << 13)),
                    torch.rand((1 << 15, 3), generator=g, device=dev)])
    u = torch.nn.functional.normalize(torch.randn((1 << 12, 3), generator=g, device=dev), dim=1)
    d = -torch.nn.functional.normalize(u + 0.2 * torch.randn((1 << 12, 3), generator=g, device=dev), dim=1)
    t = 0.05 + torch.arange(64, device=dev, dtype=torch.float32) * (1.4 / 64)
    rays = (0.5 + 0.75 * u[:, None, :] + t[None, :, None] * d[:, None, :]).reshape(-1, 3).contiguous()
    shapes = {"2^18 uniform": (enc, torch.rand((1 << 18, 3), generator=g, device=dev)),
              "2^20: 2^16 distinct x16": (enc, repeated),
              "2^18 along 2^12 rays x 64": (enc, rays),
              "Takikawa F=8, 2^16": (te, xt)}
    shapes["Takikawa F=8, 2^21, K alone"] = (te, torch.cat([
        chip_smoke.near_surface(v, f, 1 << 20, g, dev, 1.0 / (1 << 13)), torch.rand((1 << 20, 3), generator=g, device=dev)]))
    return {k: (e, e.table.detach(), x, torch.randn((x.shape[0], e.n_output_dims), generator=g, device=dev))
            for k, (e, x) in shapes.items()}


def xor_entry_lines(log: str) -> list:
    """(kernel with its template arguments, ptxas's lines) for every entry
    of kernels K and L in an ``-Xptxas -v`` log."""
    out, lines = [], log.splitlines()
    for k, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*?\d(xor_encode(?:_[a-z]+)?_kernel)I(\w+?)EEv", line)
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2) + "E"))
            info = [t.replace("ptxas info    :", "").strip() for t in lines[k + 1:k + 4]
                    if ("bytes" in t or "Used" in t) and "Compiling" not in t]
            out.append((f"{m.group(1)}<{args}>", info))
    return out


def time_xor(dev, parent: Path) -> None:
    """``--xor``: kernels K and L of ``parent`` (an older
    ``csrc/xor_encode.cu``, v1) against this checkout's (v2), each built
    alone with ``-Xptxas -v`` (their registers, spills and shared memory
    printed), at :func:`xor_shapes`. K v2 is held bit-equal to v1, L's
    position gradient bit-equal from call to call and within
    ``chip_smoke.XOR_BWD_TOL`` of v1's, its table gradient within
    ``chip_smoke.XOR_SUM_TOL`` of each slot's sum of |terms| of the plain
    version's; then K, L with both gradients and L's table half alone are
    timed by both of ``chip_smoke.both_ms``'s methods in the order v1, v2,
    v2, v1, beside ``index_add_`` of the table half's (row, value) pairs and
    the bytes bound (K alone at a shape named so)."""
    import ctypes

    import time_bvh
    from nerfshop_tpu_torch import kernels
    from nerfshop_tpu_torch.ops import xor_encode as xe

    libs = time_bvh.build_versions({XOR_V1: parent, XOR_V2: kernels.CSRC / "xor_encode.cu"},
                                   kernels.BUILD_DIR.parent / "xor_versions", "xor")
    p, i = ctypes.c_void_p, ctypes.c_int
    for label, (lib, log) in libs.items():
        lib.nst_xor_encode.argtypes = [ctypes.POINTER(kernels.XorArgs), p, p, p, p, i, p]
        lib.nst_xor_encode_bwd.argtypes = [ctypes.POINTER(kernels.XorArgs), p, p, p, p, p, p, i, p]
        lib.nst_xor_encode.restype = lib.nst_xor_encode_bwd.restype = i
        for name, info in xor_entry_lines(log):
            print(f"[xor] ptxas {label}: {name}: {' | '.join(info)}", flush=True)
    stream = kernels.stream_ptr(dev)

    def k_run(label, enc, table, x):
        out = torch.empty((x.shape[0], enc.n_output_dims), device=dev)
        mask = enc.mask.data_ptr() if enc.takikawa else None
        kernels.check(libs[label][0].nst_xor_encode(ctypes.byref(xe.xor_args(enc)), x.data_ptr(), table.data_ptr(),
                                                     mask, out.data_ptr(), x.shape[0], stream), label)
        return out

    def l_run(label, enc, table, x, dout, want_dx=True):
        dt = torch.zeros_like(table)
        dx = torch.empty((x.shape[0], enc.n_input_dims), device=dev) if want_dx else None
        mask = enc.mask.data_ptr() if enc.takikawa else None
        kernels.check(libs[label][0].nst_xor_encode_bwd(
            ctypes.byref(xe.xor_args(enc)), x.data_ptr(), table.data_ptr(), mask, dout.data_ptr(), dt.data_ptr(),
            None if dx is None else dx.data_ptr(), x.shape[0], stream), label)
        return dt, dx

    order = (XOR_V1, XOR_V2, XOR_V2, XOR_V1)
    for shape, (enc, table, x, dout) in xor_shapes(dev).items():
        N = x.shape[0]
        ref, out = k_run(XOR_V1, enc, table, x), k_run(XOR_V2, enc, table, x)
        differ = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
        chip_smoke.check(differ == 0, f"K v2 is not bit-equal to v1 ({shape}): {differ} values differ, max |d| "
                                      f"{float((out - ref).abs().max()):.3e}")
        del ref, out
        if shape.endswith("K alone"):
            times = {XOR_V1: [], XOR_V2: []}
            for label in order:
                times[label].append(chip_smoke.both_ms(lambda: k_run(label, enc, table, x)))
            print(f"[xor] {shape} N={N}: K v2 bit-equal to v1; "
                  + "; ".join(f"{label}: K device {' / '.join(f'{t[1]:.4f}' for t in ts)} ms events "
                              f"{' / '.join(f'{t[0]:.4f}' for t in ts)} ms" for label, ts in times.items()), flush=True)
            continue
        _, dx_p = xe.xor_encode_bwd_plain(table, x, dout, enc, False, True)
        dt_p, _ = xe.xor_encode_bwd_plain(table, x, dout, enc, True, False)
        rows, vals = chip_smoke.xor_index_pairs(enc, x, dout)
        dt_tol = torch.zeros_like(table).index_add_(0, rows, vals.abs()) * chip_smoke.XOR_SUM_TOL + 1e-7
        dx_v1 = None
        notes = []
        for label in libs:
            dt, dx = l_run(label, enc, table, x, dout)
            _, dx_again = l_run(label, enc, table, x, dout)
            chip_smoke.check(torch.equal(dx, dx_again), f"L {label}: d x differs between two calls ({shape})")
            ratio = float(((dt - dt_p).abs() / dt_tol).max())
            chip_smoke.check(ratio <= 1.0, f"L {label}: d table at {ratio:.3f} of its bound ({shape})")
            dx_v1 = dx if dx_v1 is None else dx_v1
            dx_err = float((dx - dx_v1).abs().max()) / max(float(dx_p.abs().max()), 1e-30)
            chip_smoke.check(dx_err <= chip_smoke.XOR_BWD_TOL, f"L {label}: d x {dx_err:.3e} of max from v1's ({shape})")
            notes.append(f"{label}: d table {ratio:.4f} of its bound, d x {dx_err:.2e} of max |d x| from v1's")
        del dt_tol, dt_p, dx_p
        times = {label: {"K": [], "L": [], "L table": []} for label in libs}
        for label in order:
            times[label]["K"].append(chip_smoke.both_ms(lambda: k_run(label, enc, table, x)))
            times[label]["L"].append(chip_smoke.both_ms(lambda: l_run(label, enc, table, x, dout)))
            times[label]["L table"].append(chip_smoke.both_ms(lambda: l_run(label, enc, table, x, dout, False)))
        lib_ms, lib_dev = chip_smoke.both_ms(lambda: torch.zeros_like(table).index_add_(0, rows, vals))
        del rows, vals
        n_rows, n_cells = chip_smoke.xor_reads(enc, x)
        F = enc.n_features_per_level
        out_bytes = N * enc.n_output_dims * 4
        k_b, _ = chip_smoke.bound(chip_smoke.nbytes(x) + out_bytes + n_rows * F * 4 + n_cells)
        l_b, _ = chip_smoke.bound(chip_smoke.nbytes(x, dout, table, x) + n_rows * F * 4 + n_cells)
        lt_b, _ = chip_smoke.bound(chip_smoke.nbytes(x, dout, table) + n_cells)
        print(f"[xor] {shape} N={N}: K v2 bit-equal to v1; {'; '.join(notes)}; d x bit-equal over two "
              f"calls in each; bytes bound K {k_b:.4f} ms, L {l_b:.4f} ms, L table {lt_b:.4f} ms; index_add_ of the "
              f"table half's pairs events {lib_ms:.4f} ms device {lib_dev:.4f} ms", flush=True)
        for label, kinds in times.items():
            parts = [f"{kind} device {' / '.join(f'{t[1]:.4f}' for t in ts)} ms events "
                     f"{' / '.join(f'{t[0]:.4f}' for t in ts)} ms" for kind, ts in kinds.items()]
            print(f"[xor] {shape}, {label}: {'; '.join(parts)} (forward / reversed pass)", flush=True)
        med = {label: {kind: statistics.median(t[1] for t in ts) for kind, ts in kinds.items()}
               for label, kinds in times.items()}
        print(f"[xor] {shape}: v1/v2 device K {med[XOR_V1]['K'] / med[XOR_V2]['K']:.3f}x, L "
              f"{med[XOR_V1]['L'] / med[XOR_V2]['L']:.3f}x, L table {med[XOR_V1]['L table'] / med[XOR_V2]['L table']:.3f}x; "
              f"v2 device/bound K {med[XOR_V2]['K'] / k_b:.2f}, L {med[XOR_V2]['L'] / l_b:.2f}", flush=True)


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
    """The SDF, Volume or Takikawa SDF testbed of ``chip_smoke.py``'s [sdf]
    / [volume] / [takikawa] phase, trained ``steps`` steps at batch 2^16."""
    import tempfile

    from nerfshop_tpu_torch.geometry import mesh_io
    from nerfshop_tpu_torch.testbed import Testbed
    from nerfshop_tpu_torch.train import volume as volume_train

    if mode == "takikawa":
        with tempfile.TemporaryDirectory() as tmp:
            obj = Path(tmp) / "bumpy.obj"
            mesh_io.save_obj(obj, chip_smoke.bumpy_mesh())
            t0 = time.perf_counter()
            tb, *_ = chip_smoke.takikawa_main(Path(tmp), obj, steps)
        print(f"[profile] takikawa testbed: load and {steps} steps in {time.perf_counter() - t0:.3f} s", flush=True)
        return tb
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
    mode.add_argument("--takikawa", action="store_true",
                      help="profile a sphere-traced frame of the Takikawa SDF testbed ([takikawa]) instead")
    mode.add_argument("--baked", action="store_true", help="profile a baked preview frame and an incremental rebake")
    mode.add_argument("--composite", action="store_true", help="time kernel H of --parent against this checkout's")
    mode.add_argument("--dx-bwd", action="store_true", help="time kernel J of --parent against this checkout's")
    mode.add_argument("--density", action="store_true", help="profile one eikonal step of [density]")
    mode.add_argument("--xor", action="store_true", help="time kernels K and L of --parent against this checkout's")
    ap.add_argument("--compact", type=float, default=None,
                    help="in the frame mode: also profile the frame with this compact_frac")
    ap.add_argument("--root", default=None, help="with --kernels or --warp: the checkout whose package is timed")
    ap.add_argument("--chunk", type=Path, default=None, help="with --kernels: the file --save-chunk wrote")
    ap.add_argument("--edit", type=Path, default=None, help="with --warp: the directory --save-edit wrote")
    ap.add_argument("--parent", type=Path, default=None,
                    help="with --composite: the older csrc/baked.cu; with --dx-bwd: the older csrc/grid_encode.cu; "
                         "with --xor: the older csrc/xor_encode.cu")
    args = ap.parse_args()
    if (args.parent is not None) != (args.composite or args.dx_bwd or args.xor):
        ap.error("--composite, --dx-bwd and --xor need --parent, and --parent goes with them")
    if args.compact is not None and (args.edited or args.normals or args.train or args.distill or args.kernels or args.warp
                                     or args.sdf or args.volume or args.takikawa or args.baked or args.composite
                                     or args.dx_bwd or args.density or args.xor
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
    if args.kernels or args.warp or args.xor or args.save_chunk is not None or args.save_edit is not None:
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
        elif args.xor:
            time_xor(dev, args.parent.resolve())
        else:
            time_kernels(dev, args.root or ".", args.chunk)
        return

    from nerfshop_tpu_torch.common import RenderMode

    smi = chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    chip_smoke.phase_build()
    if args.sdf or args.volume or args.takikawa:
        print(f"[profile] card: {smi}")
        mode = "sdf" if args.sdf else "volume" if args.volume else "takikawa"
        tb = field_testbed(dev, mode)
        if args.sdf:
            print(f"[profile] sdf testbed: calculate_iou {tb.calculate_iou():.5f}", flush=True)
        torch.cuda.reset_peak_memory_stats()
        label = {"sdf": "SDF, sphere-traced", "volume": "Volume, delta-tracked spp 4",
                 "takikawa": "Takikawa SDF, sphere-traced"}[mode]
        profile_frame(tb, label, args.out, render=lambda: (tb.render(W, H), torch.cuda.synchronize()))
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
    if args.dx_bwd:
        time_dx_bwd(tb, args.parent.resolve())
        return
    if args.density:
        profile_density(tb, args.out)
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
