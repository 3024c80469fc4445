#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nerfshop_tpu_torch``) once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one line of its own numbers:
  1. device: torch/CUDA versions, the card's name and power limit;
  2. build: compile the CUDA kernels of ``nerfshop_tpu_torch/csrc``;
  3. kernel A (sorted segment row-sum) against its plain PyTorch version;
  4. kernel B (hash-grid encode forward) against its plain version, with
     and without the slots and fractions the backward reads, at the
     training shape (2^18 uniform samples), at N = 1 and at one tile plus
     one (and, after the edit path, at the frame shape: the positions of
     the trained model's middle 1080p march chunk);
  5. the encode backward (sort + kernel A + corner rolls) against autograd
     of the plain forward;
  6. kernel C (fused MLP forward) against its plain version at 2^20 rows,
     for the density (32→64→16), the rgb (32→64→64→3) and the Takikawa SDF
     (80→64→64→1) MLP, and at input widths 7, 23, 72, 75, 80 and 128;
  6a. [xor]: kernels K (the xor-hash corner encode) and L (its backward:
     the table gradient by atomics and the position gradient) against
     their plain versions: the plain grid layout at the default config's
     grid (2^18 samples with the box's corners and points outside it, N = 1,
     129 and 257; the box's faces and, on every level, points at even and
     odd p0.x and at the clamped p0.x = res − 1, a sample count that is no
     whole number of warps; 2^16 identical positions; 2^16 positions
     repeated in runs of 16 and repeated across the lanes of each warp) and
     at the Image config's 2-D grid; the Takikawa encoding at JAX's defaults
     over the [sdf] mesh's octree (F = 8, levels of 4920, 35944 and 274632
     slots, with the box's faces; F = 2 summed; F = 4 and 2), timed beside
     their bounds and L's table half beside one ``index_add_``;
  7. the training path: the default tcnn-parity NeRF (16 levels × 2
     features, 2^19 table, 64-wide MLPs) trained through ``Testbed.train``
     with batch 2^18 on an analytic opaque-sphere scene, every chunk of 16
     steps a replay of one captured CUDA graph (the script checks that no
     step ran eagerly); then [train-loop]: from copies of the trained
     state and generator, 32 steps of the eager loop against 32 of the
     captured one (each step's loss within 1e-4 relative, the state within
     1e-3), and the steps/s of each;
  8. the render path: ``Testbed.render(1920, 1080, exact=True)`` of the
     trained model (one warm-up frame, then the median of 3), plus one
     256×256 frame each in Depth and Cost mode; then [render-compact]: the
     same frame through ``render_frame`` with ``compact_frac`` 0, the
     middle chunk's valid share rounded up, and twice that: frame ms, the
     share of valid rows dropped past the slab, and the change against the
     uncompacted frame (≤ 1e-5 where no row was dropped, else PSNR);
  8a. [baked]: the baked interactive preview of the trained sphere:
     ``bake_interactive()`` at 256³ over the tight box (seconds; kernels B
     without fracs and C), σ at 2^16 seeded cells against the field
     evaluated there (within bf16 rounding); kernels H (the shear-warp slice
     composite) and I (the screen warp) against their plain versions on six
     views (each major axis, both flips) and two more (an eye inside the bake
     box, and a close view whose back slices overflow H's shared-memory box)
     at 1920×1080 with a 384² base raster (raster and rgba within 1e-4),
     timed, with H's tile-slices skipped, staged and read directly (equal to
     ``composite_plan``'s; both paths run over the eight views);
     ``render_interactive(1920,
     1080)`` (median of 3 after a warm-up; one launch of H and of I a
     frame); the baked frame against the exact one (PSNR ≥ 24 dB,
     ``tests/test_baked.py``);
  9. the viewer path: ``Testbed.frame()`` (no training) three times into a
     1920×1080 frame buffer, through ``render_dynamic``'s dynamic
     resolution and its on-device bilinear upsample;
 10. held-out: one 128×128 view through ``Testbed.render``, scored in PSNR;
 11. snapshot: ``save_snapshot`` → a fresh ``Testbed`` → ``load_snapshot``
     renders the same view as before saving;
 11a. [encode-dx]: kernel F (the encode's gradient with respect to the
     positions) against its plain version (autograd of the plain forward)
     at the training shape with every level's boundary points (p0 =
     res − 1), at N = 1, at one block plus one, at 5 and 20 levels and at
     the frame shape;
 11a'. [density]: the torch density module (``torch_interop.py``) over the
     trained model at 2^18 positions uniform in the occupied box and 2^16
     within one grid cell of the surface: ``fwd_density``, ``bwd_density``,
     ``bwd_bwd_input_density`` and an eikonal-style step (kernel J once per
     second-order backward), all finite and, on every 8th position, held to
     the plain route on the CPU; kernel J against its plain version on the
     inputs of the module's double backward and at its edges (N = 1, 129
     and 12345, the table's first 15 levels, positions on the box's faces
     and at exactly 1), each twice and bit-equal, timed beside its bound
     with its registers and shared memory;
 11a''. [train-extras]: the sphere's views, 12 as opaque photos over black
     and 4 with transparent targets over the envmap, every view's pose
     perturbed (0.02 rad, 0.02 units) and 4 views darkened by 0.8, trained
     256 steps at batch 2^18 through captured chunks with pose and
     distortion-map optimization, exposure, the error map and the envmap
     on: kernel F in the training step, the camera leaves moved and finite,
     the corrected poses' mean rotation and translation errors printed
     every 32 steps and the views' log exposures printed (JAX's rule, the
     network's Adam, lets both drift: F16), the loss falling as [train]'s,
     held-out PSNR ≥ 14 dB, the captured loop held to eager over 32 steps
     (as [train-loop]), one 1080p frame with the envmap background;
 11b. [normals]: ``Testbed.render(1920, 1080)`` in ``RenderMode.Normals``
     (kernel F once a chunk, kernel A never, B without fracs only), and the
     middle chunk's normals and σ against the plain encode's;
 11c. [mesh]: ``compute_marching_cubes_mesh(256)`` of the trained sphere
     (seconds by stage; the vertices within one cell of the field's σ = 2.5
     level and within three of the analytic sphere, no floaters), then
     ``optimise_mesh`` for 100 steps (kernel F once a step), and kernel F
     timed against its plain version at the vertices its first step encodes;
 11d. [cli]: the sphere's views written to disk (transforms.json + PNGs
     through the port's writer) and ``nerfshop_tpu_torch.run.main`` in
     process on them from the snapshot: 64 steps, a snapshot, a mesh at
     128, the held-out score (``psnr_mean`` ≥ 14 dB), a 1080p screenshot and
     3 1080p frames of a camera path, each read back;
 11e. [ingp]: the trained network saved as .ingp (re-baked into the plain
     layout through kernels B, K and L), loaded by ``run.main(
     ["--load_snapshot", ...])`` into a fresh testbed, a 1080p exact frame
     against the brick network's (mean |Δ| < 0.02; over the lit pixels
     < 0.05, PSNR > 35 dB), K and L at the frame's middle chunk and a
     training batch, 64 captured training steps on the plain table, the
     same for .msgpack, and the re-bake at JAX's test config (mean |Δ|
     < 0.025);
 12. kernel D (dynamic gathers) against its plain version and the library
     call, bit for bit, at the shapes of the TPU gather kernels and of the
     render march (run before the training phase);
 13. the edit path on the trained model: scribble rays → ``GrowingSelection``
     (project, grow, proxy, cage) → an identity cage, a cage moved +0.18 in
     x and an affine duplicate on top, each added through
     ``Testbed.add_edit_operator`` (a full grid refresh through the stack)
     and rendered at 1920×1080; then ``save_edits`` → ``load_edits``;
 14. kernel E, the cage warp, in its first three instances
     against their plain versions: the ``LOOKUP`` (strict and inclusive)
     and the two warps (``WARP_SAMPLES``, ``WARP_POSITIONS``) on 2^20 points
     in and around the moved cage's LUT and on the points and directions the
     edited frame's middle chunk sent through the moved cage, beside the
     parent commit's launch pattern of the sample warp (two lookups, kernel
     D's row takes and the elementwise warp); then all three bit-equal on
     LUTs that test the tie rule (an exact copy of every tet listed before
     it) and the NaN rule (a degenerate tet at the head of every cell);
 15. membrane: the Poisson membrane of the moved cage through
     ``GrowingSelection.compute_membrane``; kernel E's ``WARP_MEMBRANE``
     instance against its plain version on the middle chunk, on 2^20 random
     points and on the tie and NaN LUTs, with the share of in-target points
     that pass the membrane's gate (the phase fails at 0); the 1080p frame
     of the stack with the membrane ("target" blend) against it without;
 15a. [baked-edit]: the stack with the membrane and the duplicate baked in
     full (one ``WARP_MEMBRANE`` launch a chunk); the cage dragged 0.02
     further and swapped in without a grid refresh: an incremental rebake,
     its seconds, within 1e-2 of a forced full bake; one edited 1080p baked
     frame against the exact one (PSNR, no bound);
 16. distill: the edited scene distilled into a standalone student (300
     steps of the default ``DistillConfig`` at the trained scale), steps/s,
     and the student's render without operators against the edited render
     of a side view in PSNR (bound 25 dB);
 17. native: the host library's LUT build, region growing and ``vanish``
     against the numpy paths;
 17a. [viewer]: ``ViewerServer`` on a free port in a background thread,
     driven with ``urllib``: ``GET /`` and ``/state``, four 1080p
     ``/render`` (the first bakes), a sphere selection's cage applied and
     translated (an incremental rebake, seen in ``/state``'s
     ``last_rebake_s`` and the testbed's flag), ``/train`` of 16 steps (a
     replay of the captured graph), a frame after it (a full rebake), an
     unknown verb (``ok: false``); each request's ms, the frame's and the
     PNG encode's, every PNG read back at 1920×1080;
 18. [sdf]: an 81920-face bumpy icosphere written as .obj and trained
     through ``run.main(["--mode", "sdf", ...])`` (1000 steps at batch
     2^16); kernel G (the BVH signed distance: the packed walk) against its plain version, the brute force, on a batch's,
     uniform and near-feature points from a fixed seed, and timed at 2^15
     and 2^18 points; ``calculate_iou`` ≥ 0.9; a 1920×1080 sphere-traced
     frame;
 19. [image]: kernels B and A at D = 2 against their plain versions at the
     Image config's shapes; a 2048×2048 PNG trained through ``run.main(
     ["--mode", "image", ...])`` (1000 steps at batch 2^18), its
     ``image_psnr`` line and ``compute_image_mse`` (≥ 18 dB); the table
     backward's corner fold and concatenation timed;
 20. [volume]: ``synthetic_smoke(256)`` as .npy through
     ``load_training_data``, 1000 steps at batch 2^16 (the loss halves), a
     1920×1080 delta-tracked frame at spp 4 and a 64×64 one against the
     ground-truth tracker's;
 20a. [takikawa]: the [sdf] mesh through ``run.main(["--mode", "sdf",
     "--network", ...])`` with a Takikawa encoding at JAX's defaults and
     configs/sdf/base.json's network: the octree's build time, 1000 steps
     at 2^16 (the loss falls), K and L against their plain versions on a
     training batch, the IoU and the sign agreement within one finest cell
     of the surface (printed, not gated), a 1080p frame with analytic
     normals (hit share in (0.05, 0.95); K, L, C launched);
 20b. [encodings]: 200 SDF steps each with a Frequency (12), a
     TriangleWave (12) and a OneBlob (16) position encoding: the loss
     falls, kernel C launched at 72, 36 and 48 inputs;
 21. [captured]: the sphere inside an opaque checkered backdrop (radius 1.6,
     across the outer cascades) as a captured ``transforms.json`` scene: 32
     JPEG frames at 512×384 through the port's encoder (quality 90, 4:2:0)
     and 4 held out, ``aabb_scale`` 4 (three cascades), each frame rendered
     in numpy through a rolling shutter with motion blur (its
     ``transform_matrix_end``) and carrying a ``light_dir``; loaded through
     ``Testbed.load_training_data`` (the port's JPEG decoder, ms a frame
     with the host CPU's name), 256 steps at batch 2^18 of the default
     config (the loss falls as [train]'s, every cascade refreshed, the inner
     one occupied, each cascade's occupied share, the held-out views and
     two training views at their start poses ≥ 14 dB, the renders' rgb MLP
     at its 35-wide input through kernel C); kernel C held to its plain
     version at that width; the extrinsics' round trip in both conventions and with pose deltas,
     ``n_params``, ``level_stats``, ``training_step``; a ``torch.profiler``
     trace of 16 steps and its five largest device ops; and
     ``reload_network_from_json`` (step 0, the loss back near the first).
A [launches] line gives each path's launches by kernel, and kernel B's
split into launches with fracs (training forwards only) and without
(render, grid refresh, edited frames); the edited frame runs the cage warp
as one launch of kernel E per chunk and launches kernel D only for the
march; a membrane frame launches ``WARP_MEMBRANE`` once a chunk and no
other instance of E; a distillation step launches kernel B with fracs for
the student's two forwards only. Then a JSON line with every
kernel's launches on the main paths (training, counted by graph replays,
the density module, training with the options on, render, compacted render, frame, Normals frame, mesh, CLI, edit, membrane
frame, distillation, the baked preview, the viewer and the captured scene; kernels H and I
as ``shear_warp_composite`` and ``shear_warp_screen``, their numbers the
median over the six views, the error the largest),
error, times, bound and library-call time, the
``nvidia-smi`` name/power-limit line, and as the last line ``{"ok": true,
"device": {...}}``. Any failed check raises, so the script exits non-zero;
without a CUDA device it exits non-zero before printing a result. Kernel
times are medians over repeated runs, measured with CUDA events after a
warm-up: around one call (``ms``), and with the call queued behind a spin
kernel (``device_ms``, the device work alone). A bound is the larger of the bytes a call must move (each input
read once, each output written once; for a gather, the source elements
this run's indices touch) over 3.35 TB/s and its operations over the
dense peak of their type (989 TFLOP/s bf16 tensor, 67 TFLOP/s fp32).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

STEPS = 256
BATCH = 1 << 18
RES = 128
N_VIEWS = 16
CENTER = np.array([0.5, 0.5, 0.5], np.float32)
RADIUS = 0.22
TIMING_RUNS = 25
#: the spin before a timed call (~2 ms at the H100's 1.98 GHz boost clock)
SLEEP_CYCLES = 4_000_000
#: H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def median_ms(fn, runs: int = TIMING_RUNS, queued: bool = False, warmups: int = 3) -> float:
    """Median time of ``fn()`` in ms: CUDA events around one call, after 3
    warm-up calls. Unqueued (the ``ms`` of the kernels line, the method of
    every earlier measurement of the port), the events also count the time
    the card waits for the host's checks and launches between them: what a
    caller that launches one call at a time sees. ``queued`` (the
    ``device_ms``): a spin kernel runs first, so the call is enqueued behind
    it and the events time the device work alone: what a call costs on a
    path where the host runs ahead of the card."""
    for _ in range(warmups):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def both_ms(fn) -> tuple[float, float]:
    """(events ms, device ms) of ``fn``: :func:`median_ms` unqueued and queued."""
    return median_ms(fn), median_ms(fn, queued=True)


def bound(n_bytes: float, n_ops: float = 0.0, peak: float = FP32_FLOPS):
    """(least time in ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ----------------------------------------------------------------- the scene


def look_at(eye, target=CENTER, up=(0.0, 0.0, 1.0)):
    eye = np.asarray(eye, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.concatenate([np.stack([right, down, fwd], 1), eye[:, None]], 1).astype(np.float32)


def sphere_rgba(o, d):
    """Analytic render: an opaque sphere coloured by its surface position."""
    oc = o - CENTER
    b = np.sum(oc * d, -1)
    c = np.sum(oc * oc, -1) - RADIUS**2
    disc = b * b - c
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = (disc > 0) & (t > 0)
    p = o + t[:, None] * d
    rgba = np.zeros((o.shape[0], 4), np.float32)
    rgba[hit, :3] = np.clip((p - CENTER) / (2 * RADIUS) + 0.5, 0, 1)[hit]
    rgba[hit, 3] = 1.0
    return rgba


def view_rays(xf, focal, principal, device):
    from nerfshop_tpu_torch.ops import rays

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return rays.rays_for_image((RES, RES), t(xf), t(focal), t(principal))


def sphere_dataset(device, seed=0):
    from nerfshop_tpu_torch.data.nerf_loader import CameraIntrinsics, NerfDataset

    rng = np.random.default_rng(seed)
    focal = np.array([RES * 1.1, RES * 1.1], np.float32)
    principal = np.array([0.5, 0.5], np.float32)
    images, xforms = [], []
    for i in range(N_VIEWS):
        ang = 2 * np.pi * i / N_VIEWS
        eye = CENTER + np.array([np.cos(ang), np.sin(ang), rng.uniform(-0.3, 0.8)], np.float32) * 1.3
        xf = look_at(eye)
        b = view_rays(xf, focal, principal, device)
        images.append(sphere_rgba(b.origins.cpu().numpy(), b.directions.cpu().numpy()).reshape(RES, RES, 4))
        xforms.append(xf)
    intr = [CameraIntrinsics(focal, principal, np.zeros(4, np.float32), np.array([RES, RES], np.int32))] * N_VIEWS
    ds = NerfDataset(images=np.stack(images), xforms=np.stack(xforms), intrinsics=intr, paths=[""] * N_VIEWS, aabb_scale=1)
    return ds, focal, principal


# -------------------------------------------------------------------- phases


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(
        f"[device] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"card {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} nvidia-smi: {smi}",
        flush=True,
    )
    return smi


def phase_build():
    from nerfshop_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.load()
    print(f"[build] {kernels.library_path().name} built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)


def host_us(fn, calls: int = 1000) -> float:
    """Median host time of one call of ``fn`` in µs: the wrapper's checks,
    allocations and launch, with the device queue drained before each call
    so that no call waits for the card."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def keys_from_runs(lengths, m, g, dev):
    """Sorted int32 keys with runs of the given lengths on distinct random
    slots of [0, m)."""
    slots = torch.sort(torch.randperm(m, generator=g, device=dev)[: len(lengths)]).values
    return torch.repeat_interleave(slots.int(), torch.as_tensor(lengths, device=dev)).contiguous()


def segsum_keys(label, m, N, g, dev):
    """The keys of a [segsum] case (sorted, int32)."""
    if label == "tile edges":  # runs that end exactly on tile edges, one over two tiles
        from nerfshop_tpu_torch.ops.segsum import TILE

        return keys_from_runs([TILE, 2 * TILE, TILE - 1, 1, TILE, 3 * TILE + 5, TILE - 5], m, g, dev)
    if label == "one run spans all N":
        return torch.full((N,), m // 3, dtype=torch.int32, device=dev)
    if label == "spread keys under a masked pile":  # sparse real samples, the rest masked onto the last slot
        spread = torch.randint(0, m - 1, (3000,), generator=g, device=dev, dtype=torch.int32)
        pile = torch.full((N - 3000,), m - 1, dtype=torch.int32, device=dev)
        return torch.sort(torch.cat([spread, pile])).values.contiguous()
    key = torch.randint(0, m, (N,), generator=g, device=dev, dtype=torch.int32)
    if label == "skewed":
        key[: (N * 4) // 5] = 12345
    if label == "keys 0 and m-1, m < N" and N:
        key[0], key[-1] = 0, m - 1
    return torch.sort(key).values.contiguous()


#: (label, m, N): the main path's level (hash), a dense coarse level, a skew
#: beyond a training batch's (80% of the keys on one slot), 3000 keys spread
#: below such a pile (tiles that own long stretches of rows), then the edges
SEGSUM_CASES = (
    ("hash", 1 << 19, 1 << 18),
    ("dense", 4096, 1 << 18),
    ("skewed", 1 << 19, 1 << 18),
    ("spread keys under a masked pile", 1 << 19, 1 << 18),
    ("tile edges", 1 << 16, None),
    ("one run spans all N", 1000, 100 * 512 + 3),
    ("N=1", 1 << 16, 1),
    ("N=0", 1000, 0),
    ("N not a multiple of the tile", 5000, 3 * 512 + 37),
    ("keys 0 and m-1, m < N", 1000, 50_000),
    ("4-byte-aligned views", 1 << 19, (1 << 18) - 1),
)


def segsum_case(tag, label, key, w1, dout, m):
    """Kernel A on one sorted case against its plain version → its numbers.
    Tolerance: |kernel − plain| ≤ 1e-5 · Σ|terms| of the row (fp32, other
    summation order); rows no sample hits are 0.0; two calls are bit-equal.
    D (2 or 3) is w1's width; the rows are 2^D · 2 floats wide."""
    from nerfshop_tpu_torch.ops import segsum

    N, D = w1.shape
    W = (1 << D) * 2
    ker = segsum.sorted_segment_rowsum_cuda(key, w1, dout, m)
    again = segsum.sorted_segment_rowsum_cuda(key, w1, dout, m)
    plain = segsum.sorted_segment_rowsum_plain(key, w1, dout, m)
    absum = segsum.sorted_segment_rowsum_plain(key, w1, dout.abs(), m)
    torch.cuda.synchronize()
    check(ker.shape == (m, W), f"kernel A's rows are {tuple(ker.shape)}, expected ({m}, {W}) ({label})")
    err = (ker - plain).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    check(bool((err <= 1e-5 * absum + 1e-30).all()), f"kernel A disagrees ({label}): max err {max_err}")
    untouched = absum.sum(1) == 0
    check(bool((ker[untouched] == 0).all()), f"kernel A left an unhit row non-zero ({label})")
    check(torch.equal(ker.view(torch.int32), again.view(torch.int32)), f"kernel A is not bit-reproducible ({label})")
    ms, dev_ms = both_ms(lambda: segsum.sorted_segment_rowsum_cuda(key, w1, dout, m))
    plain_ms = median_ms(lambda: segsum.sorted_segment_rowsum_plain(key, w1, dout, m))
    # library call: index_add_ of the formed [N, W] contributions
    ct = (segsum.corner_products(w1)[:, :, None] * dout[:, None, :]).reshape(N, W)
    key64 = key.long()
    lib = lambda: torch.zeros((m, W), device=key.device).index_add_(0, key64, ct)  # noqa: E731
    lib_ms, lib_dev_ms = both_ms(lib)
    us = host_us(lambda: segsum.sorted_segment_rowsum_cuda(key, w1, dout, m))
    lib_us = host_us(lib)
    # bytes: key, w1, dout in, [m, W] out; ops: the 2^D corner weights
    # ((D − 1) multiplies each), the 2^D × 2 outer product and its sums, per
    # sample (48 at D = 3, 20 at D = 2)
    b_ms, b_by = bound(nbytes(key, w1, dout) + m * W * 4, N * float((1 << D) * (D - 1) + 4 * (1 << D)))
    print(
        f"[{tag}] {label} m={m} N={N} D={D}: max_abs_err {max_err:.3e} (bound 1e-5*row sum|terms|), two calls "
        f"bit-equal; events: kernel {ms:.4f} ms plain {plain_ms:.4f} ms index_add_ {lib_ms:.4f} ms, "
        f"kernel/index_add_ {ms / lib_ms:.3f}; device (queued): kernel {dev_ms:.4f} ms index_add_ "
        f"{lib_dev_ms:.4f} ms, kernel/index_add_ {dev_ms / lib_dev_ms:.3f}; bound {b_ms:.4f} ms ({b_by}), "
        f"device/bound {dev_ms / b_ms:.2f}; host per call: wrapper {us:.1f} us, index_add_ (with its zeros) "
        f"{lib_us:.1f} us",
        flush=True,
    )
    return dict(max_abs_err=max_err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)


def phase_segsum(dev, g):
    """Kernel A against its plain version in every case of SEGSUM_CASES
    (:func:`segsum_case`)."""
    result = {}
    for label, m, N in SEGSUM_CASES:
        key = segsum_keys(label, m, N if N is not None else 0, g, dev)
        N = key.shape[0]
        w1 = torch.rand((N, 3), generator=g, device=dev)
        dout = torch.randn((N, 2), generator=g, device=dev)
        if label == "4-byte-aligned views":  # contiguous views at a 4-byte storage offset: the scalar loads
            key = torch.cat([key[:1], key])[1:]
            w1 = torch.cat([w1.reshape(-1)[:1], w1.reshape(-1)])[1:].view(N, 3)
            dout = torch.cat([dout.reshape(-1)[:1], dout.reshape(-1)])[1:].view(N, 2)
            check(key.data_ptr() % 16 == 4 and w1.data_ptr() % 16 == 4, "the views are not 4-byte aligned")
        result[label] = segsum_case("segsum", label, key, w1, dout, m)
    return {**result["hash"], "max_abs_err": max(r["max_abs_err"] for r in result.values())}


def _encoding(dev, g):
    from nerfshop_tpu_torch.config import default_nerf_config
    from nerfshop_tpu_torch.models.nerf_network import build_nerf_network

    enc = build_nerf_network(default_nerf_config(), device=dev, generator=g).pos_encoding
    with torch.no_grad():
        enc.table.uniform_(-1.0, 1.0, generator=g)
    N = 1 << 18
    x = torch.rand((N, 3), generator=g, device=dev)
    x[:6] = torch.tensor([[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.5, 1, 0], [0, 1, 1], [1, 1, 0]], device=dev)
    return enc, x


def touched_rows(enc, idx) -> int:
    """Distinct table rows the 8 corners of the slots idx [L, N] read."""
    shifts = enc.shift_table(idx.device)
    rows = torch.cat([
        ((idx[l].long()[:, None] + shifts[l][None, :]) % enc.level_sizes[l] + enc.level_offsets[l]).reshape(-1)
        for l in range(enc.n_levels)
    ])
    return int(torch.unique(rows).numel())


def encode_case(label, enc, table, x, with_fracs: bool, note: str = "", tag: str = "encode"):
    """Kernel B in one mode against its plain version on x → its numbers.
    With fracs: slots equal, w1 and out within 1e-6 absolute. Without: no
    slots or fracs, out within 1e-6 of the plain version and bit-equal to the
    kernel's out with fracs."""
    from nerfshop_tpu_torch.ops import table_ops

    out_k, idx_k, w1_k = table_ops.grid_encode_cuda(table, x, enc, with_fracs)
    out_p, idx_p, w1_p = table_ops.grid_encode_plain(table, x, enc, True)
    torch.cuda.synchronize()
    N, L = x.shape[0], enc.n_levels
    check(out_k.shape == (N, 2 * L) and bool(torch.isfinite(out_k).all()), f"kernel B out bad ({label})")
    if with_fracs:
        check(w1_k.shape == (L, N, enc.n_input_dims), f"kernel B fracs of shape {tuple(w1_k.shape)} ({label})")
    out_err = float((out_k - out_p).abs().max())
    if with_fracs:
        n_diff = int((idx_k != idx_p).sum())
        check(n_diff == 0, f"kernel B slots differ at {n_diff} (sample, level) pairs ({label})")
        w1_err = float((w1_k - w1_p).abs().max())
        check(w1_err <= 1e-6, f"kernel B fracs disagree ({label}): w1 {w1_err:.3e}")
        what = f"slots equal, w1 err {w1_err:.3e}"
    else:
        check(idx_k is None and w1_k is None, f"kernel B returned fracs it was not asked for ({label})")
        full = table_ops.grid_encode_cuda(table, x, enc, True)[0]
        check(torch.equal(out_k, full), f"kernel B out without fracs differs from out with fracs ({label})")
        what = "no slots or fracs written, out bit-equal to the out with fracs"
    check(out_err <= 1e-6, f"kernel B disagrees ({label}): out {out_err:.3e}")
    fn = lambda: table_ops.grid_encode_cuda(table, x, enc, with_fracs)  # noqa: E731
    ms, dev_ms = both_ms(fn)
    plain_ms = median_ms(lambda: table_ops.grid_encode_plain(table, x, enc, with_fracs))
    us = host_us(fn)
    # bytes: x, the distinct table rows the 8 corners touch, out (and with
    # fracs the slots and fractions); ops: ~65 fp32 per (sample, level)
    touched = touched_rows(enc, idx_p)
    n_bytes = nbytes(x, out_k) + touched * 2 * 4 + (nbytes(idx_k, w1_k) if with_fracs else 0)
    b_ms, b_by = bound(n_bytes, N * L * 65.0)
    print(
        f"[{tag}] {label} N={N} L={L} D={enc.n_input_dims} {'with' if with_fracs else 'without'} fracs: {what}, "
        f"out err {out_err:.3e} "
        f"(bound 1e-6); kernel {ms:.4f} ms (device {dev_ms:.4f} ms) plain {plain_ms:.4f} ms bound {b_ms:.4f} ms "
        f"({b_by}, {n_bytes / 1e6:.1f} MB, {touched} of {enc.table_size} table rows touched), device/bound "
        f"{dev_ms / b_ms:.2f}; host per call {us:.1f} us{note}",
        flush=True,
    )
    return dict(max_abs_err=out_err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                library_device_ms=None, bound_ms=b_ms, bound_by=b_by)


def phase_encode(dev, g):
    """Kernel B at the training shape (2^18 uniform samples, the default
    16 levels) in both modes, then at N = 1 and one tile plus one (the tile
    as the kernel's launcher sizes it); then, in both modes and at one tile
    plus one, at 5 levels (odd: a dense level and four hash levels, blocks
    of 5 levels) and at 20 (a second level group of 4). The kernels line
    takes the training shape with fracs."""
    from nerfshop_tpu_torch import kernels
    from nerfshop_tpu_torch.models.encodings import GridEncoding

    enc, x = _encoding(dev, g)
    table = enc.table.detach()
    result = {m: encode_case("training shape", enc, table, x, m) for m in (True, False)}
    tile = kernels.load().nst_grid_encode_tile(enc.n_levels)
    for label, n in (("training inputs", 1), (f"training inputs, one tile ({tile}) plus one", tile + 1)):
        for m in (True, False):
            encode_case(label, enc, table, x[-n:].contiguous(), m)
    for L, log2_size, level_scale in ((5, 14, 2.0), (20, 17, 1.5)):
        enc_l = GridEncoding(n_levels=L, log2_hashmap_size=log2_size, per_level_scale=level_scale, device=dev, generator=g)
        with torch.no_grad():
            enc_l.table.uniform_(-1.0, 1.0, generator=g)
        tile = kernels.load().nst_grid_encode_tile(L)
        n_dense = sum(enc_l.level_dense)
        for label, n in ((f"{n_dense} dense + {L - n_dense} hash levels", 1 << 16), (f"one tile ({tile}) plus one", tile + 1)):
            for m in (True, False):
                encode_case(label, enc_l, enc_l.table.detach(), x[:n].contiguous(), m)
    return result[True]


def repeat_shares(enc, x) -> tuple[float, float]:
    """(share of distinct positions in x, share of (sample, level) pairs whose
    cell equals the previous sample's): how much of a chunk's work repeats."""
    distinct = torch.unique(x, dim=0).shape[0] / x.shape[0]
    same = 0
    for l in range(enc.n_levels):
        scale = torch.full((), enc.level_scales[l], dtype=x.dtype, device=x.device)
        cell = torch.floor(x * scale + 0.5).to(torch.int64).clamp(0, enc.level_res[l] - 1)
        same += int((cell[1:] == cell[:-1]).all(dim=1).sum())
    return distinct, same / (enc.n_levels * x.shape[0])


def phase_encode_frame(tb, x):
    """Kernel B at the frame shape: the positions of one chunk of the
    trained model's 1080p march, in both modes, with the shares of that
    chunk's positions and cells that repeat."""
    enc = tb.model.pos_encoding
    distinct, same = repeat_shares(enc, x)
    note = (f"; distinct positions {distinct:.4f} of N, (sample, level) pairs in the previous "
            f"sample's cell {same:.4f}")
    for m in (False, True):
        encode_case("1080p march chunk", enc, enc.table.detach(), x, m, note)


def phase_backward(dev, g):
    """GridEncodeFunction backward vs autograd of the plain forward (index_add):
    max |diff| ≤ 1e-5 · max |d_table|."""
    from nerfshop_tpu_torch.ops import table_ops

    enc, x = _encoding(dev, g)
    ct = torch.randn((x.shape[0], enc.n_output_dims), generator=g, device=dev)
    idx, w1 = enc.brick_fracs(x)

    def ours():
        t = enc.table.detach().requires_grad_(True)
        return t, table_ops.GridEncodeFunction.apply(t, x, enc)

    def plain():
        t = enc.table.detach().requires_grad_(True)
        return t, table_ops.encode_from_fracs(t, idx, w1, enc)

    grads = []
    for make in (ours, plain):
        t, out = make()
        out.backward(ct)
        grads.append(t.grad)
    torch.cuda.synchronize()
    ref_max = float(grads[1].abs().max())
    err = float((grads[0] - grads[1]).abs().max())
    check(err <= 1e-5 * ref_max, f"encode backward disagrees: {err:.3e} vs max {ref_max:.3e}")

    def backward_ms(make, queued=False):
        times = []
        for i in range(TIMING_RUNS + 3):
            t, out = make()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if queued:  # the backward enqueues ~300 launches: a spin 10x the kernels' one
                torch.cuda._sleep(10 * SLEEP_CYCLES)
            a.record()
            out.backward(ct)
            b.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(a.elapsed_time(b))
        return statistics.median(times)

    ms, plain_ms = backward_ms(ours), backward_ms(plain)
    dev_ms, plain_dev_ms = backward_ms(ours, queued=True), backward_ms(plain, queued=True)
    print(
        f"[backward] d_table max err {err:.3e} (bound 1e-5*{ref_max:.3e}) events: sorted+kernel A {ms:.4f} ms "
        f"plain index_add autograd {plain_ms:.4f} ms; device (queued): {dev_ms:.4f} ms and {plain_dev_ms:.4f} ms",
        flush=True,
    )
    return err, ms, plain_ms


def phase_mlp(dev, g):
    """Kernel C against its plain version at N = 2^20 rows. Bound: 99.5% of
    outputs within 1e-6 + 1e-5·|plain|, and all within 1e-2·max|plain|.
    Both round the same operands to bf16 and every product is exact in
    fp32, but the fp32 sums run in another order; where a hidden value lies
    within an ulp of a bf16 rounding tie, the two round it to neighbouring
    bf16 values (2^-8 relative), which moves every output of that row. Each
    row has 64 (density) or 128 (rgb) such re-roundings."""
    from nerfshop_tpu_torch.ops import fused_mlp

    N = 1 << 20
    result = {}
    for label, dims in (("density", (32, 64, 16)), ("rgb", (32, 64, 64, 3)), ("takikawa sdf", (80, 64, 64, 1))):
        x = torch.randn((N, dims[0]), generator=g, device=dev)
        ws = [
            (torch.rand((a, b), generator=g, device=dev) * 2 - 1) * (6.0 / a) ** 0.5
            for a, b in zip(dims[:-1], dims[1:])
        ]
        ker = fused_mlp.fused_mlp_cuda(x, ws)
        plain = fused_mlp.fused_mlp_plain(x, ws)
        torch.cuda.synchronize()
        err = (ker - plain).abs()
        within = float((err <= 1e-6 + 1e-5 * plain.abs()).float().mean())
        ref_max = float(plain.abs().max())
        check(ker.shape == plain.shape and bool(torch.isfinite(ker).all()), f"kernel C output bad ({label})")
        check(within >= 0.995 and float(err.max()) <= 1e-2 * ref_max,
              f"kernel C disagrees ({label}): {within:.5f} within 1e-5 rel, max err {float(err.max()):.3e} of {ref_max:.3e}")
        ms, dev_ms = both_ms(lambda: fused_mlp.fused_mlp_cuda(x, ws))
        plain_ms = median_ms(lambda: fused_mlp.fused_mlp_plain(x, ws))
        # library call: the bf16 torch.matmul + relu chain, rounded to bf16
        # at the same points (its last product is rounded too)
        wb = [w.to(torch.bfloat16) for w in ws]

        def chain():
            h = x.to(torch.bfloat16)
            for i, w in enumerate(wb):
                h = torch.matmul(h, w)
                if i < len(wb) - 1:
                    h = torch.relu(h)
            return h

        lib_ms, lib_dev_ms = both_ms(chain)
        flops = 2.0 * N * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        b_ms, b_by = bound(nbytes(x, ker, *ws), flops, BF16_FLOPS)
        print(
            f"[mlp] {label} {'->'.join(map(str, dims))} N={N}: {within:.6f} of outputs within 1e-6+1e-5*|plain| "
            f"(bound 0.995), max_abs_err {float(err.max()):.3e} of max|out| {ref_max:.3e} (bound 1e-2*max) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bf16 matmul chain {lib_ms:.4f} ms; device (queued): kernel "
            f"{dev_ms:.4f} ms chain {lib_dev_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})",
            flush=True,
        )
        result[label] = dict(max_abs_err=float(err.max()), ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                             library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    # input widths that are not whole 16-column k-tiles: one k-tile with
    # partial columns, and two (the 35-wide rgb input is held in [captured]);
    # past 64: Frequency's 72, a partial fifth k-tile, Takikawa's 80, the widest
    for n_in in (7, 23, 72, 75, 80, 128):
        dims = (n_in, 64, 64, 3)
        x = torch.randn((1 << 16, n_in), generator=g, device=dev)
        ws = [(torch.rand((a, b), generator=g, device=dev) * 2 - 1) * (6.0 / a) ** 0.5 for a, b in zip(dims[:-1], dims[1:])]
        ker = fused_mlp.fused_mlp_cuda(x, ws)
        plain = fused_mlp.fused_mlp_plain(x, ws)
        err = (ker - plain).abs()
        within = float((err <= 1e-6 + 1e-5 * plain.abs()).float().mean())
        check(ker.shape == plain.shape and bool(torch.isfinite(ker).all()) and within >= 0.995
              and float(err.max()) <= 1e-2 * float(plain.abs().max()),
              f"kernel C disagrees at input width {n_in}: {within:.5f} within 1e-5 rel, max err {float(err.max()):.3e}")
        print(f"[mlp] input width {n_in} ({'->'.join(map(str, dims))}, 2^16 rows, zero-padded to whole k-tiles in the "
              f"kernel): {within:.6f} of outputs within 1e-6+1e-5*|plain| (bound 0.995), max_abs_err "
              f"{float(err.max()):.3e}", flush=True)
    return {**result["density"], "max_abs_err": max(r["max_abs_err"] for r in result.values())}


def kernel_wrappers():
    """Kernel name → the wrapper that counts its launches."""
    from nerfshop_tpu_torch.editing import operators
    from nerfshop_tpu_torch.geometry import bvh
    from nerfshop_tpu_torch.ops import fused_mlp, gather, segsum, table_ops, xor_encode
    from nerfshop_tpu_torch.render import baked

    return {
        "segsum": segsum.sorted_segment_rowsum_cuda,
        "grid_encode": table_ops.grid_encode_cuda,
        "grid_encode_dx": table_ops.grid_encode_dx_cuda,
        "grid_encode_dx_bwd": table_ops.grid_encode_dx_bwd_cuda,
        "fused_mlp": fused_mlp.fused_mlp_cuda,
        "gather": gather.gather_cuda,
        "tet_lookup": operators.tet_lookup_cuda,
        "cage_warp_samples": operators.cage_warp_samples_cuda,
        "cage_warp_positions": operators.cage_warp_positions_cuda,
        "cage_warp_membrane": operators.cage_warp_membrane_cuda,
        "bvh_signed_distance": bvh.bvh_signed_distance_cuda,
        "shear_warp_composite": baked.shear_warp_composite_cuda,
        "shear_warp_screen": baked.shear_warp_screen_cuda,
        "xor_encode": xor_encode.xor_encode_cuda,
        "xor_encode_bwd": xor_encode.xor_encode_bwd_cuda,
    }


# ------------------------------------------------------------------ kernel D

#: (label, form, x shape, idx shape, index range, dtype): the TPU gather
#: kernels' shapes (rows 3-13 of the PERF.md kernel table)
GATHER_PROBES = (
    ("3 probe_arch ax1 blocked", "axis1", (1 << 16, 128), (1 << 16, 128), 128, torch.float32),
    ("4 probe_pallas take 1-D", "rows", (4096,), (1024,), 4096, torch.float32),
    ("5 probe_pallas row take", "rows", (4096, 128), (1024,), 4096, torch.float32),
    ("6 probe_pallas ax1 lane", "axis1", (256, 512), (256, 128), 512, torch.float32),
    ("7 probe_gather2 ax0 S=1024", "axis0", (1024, 128), (1024, 128), 1024, torch.float32),
    ("7 probe_gather2 ax0 S=8192", "axis0", (8192, 128), (8192, 128), 8192, torch.float32),
    ("8 probe_gather2 ax1 M=128", "axis1", (256, 128), (256, 128), 128, torch.float32),
    ("8 probe_gather2 ax1 M=512", "axis1", (256, 512), (256, 512), 512, torch.float32),
    ("9 probe_gather2 ax0 1M lookups", "axis0", (8192, 128), (8192, 128), 8192, torch.float32),
    ("10 probe_chain ax1 i&127", "axis1", (1 << 16, 128), (1 << 16, 128), 128, torch.float32),
    ("11 probe_honest2 ax1", "axis1", (1 << 16, 128), (1 << 16, 128), 128, torch.float32),
    ("12 dyngather ax0 S=512 i32", "axis0", (512, 128), (512, 128), 512, torch.int32),
    ("12 dyngather ax0 S=128 Q=256", "axis0", (128, 128), (256, 128), 128, torch.float32),
    ("12 dyngather ax1 Q=4096 i32", "axis1", (4096, 128), (4096, 128), 128, torch.int32),
    ("13 ax0 sweep S=16384", "axis0", (1 << 14, 128), (1 << 14, 128), 1 << 14, torch.float32),
)


def gather_case(label, form, x, idx):
    """Kernel D against its plain version and the library call, bit for bit
    → a dict of its numbers."""
    from nerfshop_tpu_torch.ops import gather

    ker = gather.gather_cuda(x, idx, form)
    plain = gather.gather_plain(x, idx, form)
    idx64 = idx.long()
    if form == "rows":
        lib_fn = lambda: torch.index_select(x, 0, idx64)  # noqa: E731
    else:
        lib_fn = lambda: torch.gather(x, 1 if form == "axis1" else 0, idx64)  # noqa: E731
    lib = lib_fn()
    torch.cuda.synchronize()

    def bits(t):
        return t.view(torch.int32)

    mism = int((bits(ker) != bits(plain)).sum())
    check(ker.shape == plain.shape and mism == 0, f"kernel D differs from its plain version ({label}): {mism}")
    check(torch.equal(bits(ker), bits(lib.reshape(ker.shape))), f"kernel D differs from the library call ({label})")
    ms, dev_ms = both_ms(lambda: gather.gather_cuda(x, idx, form))
    plain_ms = median_ms(lambda: gather.gather_plain(x, idx, form))
    lib_ms, lib_dev_ms = both_ms(lib_fn)
    # the library call is timed with its int64 indices made beforehand, as
    # the march hands them; the wrapper's host time against the same call
    us = host_us(lambda: gather.gather_cuda(x, idx, form))
    lib_us = host_us(lib_fn)
    # bytes: the indices, the distinct source elements they touch, the output
    S = x.shape[0]
    C = x.numel() // S
    if form == "rows":
        src = int(torch.unique(idx).numel()) * C
        Q, Cq = idx.shape[0], C
    elif form == "axis1":
        src = int(torch.unique(torch.arange(idx.shape[0], device=idx.device)[:, None] * C + idx).numel())
        Q, Cq = idx.shape
    else:
        src = int(torch.unique(idx.long() * C + torch.arange(C, device=idx.device)[None, :]).numel())
        Q, Cq = idx.shape
    b_ms, b_by = bound(nbytes(idx, ker) + src * 4)
    p = gather.plan(form, S, C, Q, Cq, x.data_ptr() % 16 == 0, idx.data_ptr() % 16 == 0, idx.dtype == torch.int64)
    variant = ("staged" if p.staged else "direct") if form == "axis1" else form
    print(
        f"[gather] {label}: {form} x{tuple(x.shape)} {str(x.dtype)[6:]} idx{tuple(idx.shape)} {str(idx.dtype)[6:]} "
        f"({variant}, x by {4 * p.xvec} B, idx by {p.ivec}, block {p.tx}x{p.ty}, {p.blocks} blocks, smem {p.smem} B): "
        f"bit-equal to plain and library; events: kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {lib_ms:.4f} "
        f"ms, kernel/library {ms / lib_ms:.3f}; device (queued): kernel {dev_ms:.4f} ms library {lib_dev_ms:.4f} ms, "
        f"kernel/library {dev_ms / lib_dev_ms:.3f}; bound {b_ms:.4f} ms ({b_by}), device/bound {dev_ms / b_ms:.2f}; "
        f"host per call: wrapper {us:.1f} us, library {lib_us:.1f} us",
        flush=True,
    )
    return dict(max_abs_err=float(mism), ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)


def offset_view(t):
    """A contiguous copy of ``t`` at a 4-byte storage offset (not 16-byte aligned)."""
    flat = t.reshape(-1)
    v = torch.cat([flat[:1], flat])[1:].view(t.shape)
    check(v.is_contiguous() and v.data_ptr() % 16 == 4, "offset view is 16-byte aligned")
    return v


def phase_gather(dev, g):
    """Kernel D at the TPU gather kernels' shapes, at the edges of its plan
    (4-byte-aligned views, narrow rows by int32 and int64 indices, a row
    wider than the shared-memory budget, a sparse pick), then at the render
    march's (the fine-sort payload [8192, 512] f32 by its int64
    permutation), which is the entry of the kernels line."""
    for label, form, xs, ids, hi, dtype in GATHER_PROBES:
        if dtype == torch.float32:
            x = torch.randn(xs, generator=g, device=dev)
        else:
            x = torch.randint(-(2**31), 2**31 - 1, xs, generator=g, device=dev, dtype=torch.int32)
        idx = torch.randint(0, hi, ids, generator=g, device=dev, dtype=torch.int32)
        gather_case(label, form, x, idx)
    x = torch.randn((1 << 16, 128), generator=g, device=dev)
    idx = torch.randint(0, 128, (1 << 16, 128), generator=g, device=dev, dtype=torch.int32)
    gather_case("ax1 [2^16,128], both at a 4-byte offset", "axis1", offset_view(x), offset_view(idx))
    x = torch.randn((4096, 128), generator=g, device=dev)
    idx = torch.randint(0, 4096, (1024,), generator=g, device=dev, dtype=torch.int32)
    gather_case("row take [4096,128], x at a 4-byte offset", "rows", offset_view(x), idx)
    for C in (12, 9, 1):
        x = torch.randn((5239, C), generator=g, device=dev)
        for idt in (torch.int32, torch.int64):
            idx = torch.randint(0, 5239, (1 << 20,), generator=g, device=dev, dtype=idt)
            gather_case(f"rows C={C}", "rows", x, idx)
    x = torch.randn((256, 16384), generator=g, device=dev)
    idx = torch.randint(0, 16384, (256, 16384), generator=g, device=dev, dtype=torch.int32)
    gather_case("ax1 row of 64 KB (wider than the stage)", "axis1", x, idx)
    x = torch.randn((8192, 128), generator=g, device=dev)
    idx = torch.randint(0, 128, (8192, 1), generator=g, device=dev, dtype=torch.int64)
    gather_case("ax1 one pick per row (composite depth)", "axis1", x, idx)
    keys = torch.rand((8192, 512), generator=g, device=dev)
    keys[:, 300:] += 2.0  # occupied candidates first, as the march's keys order them
    perm = torch.sort(keys, dim=1).indices
    t_f = torch.rand((8192, 512), generator=g, device=dev)
    return gather_case("march fine-sort payload", "axis1", t_f, perm)


def reset_launches():
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["grid_encode"].fracs_launches = wrappers["grid_encode"].d2_launches = 0
    wrappers["segsum"].d2_launches = 0


def read_launches():
    """Launches by kernel, kernel B's launches with fracs as
    ``grid_encode_fracs``, and kernels B's and A's D = 2 instances' as
    ``grid_encode_d2`` and ``segsum_d2`` (within their totals)."""
    wrappers = kernel_wrappers()
    return {**{k: fn.launches for k, fn in wrappers.items()}, "grid_encode_fracs": wrappers["grid_encode"].fracs_launches,
            "grid_encode_d2": wrappers["grid_encode"].d2_launches, "segsum_d2": wrappers["segsum"].d2_launches}


def middle_chunk(W=1920, H=1080) -> int:
    """Index of the middle pixel chunk of a W×H exact frame (its rays cross
    the scene's centre)."""
    from nerfshop_tpu_torch.render.renderer import RenderOptions

    return -(-W * H // RenderOptions().chunk) // 2


@contextlib.contextmanager
def encode_input_of_call(enc, index: int):
    """While open, keep a copy of the positions of ``enc``'s ``index``-th
    forward (counting from 0) in the yielded list."""
    kept, calls = [], [0]

    def hook(module, args):
        if calls[0] == index:
            kept.append(args[0].detach().clone())
        calls[0] += 1

    handle = enc.register_forward_pre_hook(hook)
    try:
        yield kept
    finally:
        handle.remove()


@contextlib.contextmanager
def cage_input_of_call(op, index: int):
    """While open, keep (positions, directions) of the ``index``-th sample
    warp through the cage operator ``op`` (counting from 0) in the yielded
    list; the warp still runs and kernel E still counts its launch."""
    from nerfshop_tpu_torch.editing import operators as ops_lib

    warp, kept, calls = ops_lib.cage_map_samples, [], [0]

    def spy(op_, pos, direction):
        if op_ is op:
            if calls[0] == index:
                kept.append((pos.contiguous().clone(), direction.contiguous().clone()))
            calls[0] += 1
        return warp(op_, pos, direction)

    ops_lib.cage_map_samples = spy
    try:
        yield kept
    finally:
        ops_lib.cage_map_samples = warp


def check_launched(launches: dict, names, where: str) -> None:
    check(all(launches[k] > 0 for k in names), f"a kernel of the {where} was not launched: {launches}")


def psnr(img, gt):
    return -10 * math.log10(float(np.mean((img - gt) ** 2)) + 1e-12)


def phase_main_path(dev):
    from nerfshop_tpu_torch.common import TestbedMode
    from nerfshop_tpu_torch.config import default_nerf_config
    from nerfshop_tpu_torch.ops import grid as grid_lib
    from nerfshop_tpu_torch.testbed import Testbed
    from nerfshop_tpu_torch.train import nerf as nerf_train

    ds, focal, principal = sphere_dataset(dev)
    tb = Testbed(TestbedMode.Nerf, config=default_nerf_config(), device=dev, seed=0)
    tb.set_training_data(ds)
    enc = tb.model.pos_encoding
    check(max(enc.level_sizes) == 1 << 19 and enc.n_levels == 16, "not the default full-width config")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tb.train(n_steps=STEPS, batch_size=BATCH)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    losses = [lv for _, lv in tb.loss_history]
    check(len(losses) == STEPS and all(math.isfinite(v) for v in losses), "non-finite or missing losses")
    tail = float(np.mean(losses[-10:]))
    check(tail < 0.35 * losses[0], f"loss did not fall enough: first {losses[0]:.4e} last-10 mean {tail:.4e}")
    check(tb.stats.measured_samples_total > 0, "no samples measured")
    check_launched(launches, ("segsum", "grid_encode", "fused_mlp", "gather"), "training path")
    # every step a replayed step of a captured graph: no eager training step ran
    check(tb.stats.captured_steps == STEPS == tb.stats.step and tb.stats.graph_replays == STEPS // 16,
          f"training did not run through the captured loop only: {tb.stats.captured_steps} captured steps of "
          f"{tb.stats.step}, {tb.stats.graph_replays} replays")
    per_step = {k: v / 16 for k, v in tb.stats.graph_launches.items()}
    check(all(per_step.get(f"{fn}.launches", 0) > 0
              for fn in ("sorted_segment_rowsum_cuda", "grid_encode_cuda", "gather_cuda")),
          f"a kernel of the captured step was not in its graph: {per_step}")

    # one full grid refresh, timed on a copy of the grid
    g = tb.grid
    copy = grid_lib.OccupancyGrid(g.density.clone(), g.occupancy.clone(), g.mean_density.clone())
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    nerf_train.update_grid(tb.model, copy, tb.train_config, tb.generator, full_refresh=True, trained_mask=tb.trained_mask)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    refresh = read_launches()
    check(refresh["grid_encode"] > 0 and refresh["grid_encode_fracs"] == 0,
          f"the grid refresh did not encode without fracs only: {refresh}")
    check(launches["grid_encode_fracs"] > 0, f"the training path never encoded with fracs: {launches}")

    print(
        f"[train] captured loop: {tb.stats.graph_replays} replays of 16 steps, {tb.stats.captured_steps} captured "
        f"steps of {tb.stats.step}, hand-kernel launches per step inside the graph {per_step}",
        flush=True,
    )
    print(
        f"[train] {STEPS} steps batch {BATCH} in {train_s:.3f} s (the graph's capture included): "
        f"{STEPS / train_s:.3f} steps/s, "
        f"{tb.stats.measured_samples_total / train_s:.6g} real samples/s "
        f"({tb.stats.measured_samples_total} samples), loss {losses[0]:.4e} -> last-10 {tail:.4e} "
        f"(ratio {tail / losses[0]:.3f}), final (rays, K) = ({tb.train_config.n_rays_per_batch}, {tb.train_config.k_samples}), "
        f"occupancy {float(g.occupancy.float().mean()):.4f}",
        flush=True,
    )
    print(
        f"[train] grid full refresh {refresh_s:.4f} s (kernel B {refresh['grid_encode']} launches, "
        f"{refresh['grid_encode_fracs']} with fracs), peak memory {peak / 2**30:.3f} GiB, launches {launches}",
        flush=True,
    )
    return tb, focal, principal, launches, STEPS / train_s


#: the largest relative loss difference on any step, and the largest
#: relative (L2) difference of any parameter, EMA or Adam tensor, between
#: the captured loop and the eager one from one state and one generator
#: state; the two run the same kernels in the same order, so bit-equal is
#: expected
LOOP_LOSS_TOL = 1e-4
LOOP_PARAM_TOL = 1e-3


def phase_train_loop(tb, chunk=16, calls=2, tag="[train-loop]"):
    """[train-loop]: copies of the trained model's state and generator (and
    of its error map, where it has one); the eager loop
    (``make_train_loop(..., captured=False)``) and the captured one each run
    ``calls`` × ``chunk`` steps from them on the same grid → the captured
    loop's launches by kernel in its timed call. The second call of each is
    timed (the first of the captured loop captures). The error maps after
    the steps are held to each other with the state."""
    import copy

    from nerfshop_tpu_torch.train import nerf as nerf_train

    runs = {}
    for captured in (False, True):
        state = copy.deepcopy(tb._state)
        g = torch.Generator(device=tb.device)
        g.set_state(tb.generator.get_state())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        em = None if tb._error_map is None else tb._error_map.clone()
        loop = nerf_train.make_train_loop(state, tb.grid, tb._device_data, tb.train_config, chunk, captured=captured,
                                          error_map=em)
        losses, times = [], []
        for _ in range(calls):
            reset_launches()
            t0 = time.perf_counter()
            ys = loop(tb.grid, g)
            losses.append(ys["loss"].cpu().numpy())  # the host pull syncs
            times.append(time.perf_counter() - t0)
        written = state.tensors() + ([em] if em is not None else [])
        runs[captured] = (np.concatenate(losses), written, times[-1], read_launches(), torch.cuda.max_memory_allocated(),
                          loop)
    (le, se, te, _, pe, _), (lc, sc, tc, launches, pc, loop) = runs[False], runs[True]
    loss_diff = float(np.max(np.abs(lc - le) / np.maximum(np.abs(le), 1e-30)))
    param_diff = max(float(torch.linalg.vector_norm(a - b) / torch.clamp_min(torch.linalg.vector_norm(b), 1e-30))
                     for a, b in zip(sc, se))
    equal = all(torch.equal(a, b) for a, b in zip(sc, se)) and bool((lc == le).all())
    check(loop.replays == calls and loop.graph_launches, f"the captured loop was not replayed: {loop.replays} replays")
    check(np.isfinite(lc).all() and np.isfinite(le).all(), "non-finite loss in the loop comparison")
    check(loss_diff <= LOOP_LOSS_TOL, f"captured vs eager: a step's loss differs by {loss_diff:.3e} > {LOOP_LOSS_TOL}")
    check(param_diff <= LOOP_PARAM_TOL, f"captured vs eager: the state differs by {param_diff:.3e} > {LOOP_PARAM_TOL}")
    print(
        f"{tag} {calls * chunk} steps eager vs captured from one state and generator (batch "
        f"{tb.train_config.n_rays_per_batch} x {tb.train_config.k_samples}): largest relative loss difference "
        f"{loss_diff:.3e} (bound {LOOP_LOSS_TOL}), largest relative state difference {param_diff:.3e} (bound "
        f"{LOOP_PARAM_TOL}), bit-equal {equal}; a {chunk}-step call after the first, draws included, no grid "
        f"refresh: eager {te * 1e3:.2f} ms ({chunk / te:.2f} steps/s), captured {tc * 1e3:.2f} ms ({chunk / tc:.2f} "
        f"steps/s); peak memory eager {pe / 2**30:.3f} GiB, captured {pc / 2**30:.3f} GiB; launches in one replayed "
        f"call {launches}",
        flush=True,
    )
    return launches


def phase_render_compact(tb, W=1920, H=1080):
    """[render-compact]: the trained model's 1080p frame through
    ``render_frame`` with the testbed's options, at ``compact_frac`` 0 and
    at two values from the valid share of the frame's middle chunk (that
    share rounded up to a hundredth, and twice that) → the launches of one
    frame at the first of them."""
    from nerfshop_tpu_torch.render import renderer

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=tb.device)

    base = tb._render_options()
    args = (tb.model, tb.inference_params, tb.grid, (W, H), t(tb.camera_matrix), t(tb._focal_for(W, H)),
            t(tb.screen_center))
    slots = min(base.chunk, W * H) * base.k_samples * base.n_windows  # render_frame's chunk
    # valid slots of every chunk, from the uncompacted frame
    counts, real = [], renderer._eval_window

    def spy(field, samples, *a, **kw):
        counts.append(samples.valid.sum())
        return real(field, samples, *a, **kw)

    renderer._eval_window = spy
    try:
        ref = renderer.render_frame(*args, opts=base).rgba
    finally:
        renderer._eval_window = real
    n_valid = torch.stack(counts).cpu().numpy().astype(np.int64)
    share = n_valid[middle_chunk(W, H)] / slots
    frac = max(math.ceil(share * 100) / 100, 0.01)
    results, launches = [], None
    for f in (0.0, frac, 2 * frac):
        opts = dataclasses.replace(base, compact_frac=f)
        torch.cuda.synchronize()
        reset_launches()
        out = renderer.render_frame(*args, opts=opts).rgba
        torch.cuda.synchronize()
        if f == frac:
            launches = read_launches()
            check_launched(launches, ("grid_encode", "fused_mlp", "gather"), "compacted frame")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            renderer.render_frame(*args, opts=opts)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        budget = renderer.compact_budget(slots, f)
        dropped = int(np.maximum(n_valid - budget, 0).sum()) if 0 < budget < slots else 0
        check(out.shape == (H, W, 4) and bool(torch.isfinite(out).all()), f"compact_frac {f}: frame not finite")
        delta = float((out - ref).abs().max())
        if dropped == 0:
            check(delta <= 1e-5, f"compact_frac {f}: no row dropped, yet max |delta rgba| {delta:.3e} > 1e-5")
            quality = f"max |delta rgba| {delta:.3e} (bound 1e-5)"
        else:
            quality = f"PSNR {psnr(out.cpu().numpy(), ref.cpu().numpy()):.2f} dB, max |delta rgba| {delta:.3e}"
        results.append(
            f"compact_frac {f:.2f} (slab {budget if 0 < budget < slots else slots} of {slots} slots a chunk): "
            f"median of 3 {statistics.median(times):.1f} ms {[round(x, 1) for x in times]}, "
            f"valid rows dropped {dropped / max(int(n_valid.sum()), 1):.6f}, {quality}"
        )
    print(
        f"[render-compact] {W}x{H}, {len(n_valid)} chunks, valid share of the middle chunk {share:.4f} "
        f"(of the frame {n_valid.sum() / (slots * len(n_valid)):.4f}, largest chunk {n_valid.max() / slots:.4f}): "
        + "; ".join(results) + f"; launches in one frame at {frac:.2f}: {launches}",
        flush=True,
    )
    return launches


def phase_render(tb, W=1920, H=1080):
    """The render path: ``Testbed.render(W, H, exact=True)`` of the trained
    model → (the launch counts of the warm-up frame, the positions its middle
    chunk encoded)."""
    from nerfshop_tpu_torch.common import RenderMode

    tb.set_look_at(eye=CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    torch.cuda.synchronize()
    reset_launches()
    with encode_input_of_call(tb.model.pos_encoding, middle_chunk(W, H)) as kept:
        t0 = time.perf_counter()
        img = tb.render(W, H, spp=1, exact=True)
        first_s = time.perf_counter() - t0
    launches = read_launches()
    check(img.shape == (H, W, 4) and np.isfinite(img).all(), "1080p frame is not finite / of the expected shape")
    check_launched(launches, ("grid_encode", "fused_mlp", "gather"), "1080p frame")
    check(float(img[..., 3].max()) > 0.5, "1080p frame shows no content")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        tb.render(W, H, spp=1, exact=True)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    frame_s = statistics.median(times)
    samples = tb.stats.render_samples
    print(
        f"[render] {W}x{H} exact spp=1: first frame {first_s * 1e3:.1f} ms, median of 3 {frame_s * 1e3:.1f} ms "
        f"({[round(t * 1e3, 1) for t in times]}), {W * H / frame_s:.6g} rays/s, {samples} sample slots evaluated "
        f"({samples / frame_s:.6g} /s), peak memory {peak / 2**30:.3f} GiB, launches in one frame {launches}",
        flush=True,
    )
    for mode in (RenderMode.Depth, RenderMode.Cost):
        tb.render_mode = mode
        small = tb.render(256, 256, exact=True)
        check(small.shape == (256, 256, 4) and np.isfinite(small).all(), f"{mode.value} frame bad")
        print(f"[render] 256x256 {mode.value}: min {float(small[..., 0].min()):.4f} max {float(small[..., 0].max()):.4f}", flush=True)
    tb.render_mode = RenderMode.Shade
    check(len(kept) == 1, "the middle chunk's positions were not captured")
    return launches, kept[0]


def phase_frame(tb, W=1920, H=1080):
    """The viewer path: ``Testbed.frame()`` without training, three frames.
    The first renders at full size; the dynamic resolution then lowers the
    factor towards the 20 fps target, and the frame is upsampled on the card."""
    tb.set_train(False)
    tb.frame_resolution = (W, H)
    tb.dynamic_res = True
    torch.cuda.synchronize()
    reset_launches()
    frames = []
    for _ in range(3):
        check(tb.frame(), "frame() returned False")
        buf = tb.frame_buffer
        check(buf.shape == (H, W, 4) and np.isfinite(buf).all(), "frame buffer is not finite / of the expected shape")
        frames.append((round(tb.stats.frame_ms, 1), round(tb._dyn_res_factor, 4)))
    launches = read_launches()
    check_launched(launches, ("grid_encode", "fused_mlp", "gather"), "viewer path")
    print(f"[frame] {W}x{H} frame() x3 (ms, next dynamic-res factor): {frames}, launches {launches}", flush=True)
    return launches


def phase_held_out(tb, focal, principal):
    """Held-out PSNR through ``Testbed.render`` with the view's own camera."""
    xf = look_at(CENTER + np.array([0.9, 0.9, 0.5], np.float32))
    b = view_rays(xf, focal, principal, tb.device)
    gt = sphere_rgba(b.origins.cpu().numpy(), b.directions.cpu().numpy()).reshape(RES, RES, 4)
    img = tb.render(RES, RES, spp=1, camera_matrix=xf, focal=focal, principal=principal, exact=True)
    check(img.shape == (RES, RES, 4) and np.isfinite(img).all(), "held-out render is not finite / of the expected shape")
    value = psnr(img[..., :3], gt[..., :3] * gt[..., 3:])
    check(value >= 14.0, f"held-out PSNR {value:.2f} dB < 14")
    print(f"[held-out] {RES}x{RES} PSNR {value:.2f} dB through Testbed.render (bound 14)", flush=True)
    return xf


def phase_snapshot(tb, xf, focal, principal, workdir: Path) -> Path:
    """save_snapshot → fresh Testbed → load_snapshot → the same view: max |Δ| ≤ 1e-6
    → the snapshot's path (in ``workdir``, read again by [cli])."""
    from nerfshop_tpu_torch.testbed import Testbed

    kw = dict(camera_matrix=xf, focal=focal, principal=principal, exact=True)
    before = tb.render(RES, RES, **kw)
    path = workdir / "model.snap"
    t0 = time.perf_counter()
    tb.save_snapshot(str(path))
    save_s = time.perf_counter() - t0
    size = path.stat().st_size
    fresh = Testbed(device=tb.device, seed=1)
    t0 = time.perf_counter()
    fresh.load_snapshot(str(path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    after = fresh.render(RES, RES, **kw)
    delta = float(np.abs(after - before).max())
    check(delta <= 1e-6, f"snapshot round trip changed the frame: max |delta| {delta:.3e}")
    print(
        f"[snapshot] {size / 2**20:.1f} MiB, save {save_s:.2f} s, load {load_s:.2f} s, "
        f"{RES}x{RES} frame max |delta| {delta:.3e} (bound 1e-6)",
        flush=True,
    )
    return path


# ------------------------------------------------- kernel F and the outputs


def boundary_points(enc, dev) -> torch.Tensor:
    """Per level, points whose cell is the last one (p0 = res − 1) on one
    axis and on all three (where x ≤ 1 reaches it)."""
    pts = []
    for scale, res in zip(enc.level_scales, enc.level_res):
        u = min((res - 0.75) / scale, 1.0)
        pts += [[u, 0.3, 0.6], [0.2, u, 0.7], [u, u, u]]
    return torch.tensor(pts, dtype=torch.float32, device=dev)


#: the seed of kernel F's dout at the mesh vertices
F_MESH_SEED = 1618
#: kernel F's samples a block (kThreads / kDxLanes of csrc/grid_encode.cu)
F_BLOCK = 128


def encode_dx_case(label, enc, table, x, g):
    """Kernel F against its plain version (autograd of the plain forward) on
    x with a seeded dout → its numbers: max |Δ| within 1e-5 of max |d_x|."""
    from nerfshop_tpu_torch.ops import table_ops

    N, L = x.shape[0], enc.n_levels
    dout = torch.randn((N, 2 * L), generator=g, device=x.device)
    got = table_ops.grid_encode_dx_cuda(table, x, dout, enc)
    ref = table_ops.grid_encode_dx_plain(table, x, dout, enc)
    torch.cuda.synchronize()
    check(got.shape == (N, 3) and bool(torch.isfinite(got).all()), f"kernel F out bad ({label})")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    check(err <= 1e-5 * max(scale, 1e-30), f"kernel F disagrees ({label}): {err:.3e} vs max |d_x| {scale:.3e}")
    fn = lambda: table_ops.grid_encode_dx_cuda(table, x, dout, enc)  # noqa: E731
    ms, dev_ms = both_ms(fn)
    plain_ms = median_ms(lambda: table_ops.grid_encode_dx_plain(table, x, dout, enc))
    # bytes: x, dout and d_x once, and each table row the 8 corners touch
    touched = touched_rows(enc, enc.brick_fracs(x)[0])
    n_bytes = nbytes(x, dout, got) + touched * 2 * 4
    b_ms, b_by = bound(n_bytes)
    print(
        f"[encode-dx] {label} N={N} L={L}: max |delta| {err:.3e} = {err / max(scale, 1e-30):.3e} of max |d_x| "
        f"{scale:.3e} (bound 1e-5); kernel {ms:.4f} ms (device {dev_ms:.4f} ms) plain {plain_ms:.4f} ms bound "
        f"{b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB, {touched} of {enc.table_size} table rows touched), "
        f"device/bound {dev_ms / b_ms:.2f}; no library call computes d_x",
        flush=True,
    )
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                library_device_ms=None, bound_ms=b_ms, bound_by=b_by)


def phase_encode_dx(dev, g, tb, chunk_x):
    """[encode-dx]: kernel F at the training shape (2^18 uniform samples with
    the cube's corners and every level's boundary points), at N = 1, at one
    block of samples plus one, at 5 levels (odd: the dout rows end on a
    single level) and 20 (more levels than a sample's lanes take in one
    round), and at the frame shape (the 1080p middle chunk's positions, as
    [encode] takes them) → the training shape's numbers."""
    from nerfshop_tpu_torch.models.encodings import GridEncoding

    enc, x = _encoding(dev, g)
    x = torch.cat([boundary_points(enc, dev), x[: x.shape[0] - 3 * enc.n_levels]])
    table = enc.table.detach()
    result = encode_dx_case("training shape (boundary points included)", enc, table, x, g)
    for label, n in (("training inputs", 1), (f"training inputs, one block ({F_BLOCK}) plus one", F_BLOCK + 1)):
        encode_dx_case(label, enc, table, x[:n].contiguous(), g)
    for L, log2_size, level_scale in ((5, 14, 2.0), (20, 17, 1.5)):
        enc_l = GridEncoding(n_levels=L, log2_hashmap_size=log2_size, per_level_scale=level_scale, device=dev, generator=g)
        with torch.no_grad():
            enc_l.table.uniform_(-1.0, 1.0, generator=g)
        x_l = torch.cat([boundary_points(enc_l, dev), x[: (1 << 16) - 3 * L]])
        encode_dx_case(f"{sum(enc_l.level_dense)} dense + {L - sum(enc_l.level_dense)} hash levels, boundary points "
                       "included", enc_l, enc_l.table.detach(), x_l, g)
    frame_enc = tb.model.pos_encoding
    encode_dx_case("1080p march chunk", frame_enc, frame_enc.table.detach(), chunk_x, g)
    return result


#: kernel J within this share of max |dh| and of max |d_x2| of its plain
#: version (F's bound: the same float32 terms in another order)
J_TOL = 1e-5
#: the density module on the card against its plain route on the CPU
#: (relative L2 norm): the MLP's operands and cotangents are rounded to bf16
#: on both sides, and cuBLAS sums the products in another order than the CPU,
#: so a value on a rounding boundary can round the other way
DENSITY_TOL = 5e-3
#: positions of [density] held to the plain route on the CPU: every 8th
DENSITY_CPU_STRIDE = 8


def density_positions(tb):
    """[density]'s positions (warped coordinates), from a generator seeded
    with :data:`G_SEED`: 2^18 uniform in the box of the trained grid's
    occupied cells, then 2^16 within one grid cell of the sphere's surface
    → (positions [2^18 + 2^16, 3], box lo, box hi)."""
    dev = tb.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(G_SEED)
    occ = tb.grid.occupancy[0]
    res = occ.shape[-1]
    cells = occ.nonzero()
    lo, hi = cells.min(0).values.float() / res, (cells.max(0).values.float() + 1) / res
    uniform = lo + (hi - lo) * torch.rand((1 << 18, 3), generator=gen, device=dev)
    d = torch.randn((1 << 16, 3), generator=gen, device=dev)
    r = RADIUS + (2.0 * torch.rand((1 << 16, 1), generator=gen, device=dev) - 1.0) / res
    near = torch.as_tensor(CENTER, device=dev) + r * d / d.norm(dim=1, keepdim=True)
    return torch.cat([uniform, near]).contiguous(), lo, hi


def density_inputs(tb):
    """[density]'s inputs: :func:`density_positions`, the density module
    over ``tb``'s EMA weights, and the seeded cotangents of its calls →
    (positions, box lo, box hi, module, d_out, d_dpos)."""
    from nerfshop_tpu_torch.torch_interop import NerfDensityModule

    dev = tb.device
    x, lo, hi = density_positions(tb)
    N = x.shape[0]
    mod = NerfDensityModule(tb.model, tb.inference_params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(G_SEED + 1)
    d_out = torch.randn((N, mod.n_density_output_dims), generator=gen, device=dev)
    d_dpos = torch.randn((N, 3), generator=gen, device=dev)
    return x, lo, hi, mod, d_out, d_dpos


def eikonal_step(mod, x):
    """The positions' gradient of mean((|∇σ| − 1)²), σ the module's raw
    density at ``x`` (its double backward) → (loss, gradient)."""
    p = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(mod(p)[:, 0].sum(), p, create_graph=True)
    eik = ((grad.norm(dim=-1) - 1.0) ** 2).mean()
    (g_eik,) = torch.autograd.grad(eik, p)
    return eik, g_eik


@contextlib.contextmanager
def j_spy():
    """Within it, every call of ``table_ops.grid_encode_dx_bwd`` (kernel J's
    dispatch) records its (table, x, g, v) in the list it yields."""
    from nerfshop_tpu_torch.ops import table_ops

    calls, dispatch = [], table_ops.grid_encode_dx_bwd

    def spy(table, xx, g, v, enc_):
        calls.append((table.detach(), xx.detach().contiguous(), g.detach().float().contiguous(),
                      v.detach().float().contiguous()))
        return dispatch(table, xx, g, v, enc_)

    table_ops.grid_encode_dx_bwd = spy
    try:
        yield calls
    finally:
        table_ops.grid_encode_dx_bwd = dispatch


def level_prefix(enc, L: int):
    """``enc`` cut to its first ``L`` levels over the same table: the same
    level records and rows (a shallow copy with caches of its own)."""
    import copy

    sub = copy.copy(enc)
    sub.n_levels, sub._meta = L, {}
    return sub


def face_points(enc, x) -> torch.Tensor:
    """``x`` with each axis in turn set to 0 and to exactly 1 on a share of
    its rows (a face of the unit box; at 1 every level clamps the axis), the
    box's corners 0 and 1, and :func:`boundary_points` (each level's last
    cell)."""
    x = x.clone()
    n = x.shape[0] // 8
    for d in range(3):
        x[2 * d * n : (2 * d + 1) * n, d] = 0.0
        x[(2 * d + 1) * n : (2 * d + 2) * n, d] = 1.0
    x[6 * n] = 0.0
    x[6 * n + 1] = 1.0
    return torch.cat([boundary_points(enc, x.device), x]).contiguous()


def j_case(label, enc, table, x, g, v):
    """Kernel J against its plain version on (x, g, v): dh and d_x2 within
    :data:`J_TOL` of their max, finite, and two runs bit-equal → (max |Δdh|,
    max |Δd_x2|, dh, d_x2)."""
    from nerfshop_tpu_torch.ops import table_ops

    N, L = x.shape[0], enc.n_levels
    got_h, got_x = table_ops.grid_encode_dx_bwd_cuda(table, x, g, v, enc)
    again_h, again_x = table_ops.grid_encode_dx_bwd_cuda(table, x, g, v, enc)
    ref_h, ref_x = table_ops.grid_encode_dx_bwd_plain(table, x, g, v, enc)
    torch.cuda.synchronize()
    check(got_h.shape == (N, 2 * L) and got_x.shape == (N, 3) and bool(torch.isfinite(got_h).all())
          and bool(torch.isfinite(got_x).all()), f"kernel J ({label}): an output of the wrong shape or not finite")
    check(torch.equal(got_h, again_h) and torch.equal(got_x, again_x), f"kernel J ({label}): two runs differ")
    err_h, err_x = float((got_h - ref_h).abs().max()), float((got_x - ref_x).abs().max())
    scale_h, scale_x = max(float(ref_h.abs().max()), 1e-30), max(float(ref_x.abs().max()), 1e-30)
    check(err_h <= J_TOL * scale_h and err_x <= J_TOL * scale_x,
          f"kernel J disagrees ({label}): dh {err_h:.3e} of {scale_h:.3e}, d_x2 {err_x:.3e} of {scale_x:.3e} "
          f"(bound {J_TOL})")
    print(f"[density] kernel J, {label}, N={N} L={L}: max |delta| dh {err_h:.3e} = {err_h / scale_h:.3e} of max "
          f"|dh|, d_x2 {err_x:.3e} = {err_x / scale_x:.3e} of max |d_x2| (bound {J_TOL}); two runs bit-equal",
          flush=True)
    return err_h, err_x, got_h, got_x


def rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm((a - b).double()) / torch.clamp_min(torch.linalg.vector_norm(b.double()), 1e-30))


def phase_density(tb):
    """[density]: the torch density module (``torch_interop.py``) over the
    trained model's EMA weights at :func:`density_positions`:
    ``fwd_density``, ``bwd_density`` and ``bwd_bwd_input_density``, then an
    eikonal-style step (the positions' gradient of mean((|∇σ| − 1)²), σ the
    raw density); kernel J once per second-order backward; every output
    finite and, on every 8th position, held to the plain route (the model
    copied to the CPU); kernel J alone against its plain version
    (:func:`j_case`) on the inputs the module's double backward gave it and
    at its edges, timed beside its bound → (J's kernels-line numbers, the
    path's launches)."""
    import copy

    from nerfshop_tpu_torch.ops import table_ops
    from nerfshop_tpu_torch.torch_interop import NerfDensityModule

    x, lo, hi, mod, d_out, d_dpos = density_inputs(tb)
    N = x.shape[0]
    enc = tb.model.pos_encoding
    torch.cuda.synchronize()
    reset_launches()
    with j_spy() as j_inputs:
        t0 = time.perf_counter()
        feats = mod.fns.fwd_density(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g1 = mod.fns.bwd_density(x, d_out)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        d_pos2, d_dout = mod.fns.bwd_bwd_input_density(x, d_out, d_dpos)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        api = read_launches()
        eik, g_eik = eikonal_step(mod, x)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    launches = read_launches()
    outs = {"fwd": feats, "bwd": g1, "d_pos2": d_pos2, "d_dout": d_dout, "eikonal grad": g_eik}
    check(all(bool(torch.isfinite(t).all()) for t in outs.values()) and math.isfinite(float(eik.detach())),
          "[density]: a non-finite output")
    check(feats.shape == d_dout.shape == (N, mod.n_density_output_dims) and g1.shape == d_pos2.shape == (N, 3),
          "[density]: an output of the wrong shape")
    check(api["grid_encode_dx_bwd"] == 1 and launches["grid_encode_dx_bwd"] == 2 and len(j_inputs) == 2,
          f"kernel J was not launched once per second-order backward: {launches}")
    check(float(g_eik.abs().max()) > 0 and float(d_pos2.abs().max()) > 0, "[density]: a second-order gradient is 0")

    # the plain route: the model and weights copied to the CPU, every 8th position
    sub = slice(None, None, DENSITY_CPU_STRIDE)
    cpu_mod = NerfDensityModule(copy.deepcopy(tb.model).cpu(), {k: v.cpu() for k, v in tb.inference_params.items()})
    xc, doc, ddc = (t[sub].cpu() for t in (x, d_out, d_dpos))
    ref = {"fwd": cpu_mod.fns.fwd_density(xc), "bwd": cpu_mod.fns.bwd_density(xc, doc)}
    ref["d_pos2"], ref["d_dout"] = cpu_mod.fns.bwd_bwd_input_density(xc, doc, ddc)
    errs = {k: rel_l2(outs[k][sub].cpu(), ref[k]) for k in ref}
    check(all(e <= DENSITY_TOL for e in errs.values()),
          f"[density] the module disagrees with its plain route: {errs} (bound {DENSITY_TOL})")

    # kernel J alone on the inputs of the module's double backward, then at
    # its edges
    table, xx, g, v = j_inputs[0]
    err_h, err_x, got_h, got_x = j_case("module inputs", enc, table, xx, g, v)
    for label, n in (("the first position", 1), ("the first 129 (not a multiple of a block's samples)", 129),
                     ("the first 12345", 12345)):
        j_case(label, enc, table, xx[:n].contiguous(), g[:n].contiguous(), v[:n].contiguous())
    j_case("L = 15 (the table's first 15 levels)", level_prefix(enc, 15), table, xx, g[:, :30].contiguous(), v)
    xf = face_points(enc, xx[: 1 << 14])
    j_case("positions on the box's faces, at 0 and exactly 1, and on every level's last cell", enc, table, xf,
           g[: xf.shape[0]].contiguous(), v[: xf.shape[0]].contiguous())
    attrs = table_ops.grid_encode_dx_bwd_attrs(enc.n_levels)
    ms, dev_ms = both_ms(lambda: table_ops.grid_encode_dx_bwd_cuda(table, xx, g, v, enc))
    plain_ms = median_ms(lambda: table_ops.grid_encode_dx_bwd_plain(table, xx, g, v, enc))
    touched = touched_rows(enc, enc.brick_fracs(xx)[0])
    n_bytes = nbytes(xx, g, v, got_h, got_x) + touched * 2 * 4
    b_ms, b_by = bound(n_bytes)
    print(
        f"[density] NerfDensityModule over the trained model's EMA weights at {N} positions ({1 << 18} uniform in "
        f"the occupied box {[round(float(a), 4) for a in lo]}-{[round(float(a), 4) for a in hi]}, {1 << 16} within "
        f"one cell of the surface): fwd_density {(t1 - t0) * 1e3:.2f} ms, bwd_density {(t2 - t1) * 1e3:.2f} ms, "
        f"bwd_bwd_input_density {(t3 - t2) * 1e3:.2f} ms, eikonal step {(t4 - t3) * 1e3:.2f} ms (loss {float(eik.detach()):.4e}, "
        f"max |grad| {float(g_eik.abs().max()):.3e}); launches {launches}",
        flush=True,
    )
    print(
        f"[density] against the plain route on the CPU at every {DENSITY_CPU_STRIDE}th position (relative L2, bound "
        f"{DENSITY_TOL}): {', '.join(f'{k} {e:.3e}' for k, e in errs.items())}",
        flush=True,
    )
    print(
        f"[density] kernel J N={xx.shape[0]} L={enc.n_levels}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms) plain "
        f"{plain_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB, {touched} of {enc.table_size} table "
        f"rows touched), device/bound {dev_ms / b_ms:.2f}; {attrs['registers']} registers, "
        f"{attrs['local_bytes']} B local, {attrs['static_smem']} B static and {attrs['dynamic_smem']} B dynamic "
        f"shared memory a block, {attrs['blocks_per_sm']} blocks of 256 threads an SM; launches on the path "
        f"{launches['grid_encode_dx_bwd']} (one per second-order backward); no library call computes it",
        flush=True,
    )
    row = dict(max_abs_err=max(err_h, err_x), ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
               library_device_ms=None, bound_ms=b_ms, bound_by=b_by)
    return row, launches


#: the seed of [train-extras]' pose perturbation
POSE_SEED = 31
#: the perturbation: each view's rotation by this angle (rad) about a random
#: axis, and its camera centre moved this far in a random direction
POSE_NOISE = 0.02
#: views whose rgb is darkened (the first ones), and the factor
DARK_VIEWS, DARK = 4, 0.8
#: views whose targets stay transparent (the last ones), composited over
#: the trainable envmap, where the envmap and the field compete for the
#: sphere; the others are opaque photos over black
CLEAR_VIEWS = 4


def pose_errors(xf, true) -> tuple[float, float]:
    """(mean rotation angle in rad, mean camera-centre distance) of poses
    ``xf`` [N, 3, 4] against ``true``."""
    rel = xf[:, :, :3].transpose(1, 2) @ true[:, :, :3]
    cos = (rel.diagonal(dim1=1, dim2=2).sum(-1) - 1.0) / 2.0
    return float(torch.arccos(cos.clamp(-1.0, 1.0)).mean()), float((xf[:, :, 3] - true[:, :, 3]).norm(dim=-1).mean())


def extras_dataset(dev):
    """The smoke's sphere dataset, its last :data:`CLEAR_VIEWS` views
    transparent (over the envmap) and the others opaque photos over black,
    its poses perturbed (:data:`POSE_NOISE`) and its first
    :data:`DARK_VIEWS` views darkened → (dataset, focal, principal, true
    poses, perturbed poses)."""
    from nerfshop_tpu_torch.ops import rays

    ds, focal, principal = sphere_dataset(dev)
    opaque = slice(0, N_VIEWS - CLEAR_VIEWS)
    a = ds.images[opaque, ..., 3:]
    ds.images[opaque] = np.concatenate([ds.images[opaque, ..., :3] * a, np.ones_like(a)], -1)
    true = torch.as_tensor(ds.xforms, device=dev)
    rng = np.random.default_rng(POSE_SEED)

    def directions(n):
        v = rng.normal(size=(n, 3))
        return torch.as_tensor((v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32), device=dev)

    noisy = rays.apply_pose_delta(true, directions(N_VIEWS) * POSE_NOISE, directions(N_VIEWS) * POSE_NOISE)
    ds.xforms = noisy.cpu().numpy()
    ds.images[:DARK_VIEWS, ..., :3] *= DARK
    return ds, focal, principal, true, noisy


def f_step_times(tb) -> None:
    """Kernel F at the positions and output cotangent of one training step
    of ``tb`` (an eager step from its draws, the inputs kept by a spy on
    the dispatcher), timed by events and on the device beside its plain
    version and its bound."""
    from nerfshop_tpu_torch.ops import table_ops
    from nerfshop_tpu_torch.train import nerf as nerf_train

    kept, dispatch = [], table_ops.grid_encode_dx

    def spy(table, x, dout, enc):
        kept.append((table.detach().contiguous(), x.detach().contiguous(), dout.detach().float().contiguous(), enc))
        return dispatch(table, x, dout, enc)

    cfg, data = tb.train_config, tb._device_data
    draws = nerf_train.draw_step(cfg, data, tb.generator)
    pix = nerf_train.pixels_of_step(cfg, data, draws[0], draws[1], tb._error_map)
    table_ops.grid_encode_dx = spy
    try:
        nerf_train.grads_from_draws(tb.model, tb.grid, data, cfg, draws[0], pix, *draws[2:], extra=tb._state.extra)
    finally:
        table_ops.grid_encode_dx = dispatch
    check(len(kept) == 1, f"one training step called kernel F's dispatcher {len(kept)} times")
    table, x, dout, enc = kept[0]
    ms, dev_ms = both_ms(lambda: table_ops.grid_encode_dx_cuda(table, x, dout, enc))
    plain_ms = median_ms(lambda: table_ops.grid_encode_dx_plain(table, x, dout, enc))
    n_bytes = nbytes(x, dout) + x.numel() * 4 + touched_rows(enc, enc.brick_fracs(x)[0]) * 2 * 4
    b_ms, _ = bound(n_bytes)
    print(
        f"[train-extras] kernel F at one training step's {x.shape[0]} positions ({cfg.n_rays_per_batch} rays x "
        f"{cfg.k_samples}): kernel {ms:.4f} ms (device {dev_ms:.4f} ms) plain {plain_ms:.4f} ms bound {b_ms:.4f} ms, "
        f"device/bound {dev_ms / b_ms:.2f}",
        flush=True,
    )


def phase_train_extras(dev, train_steps_per_s, W=1920, H=1080):
    """[train-extras]: the sphere with perturbed poses, darkened views and
    some transparent ones (:func:`extras_dataset`), every training option
    on (pose and distortion-map optimization, exposure, the error map, the
    trainable envmap), ``Testbed.train`` for 256 steps at batch 2^18 in
    captured chunks; kernel F in the training step; the camera leaves moved
    and finite; the corrected poses' errors and the log exposures printed
    (the camera leaves take the network's Adam, as in JAX, and drift: F16,
    ``ROADMAP.md`` Queue 3); the loss falling; the held-out PSNR;
    the captured loop held to eager; one 1080p frame with the envmap
    background; kernel F timed at one training step's inputs → the
    training's launches."""
    from nerfshop_tpu_torch.common import TestbedMode
    from nerfshop_tpu_torch.config import default_nerf_config
    from nerfshop_tpu_torch.ops import rays
    from nerfshop_tpu_torch.testbed import Testbed

    ds, focal, principal, true, noisy = extras_dataset(dev)
    tb = Testbed(TestbedMode.Nerf, config=default_nerf_config(), device=dev, seed=0)
    t = tb.nerf.training
    t.optimize_extrinsics = t.optimize_distortion = t.optimize_exposure = t.use_error_map = t.train_envmap = True
    tb.set_training_data(ds)
    cfg = tb.train_config
    check(cfg.optimize_extrinsics and cfg.optimize_exposure and cfg.use_error_map and cfg.train_envmap,
          f"[train-extras] a knob did not reach the training config: {cfg}")
    extra = tb._state.extra
    check(sorted(extra) == ["camera.distortion_map", "camera.log_exposure", "camera.rot", "camera.trans", "envmap"],
          f"[train-extras] the training leaves: {sorted(extra)}")
    err0 = pose_errors(noisy, true)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trace = []
    t0 = time.perf_counter()
    for _ in range(STEPS // 32):
        tb.train(n_steps=32, batch_size=BATCH)
        corrected = rays.apply_pose_delta(noisy, extra["camera.rot"].detach(), extra["camera.trans"].detach())
        trace.append(pose_errors(corrected, true))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [lv for _, lv in tb.loss_history]
    check(len(losses) == STEPS and all(math.isfinite(v) for v in losses), "[train-extras] non-finite or missing losses")
    check(tb.stats.captured_steps == STEPS == tb.stats.step, "[train-extras] a step ran outside the captured loop")
    per_step = {k: v / 16 for k, v in tb.stats.graph_launches.items()}
    check(launches["grid_encode_dx"] > 0 and per_step.get("grid_encode_dx_cuda.launches", 0) > 0,
          f"[train-extras] kernel F was not launched in the training step: {launches}")
    check_launched(launches, ("segsum", "grid_encode", "fused_mlp", "gather"), "[train-extras] training path")
    err1 = trace[-1]
    le = extra["camera.log_exposure"].detach()
    dark_le, other_le = float(le[:DARK_VIEWS].mean()), float(le[DARK_VIEWS:].mean())
    clear_le = float(le[N_VIEWS - CLEAR_VIEWS:].mean())
    em = tb._error_map
    print(
        f"[train-extras] {STEPS} steps batch {BATCH} with pose, distortion-map and exposure optimization, the error "
        f"map and the envmap in {train_s:.3f} s (the graphs' captures included): {STEPS / train_s:.3f} steps/s "
        f"([train]: {train_steps_per_s:.3f}), loss {losses[0]:.4e} -> last-10 {float(np.mean(losses[-10:])):.4e}, "
        f"peak memory {peak / 2**30:.3f} GiB; kernel F in the captured step: {per_step.get('grid_encode_dx_cuda.launches')} "
        f"a step; launches {launches}",
        flush=True,
    )
    print(
        f"[train-extras] poses perturbed by {POSE_NOISE} rad and {POSE_NOISE} units: mean rotation error {err0[0]:.5f} "
        f"-> {err1[0]:.5f} rad, mean translation error {err0[1]:.5f} -> {err1[1]:.5f} (every 32 steps: "
        f"{[(round(a, 5), round(b, 5)) for a, b in trace]}); log exposure of the {DARK_VIEWS} views darkened by {DARK}: "
        f"{dark_le:.4f} (others {other_le:.4f}, of which the {CLEAR_VIEWS} transparent {clear_le:.4f}; ideal difference "
        f"{-math.log(DARK):.4f}); distortion map max "
        f"|offset| {float(extra['camera.distortion_map'].detach().abs().max()):.3e}; envmap mean "
        f"{float(extra['envmap'].detach()[..., :3].mean()):.4f}; error map {float(em.min()):.4e}-{float(em.max()):.4e}",
        flush=True,
    )
    cam = [extra[k].detach() for k in ("camera.rot", "camera.trans", "camera.distortion_map")]
    check(all(bool(torch.isfinite(c).all()) and float(c.abs().max()) > 0 for c in cam),
          "[train-extras] a camera leaf did not move or is not finite")
    check(float(np.mean(losses[-10:])) < 0.35 * losses[0], "[train-extras] the loss did not fall as [train]'s must")

    # held-out PSNR, as [held-out]
    xf = look_at(CENTER + np.array([0.9, 0.9, 0.5], np.float32))
    b = view_rays(xf, focal, principal, tb.device)
    gt = sphere_rgba(b.origins.cpu().numpy(), b.directions.cpu().numpy()).reshape(RES, RES, 4)
    img = tb.render(RES, RES, spp=1, camera_matrix=xf, focal=focal, principal=principal, exact=True)
    value = psnr(img[..., :3], gt[..., :3] * gt[..., 3:])
    on_sphere = gt[..., 3] > 0
    sphere_psnr = psnr(img[on_sphere, :3], gt[on_sphere, :3])
    check(np.isfinite(img).all() and value >= 14.0, f"[train-extras] held-out PSNR {value:.2f} dB < 14")
    f_step_times(tb)
    phase_train_loop(tb, tag="[train-extras]")
    tb.set_look_at(eye=CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = tb.render(W, H, spp=1, exact=True)
    frame_s = time.perf_counter() - t0
    check(frame.shape == (H, W, 4) and np.isfinite(frame).all() and float(frame[..., 3].min()) > 0.99,
          "[train-extras] the 1080p frame with the envmap is not finite and opaque")
    print(
        f"[train-extras] held-out {RES}x{RES} PSNR {value:.2f} dB (bound 14; on the sphere's pixels {sphere_psnr:.2f} "
        f"dB); {W}x{H} exact frame with the envmap "
        f"background {frame_s * 1e3:.1f} ms (alpha min {float(frame[..., 3].min()):.4f})",
        flush=True,
    )
    return launches


def phase_normals(tb, W=1920, H=1080):
    """[normals]: ``Testbed.render`` of the trained model in
    ``RenderMode.Normals``: kernel F once a chunk, kernel A never, kernel B
    without fracs only; the middle chunk's normals and σ against the plain
    versions' (the plain encode and its autograd) → the frame's launches."""
    from nerfshop_tpu_torch.common import RenderMode
    from nerfshop_tpu_torch.models.nerf_network import density_activation_fn
    from nerfshop_tpu_torch.ops import fused_mlp, table_ops

    tb.set_look_at(eye=CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    tb.render_mode = RenderMode.Normals
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with encode_input_of_call(tb.model.pos_encoding, middle_chunk(W, H)) as kept:
        t0 = time.perf_counter()
        img = tb.render(W, H, spp=1, exact=True)
        first_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    tb.render(W, H, spp=1, exact=True)
    frame_s = time.perf_counter() - t0
    tb.render_mode = RenderMode.Shade
    opts = tb._render_options()
    n_chunks = -(-W * H // opts.chunk)
    check(img.shape == (H, W, 4) and np.isfinite(img).all(), "Normals frame is not finite / of the expected shape")
    check(float(img[..., 3].max()) > 0.5 and float(np.ptp(img[..., :3][img[..., 3] > 0.5])) > 0.2,
          "Normals frame shows no shaded content")
    check(launches["grid_encode_dx"] == n_chunks, f"kernel F not launched once a chunk ({n_chunks}): {launches}")
    check(launches["segsum"] == 0 and launches["grid_encode_fracs"] == 0,
          f"a Normals frame formed a table gradient or wrote fracs: {launches}")
    check(len(kept) == 1, "the middle chunk's positions were not captured")

    # the middle chunk's slots: the kernels' path (B, F) against the plain
    # encode under autograd, both with the plain MLP and the EMA weights
    x = kept[0]
    params = {k: v.detach() for k, v in tb.inference_params.items()}
    enc, mlp = tb.model.pos_encoding, tb.model.density_mlp
    ws = [params[f"density_mlp.weights.{i}"] for i in range(len(mlp.weights))]
    table = params["pos_encoding.table"]

    def normals(encode):
        with torch.enable_grad():
            p = x.detach().requires_grad_(True)
            raw = fused_mlp.fused_mlp_plain(encode(p), ws)[:, 0]
            sig = density_activation_fn(raw, tb.model.density_activation)
            (grad,) = torch.autograd.grad(sig.sum(), p)
        return sig.detach(), grad

    sig_k, grad_k = normals(lambda p: table_ops.GridEncodeFunction.apply(table, p, enc))
    sig_p, grad_p = normals(lambda p: table_ops.grid_encode_plain(table, p, enc, with_fracs=False)[0])
    torch.cuda.synchronize()
    norm = torch.linalg.vector_norm(grad_p, dim=-1)
    well = norm > 1e-3 * float(norm.max())  # where the direction is well conditioned
    n_k = grad_k / (torch.linalg.vector_norm(grad_k, dim=-1, keepdim=True) + 1e-9)
    n_p = grad_p / (norm[:, None] + 1e-9)
    # kernel B's features and the plain encode's differ by an ulp (another
    # summation order), which can move a bf16-rounded MLP input by 2^-8 on a
    # rare slot, and raw σ (log σ) by up to ~2^-8 · Σ|w·h| ≈ 0.01-0.03 with
    # it: 99.9% of slots within 1e-4 (normals) and 1e-5 (σ relative), all
    # within 0.05
    n_d = (n_k - n_p)[well].abs().amax(dim=-1)
    s_d = (sig_k - sig_p).abs() / sig_p.abs().clamp_min(1e-6)
    n_share, s_share = float((n_d <= 1e-4).float().mean()), float((s_d <= 1e-5).float().mean())
    n_err, s_err = float(n_d.max()), float(s_d.max())
    check(n_share >= 0.999 and s_share >= 0.999 and n_err <= 0.05 and s_err <= 0.05,
          f"Normals chunk disagrees with the plain versions: normals within 1e-4 on {n_share:.5f} (max {n_err:.3e}), "
          f"sigma within 1e-5 relative on {s_share:.5f} (max {s_err:.3e})")
    print(
        f"[normals] {W}x{H} exact spp=1: first frame {first_s * 1e3:.1f} ms, second {frame_s * 1e3:.1f} ms, peak "
        f"memory {peak / 2**30:.3f} GiB ({opts.chunk} rays x {opts.k_samples * opts.n_windows} slots a chunk under "
        f"autograd); launches in one frame {launches} ({n_chunks} chunks); middle chunk ({x.shape[0]} slots, "
        f"{int(well.sum())} with |grad sigma| > 1e-3 of its max) against the plain encode: normals within 1e-4 on "
        f"{n_share:.5f} of them (max |delta| {n_err:.3e}; bounds 0.999, 0.05), sigma within 1e-5 relative on "
        f"{s_share:.5f} (max {s_err:.3e}; bounds 0.999, 0.05)",
        flush=True,
    )
    return launches


@contextlib.contextmanager
def timed_calls(times: dict, targets):
    """While open, time every call of each ``(owner, name)`` in ``targets``
    (card drained before and after) into ``times[name]``."""
    saved = [(owner, name, getattr(owner, name)) for owner, name in targets]

    def wrap(name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed

    for owner, name, fn in saved:
        setattr(owner, name, wrap(name, fn))
    try:
        yield times
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def phase_mesh(tb, res=256, steps=100):
    """[mesh]: ``compute_marching_cubes_mesh(res)`` of the trained sphere
    (seconds by stage; the mean distance of its vertices to the field's own
    σ = 2.5 level within one grid cell, and to the analytic sphere within
    three), then ``optimise_mesh`` for ``steps`` steps (mean
    |σ − 2.5| at the vertices before and after) → the path's launches."""
    from nerfshop_tpu_torch.geometry import isosurface

    torch.cuda.synchronize()
    reset_launches()
    times = {}
    with timed_calls(times, ((tb, "get_density_on_grid"), (isosurface, "marching_tets"),
                             (isosurface, "orient_consistently"))):
        t0 = time.perf_counter()
        mesh = tb.compute_marching_cubes_mesh(res)
        total_s = time.perf_counter() - t0
    check(mesh.n_vertices > 1000 and mesh.colors is not None and np.isfinite(mesh.colors).all(),
          f"the mesh is empty or its colours bad ({mesh.n_vertices} vertices)")
    cell = 1.0 / res
    signed = np.linalg.norm(mesh.vertices - CENTER, axis=-1) - RADIUS
    dist = np.abs(signed)
    density = tb._density_fn()

    def off_iso(v):
        with torch.no_grad():
            return float((density(torch.as_tensor(v, device=tb.device)) - 2.5).abs().mean())

    before = off_iso(mesh.vertices)
    verts0 = mesh.vertices.copy()
    torch.cuda.synchronize()
    with encode_input_of_call(tb.model.pos_encoding, 0) as kept:
        t0 = time.perf_counter()
        tb.optimise_mesh(mesh, n_steps=steps)
        torch.cuda.synchronize()
        opt_s = time.perf_counter() - t0
    after = off_iso(mesh.vertices)
    launches = read_launches()
    check(np.isfinite(mesh.vertices).all(), "optimise_mesh produced non-finite vertices")
    check_launched(launches, ("grid_encode", "fused_mlp", "grid_encode_dx"), "mesh path")
    check(launches["grid_encode_dx"] == steps and launches["segsum"] == 0,
          f"optimise_mesh did not take d_x from kernel F once a step without a table gradient: {launches}")
    # the extraction against its own field: each vertex's distance to the
    # σ = 2.5 level, |σ − 2.5| / |∇σ| (the gradient through kernel F), within
    # a cell on average; against the analytic sphere: a closed shell with no
    # floaters, whose offset is the trained density's fall-off outside the
    # surface (σ = 2.5 lies ~2 cells out after 256 steps; PERF.md PR 9)
    with torch.enable_grad():
        v = torch.as_tensor(verts0, device=tb.device).requires_grad_(True)
        sig = density(v)
        (grad,) = torch.autograd.grad(sig.sum(), v)
    to_iso = float(((sig.detach() - 2.5).abs() / torch.linalg.vector_norm(grad, dim=-1).clamp_min(1e-6)).mean())
    check(to_iso <= cell, f"the mesh lies {to_iso:.3e} from its field's iso level, more than a cell ({cell:.3e})")
    far = float((dist > 0.02).mean())
    # the trained density's fall-off across the analytic surface: median σ
    # on the grid in shells of 0.005 around RADIUS
    field = tb.get_density_on_grid(res)
    g = (np.arange(res) + 0.5) / res - CENTER[0]
    r = np.sqrt(g[:, None, None] ** 2 + g[None, :, None] ** 2 + g[None, None, :] ** 2)
    shells = {f"{lo:+.3f}": round(float(np.median(field[(r >= RADIUS + lo) & (r < RADIUS + lo + 0.005)])), 3)
              for lo in (-0.01, -0.005, 0.0, 0.005, 0.01, 0.015)}
    check(dist.mean() <= 3 * cell and far <= 0.01,
          f"the mesh is not a shell at the sphere: mean distance {dist.mean():.3e} (bound 3 cells, {3 * cell:.3e}), "
          f"{far:.4f} of the vertices farther than 0.02 (bound 0.01)")
    print(
        f"[mesh] compute_marching_cubes_mesh({res}): {total_s:.3f} s (density grid {times['get_density_on_grid']:.3f} s, "
        f"marching tets {times['marching_tets']:.3f} s, orientation {times['orient_consistently']:.3f} s, vertex "
        f"colours and the rest {total_s - sum(times.values()):.3f} s); {mesh.n_vertices} vertices, {mesh.n_faces} faces; "
        f"distance to the field's sigma = 2.5 level mean {to_iso:.3e} (bound one cell, {cell:.3e}); to the analytic "
        f"sphere mean {dist.mean():.3e} = {dist.mean() / cell:.2f} cells (bound 3), signed median {np.median(signed):.3e}, "
        f"p1 {np.percentile(signed, 1):.3e} p99 {np.percentile(signed, 99):.3e}, share beyond 0.02 {far:.4f} (bound 0.01); "
        f"median sigma in shells of 0.005 from r = RADIUS + {json.dumps(shells)}; "
        f"optimise_mesh {steps} steps {opt_s:.3f} s: mean |sigma - 2.5| at the vertices {before:.4f} -> {after:.4f}, "
        f"vertices moved mean {np.linalg.norm(mesh.vertices - verts0, axis=-1).mean():.3e}; launches {launches}",
        flush=True,
    )
    # kernel F where its refinement launches run: the positions the first
    # step encodes (the vertices in the unit cube) and the EMA table
    check(len(kept) == 1, "the first refinement step's positions were not captured")
    g = torch.Generator(device=tb.device)
    g.manual_seed(F_MESH_SEED)
    encode_dx_case("mesh vertices (optimise_mesh's first step)", tb.model.pos_encoding,
                   tb.inference_params["pos_encoding.table"].detach(), kept[0].contiguous(), g)
    return launches


class _Stamped:
    """A stdout stand-in that keeps each written line with its time."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, text):
        self._part += text
        *done, self._part = self._part.split("\n")
        self.lines += [(time.perf_counter(), line) for line in done]
        return len(text)

    def flush(self):
        pass


def stamped_main(argv):
    """``nerfshop_tpu_torch.run.main(argv)`` in process with its stdout kept
    line by line with times → (testbed, lines, start time, launches)."""
    from nerfshop_tpu_torch import run

    stamped = _Stamped()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stamped):
        tb = run.main(argv)
    torch.cuda.synchronize()
    return tb, stamped.lines, t0, read_launches()


def write_scene(ds, root: Path) -> Path:
    """``ds`` (the smoke's sphere views) as a scene on disk: transforms.json
    (scale 1, offset 0: the matrices as they are) and RGBA PNGs through the
    port's writer."""
    from nerfshop_tpu_torch.data import image_io
    from nerfshop_tpu_torch.data.nerf_loader import ngp_matrix_to_nerf

    (root / "images").mkdir(parents=True)
    frames = []
    for i, (img, xf, intr) in enumerate(zip(ds.images, ds.xforms, ds.intrinsics)):
        image_io.write_image(root / "images" / f"{i:03d}.png", img, linear_input=False)
        m = np.eye(4)
        m[:3] = ngp_matrix_to_nerf(np.asarray(xf, np.float32), 1.0, np.zeros(3, np.float32))
        frames.append({"file_path": f"images/{i:03d}.png", "transform_matrix": m.tolist()})
    f, c = ds.intrinsics[0].focal, ds.intrinsics[0].principal
    meta = {"fl_x": float(f[0]), "fl_y": float(f[1]), "cx": float(c[0] * RES), "cy": float(c[1] * RES),
            "w": RES, "h": RES, "scale": 1.0, "offset": [0.0, 0.0, 0.0], "aabb_scale": 1, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


def phase_cli(dev, snapshot: Path, workdir: Path, W=1920, H=1080):
    """[cli]: the smoke's sphere views written to disk as a scene, then
    ``nerfshop_tpu_torch.run.main`` in process on it from the snapshot:
    64 steps, a snapshot, a mesh at 128, the held-out score, a 1080p
    screenshot and 3 1080p frames of a 3-keyframe camera path. Every file
    must decode through the port's readers and ``psnr_mean`` reach 14 dB →
    the run's launches."""
    from nerfshop_tpu_torch.data import image_io
    from nerfshop_tpu_torch.geometry import mesh_io
    from nerfshop_tpu_torch.io import snapshot as snap_lib
    from nerfshop_tpu_torch.render.camera_path import CameraPath

    ds, _, _ = sphere_dataset(dev, seed=1)
    scene = write_scene(ds, workdir / "scene")
    path = CameraPath()
    for eye in ((1.0, -0.9, 0.4), (1.2, 0.2, 0.6), (0.6, 1.1, 0.3)):
        path.add_camera(look_at(CENTER + np.array(eye, np.float32)), fov_deg=50.0)
    path.save(workdir / "path.json")
    out = workdir / "cli"
    argv = [
        "--scene", str(scene), "--load_snapshot", str(snapshot), "--n_steps", "64", "--save_snapshot",
        str(out / "model.snap"), "--save_mesh", str(out / "mesh.obj"), "--marching_cubes_res", "128",
        "--test_transforms", str(scene / "transforms.json"), "--screenshot_dir", str(out / "shots"), "--width", str(W),
        "--height", str(H), "--screenshot_spp", "1", "--video_camera_path", str(workdir / "path.json"),
        "--video_n_frames", "3", "--video_spp", "1", "--video_output", str(out / "video"), "--device", "cuda",
    ]
    out.mkdir()
    cli_tb, lines, t0, launches = stamped_main(argv)
    total_s = time.perf_counter() - t0
    result = json.loads(next(line for _, line in lines if line.startswith('{"psnr_mean"')))

    def at(prefix):
        return next(t for t, line in lines if line.lstrip().startswith(prefix))

    stages = {
        "load": at("training") - t0, "train": at("trained in") - at("training"),
        "save snapshot": at("saved snapshot") - at("trained in"), "mesh": at("evaluating on") - at("marching cubes"),
        "evaluate": at('{"psnr_mean"') - at("evaluating on"), "screenshot": at("wrote " + str(out / "shots")) - at('{"psnr_mean"'),
        "video": at("wrote 3 frames") - at("wrote " + str(out / "shots")),
    }
    shot = image_io.read_image(out / "shots" / "screenshot.png", linear=False)
    check(shot.shape == (H, W, 4) and float(shot[..., 3].max()) > 0.5, f"the screenshot is bad: {shot.shape}")
    for i in range(3):
        frame = image_io.read_image(out / "video" / f"frame_{i:04d}.png", linear=False)
        check(frame.shape == (H, W, 4) and float(frame[..., 3].max()) > 0.5, f"video frame {i} is bad")
    mesh = mesh_io.load_mesh(out / "mesh.obj")
    check(mesh.n_vertices > 100 and mesh.n_faces > 100, f"the CLI's mesh is empty: {mesh.n_vertices} vertices")
    snap = snap_lib.load_snapshot(str(out / "model.snap"))
    check(snap.get("step") == 256 + 64, f"the CLI's snapshot holds step {snap.get('step')}, expected 320")
    check(result["n_views"] == N_VIEWS and result["psnr_mean"] >= 14.0,
          f"the CLI's held-out score is {result} (bound 14 dB over {N_VIEWS} views)")
    check_launched(launches, ("segsum", "grid_encode", "fused_mlp", "gather"), "CLI path")
    check(cli_tb.stats.step == 256 + 64, f"the CLI trained to step {cli_tb.stats.step}")
    print(
        f"[cli] python -m nerfshop_tpu_torch.run in process, {len(lines)} lines printed, {total_s:.2f} s: "
        f"psnr_mean {result['psnr_mean']:.2f} dB (bound 14) ssim_mean {result['ssim_mean']:.4f} over "
        f"{result['n_views']} views; seconds by stage {json.dumps({k: round(v, 3) for k, v in stages.items()})}; "
        f"written and read back: snapshot (step {snap.get('step')}), {W}x{H} screenshot, 3 {W}x{H} video frames, "
        f"mesh ({mesh.n_vertices} vertices); launches {launches}",
        flush=True,
    )
    return launches


# ------------------------------------------------------------------ the edit


def ops_equal(a, b) -> bool:
    """Two operator lists equal bit for bit, their LUTs and packed forms too."""

    def same(u, v):
        if isinstance(u, torch.Tensor):
            return isinstance(v, torch.Tensor) and torch.equal(u, v)
        if hasattr(u, "_fields"):
            return type(u) is type(v) and all(same(x, y) for x, y in zip(u, v))
        return u == v

    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


def opacity_centroid_x(img) -> float:
    a = img[..., 3]
    return float((np.arange(img.shape[1])[None, :] * a).sum() / max(float(a.sum()), 1e-6))


def timed_frames(tb, W, H, n=3):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        img = tb.render(W, H, spp=1, exact=True)
        times.append(time.perf_counter() - t0)
    return img, times


#: the edit's cage move and the affine duplicate stacked on it
CAGE_SHIFT = np.array([0.18, 0.0, 0.0], np.float32)
SIDE_EYE = CENTER + np.array([0.0, -1.3, 0.0], np.float32)


def duplicate_op(dev):
    """Box around the moved sphere, copied −0.42 in x."""
    from nerfshop_tpu_torch.editing.operators import AffineDuplicationOp

    return AffineDuplicationOp.create(
        center=CENTER + CAGE_SHIFT, half_extents=[0.25, 0.25, 0.25], transform_t=[-0.42, 0.0, 0.0], device=dev
    )


def scribble_cage(tb, focal, principal):
    """Scribble → ``GrowingSelection`` → proxy cage → tets + MVC → operator:
    the 16×16 centre pixels of the held-out view, grown over the cells the
    renderer counts as occupied. → (gs, identity operator, host seconds per
    stage, a summary line)."""
    from nerfshop_tpu_torch.common import MIN_CONE_STEPSIZE, NERF_MIN_OPTICAL_THICKNESS

    dev = tb.device
    host = {}
    b = view_rays(look_at(CENTER + np.array([0.9, 0.9, 0.5], np.float32)), focal, principal, dev)
    centre = np.arange(RES // 2 - 8, RES // 2 + 8)
    pix = torch.as_tensor((centre[:, None] * RES + centre[None, :]).reshape(-1), device=dev)
    gs = tb.begin_cage_edit()
    gs.density_threshold = float(torch.clamp_max(tb.grid.mean_density, NERF_MIN_OPTICAL_THICKNESS / MIN_CONE_STEPSIZE))

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        host[name] = time.perf_counter() - t0
        return out

    hits = stage("project", lambda: gs.project(tb.inference_params, tb.grid, b.origins[pix], b.directions[pix]))
    check(hits >= 128, f"only {hits} of 256 scribble rays hit the sphere")
    grown = stage("grow", lambda: gs.grow_region(tb.grid, n_steps=1 << 30))
    sel_frac = float(gs.region.selection.mean())
    check(not gs.region.queue and grown > 0 and sel_frac < 0.25, f"region growing: {grown} cells, {sel_frac:.4f} of the grid")
    cage = stage("proxy", gs.compute_proxy)
    tet_mesh = stage("tet+mvc", gs.extract_cage)
    op = stage("luts", gs.make_operator)
    lut = op.lut_def
    summary = (
        f"{hits} of 256 scribble rays hit, {len(gs.projected_cells)} seed cells, {grown} cells grown "
        f"(threshold {gs.density_threshold:.4g}, {sel_frac:.5f} of the grid), cage {cage.n_vertices} vertices / "
        f"{cage.n_faces} faces, {tet_mesh.n_tets} tets, LUT {lut.res}^3 x {lut.cells.shape[1]}"
    )
    return gs, op, host, summary


def phase_edit(tb, focal, principal, W=1920, H=1080):
    """The cage-edit path of the trained model through the facade: scribble
    → GrowingSelection → operators added with a full grid refresh through
    the stack → 1080p frames; then the edits file round trip."""
    dev = tb.device
    gs, op_identity, host, summary = scribble_cage(tb, focal, principal)
    print(f"[edit] host stages (s): " + ", ".join(f"{k} {v:.3f}" for k, v in host.items()) + f"; {summary}", flush=True)

    # identity cage: a refresh through the empty stack, then through the cage
    tb.set_look_at(eye=CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    tb.refresh_grid_for_edits()
    base = tb.render(W, H, spp=1, exact=True)
    tb.add_edit_operator(op_identity)
    ident = tb.render(W, H, spp=1, exact=True)
    diff = np.abs(ident[..., :3] - base[..., :3])
    d_mean, d_p99 = float(diff.mean()), float(np.quantile(diff, 0.99))
    check(d_mean < 0.01 and d_p99 < 0.12, f"identity cage changed the frame: mean {d_mean:.4g} p99 {d_p99:.4g}")
    check(float(base[..., 3].max()) > 0.5, "the unedited frame shows no content")
    print(f"[edit] identity cage {W}x{H}: mean |drgb| {d_mean:.5f} (bound 0.01), p99 {d_p99:.5f} (bound 0.12)", flush=True)

    # the cage moved +0.18 in x, seen from the side
    tb.remove_edit_operator(0)
    tb.set_look_at(eye=SIDE_EYE)
    unedited, unedited_times = timed_frames(tb, W, H)
    gs.translate_cage(CAGE_SHIFT)
    t0 = time.perf_counter()
    op_moved = gs.make_operator()
    rebuild_s = time.perf_counter() - t0
    tb.add_edit_operator(op_moved)
    moved = tb.render(W, H, spp=1, exact=True)
    shift_px = float(CAGE_SHIFT[0]) * float(tb._focal_for(W, H)[0]) / 1.3
    dx = opacity_centroid_x(moved) - opacity_centroid_x(unedited)
    check(dx >= 0.5 * shift_px, f"opacity centroid moved {dx:.1f} px, less than half the projected {shift_px:.1f} px")
    r = 0.22 * float(tb._focal_for(W, H)[0]) / 1.3  # the sphere's projected radius
    win = (slice(H // 2 - 30, H // 2 + 30), slice(int(W // 2 - 0.8 * r), int(W // 2 - 0.3 * r)))
    a_old, a_new = float(unedited[win][..., 3].mean()), float(moved[win][..., 3].mean())
    check(a_new < a_old, f"opacity at the old centre did not drop: {a_old:.4f} -> {a_new:.4f}")
    print(
        f"[edit] cage +0.18 x: opacity centroid +{dx:.1f} px (bound {0.5 * shift_px:.1f}), opacity left of the old "
        f"centre {a_old:.4f} -> {a_new:.4f}; operator rebuild after the drag {rebuild_s:.3f} s",
        flush=True,
    )

    # an affine duplicate of the moved content on top
    tb.add_edit_operator(duplicate_op(dev))
    torch.cuda.synchronize()
    counts = read_launches()
    with cage_input_of_call(op_moved, middle_chunk(W, H)) as kept:
        edited = tb.render(W, H, spp=1, exact=True)
    check(len(kept) == 1, "the middle chunk's warp through the moved cage was not captured")
    frame_launches = {k: v - counts[k] for k, v in read_launches().items()}
    check(float(edited[..., 3].sum()) > float(moved[..., 3].sum()), "the affine duplicate did not add opacity")
    check(edited.shape == (H, W, 4) and np.isfinite(edited).all(), "edited frame is not finite / of the expected shape")
    check_launched(frame_launches, ("grid_encode", "fused_mlp", "gather", "cage_warp_samples"), "edited frame")
    # the cage warp is one launch of kernel E per call: no lookup of its own
    # and no kernel D row take, so the edited frame launches kernel D as often
    # as the same frame without the operators over the same grid (the march's)
    stack, tb._edit_operators = tb._edit_operators, []
    counts = read_launches()
    tb.render(W, H, spp=1, exact=True)
    tb._edit_operators = stack
    bare_gathers = read_launches()["gather"] - counts["gather"]
    check(frame_launches["tet_lookup"] == 0 and frame_launches["gather"] == bare_gathers,
          f"the cage warp launched more than kernel E's warp: {frame_launches}, {bare_gathers} gathers without it")
    torch.cuda.reset_peak_memory_stats()
    _, edited_times = timed_frames(tb, W, H)
    peak = torch.cuda.max_memory_allocated()
    med_e, med_u = statistics.median(edited_times), statistics.median(unedited_times)
    print(
        f"[edit] affine duplicate on top: total opacity {float(moved[..., 3].sum()):.1f} -> {float(edited[..., 3].sum()):.1f}; "
        f"{W}x{H} edited frame (2 operators) median of 3 {med_e * 1e3:.1f} ms "
        f"({[round(t * 1e3, 1) for t in edited_times]}) vs unedited {med_u * 1e3:.1f} ms "
        f"({[round(t * 1e3, 1) for t in unedited_times]}), peak memory {peak / 2**30:.3f} GiB, "
        f"launches in one edited frame {frame_launches} (kernel D without the operators over the same grid: "
        f"{bare_gathers})",
        flush=True,
    )

    # save → load: the same operators, and the same frame over the same grid
    small = (W // 4, H // 4)
    before = tb.render(*small, spp=1, exact=True)
    ops_before = tb.edit_operators
    g = tb.grid
    saved = (g.density.clone(), g.occupancy.clone(), g.mean_density.clone())
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/edits.json"
        tb.save_edits(path)
        size = Path(path).stat().st_size
        tb.load_edits(path)
    check(ops_equal(ops_before, tb.edit_operators), "load_edits gave other operators than save_edits wrote")
    g.density.copy_(saved[0])
    g.occupancy, g.mean_density = saved[1], saved[2]
    after = tb.render(*small, spp=1, exact=True)
    check(np.array_equal(after, before), "the frame after the edits round trip differs")
    print(f"[edit] save_edits -> load_edits: {size / 2**20:.2f} MiB, operators bit-equal, {small[0]}x{small[1]} frame bit-equal", flush=True)
    return gs, op_moved, frame_launches, kept[0]


def tie_nan_op(op):
    """``op`` with LUTs that test the lookup's tie and NaN rules: every tet t
    gets an exact copy t + Nt listed just before it in every cell (the two
    score alike to the bit, and the earlier, the copy, must win), and a
    degenerate tet 2·Nt with NaN inverse edges (its score is NaN, which must
    never win) heads every non-empty cell and is all that the empty ones
    list. Points of an empty cell then find nothing (tet 0)."""
    from nerfshop_tpu_torch.editing.operators import CAGE_ARRAYS, CageDeformationOp
    from nerfshop_tpu_torch.editing.tet_mesh import TetLut

    nt = op.v0_def.shape[0]

    def lut(lt):
        c = lt.cells
        out = torch.full((c.shape[0], 2 * c.shape[1] + 1), -1, dtype=torch.int32, device=c.device)
        out[:, 0] = 2 * nt
        out[:, 1:] = torch.stack([torch.where(c >= 0, c + nt, c), c], dim=2).reshape(c.shape[0], -1)
        return TetLut(lt.bbox_lo, lt.inv_cell, out, lt.res)

    def arr(name):
        a = getattr(op, name)
        bad = torch.full_like(a[:1], float("nan")) if name.startswith("inv_") else torch.zeros_like(a[:1])
        return torch.cat([a, a, bad])

    syn = CageDeformationOp.create(lut(op.lut_def), lut(op.lut_orig), op.copy_mode, **{k: arr(k) for k in CAGE_ARRAYS})
    m = op.membrane
    if m is not None:  # the copies carry their tets' membrane rows, the NaN tet zeros
        from nerfshop_tpu_torch.editing.poisson import MembraneData

        def ext(a):
            return torch.cat([a, a, torch.zeros_like(a[:1])])

        syn = syn._replace(membrane=MembraneData.create(ext(m.density), ext(m.outside_density), ext(m.sh), m.amplitude))
    return syn


def near_ties(lut, table, p, thr):
    """[N] bool: the points whose lookup may flip under another fp32 order,
    where the two best candidate scores, or the best score and ``thr``, lie
    within 1e-6."""
    from nerfshop_tpu_torch.editing import operators as ops_lib

    ci, inb = ops_lib._cells(lut, p)
    cand = lut.cells[ci]
    top = torch.full((p.shape[0], 2), float("-inf"), device=p.device)
    for c in range(cand.shape[1]):
        tid = cand[:, c]
        w = ops_lib._bary_rows(table[tid.clamp_min(0).long()], p)
        sc = torch.minimum(torch.minimum(w[0], w[1]), torch.minimum(w[2], w[3]))
        sc = torch.where((tid >= 0) & inb & ~sc.isnan(), sc, torch.full_like(sc, float("-inf")))
        top = torch.stack([torch.maximum(top[:, 0], sc), torch.maximum(top[:, 1], torch.minimum(top[:, 0], sc))], 1)
    return ((top[:, 0] - top[:, 1]) < 1e-6) | ((top[:, 0] - thr).abs() < 1e-6)


def lut_reads(lut, records_row_bytes, p):
    """(bytes, candidates per point [N]) that a lookup of ``p`` in the packed
    ``lut`` must read from the LUT and the records: the offsets of each
    distinct cell, its ids, and a lookup row of each distinct candidate."""
    from nerfshop_tpu_torch.editing import operators as ops_lib

    ci, inb = ops_lib._cells(lut, p)
    start = lut.offsets[ci].long()
    fan = torch.where(inb, lut.offsets[ci + 1].long() - start, torch.zeros_like(start))
    cells = torch.unique(ci[inb])
    c0 = lut.offsets[cells].long()
    counts = lut.offsets[cells + 1].long() - c0
    n_ids = int(counts.sum())
    # the positions of every id these cells list: c0 + 0, c0 + 1, ... per cell
    first = torch.repeat_interleave(c0 - (torch.cumsum(counts, 0) - counts), counts)
    read = lut.ids[first + torch.arange(n_ids, device=p.device)]
    return cells.numel() * 8 + n_ids * 4 + torch.unique(read).numel() * records_row_bytes, fan


def lookup_case(label, op, p, thr, exact=False):
    """Kernel E's ``LOOKUP`` instance on the moved cage's deformed LUT at
    threshold ``thr`` against both plain versions (the padded LUT and the
    packed one) → its numbers. found and tet agree off near ties, bary within
    1e-5 where the tets agree; ``exact``: everything bit-equal, no exemption."""
    from nerfshop_tpu_torch.editing import operators as ops_lib

    pk = op.packed
    table = pk.records[ops_lib.REC_DEF]
    kernel = lambda: ops_lib.tet_lookup_cuda(pk.lut_def, table, p, thr)  # noqa: E731
    fk, tk, bk = kernel()
    fp, tp, bp = ops_lib.tet_lookup_plain(op.lut_def, table, p, thr)
    fq, tq, bq = ops_lib.tet_lookup_packed_plain(pk.lut_def, table, p, thr)
    torch.cuda.synchronize()
    check(torch.equal(fp, fq) and torch.equal(tp, tq) and torch.equal(bp.view(torch.int32), bq.view(torch.int32)),
          f"the plain lookups over the padded and the packed LUT differ ({label})")
    n_diff = int(((fk != fp) | (tk != tp)).sum())
    same = tk == tp
    b_err = float((bk - bp).abs()[same].max()) if bool(same.any()) else 0.0
    if exact:
        ties = torch.zeros_like(fk)
        check(n_diff == 0 and torch.equal(bk.view(torch.int32), bp.view(torch.int32)),
              f"kernel E LOOKUP is not bit-equal to its plain version ({label}): {n_diff} points differ")
    else:
        ties = near_ties(op.lut_def, table, p, thr)
        bad = int((((fk != fp) | (tk != tp)) & ~ties).sum())
        check(bad == 0 and b_err <= 1e-5, f"kernel E LOOKUP disagrees ({label}): {bad} points off the near ties, "
              f"bary err {b_err:.3e}")
    ms, dev_ms = both_ms(kernel)
    # the plain versions are timed at the path's LUT only (``exact`` cases check rules)
    plain_ms = packed_ms = float("nan")
    if not exact:
        plain_ms = median_ms(lambda: ops_lib.tet_lookup_plain(op.lut_def, table, p, thr))
        packed_ms = median_ms(lambda: ops_lib.tet_lookup_packed_plain(pk.lut_def, table, p, thr))
    # bytes: positions in, found/tet/bary out, the LUT and the 48-byte rows
    # read; ops: ~24 fp32 per candidate scored, 21 for the winner's bary
    lut_bytes, fan = lut_reads(pk.lut_def, 48, p)
    b_ms, b_by = bound(nbytes(p, fk, tk, bk) + lut_bytes, float(fan.sum()) * 24 + p.shape[0] * 21.0)
    print(
        f"[tetlookup] LOOKUP {label} N={p.shape[0]} threshold {thr:g}: {n_diff} points differ, all at near ties "
        f"({int(ties.sum())} near ties), bary max err {b_err:.3e} (bound 1e-5{', bit-equal required' if exact else ''}); "
        f"events {ms:.4f} ms, device {dev_ms:.4f} ms; "
        f"{'' if exact else f'plain {plain_ms:.4f} ms (padded LUT), {packed_ms:.4f} ms (packed LUT); '}bound {b_ms:.4f} ms ({b_by}), device/bound {dev_ms / b_ms:.2f}; found {float(fk.float().mean()):.4f}, "
        f"{float(fan.float().mean()):.2f} candidates per point, {float((fan > 0).float().mean()):.4f} of the points "
        f"with any",
        flush=True,
    )
    return dict(max_abs_err=b_err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=None,
                library_device_ms=None, bound_ms=b_ms, bound_by=b_by), (fk, tk)


def composition_samples(op, pos, direction):
    """The parent commit's launch pattern of the sample warp, on this
    commit's kernels: the lookup rows concatenated per call, two ``LOOKUP``
    launches, kernel D's two row takes and ~25 elementwise launches."""
    from nerfshop_tpu_torch.editing import operators as ops_lib
    from nerfshop_tpu_torch.ops.gather import take_rows

    pk = op.packed
    rows_def = ops_lib._table(op.v0_def, op.inv_def)
    in_target, tet, bary = ops_lib.tet_lookup_cuda(pk.lut_def, rows_def, pos, ops_lib._threshold(ops_lib.INCLUSIVE_EPS))
    delta = ops_lib._bary_delta(take_rows((op.verts_orig - op.verts_def).reshape(-1, 12).contiguous(), tet), bary)
    new_dir = ops_lib._rotate_back(take_rows(op.rot.reshape(-1, 9).contiguous(), tet), direction)
    pos_out = torch.where(in_target[:, None], pos + delta, pos)
    dir_out = torch.where(in_target[:, None], new_dir, direction)
    rows_orig = ops_lib._table(op.v0_orig, op.inv_orig)
    in_source = ops_lib.tet_lookup_cuda(pk.lut_orig, rows_orig, pos, ops_lib._threshold(ops_lib.STRICT_EPS))[0]
    return pos_out, dir_out, in_source & ~in_target & (not op.copy_mode), in_target


def warp_case(label, op, pos, direction, tets, exact=False):
    """Kernel E's ``WARP_SAMPLES`` and ``WARP_POSITIONS`` instances against
    the plain warp on ``pos``, ``direction`` → the numbers of both. ``tets``:
    (found, tet) of the ``LOOKUP`` instance on the deformed LUT at these
    points. The flags agree off near ties (of either lookup); where the
    kernel's tet agrees with the plain one, pos' and dir' are within 1e-5;
    ``exact``: flags equal everywhere, pos' bit-equal."""
    from nerfshop_tpu_torch.editing import operators as ops_lib

    pk = op.packed
    kernel = lambda: ops_lib.cage_warp_samples_cuda(op, pos, direction)  # noqa: E731
    kpos = lambda: ops_lib.cage_warp_positions_cuda(op, pos)  # noqa: E731
    ks, kp = kernel(), kpos()
    ps = ops_lib.cage_map_samples_plain(op, pos, direction)
    pp = ops_lib.cage_map_positions_plain(op, pos)
    t_def, t_orig = pk.records[ops_lib.REC_DEF], pk.records[ops_lib.REC_ORIG]
    tp = ops_lib.tet_lookup_plain(op.lut_def, t_def, pos, ops_lib._threshold(ops_lib.INCLUSIVE_EPS))[1]
    torch.cuda.synchronize()
    if exact:
        ties = torch.zeros_like(ks[2])
    else:
        ties = near_ties(op.lut_def, t_def, pos, ops_lib._threshold(ops_lib.INCLUSIVE_EPS))
        ties |= near_ties(op.lut_orig, t_orig, pos, ops_lib._threshold(ops_lib.STRICT_EPS))
    agree = (tets[1] == tp) & ~ties
    flags = [(ks[2], ps[2], "empty"), (ks[3], ps[3], "in_target"), (kp[1], pp[1], "kill")]
    n_flag = {name: int(((a != b) & ~ties).sum()) for a, b, name in flags}
    pos_err = max(float((ks[0] - ps[0]).abs()[agree].max()), float((kp[0] - pp[0]).abs()[agree].max()))
    dir_err = float((ks[1] - ps[1]).abs()[agree].max())
    check(sum(n_flag.values()) == 0 and pos_err <= 1e-5 and dir_err <= 1e-5,
          f"kernel E's warps disagree ({label}): flags off the near ties {n_flag}, pos err {pos_err:.3e}, "
          f"dir err {dir_err:.3e}")
    check(torch.equal(kp[0], ks[0]) and torch.equal(kp[1], ks[2]), f"WARP_POSITIONS differs from WARP_SAMPLES ({label})")
    if exact:
        check(torch.equal(ks[0].view(torch.int32), ps[0].view(torch.int32)), f"pos' is not bit-equal ({label})")
    ms, dev_ms = both_ms(kernel)
    pms, pdev_ms = both_ms(kpos)
    plain_ms = pplain_ms = comp_ms = comp_dev_ms = float("nan")
    if not exact:
        plain_ms = median_ms(lambda: ops_lib.cage_map_samples_plain(op, pos, direction))
        pplain_ms = median_ms(lambda: ops_lib.cage_map_positions_plain(op, pos))
        comp_ms, comp_dev_ms = both_ms(lambda: composition_samples(op, pos, direction))
    # bytes: p (and dir) in, pos' (and dir') and the flags out, the LUTs and
    # the rows read (48 bytes of lookup row a candidate, 84 of deltas and
    # rotation a winner); the strict lookup only for points outside the
    # target; ops: ~24 a candidate, ~60 a warped point
    in_t = ks[3]
    b1, fan1 = lut_reads(pk.lut_def, 48, pos)
    b2, fan2 = lut_reads(pk.lut_orig, 48, pos[~in_t]) if not op.copy_mode else (0, fan1[:0])
    winners = torch.unique(tets[1][in_t]).numel()
    cands = float(fan1.sum() + fan2.sum())
    n_in = int(in_t.sum())
    b_ms, b_by = bound(nbytes(pos, direction, *ks) + b1 + b2 + winners * 84, cands * 24 + n_in * 60.0)
    pb_ms, pb_by = bound(nbytes(pos, *kp) + b1 + b2 + winners * 48, cands * 24 + n_in * 40.0)
    print(
        f"[tetlookup] WARP_SAMPLES {label} N={pos.shape[0]}: flags off the near ties differ {n_flag} "
        f"({int(ties.sum())} near ties), pos' err {pos_err:.3e}, dir' err {dir_err:.3e} where the tets agree (bound 1e-5); "
        f"events {ms:.4f} ms, device {dev_ms:.4f} ms; "
        f"{'' if exact else f'plain warp {plain_ms:.4f} ms; the parent commit launch pattern (2 LOOKUP + 2 D + elementwise) events {comp_ms:.4f} ms, device {comp_dev_ms:.4f} ms; '}"
        f"bound {b_ms:.4f} ms "
        f"({b_by}), device/bound {dev_ms / b_ms:.2f}; in_target {n_in / pos.shape[0]:.4f}, empty "
        f"{float(ks[2].float().mean()):.4f}, candidates per point {cands / pos.shape[0]:.2f} (deformed "
        f"{float(fan1.float().mean()):.2f}, original for the points outside the target "
        f"{float(fan2.sum()) / pos.shape[0]:.2f})",
        flush=True,
    )
    print(
        f"[tetlookup] WARP_POSITIONS {label}: pos' and kill as WARP_SAMPLES's pos' and empty; events {pms:.4f} ms, "
        f"device {pdev_ms:.4f} ms; {'' if exact else f'plain warp {pplain_ms:.4f} ms; '}bound {pb_ms:.4f} ms ({pb_by}), device/bound "
        f"{pdev_ms / pb_ms:.2f}",
        flush=True,
    )
    common = dict(library_ms=None, library_device_ms=None)
    return (
        dict(max_abs_err=max(pos_err, dir_err), ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by=b_by, **common),
        dict(max_abs_err=pos_err, ms=pms, device_ms=pdev_ms, plain_ms=pplain_ms, bound_ms=pb_ms, bound_by=pb_by,
             **common),
    )


def random_points(op, g, N):
    """N points, 90% uniform in ``op``'s deformed LUT box and 10% beyond
    it, with random unit directions."""
    lut = op.lut_def
    dev = lut.cells.device
    size = lut.res / lut.inv_cell
    n_in = (N * 9) // 10
    p = torch.cat([
        lut.bbox_lo + torch.rand((n_in, 3), generator=g, device=dev) * size,
        lut.bbox_lo + size * (1.05 + torch.rand((N - n_in, 3), generator=g, device=dev)),
    ])
    return p, torch.nn.functional.normalize(torch.randn((N, 3), generator=g, device=dev), dim=1)


def phase_tetlookup(op, g, chunk, N=1 << 20):
    """Kernel E's three instances against their plain versions: the
    ``LOOKUP`` on 2^20 random points, 90% inside the moved cage's deformed
    LUT box and 10% outside, strict and inclusive, and on the positions the
    edited frame's middle chunk sent through the moved cage (``chunk``:
    positions and directions); the two warps on the same points with random
    directions and on the chunk; then all three on :func:`tie_nan_op`'s LUTs,
    bit-equal. → {instance: the numbers of the kernels line (the chunk's)}."""
    from nerfshop_tpu_torch.editing import operators as ops_lib

    lut, pk = op.lut_def, op.packed
    p, d = random_points(op, g, N)
    incl = ops_lib._threshold(ops_lib.INCLUSIVE_EPS)
    for eps in (ops_lib.INCLUSIVE_EPS, ops_lib.STRICT_EPS):
        _, tets = lookup_case(f"eps {eps:g} random points (90% in the LUT box)", op, p, ops_lib._threshold(eps))
        if eps < 0:
            warp_case("random points (90% in the LUT box)", op, p, d, tets)
    result = {}
    result["tet_lookup"], tets = lookup_case("edited 1080p frame's middle chunk", op, chunk[0], incl)
    result["cage_warp_samples"], result["cage_warp_positions"] = warp_case(
        "edited 1080p frame's middle chunk", op, *chunk, tets)

    syn = tie_nan_op(op)
    nt = op.v0_def.shape[0]
    _, (found, tet) = lookup_case("tie and NaN LUT, random points", syn, p, incl, exact=True)
    check(bool(((tet >= nt) & (tet < 2 * nt))[found].all()) and not bool((tet == 2 * nt).any()) and bool(found.any()),
          "kernel E broke the tie rule (the earlier copy must win) or let a NaN score win")
    warp_case("tie and NaN LUT, random points", syn, p, d, (found, tet), exact=True)
    base = ops_lib.tet_lookup_cuda(pk.lut_def, pk.records[ops_lib.REC_DEF], p, incl)
    torch.cuda.synchronize()
    check(torch.equal(found, base[0]) and torch.equal(torch.where(found, tet - nt, tet), torch.where(found, base[1], tet)),
          "the tie and NaN LUT changed which tets the points find")

    def mib(n):
        return f"{n / 2**20:.2f} MiB"

    fan = (lut.cells >= 0).sum(dim=1)
    nz = fan[fan > 0].float()
    padded = nbytes(op.lut_def.cells) + nbytes(op.lut_orig.cells)
    packed = pk.lut_def.nbytes() + pk.lut_orig.nbytes()
    print(
        f"[tetlookup] LUTs {lut.res}^3: deformed fanout max {int(fan.max())} mean {float(nz.mean()):.2f} over "
        f"{nz.numel()} non-empty cells; both LUTs padded [res^3, {lut.cells.shape[1]}] + "
        f"[res^3, {op.lut_orig.cells.shape[1]}] {mib(padded)}, packed (offsets + ids) {mib(packed)}; records "
        f"{mib(nbytes(pk.records))} for {nt} tets",
        flush=True,
    )
    return result


# ------------------------------------------------------------ the membrane


def membrane_case(label, op, pos, direction, exact=False):
    """Kernel E's ``WARP_MEMBRANE`` instance against its plain version (the
    JAX composition) on ``pos``, ``direction`` → (its numbers, the share of
    in-target points that pass the membrane's gate). Off near ties the flags
    and the tet (the ``LOOKUP`` instance's against the plain lookup's)
    agree; where the tets agree, pos' and dir' are within 1e-5 and the
    three residuals within 1e-5 absolute plus 1e-5 relative. ``exact``:
    flags, tet and pos' bit-equal everywhere, the residuals within the same
    bound."""
    from nerfshop_tpu_torch.editing import operators as ops_lib

    pk, N = op.packed, pos.shape[0]
    incl = ops_lib._threshold(ops_lib.INCLUSIVE_EPS)
    dev = pos.device

    def accs():
        return (torch.zeros((N,), device=dev), torch.zeros((N,), device=dev), torch.zeros((N, 3), device=dev))

    acc = accs()
    kernel_out = ops_lib.cage_warp_membrane_cuda(op, pos, direction, *acc)
    plain = ops_lib.cage_map_membrane_plain(op, pos, direction)
    found_k, tet_k, _ = ops_lib.tet_lookup_cuda(pk.lut_def, pk.records[ops_lib.REC_DEF], pos, incl)
    tet_p = ops_lib.tet_lookup_plain(op.lut_def, pk.records[ops_lib.REC_DEF], pos, incl)[1]
    torch.cuda.synchronize()
    if exact:
        ties = torch.zeros_like(found_k)
    else:
        ties = near_ties(op.lut_def, pk.records[ops_lib.REC_DEF], pos, incl)
        ties |= near_ties(op.lut_orig, pk.records[ops_lib.REC_ORIG], pos, ops_lib._threshold(ops_lib.STRICT_EPS))
    agree = (tet_k == tet_p) & ~ties
    flags = {"empty": (kernel_out[2], plain[2]), "in_target": (kernel_out[3], plain[3]), "tet": (tet_k, tet_p)}
    n_flag = {k: int(((a != b) & ~ties).sum()) for k, (a, b) in flags.items()}
    pos_err = float((kernel_out[0] - plain[0]).abs()[agree].max())
    dir_err = float((kernel_out[1] - plain[1]).abs()[agree].max())
    res_err = 0.0
    for k, p in zip(acc, plain[4:]):
        over = ((k - p).abs() - 1e-5 * p.abs())[agree]
        res_err = max(res_err, float(over.max()))
    check(sum(n_flag.values()) == 0 and pos_err <= 1e-5 and dir_err <= 1e-5 and res_err <= 1e-5,
          f"WARP_MEMBRANE disagrees with its plain version ({label}): flags off the near ties {n_flag}, pos err "
          f"{pos_err:.3e}, dir err {dir_err:.3e}, residual err beyond 1e-5 relative {res_err:.3e}")
    if exact:
        check(torch.equal(kernel_out[0].view(torch.int32), plain[0].view(torch.int32)), f"pos' is not bit-equal ({label})")
    in_t = kernel_out[3]
    n_in = int(in_t.sum())
    gated = float((in_t & (acc[1] > 1e-9)).sum()) / max(n_in, 1)
    # timing: each call adds into the same accumulators (the values are not read)
    kernel = lambda: ops_lib.cage_warp_membrane_cuda(op, pos, direction, *acc)  # noqa: E731
    ms, dev_ms = both_ms(kernel)
    plain_ms = float("nan") if exact else median_ms(lambda: ops_lib.cage_map_membrane_plain(op, pos, direction))
    # bytes: p and dir in, pos', dir' and the flags out, the LUTs and rows
    # read, a winner's deltas, rotation and 480-byte membrane row, and the
    # accumulators read and written at the in-target points; ops: ~24 a
    # candidate scored, ~60 a warped point and ~250 its membrane sums
    b1, fan1 = lut_reads(pk.lut_def, 48, pos)
    b2, fan2 = lut_reads(pk.lut_orig, 48, pos[~in_t]) if not op.copy_mode else (0, fan1[:0])
    winners = torch.unique(tet_k[in_t]).numel()
    cands = float(fan1.sum() + fan2.sum())
    b_ms, b_by = bound(nbytes(pos, direction, *kernel_out) + b1 + b2 + winners * (84 + 480) + n_in * 40,
                       cands * 24 + n_in * 310.0)
    print(
        f"[membrane] WARP_MEMBRANE {label} N={N}: flags and tet off the near ties differ {n_flag} "
        f"({int(ties.sum())} near ties), pos' err {pos_err:.3e}, dir' err {dir_err:.3e}, residuals beyond 1e-5 "
        f"relative {res_err:.3e} where the tets agree (bound 1e-5{', bit-equal flags, tet and pos required' if exact else ''}); "
        f"events {ms:.4f} ms, device {dev_ms:.4f} ms; {'' if exact else f'plain {plain_ms:.4f} ms; '}bound {b_ms:.4f} ms "
        f"({b_by}), device/bound {dev_ms / b_ms:.2f}; in_target {n_in / N:.4f}, gated share of in-target points "
        f"{gated:.4f}, residual sigma max {float(acc[0].max()):.4g}",
        flush=True,
    )
    check(gated > 0 or exact, f"no in-target point passes the membrane's gate ({label}): the membrane tests nothing")
    return dict(max_abs_err=max(pos_err, dir_err, res_err), ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, library_device_ms=None), gated


def phase_membrane(tb, gs, op_moved, g, chunk, W=1920, H=1080):
    """The Poisson membrane of the moved cage through
    ``GrowingSelection.compute_membrane``; ``WARP_MEMBRANE`` against its plain
    version on the edited frame's middle chunk (``chunk``), on 2^20 random
    points and on the tie and NaN LUTs; then the 1080p frame of the stack
    with the membrane ("target" blend) against the same stack without it
    → (the operator with the membrane, the kernels-line numbers, one
    membrane frame's launches)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs.compute_membrane(tb.inference_params, tb.generator, grid=tb.grid)
    torch.cuda.synchronize()
    mem_s = time.perf_counter() - t0
    op_mem = op_moved._replace(membrane=gs.membrane)
    m = gs.membrane
    check(m.packed.shape == (op_moved.v0_def.shape[0], 120) and bool(torch.isfinite(m.packed).all()),
          "the membrane's packed rows are not finite / of the expected shape")
    print(
        f"[membrane] compute_membrane {mem_s:.3f} s: {gs.cage.n_vertices} cage vertices x 100 directions x 2, "
        f"{m.packed.shape[0]} tets; residual density max {float(m.density.max()):.4g}, outside density max "
        f"{float(m.outside_density.max()):.4g}, mean {float(m.outside_density.mean()):.4g}",
        flush=True,
    )
    numbers, gated = membrane_case("edited 1080p frame's middle chunk", op_mem, *chunk)
    membrane_case("random points (90% in the LUT box)", op_mem, *random_points(op_mem, g, 1 << 20))
    p, d = random_points(op_mem, g, 1 << 20)
    membrane_case("tie and NaN LUT, random points", tie_nan_op(op_mem), p, d, exact=True)

    # the 1080p frame with the membrane against the same stack without it
    tb.set_look_at(eye=SIDE_EYE)
    tb.replace_edit_operator(0, op_mem)
    torch.cuda.synchronize()
    reset_launches()
    img = tb.render(W, H, spp=1, exact=True)
    torch.cuda.synchronize()
    launches = read_launches()
    chunks = -(-W * H // 8192)
    check(img.shape == (H, W, 4) and np.isfinite(img).all(), "the membrane frame is not finite / of the expected shape")
    check(launches["cage_warp_membrane"] == chunks and launches["tet_lookup"] == 0 and launches["cage_warp_samples"] == 0,
          f"the membrane frame did not run one WARP_MEMBRANE launch a chunk and no other cage launch: {launches}")
    check(launches["grid_encode_fracs"] == 0, "kernel B wrote fracs in the membrane frame")
    _, mem_times = timed_frames(tb, W, H)
    tb.replace_edit_operator(0, op_moved)
    plain_img, plain_times = timed_frames(tb, W, H)
    diff = float(np.abs(img[..., :3] - plain_img[..., :3]).mean())
    tb.replace_edit_operator(0, op_mem)
    print(
        f"[membrane] {W}x{H} frame of the stack with the membrane (target blend) median of 3 "
        f"{statistics.median(mem_times) * 1e3:.1f} ms ({[round(t * 1e3, 1) for t in mem_times]}) vs without "
        f"{statistics.median(plain_times) * 1e3:.1f} ms ({[round(t * 1e3, 1) for t in plain_times]}); mean |drgb| "
        f"{diff:.5f}; gated share at the middle chunk {gated:.4f}; launches in one membrane frame {launches}",
        flush=True,
    )
    return op_mem, numbers, launches


def phase_distill(tb, W=256, H=256, steps=300):
    """Distill the edited scene (the stack with the membrane and the affine
    duplicate) into a standalone student, in the order of
    ``scripts/edit_demo.py``: refresh the edited grid, distill with the
    default ``DistillConfig`` at the trained scene's aabb_scale and
    cone_angle, then render the student without operators over a grid
    refreshed from it and score it against the edited render of the same
    side view (bound 25 dB, ``tests/test_distill.py``) → the launches of
    the distillation."""
    from nerfshop_tpu_torch.train import distill as distill_lib
    from nerfshop_tpu_torch.utils import metrics

    tb.set_look_at(eye=SIDE_EYE)
    tb.refresh_grid_for_edits()
    edited = tb.render(W, H, spp=1, exact=True)
    grid = tb.grid
    saved = (grid.density.clone(), grid.occupancy.clone(), grid.mean_density.clone())
    cfg = distill_lib.DistillConfig(aabb_scale=tb.train_config.aabb_scale, cone_angle=tb.train_config.cone_angle)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    student = distill_lib.distill(tb.model, tb.inference_params, tuple(tb.edit_operators), tb._device_data, grid,
                                  tb.generator, n_steps=steps, cfg=cfg)
    torch.cuda.synchronize()
    distill_s = time.perf_counter() - t0
    launches = read_launches()
    n_membrane = sum(op.membrane is not None for op in tb.edit_operators if hasattr(op, "membrane"))
    check(launches["grid_encode_fracs"] == 2 * steps,
          f"a distillation step did not launch kernel B with fracs for the student's two forwards only: {launches}")
    check(launches["grid_encode"] > launches["grid_encode_fracs"] and launches["segsum"] > 0,
          f"the teacher or the student's backward did not run: {launches}")
    check(launches["cage_warp_membrane"] == 2 * steps * n_membrane and launches["tet_lookup"] == 0,
          f"the teacher did not warp through WARP_MEMBRANE once per sample set: {launches}")
    # one step more, for the loss the student has reached
    aux = distill_lib.distill_step(student, tb.inference_params, tuple(tb.edit_operators), grid, tb._device_data, cfg,
                                   tb.generator)
    # the student alone: no operators, a grid refreshed from its own field
    teacher = (tb._state, tb._model, tb._edit_operators)
    tb._state, tb._model, tb._edit_operators = student, student.model, []
    try:
        tb.refresh_grid_for_edits()
        distilled = tb.render(W, H, spp=1, exact=True)
    finally:
        tb._state, tb._model, tb._edit_operators = teacher
        grid.density.copy_(saved[0])
        grid.occupancy, grid.mean_density = saved[1], saved[2]
    fin = np.isfinite(edited[..., :3]).all(-1) & np.isfinite(distilled[..., :3]).all(-1)
    value = metrics.psnr(distilled[..., :3][fin], edited[..., :3][fin])
    print(
        f"[distill] {steps} steps (rays {cfg.n_rays_per_batch} x {cfg.k_samples}, {cfg.n_free_samples} free and "
        f"{cfg.n_edit_samples} edit samples, aabb_scale {cfg.aabb_scale}, cone_angle {cfg.cone_angle}) in "
        f"{distill_s:.3f} s: {steps / distill_s:.3f} steps/s; loss of one step more {float(aux['loss']):.4e} (field "
        f"{float(aux['field_loss']):.4e}, pixel {float(aux['pixel_loss']):.4e}, photo {float(aux['gt_loss']):.4e}); "
        f"distilled vs edited {W}x{H} side view PSNR {value:.2f} dB (bound 25), {int(fin.sum())} finite pixels; "
        f"launches {launches}",
        flush=True,
    )
    check(np.isfinite(distilled).all() and fin.all(), "the distilled render is not finite")
    check(value >= 25.0, f"distilled vs edited PSNR {value:.2f} dB < 25")
    return launches


def phase_native(tb, gs):
    """The native host library against the numpy paths: the smoke cage's LUT
    build (both LUTs, cells equal but for face-plane rounding ties, both
    times), the region growing from the scribble's seed cells against the
    Python BFS, and ``vanish`` on the edited grid."""
    from nerfshop_tpu_torch.editing import selection as sel_lib
    from nerfshop_tpu_torch.editing.tet_mesh import LUT_RES_DEFAULT, MAX_TETS_PER_CELL

    tm = gs.tet_mesh
    t0 = time.perf_counter()
    luts = [tm._voxelize_full(v, LUT_RES_DEFAULT, MAX_TETS_PER_CELL) for v in (tm.vertices_deformed, tm.vertices_original)]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plains = [tm._voxelize_plain(v, LUT_RES_DEFAULT, c.shape[1]) for v, (_, _, c) in
              zip((tm.vertices_deformed, tm.vertices_original), luts)]
    plain_s = time.perf_counter() - t0
    rows = []
    for (lo, ic, cells), (plo, pic, pcells, _) in zip(luts, plains):
        check(np.array_equal(lo, plo) and np.array_equal(ic, pic) and cells.shape == pcells.shape,
              "the native LUT's box or fanout differs from the numpy path's")
        diff = np.nonzero((cells != pcells).any(axis=1))[0]
        extra = max((len(set(cells[r][cells[r] >= 0]) ^ set(pcells[r][pcells[r] >= 0])) for r in diff), default=0)
        rows.append((len(diff), extra))
        check(len(diff) <= max(1, cells.shape[0] // 100000) and extra <= 1,
              f"the native LUT differs from the numpy path's beyond face-plane rounding ties: {len(diff)} cells, "
              f"{extra} tets")
    print(
        f"[native] LUT build {LUT_RES_DEFAULT}^3, both LUTs of {tm.n_tets} tets: native {native_s:.3f} s, numpy "
        f"{plain_s:.3f} s ({plain_s / native_s:.1f}x); widths {[c.shape[1] for _, _, c in luts]}; cells that differ "
        f"(count, tets) deformed {rows[0]}, original {rows[1]}",
        flush=True,
    )
    dens = tb.grid.density.cpu().numpy()
    grown = []
    for name in ("grow", "grow_plain"):
        rg = sel_lib.RegionGrowing(density=dens, density_threshold=gs.density_threshold)
        rg.reset(gs.projected_cells)
        t0 = time.perf_counter()
        n = getattr(rg, name)(1 << 30)
        grown.append((n, rg, time.perf_counter() - t0))
    (n_nat, rg_nat, s_nat), (n_bfs, rg_bfs, s_bfs) = grown
    check(np.array_equal(rg_nat.selection, rg_bfs.selection) and rg_nat.growing_level == rg_bfs.growing_level
          and n_nat == n_bfs > 0, f"native region growing differs from the BFS: {n_nat} vs {n_bfs} cells")
    g = tb.grid
    before = int((g.density == 0).sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vanished = gs.vanish(g)
    torch.cuda.synchronize()
    vanish_s = time.perf_counter() - t0
    cleared = int((vanished.density == 0).sum()) - before
    check(cleared > 0 and bool(torch.equal(g.density == 0, (g.density == 0) & (vanished.density == 0))),
          f"vanish cleared no cells ({cleared}) or restored one")
    occ_before, occ_after = float(g.occupancy.float().mean()), float(vanished.occupancy.float().mean())
    check(occ_after < occ_before, f"vanish left the occupancy at {occ_after:.5f} (was {occ_before:.5f})")
    print(
        f"[native] region growing from {len(gs.projected_cells)} seed cells: native {s_nat * 1e3:.1f} ms, Python BFS "
        f"{s_bfs * 1e3:.1f} ms, {n_nat} cells, the same selection; vanish on the edited grid {vanish_s * 1e3:.1f} ms: "
        f"{cleared} more cells at density 0, occupancy {occ_before:.5f} -> {occ_after:.5f}",
        flush=True,
    )



# ---------------------------------------------------- the other testbeds


def icosphere(subdiv: int):
    """The unit icosphere → (vertices [V, 3], faces [F, 3] int64, outward),
    20 · 4^subdiv faces, by midpoint subdivision."""
    t = (1 + 5**0.5) / 2
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                  [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5], [2, 4, 11],
                  [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdiv):
        F = len(f)
        edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = v[uniq].mean(1)
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        inv = inv.reshape(-1) + len(v)
        ab, bc, ca = inv[:F], inv[F:2 * F], inv[2 * F:]
        a, b, c = f.T
        v = np.concatenate([v, mid])
        f = np.concatenate([np.stack(q, 1) for q in ((a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca))])
    return v, f


def bumpy_mesh(subdiv: int = 6):
    """The [sdf] mesh: an icosphere subdivided ``subdiv`` times (81920 faces
    at 6), displaced radially by a smooth bump field, so that it is closed
    but neither a sphere nor convex."""
    from nerfshop_tpu_torch.geometry import mesh_io

    v, f = icosphere(subdiv)
    x, y, z = v.T
    r = 1 + 0.12 * np.sin(5 * x) * np.cos(4 * y) * np.sin(3 * z + 1) + 0.04 * np.sin(11 * x + 7 * y)
    return mesh_io.TriMesh((v * r[:, None]).astype(np.float32), f.astype(np.int32))


def training_lines(lines, steps):
    """(steps/s between the CLI's "training" and "trained in" lines, the loss
    of every printed chunk)."""
    t_a = next(t for t, line in lines if line.startswith("training"))
    t_b = next(t for t, line in lines if line.startswith("trained in"))
    losses = [float(line.split("loss")[1].split()[0]) for _, line in lines if line.lstrip().startswith("step")]
    return steps / (t_b - t_a), losses, t_a


#: the seed of kernel G's timing and checking points, so that two versions
#: of the kernel are timed on the same points
G_SEED = 2718


def g_points(sdf) -> dict:
    """Kernel G's points on the SDF testbed ``sdf``, drawn from its
    generator reseeded with :data:`G_SEED`: "2^15", a training batch's
    ground-truth points (3/4 near the surface, 1/4 uniform); "2^18", uniform
    points in the unit box (an IoU's); "near features", 4096 points within
    1e-4 of the mesh's vertices (half) and of points on its edges (half),
    where triangles tie and the pseudo-normal chosen matters."""
    gen, dev = sdf.generator, sdf.device
    gen.manual_seed(G_SEED)
    batch = sdf._sample_batch(1 << 16)[0][sdf.batch_sizes(1 << 16)[0]:].contiguous()
    uniform = torch.rand((1 << 18, 3), generator=gen, device=dev)
    v = torch.as_tensor(sdf.mesh_vertices, device=dev)
    f = torch.as_tensor(sdf.mesh_faces.astype(np.int64), device=dev)
    vert = v[torch.randint(v.shape[0], (2048,), generator=gen, device=dev)]
    fi = torch.randint(f.shape[0], (2048,), generator=gen, device=dev)
    k = torch.randint(3, (2048,), generator=gen, device=dev)
    a, b = v[f[fi, k]], v[f[fi, (k + 1) % 3]]
    edge = a + torch.rand((2048, 1), generator=gen, device=dev) * (b - a)
    step = torch.randn((4096, 3), generator=gen, device=dev)
    step *= 1e-4 * torch.rand((4096, 1), generator=gen, device=dev) / step.norm(dim=1, keepdim=True)
    return {"2^15": batch, "2^18": uniform, "near features": (torch.cat([vert, edge]) + step).contiguous()}


def phase_sdf(workdir: Path, W=1920, H=1080, steps=1000):
    """[sdf]: the bumpy 81920-face mesh written as .obj and trained through
    ``run.main(["--mode", "sdf", ...])`` (1000 steps at batch 2^16, the
    loss falling); kernel G against its plain version (the brute force) on
    4096 of a training batch's points, 4096 uniform ones and 4096 near the
    mesh's vertices and edges (:func:`g_points`, from a fixed seed; max
    |Δd| ≤ 1e-5, no sign disagreement where |d| > 1e-6), timed at 2^15 (a
    batch's ground-truth points) and 2^18 points (the IoU's);
    ``calculate_iou`` ≥ 0.9 through one launch of G; a 1920×1080 ``render``
    → ({path: launches}, G's numbers)."""
    from nerfshop_tpu_torch.geometry import bvh as bvh_lib
    from nerfshop_tpu_torch.geometry import mesh_io

    mesh = bumpy_mesh()
    check(mesh.n_faces == 81920, f"the [sdf] mesh has {mesh.n_faces} faces")
    obj = workdir / "bumpy.obj"
    mesh_io.save_obj(obj, mesh)
    tb, lines, t0, train_launches = stamped_main(
        ["--mode", "sdf", "--scene", str(obj), "--n_steps", str(steps), "--batch_size", str(1 << 16), "--device", "cuda"])
    steps_s, losses, t_train = training_lines(lines, steps)
    check(tb.mode.value == "sdf" and tb.stats.step == steps, f"the SDF CLI trained {tb.stats.step} steps")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], f"the SDF loss did not fall: {losses}")
    check_launched(train_launches, ("bvh_signed_distance", "grid_encode", "segsum"), "SDF training path")
    check(train_launches["bvh_signed_distance"] == steps, f"kernel G not once a step: {train_launches}")

    sdf = tb.sdf
    packed = sdf.packed_bvh
    bvh = packed.bvh
    tris = bvh.triangles()
    pts = g_points(sdf)
    errs, flips = {}, {}
    for label, p in (("batch", pts["2^15"][::8].contiguous()), ("uniform", pts["2^18"][:4096].contiguous()),
                     ("near features", pts["near features"])):
        d_k = bvh_lib.bvh_signed_distance_cuda(packed, p)
        d_p = bvh_lib.signed_distance_plain(tris, p)
        torch.cuda.synchronize()
        errs[label] = float((d_k - d_p).abs().max())
        clear = d_p.abs() > 1e-6
        flips[label] = float((torch.sign(d_k[clear]) != torch.sign(d_p[clear])).float().mean())
        check(errs[label] <= 1e-5 and flips[label] == 0.0,
              f"kernel G disagrees ({label}): max |dd| {errs[label]:.3e}, sign flips {flips[label]}")
    bvh_bytes = sum(nbytes(t) for t in bvh)
    packed_bytes = nbytes(packed.nodes, packed.tris)
    timing = {}
    for label in ("2^15", "2^18"):
        p = pts[label]
        ms, dev_ms = both_ms(lambda: bvh_lib.bvh_signed_distance_cuda(packed, p))
        # the bound keeps its first definition: the points, the output and
        # the BvhArrays once (the packed bytes are printed beside it)
        b_ms, b_by = bound(nbytes(p) + p.shape[0] * 4 + bvh_bytes)
        timing[label] = dict(ms=ms, device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by)
    # the brute force at 2^15 takes seconds a call: one timed call (its
    # kernels warmed up by the comparison above)
    plain_ms = median_ms(lambda: bvh_lib.signed_distance_plain(tris, pts["2^15"]), runs=1, warmups=0)
    t_pack = time.perf_counter()
    bvh_lib.pack_bvh(bvh)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t_pack

    torch.cuda.synchronize()
    reset_launches()
    iou = tb.calculate_iou()
    torch.cuda.synchronize()
    iou_launches = read_launches()
    check(iou >= 0.9, f"SDF IoU {iou:.4f} < 0.9")
    check(iou_launches["bvh_signed_distance"] == 1, f"the IoU's 2^18 points did not go through kernel G once: {iou_launches}")
    tb.render(64, 36)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    img = tb.render(W, H)
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t1) * 1e3
    render_launches = read_launches()
    hit = float(img[..., 3].mean())
    check(img.shape == (H, W, 4) and bool(np.isfinite(img).all()) and 0.05 < hit < 0.95,
          f"the SDF frame is bad: {img.shape}, hit share {hit}")
    check_launched(render_launches, ("grid_encode", "fused_mlp", "grid_encode_dx"), "SDF frame")
    check(render_launches["grid_encode_fracs"] == 0 and render_launches["segsum"] == 0,
          f"the SDF frame wrote fracs or ran kernel A: {render_launches}")
    print(f"[sdf] run.main --mode sdf on a {mesh.n_faces}-face bumpy icosphere: load + BVH build "
          f"{t_train - t0:.3f} s, {steps} steps batch {1 << 16} at {steps_s:.3f} steps/s, loss by 100 steps "
          f"{losses}; launches {train_launches}", flush=True)
    print(f"[sdf] kernel G vs brute force: max |dd| {errs} (bound 1e-5), sign disagreements where |d| > 1e-6 {flips} "
          f"(bound 0); BVH {bvh.node_min.shape[0]} nodes, {bvh_bytes / 1e6:.2f} MB; packed {packed.nodes.shape[0]} "
          f"records and {packed.tris.shape[0]} triangles, {packed_bytes / 1e6:.3f} MB, depth {packed.depth}, packed in "
          f"{pack_s:.3f} s; timing points from seed {G_SEED}: " + "; ".join(
              f"{k} points: events {v['ms']:.4f} ms, device {v['device_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']}), device/bound {v['device_ms'] / v['bound_ms']:.1f}" for k, v in timing.items())
          + f"; brute force at 2^15 {plain_ms:.2f} ms (at 2^18 not measured)", flush=True)
    print(f"[sdf] calculate_iou {iou:.5f} (bound 0.9); {W}x{H} render {render_ms:.1f} ms, hit share {hit:.4f}, "
          f"launches B {render_launches['grid_encode']} C {render_launches['fused_mlp']} "
          f"F {render_launches['grid_encode_dx']} G {render_launches['bvh_signed_distance']}", flush=True)
    g_row = dict(max_abs_err=max(errs.values()), plain_ms=plain_ms, library_ms=None, library_device_ms=None,
                 **timing["2^15"])
    return {"sdf_train": train_launches, "sdf_iou": iou_launches, "sdf_render": render_launches}, g_row


def detail_image(H=2048, W=2048):
    """[image]'s target: RGB with detail at every scale: sinusoids from 2 to
    256 cycles across, a checkerboard of 64-pixel squares and discs of
    radius 8 to 400 pixels."""
    y, x = (np.mgrid[0:H, 0:W] + 0.5) / np.array([H, W], np.float64)[:, None, None]
    waves = sum(a * np.sin(2 * np.pi * (k * x + 0.6 * k * y)) for a, k in ((0.2, 2), (0.12, 9), (0.08, 37), (0.05, 256)))
    check_board = ((x * W // 64).astype(int) + (y * H // 64).astype(int)) % 2
    discs = np.zeros_like(x)
    for cx, cy, r in ((0.3, 0.3, 400), (0.7, 0.6, 150), (0.5, 0.85, 40), (0.85, 0.2, 8), (0.15, 0.8, 20)):
        discs += np.hypot((x - cx) * W, (y - cy) * H) < r
    img = np.stack([0.5 + waves, 0.25 + 0.5 * check_board + 0.5 * waves * y, 0.2 + 0.6 * np.clip(discs, 0, 1) * x], -1)
    return np.clip(img, 0, 1).astype(np.float32)


def phase_image(dev, g, workdir: Path, steps=1000):
    """[image]: kernel B at D = 2 against its plain version at 2^18 uniform
    points of configs/image/base.json's grid (a table uniform in ±1), with
    and without fracs; kernel A at D = 2 on those points' sorted keys at a
    dense and a hashed level; a 2048×2048 image written as PNG and trained
    through ``run.main(["--mode", "image", ...])`` (1000 steps at batch
    2^18: steps/s, peak memory; its ``image_psnr`` line read back);
    ``compute_image_mse`` as PSNR ≥ 18 dB; the backward's corner fold and
    concatenation timed on one step → ({path: launches}, B's and A's
    numbers)."""
    from nerfshop_tpu_torch.config import default_image_config
    from nerfshop_tpu_torch.data import image_io
    from nerfshop_tpu_torch.models.encodings import build_encoding
    from nerfshop_tpu_torch.ops import segsum, table_ops

    enc = build_encoding(default_image_config()["encoding"], 2, device=dev, generator=g)
    check(enc.table_size == 139_810_048, f"not configs/image/base.json's grid: {enc.table_size} rows")
    with torch.no_grad():
        enc.table.uniform_(-1.0, 1.0, generator=g)
    table = enc.table.detach()
    x = torch.rand((1 << 18, 2), generator=g, device=dev)
    x[:4] = torch.tensor([[0, 0], [1, 1], [1, 0], [0, 1]], device=dev)
    b_rows = {m: encode_case("2^18 uniform xy, configs/image/base.json", enc, table, x, m, tag="image")
              for m in (True, False)}
    _, idx, w1 = table_ops.grid_encode_cuda(table, x, enc, True)
    dout = torch.randn((x.shape[0], 2), generator=g, device=dev)
    a_rows = {}
    for l in (0, enc.n_levels - 1):
        key, perm = torch.sort(idx[l], stable=True)
        kind = "dense" if enc.level_dense[l] else "hash"
        a_rows[l] = segsum_case("image", f"one step's sorted keys, level {l} ({kind})", key.contiguous(),
                                w1[l][perm].contiguous(), dout[perm].contiguous(), enc.level_sizes[l])
    del enc, table, idx, w1

    png = workdir / "detail.png"
    image_io.write_image(png, detail_image(), linear_input=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tb, lines, t0, launches = stamped_main(
        ["--mode", "image", "--scene", str(png), "--n_steps", str(steps), "--batch_size", str(1 << 18), "--device", "cuda"])
    peak = torch.cuda.max_memory_allocated()
    steps_s, losses, t_train = training_lines(lines, steps)
    cli = json.loads(lines[-1][1])
    mse = tb.compute_image_mse()
    value = -10 * math.log10(mse)
    check(tb.mode.value == "image" and tb.stats.step == steps, f"the Image CLI trained {tb.stats.step} steps")
    check(losses[-1] < losses[0], f"the Image loss did not fall: {losses}")
    check(value >= 18.0, f"Image PSNR {value:.2f} dB < 18")
    check(abs(cli["image_psnr"] - value) < 1e-6, f"the CLI's image_psnr {cli} is not compute_image_mse's {value}")
    check(launches["grid_encode_d2"] > 0 and launches["segsum_d2"] > 0 and launches["fused_mlp"] > 0,
          f"a kernel of the Image path was not launched: {launches}")

    # the table backward of one step, by part: sort + kernel A, the corner
    # fold (2^D rolls and adds a level), the concatenation of the levels
    enc = tb.model.encoding
    tab = enc.table.detach()
    _, idx, w1 = table_ops.grid_encode_cuda(tab, torch.rand((1 << 18, 2), generator=g, device=dev), enc, True)
    ct = torch.randn((1 << 18, 2 * enc.n_levels), generator=g, device=dev)
    L, N = idx.shape
    keys_s, perm = torch.sort(idx, dim=1, stable=True)
    w1_s = torch.gather(w1, 1, perm[:, :, None].expand(L, N, 2))
    ct_s = torch.gather(ct.reshape(N, L, 2).transpose(0, 1), 1, perm[:, :, None].expand(L, N, 2))
    dBs = [segsum.sorted_segment_rowsum_cuda(keys_s[l].contiguous(), w1_s[l].contiguous(), ct_s[l].contiguous(),
                                              enc.level_sizes[l]) for l in range(L)]
    fold_ms = median_ms(lambda: [table_ops.fold_corners(dB, enc, l) for l, dB in enumerate(dBs)], runs=5)
    folded = [table_ops.fold_corners(dB, enc, l) for l, dB in enumerate(dBs)]
    cat_ms = median_ms(lambda: torch.cat(folded, dim=0), runs=5)
    grad_ms = median_ms(lambda: table_ops.table_grad(idx, w1, ct, enc), runs=5)
    del dBs, folded
    print(f"[image] run.main --mode image on a 2048x2048 PNG: load {t_train - t0:.3f} s, {steps} steps batch "
          f"{1 << 18} at {steps_s:.3f} steps/s, loss by 100 steps {losses}, peak memory {peak / 2**30:.3f} GiB; "
          f"the CLI's line {json.dumps(cli)}; compute_image_mse PSNR {value:.3f} dB (bound 18); launches {launches}",
          flush=True)
    print(f"[image] one step's table backward (events): table_grad {grad_ms:.3f} ms, of which the corner fold "
          f"{fold_ms:.3f} ms ({sum(1 for sh in enc.brick_shifts for v in sh if v)} rolls and their adds over {L} "
          f"levels, {enc.table_size} rows) and the concatenation {cat_ms:.3f} ms "
          f"({enc.table_size * 8 / 2**30:.3f} GiB)",
          flush=True)
    return {"image": launches}, b_rows[True], a_rows[enc.n_levels - 1]


def phase_volume(dev, workdir: Path, steps=1000, W=1920, H=1080):
    """[volume]: ``synthetic_smoke(256)`` written as .npy and loaded through
    ``Testbed.load_training_data``; 1000 steps at batch 2^16 (the last loss
    < 0.5 × the first); a 1920×1080 render at spp 4; a 64×64 render at spp 8
    against the ground-truth tracker's (mean |Δα| < 0.25) → {path: launches}."""
    from nerfshop_tpu_torch.testbed import Testbed
    from nerfshop_tpu_torch.train import volume as volume_train

    t0 = time.perf_counter()
    vol = volume_train.synthetic_smoke(256)
    npy = workdir / "smoke.npy"
    np.save(npy, vol)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tb = Testbed("volume", device=dev, seed=0)
    tb.load_training_data(str(npy))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    first = tb.train(1, 1 << 16)
    last = tb.train(steps - 1, 1 << 16)
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    check(math.isfinite(last) and last < 0.5 * first, f"the Volume loss did not halve: {first} -> {last}")
    check_launched(train_launches, ("grid_encode", "segsum"), "Volume training path")
    tb.render(64, 36)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    img = tb.render(W, H)
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3
    render_launches = read_launches()
    check(img.shape == (H, W, 4) and bool(np.isfinite(img).all()) and float(img[..., 3].mean()) > 0.01,
          f"the Volume frame is bad: {img.shape}, alpha {float(img[..., 3].mean())}")
    check_launched(render_launches, ("grid_encode", "fused_mlp"), "Volume frame")
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, 1, -1.2]], np.float32)
    focal = np.array([28.0 * 64 / 24] * 2, np.float32)
    net = tb._volume.render(64, 64, cam, focal, spp=8).cpu().numpy()
    gt = tb._volume.render(64, 64, cam, focal, spp=8, use_gt=True).cpu().numpy()
    diff = float(np.abs(net[..., 3] - gt[..., 3]).mean())
    check(diff < 0.25, f"the Volume render is {diff:.4f} from the ground truth's (bound 0.25)")
    print(f"[volume] synthetic_smoke(256) ({vol.nbytes / 2**20:.0f} MiB) made and written in {gen_s:.3f} s, "
          f"loaded in {load_s:.3f} s; {steps} steps batch {1 << 16} at {steps / train_s:.3f} steps/s, loss {first:.5f} "
          f"-> {last:.5f} (ratio {last / first:.4f}, bound 0.5); {W}x{H} spp 4 render {render_ms:.1f} ms, alpha "
          f"{float(img[..., 3].mean()):.4f}; 64x64 spp 8 vs ground truth mean |d alpha| {diff:.4f} (bound 0.25), mean "
          f"|d rgb| {float(np.abs(net[..., :3] - gt[..., :3]).mean()):.4f}; launches train {train_launches} "
          f"render {render_launches}", flush=True)
    return {"volume_train": train_launches, "volume_render": render_launches}


# ------------------------------------------------------- the baked preview

#: the interactive bake's side, its frame's base raster, the seed of the
#: cells whose σ is checked, and the cage drag of [baked-edit]
BAKE_RES = 256
BAKED_BI = 384
BAKE_SEED = 1313
BAKE_DRAG = np.array([0.02, 0.0, 0.0], np.float32)


def baked_views():
    """Six cameras 1.6 from the centre, one along each world axis each way
    (tilted a little), naming (view-major axis, flip)."""
    e = np.eye(3, dtype=np.float32)
    return {
        f"{'xyz'[m]}{'+-'[s < 0]}": look_at(CENTER - s * 1.6 * e[m] + 0.25 * e[(m + 1) % 3] - 0.15 * e[(m + 2) % 3],
                                             up=e[(m + 2) % 3])
        for m in range(3) for s in (1, -1)
    }


def baked_extra_views():
    """Two views beside :func:`baked_views`: an eye inside the bake box
    looking across it (the base plane lies behind the eye: 1 / s < 0), and
    a close view, 0.5 from the centre, whose back slices' tile footprints
    are too large for kernel H's box buffers (read directly)."""
    return {
        "inside": look_at(CENTER + np.array([0.05, -0.1, 0.03], np.float32),
                          target=CENTER + np.array([1.0, 0.3, 0.2], np.float32)),
        "close": look_at(CENTER + np.array([0.03, -0.5, 0.02], np.float32)),
    }


def shear_warp_case(label, vol, xf, focal, W, H):
    """Kernels H and I against their plain versions on one view of ``vol``
    (with depth), timed as the preview calls them (without) → (H numbers, I
    numbers, H's tile-slices by path)."""
    from nerfshop_tpu_torch.render import baked as baked_lib

    fp = baked_lib.frame_params(vol.resolution, vol.aabb_lo, vol.aabb_hi, (W, H), xf, focal, None, (0.0, 0.0, 0.0, 0.0),
                                BAKED_BI, with_depth=True)
    field = vol.fields[fp.major]
    counted = torch.zeros(3, dtype=torch.int32, device=field.device)
    raster = baked_lib.shear_warp_composite_cuda(field, fp, paths=counted)
    paths, plan = dict(zip(("skipped", "staged", "direct"), counted.tolist())), baked_lib.composite_plan(fp).counts()
    check(paths == plan, f"kernel H's tile-slices by path {paths} are not composite_plan's {plan}")
    raster_p = baked_lib.shear_warp_composite_plain(field, fp)
    rgba, depth = baked_lib.shear_warp_screen_cuda(raster_p, fp)
    rgba_p, depth_p = baked_lib.shear_warp_screen_plain(raster_p, fp)
    torch.cuda.synchronize()
    err_h = float((raster - raster_p).abs().max())
    err_i = float((rgba - rgba_p).abs().max())
    opaque = rgba_p[..., 3] > 0.5
    err_d = float((depth - depth_p).abs()[opaque].max()) if bool(opaque.any()) else 0.0
    check(bool(torch.isfinite(raster).all() and torch.isfinite(rgba).all()), f"kernel H or I output not finite ({label})")
    check(err_h <= 1e-4, f"kernel H disagrees with its plain version ({label}): {err_h:.3e} > 1e-4")
    check(err_i <= 1e-4, f"kernel I disagrees with its plain version ({label}): {err_i:.3e} > 1e-4")
    fp = fp._replace(with_depth=False)
    ms_h, dev_h = both_ms(lambda: baked_lib.shear_warp_composite_cuda(field, fp))
    plain_h = median_ms(lambda: baked_lib.shear_warp_composite_plain(field, fp), runs=5, warmups=1)
    ms_i, dev_i = both_ms(lambda: baked_lib.shear_warp_screen_cuda(raster, fp))
    plain_i = median_ms(lambda: baked_lib.shear_warp_screen_plain(raster, fp), runs=5, warmups=1)
    B, Bi = fp.B, fp.Bi
    # H: the layout read once and the raster written; ~50 fp32 operations and
    # 2 exponentials a texel and slice. I: the raster read, the frame written.
    bound_h = bound(B**3 * 8 + Bi * Bi * 5 * 4, 50.0 * B * Bi * Bi)
    bound_i = bound(Bi * Bi * 5 * 4 + W * H * (4 + 1) * 4, 60.0 * W * H)
    print(
        f"[baked] view {label} (major {'xyz'[fp.major]}, flip {fp.flip}, eye {fp.e.tolist()}, base box {fp.box.tolist()}):"
        f" H's tile-slices {paths}; kernel H vs plain max|d raster| {err_h:.3e} "
        f"(bound 1e-4), kernel I vs plain max|d rgba| {err_i:.3e} (bound 1e-4), max|d depth| where alpha > 0.5 "
        f"{err_d:.3e}; H {ms_h:.4f} ms (device {dev_h:.4f}) plain {plain_h:.2f} ms bound {bound_h[0]:.4f} ms "
        f"({bound_h[1]}); I {ms_i:.4f} ms (device {dev_i:.4f}) plain {plain_i:.2f} ms bound {bound_i[0]:.4f} ms "
        f"({bound_i[1]}); alpha > 0.5 on {float(opaque.float().mean()):.4f} of the frame",
        flush=True,
    )
    return (
        dict(max_abs_err=err_h, ms=ms_h, device_ms=dev_h, plain_ms=plain_h, bound_ms=bound_h[0], bound_by=bound_h[1],
             library_ms=None, library_device_ms=None),
        dict(max_abs_err=err_i, ms=ms_i, device_ms=dev_i, plain_ms=plain_i, bound_ms=bound_i[0], bound_by=bound_i[1],
             library_ms=None, library_device_ms=None),
        paths,
    )


def median_rows(rows):
    """One kernels-line entry from per-view numbers: the largest error, the
    median of each time, the bound of the first view (the same bytes)."""
    return {
        **{k: statistics.median(r[k] for r in rows) for k in ("ms", "device_ms", "plain_ms")},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        **{k: rows[0][k] for k in ("bound_ms", "bound_by", "library_ms", "library_device_ms")},
    }


def interactive_frames(tb, W, H, n=3):
    """``render_interactive`` ``n`` times after a warm-up → (frame, host s)."""
    img = tb.render_interactive(W, H)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        img = tb.render_interactive(W, H)
        times.append(time.perf_counter() - t0)
    return img, times


def phase_baked(tb, W=1920, H=1080):
    """[baked]: the trained sphere baked at 256³ through ``bake_interactive``
    (seconds; kernels B without fracs and C); σ at 2^16 seeded cells against
    the field evaluated there; kernels H and I against their plain versions
    on eight views (the kernels line's numbers: the median over the first
    six); ``render_interactive`` at 1080p (one launch of H and one of
    I a frame); the baked frame against the exact one in PSNR (bound 24 dB,
    ``tests/test_baked.py``) → (bake launches, frame launches, H row, I row)."""
    from nerfshop_tpu_torch.models.nerf_network import density_with
    from nerfshop_tpu_torch.ops import coords
    from nerfshop_tpu_torch.render import baked as baked_lib

    dev = tb.device
    tb.set_look_at(eye=CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    tb.interactive_bake_resolution = BAKE_RES
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tb.bake_interactive()
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t0
    bake_launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    vol = tb._baked
    check(not tb.last_bake_incremental and vol.resolution == BAKE_RES, "the first bake was not a full 256^3 bake")
    check(all(f.shape == (BAKE_RES,) * 3 + (4,) and f.dtype == torch.bfloat16 for f in (*vol.fields, vol.canonical)),
          "the bake's volumes are not [256, 256, 256, 4] bf16")
    check_launched(bake_launches, ("grid_encode", "fused_mlp"), "bake")
    check(bake_launches["grid_encode_fracs"] == 0, f"kernel B wrote fracs in the bake: {bake_launches}")

    # σ at seeded cells against the field evaluated there (the same kernels)
    g = torch.Generator(device=dev)
    g.manual_seed(BAKE_SEED)
    zyx = torch.randint(0, BAKE_RES, (1 << 16, 3), generator=g, device=dev)
    lo, hi = (torch.as_tensor(v, device=dev) for v in (vol.aabb_lo, vol.aabb_hi))
    pos = lo + (zyx.flip(-1).to(torch.float32) + 0.5) / BAKE_RES * (hi - lo)
    full = coords.BoundingBox.from_aabb_scale(tb.train_config.aabb_scale, device=dev)
    with torch.no_grad():
        direct = density_with(tb.model, tb.inference_params, torch.clamp(coords.warp_position(pos, full), 0.0, 1.0))
        direct = direct * baked_lib.occupancy_at(tb.grid.occupancy, pos)
    baked_sigma = vol.canonical[zyx[:, 0], zyx[:, 1], zyx[:, 2], 3].float()
    sig_err = (baked_sigma - direct).abs()
    sig_ok = float((sig_err <= direct.abs() * 2.0**-8 + 1e-6).float().mean())
    check(sig_ok == 1.0, f"baked sigma off the field beyond bf16 rounding at {1 - sig_ok:.2e} of the cells "
                         f"(max {float(sig_err.max()):.3e})")
    occupied = float((baked_sigma > 0).float().mean())
    print(
        f"[baked] bake_interactive {BAKE_RES}^3 over the tight box {vol.aabb_lo.tolist()} .. {vol.aabb_hi.tolist()}: "
        f"{bake_s:.3f} s (first, after a sync), peak memory {peak / 2**30:.3f} GiB, launches {bake_launches}; sigma at "
        f"{1 << 16} seeded cells within bf16 rounding of the field (2^-8 relative) on {sig_ok:.6f} of them, max "
        f"|d| {float(sig_err.max()):.4e}, {occupied:.4f} of them > 0",
        flush=True,
    )

    focal = tb._focal_for(W, H)
    rows = [shear_warp_case(label, vol, xf, focal, W, H) for label, xf in baked_views().items()]
    h_row, i_row = median_rows([r[0] for r in rows]), median_rows([r[1] for r in rows])
    rows += [shear_warp_case(label, vol, xf, focal, W, H) for label, xf in baked_extra_views().items()]
    paths = {k: sum(r[2][k] for r in rows) for k in rows[0][2]}
    check(paths["staged"] > 0 and paths["direct"] > 0, f"kernel H did not take both paths over the eight views: {paths}")

    torch.cuda.synchronize()
    reset_launches()
    img, times = interactive_frames(tb, W, H)
    frame_launches = read_launches()
    check(tb._baked is vol, "render_interactive rebaked with nothing changed")
    check(frame_launches["shear_warp_composite"] == frame_launches["shear_warp_screen"] == 4
          and frame_launches["grid_encode"] == 0,
          f"a baked frame did not launch H and I once each and nothing else of the kernels: {frame_launches}")
    exact = tb.render(W, H, spp=1, exact=True)
    check(img.shape == (H, W, 4) and np.isfinite(img).all(), "the baked frame is not finite / of the expected shape")
    value = psnr(np.clip(img[..., :3], 0, 1), exact[..., :3])
    print(
        f"[baked] render_interactive {W}x{H} (Bi {BAKED_BI}) median of 3 {statistics.median(times) * 1e3:.2f} ms "
        f"({[round(t * 1e3, 2) for t in times]}), launches in 4 frames {frame_launches}; baked vs exact frame PSNR "
        f"{value:.2f} dB (bound 24)",
        flush=True,
    )
    check(value >= 24.0, f"baked vs exact PSNR {value:.2f} dB < 24")
    return bake_launches, frame_launches, h_row, i_row


def phase_baked_edit(tb, gs, op_mem, W=1920, H=1080):
    """[baked-edit]: the edited stack (the moved cage with its membrane, the
    duplicate) baked in full through kernel E; the cage dragged
    ``BAKE_DRAG`` further, replaced without a grid refresh (as
    ``tests/test_interactive_rebake.py`` does, so that both bakes read one
    grid and one box), rebaked incrementally and held to a forced full bake
    within 1e-2; then one edited 1080p baked frame against the exact one
    (PSNR, no bound). The stack is left as it was found → launches of the
    full bake."""
    from nerfshop_tpu_torch.render import baked as baked_lib

    tb.set_look_at(eye=SIDE_EYE)
    check(len(tb.edit_operators) == 2 and tb.edit_operators[0] is op_mem, "not the membrane stack")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    tb.bake_interactive()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    launches = read_launches()
    chunks = -(-BAKE_RES // max(1, (1 << 18) // BAKE_RES**2))
    check(not tb.last_bake_incremental, "the first bake of the edited stack was not full")
    check(launches["cage_warp_membrane"] == chunks and launches["cage_warp_samples"] == 0 and launches["tet_lookup"] == 0,
          f"the edited bake did not warp each chunk by one WARP_MEMBRANE launch: {launches}")
    check(launches["grid_encode_fracs"] == 0, f"kernel B wrote fracs in the edited bake: {launches}")

    gs.translate_cage(BAKE_DRAG)
    dragged = gs.make_operator()
    tb.replace_edit_operator(0, dragged, refresh_grid=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tb.bake_interactive()
    torch.cuda.synchronize()
    incr_s = time.perf_counter() - t0
    check(tb.last_bake_incremental, "the drag did not rebake incrementally")
    from nerfshop_tpu_torch.editing.operators import operator_roi_aabb

    roi = [np.minimum(operator_roi_aabb(op_mem)[0], operator_roi_aabb(dragged)[0]),
           np.maximum(operator_roi_aabb(op_mem)[1], operator_roi_aabb(dragged)[1])]
    _, dims = baked_lib._roi_dims(*roi, baked_lib.coords.BoundingBox(tb._baked.aabb_lo, tb._baked.aabb_hi), BAKE_RES)
    incr = tb._baked.canonical.clone()
    t0 = time.perf_counter()
    tb.bake_interactive(force_full=True)
    torch.cuda.synchronize()
    forced_s = time.perf_counter() - t0
    diff = float((incr.float() - tb._baked.canonical.float()).abs().max())
    del incr
    check(diff <= 1e-2, f"the incremental rebake is {diff:.3e} from a full bake (bound 1e-2)")
    tb.refresh_grid_for_edits()
    img, times = interactive_frames(tb, W, H)
    exact = tb.render(W, H, spp=1, exact=True)
    value = psnr(np.clip(img[..., :3], 0, 1), exact[..., :3])
    print(
        f"[baked-edit] the stack (moved cage with membrane, duplicate) baked in full in {full_s:.3f} s, launches "
        f"{launches}; the cage dragged {BAKE_DRAG.tolist()} further: incremental rebake of a {dims} (z, y, x) region "
        f"in {incr_s:.3f} s, a forced full bake {forced_s:.3f} s, max|incremental - full| {diff:.3e} (bound 1e-2); "
        f"after a grid refresh the {W}x{H} edited baked frame median of 3 {statistics.median(times) * 1e3:.2f} ms, "
        f"PSNR against the exact edited frame {value:.2f} dB (no bound)",
        flush=True,
    )
    gs.translate_cage(-BAKE_DRAG)
    tb.replace_edit_operator(0, op_mem)
    return launches


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_viewer(tb, W=1920, H=1080):
    """[viewer]: ``ViewerServer`` on a free port in the background, driven
    with ``urllib``: the page, the state, four 1080p baked frames (the first
    bakes), a cage edit applied and dragged (an incremental rebake), 16
    training steps (a graph replay) and a frame after them (a full rebake),
    an unknown verb; each request's ms, the frame's and the PNG's, every PNG
    read back at its size → the launches of the whole phase."""
    import urllib.request

    from nerfshop_tpu_torch.data import image_io
    from nerfshop_tpu_torch.viewer.server import ViewerServer

    srv = ViewerServer(tb, port=free_port(), bake_resolution=BAKE_RES)
    httpd = srv.start_background()
    url = f"http://127.0.0.1:{srv.port}"
    timings = []
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_viewer_"))

    def request(path, body=None):
        t0 = time.perf_counter()
        if body is None:
            out = urllib.request.urlopen(url + path, timeout=600).read()
        else:
            req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST")
            out = urllib.request.urlopen(req, timeout=600).read()
        ms = (time.perf_counter() - t0) * 1e3
        if path == "/render":
            (tmp / "frame.png").write_bytes(out)
            img = image_io.read_png(tmp / "frame.png")
            check(img.shape == (H, W, 4), f"the viewer's PNG is {img.shape}, expected {(H, W, 4)}")
            timings.append(f"{path} {ms:.1f} ms (frame {srv.last_frame_ms:.1f}, png {srv.last_png_ms:.1f})")
            return img
        timings.append(f"{path} {ms:.1f} ms")
        return out if path == "/" else json.loads(out)

    try:
        torch.cuda.synchronize()
        reset_launches()
        check(b"nerfshop_tpu viewer" in request("/"), "GET / did not serve the viewer page")
        check(request("/edit/clear", {})["n_operators"] == 0, "clear left operators")
        check(request("/state")["n_operators"] == 0, "the state shows operators after clear")
        cam = look_at(CENTER + np.array([0.9, -0.9, 0.5], np.float32)).tolist()
        frame = {"camera": cam, "width": W, "height": H}
        rebakes = []
        for _ in range(4):
            request("/render", frame)
            rebakes.append(srv.last_rebake_s)
        check(not tb.last_bake_incremental and rebakes[0] is not None and len(set(rebakes)) == 1,
              f"the first frame did not bake in full once, or a later one rebaked: {rebakes}")
        check(request("/edit/select_sphere", {"center": [0.5, 0.5, 0.5], "radius": 0.1})["ok"], "select_sphere failed")
        check(request("/edit/compute_proxy", {})["stage"] == "ProxyMesh", "compute_proxy failed")
        check(request("/edit/extract_cage", {})["stage"] == "TetMesh", "extract_cage failed")
        check(request("/edit/apply", {})["n_operators"] == 1, "apply failed")
        request("/render", frame)
        full_s = srv.last_rebake_s
        check(not tb.last_bake_incremental, "the frame after apply did not bake in full")
        check(request("/edit/translate", {"offset": [0.03, 0.0, 0.0]})["ok"], "translate failed")
        request("/render", frame)
        incr_s = request("/state")["last_rebake_s"]
        check(tb.last_bake_incremental and incr_s != full_s, "the drag did not rebake incrementally")
        replays = tb.stats.graph_replays
        out = request("/train", {"n_steps": 16})
        check(math.isfinite(out["loss"]) and tb.stats.graph_replays == replays + 1,
              f"/train did not replay the captured graph once: {tb.stats.graph_replays - replays} replays")
        request("/render", frame)
        check(not tb.last_bake_incremental and request("/state")["last_rebake_s"] != incr_s,
              "the frame after training did not rebake in full")
        check(request("/edit/nonsense", {})["ok"] is False, "an unknown verb did not answer ok: false")
        check(request("/edit/clear", {})["n_operators"] == 0, "clear left operators")
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        httpd.shutdown()
        httpd.server_close()
        shutil.rmtree(tmp, ignore_errors=True)
    check(launches["shear_warp_composite"] == launches["shear_warp_screen"] == 7,
          f"the viewer's 7 frames did not launch H and I once each: {launches}")
    print(f"[viewer] requests: {'; '.join(timings)}; rebakes: full {full_s:.3f} s, after the drag {incr_s:.3f} s "
          f"(incremental); launches {launches}", flush=True)
    return launches


#: the numbers of a kernel in the kernels line; ``ms``, ``plain_ms`` and
#: ``library_ms`` are events around one call, ``device_ms`` and
#: ``library_device_ms`` the same calls queued behind a spin (:func:`median_ms`)
# ------------------------------------------------------- the captured scene

CAP_VIEWS, CAP_HELD = 32, 4
CAP_W, CAP_H = 512, 384
CAP_FOCAL = 560.0
CAP_QUALITY = 90
CAP_AABB = 4
#: transforms.json's scale and offset (the reference's defaults)
CAP_SCALE, CAP_OFFSET = 0.33, np.array([0.5, 0.5, 0.5], np.float32)
#: the rolling shutter: (offset, column term, row term, motion-blur jitter)
CAP_SHUTTER = np.array([0.0, 0.2, 0.5, 0.3], np.float32)
#: each view's camera moves this far (ngp units) over its exposure
CAP_MOTION = 0.02
#: the shutter times a ground-truth pixel averages
CAP_GT_SAMPLES = 4
CAP_SEED = 4242
#: training steps profiled by start_profiler / stop_profiler
CAP_PROFILED = 16
#: the radius of the backdrop around the sphere: inside the scene's box
#: [-1.5, 2.5]³ (aabb_scale 4), across the outer two cascades; the cameras'
#: distance from the centre in the horizontal plane
CAP_ROOM, CAP_EYE = 1.6, 1.0


def captured_rgba(o, d):
    """The captured scene's analytic render: the smoke's opaque sphere
    (:func:`sphere_rgba`) inside a backdrop, a sphere of radius
    :data:`CAP_ROOM` about it seen from within, a checker over smooth colour
    bands, so that every ray ends on a textured surface, as a photo's do."""
    rgba = sphere_rgba(o, d)
    oc = o - CENTER
    b = np.sum(oc * d, -1)
    t = -b + np.sqrt(np.maximum(b * b - np.sum(oc * oc, -1) + CAP_ROOM**2, 0.0))
    n = (oc + t[:, None] * d) / CAP_ROOM
    # smooth colour bands under a 16 × 8 checker in longitude and latitude:
    # edges every view can triangulate
    band = 0.5 + 0.3 * np.stack([np.sin(3 * n[:, 0] + 1), np.sin(2 * (n[:, 1] + n[:, 2]) - 0.5), np.cos(3 * n[:, 2])], -1)
    lon = np.floor((np.arctan2(n[:, 1], n[:, 0]) / (2 * np.pi) + 0.5) * 16)
    lat = np.floor(np.arccos(np.clip(n[:, 2], -1.0, 1.0)) / np.pi * 8)
    room = band * (0.55 + 0.45 * ((lon + lat) % 2))[:, None]
    miss = rgba[:, 3] == 0
    rgba[miss, :3] = room[miss]
    rgba[:, 3] = 1.0
    return rgba.astype(np.float32)


def sphere_exposure(xf, xf_end, W, H, focal, shutter, n):
    """The captured scene (:func:`captured_rgba`) seen through a rolling
    shutter with motion blur, in numpy: each pixel (x, y) averages ``n``
    renders at the shutter times
    shutter · (1, x/W, y/H, (k + 1/2)/n), its camera matrix lerped between
    ``xf`` and ``xf_end`` at each, its ray through the pixel's centre →
    [H·W, 4]. ``n`` = 1 with ``xf_end`` = ``xf`` is the still frame."""
    y, x = np.mgrid[0:H, 0:W].reshape(2, -1).astype(np.float32)
    d_cam = np.stack([(x + 0.5 - 0.5 * W) / focal, (y + 0.5 - 0.5 * H) / focal, np.ones_like(x)], -1)
    # the lerped matrix acts linearly: lerp the two ends' rays instead
    d0, d1 = d_cam @ xf[:, :3].T, d_cam @ xf_end[:, :3].T
    acc = np.zeros((H * W, 4), np.float32)
    for k in range(n):
        t = (shutter[0] + shutter[1] * x / W + shutter[2] * y / H + shutter[3] * (k + 0.5) / n)[:, None]
        d = d0 * (1.0 - t) + d1 * t
        acc += captured_rgba(xf[:, 3] * (1.0 - t) + xf_end[:, 3] * t, d / np.linalg.norm(d, axis=-1, keepdims=True))
    return acc / n


def captured_poses(n, rng):
    """``n`` views around the sphere (ngp convention) and their end-of-
    exposure poses, each moved :data:`CAP_MOTION` sideways."""
    starts, ends = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n + rng.uniform(0, 0.2)
        eye = CENTER + np.array([np.cos(ang), np.sin(ang), rng.uniform(-0.3, 0.6)], np.float32) * CAP_EYE
        xf = look_at(eye)
        end = xf.copy()
        end[:, 3] += xf[:, 0] * CAP_MOTION
        starts.append(xf)
        ends.append(end)
    return starts, ends


def write_captured_scene(root: Path, views=CAP_VIEWS, held=CAP_HELD, W=CAP_W, H=CAP_H, focal=CAP_FOCAL):
    """The sphere as a captured scene: ``transforms.json`` (nerf convention,
    ``aabb_scale`` :data:`CAP_AABB`, the rolling shutter, each frame's
    ``transform_matrix_end`` and a unit ``light_dir``) over ``views`` JPEG
    frames through the port's encoder at quality :data:`CAP_QUALITY`, 4:2:0,
    rendered through the shutter (:func:`sphere_exposure`); and
    ``held`` still views between them as JPEGs, the test set → (held-out ngp
    poses, their JPEG paths, the encode's seconds)."""
    from nerfshop_tpu_torch import native
    from nerfshop_tpu_torch.data import image_io
    from nerfshop_tpu_torch.data.nerf_loader import ngp_matrix_to_nerf

    rng = np.random.default_rng(CAP_SEED)
    starts, ends = captured_poses(views + held, rng)
    # the held-out views spread around the ring, between training views
    test = {int((k + 0.5) * (views + held) / held) for k in range(held)}
    order = [i for i in range(views + held) if i not in test] + sorted(test)
    starts, ends = [starts[i] for i in order], [ends[i] for i in order]
    (root / "images").mkdir(parents=True)
    (root / "test").mkdir()

    def nerf(xf):
        m = np.eye(4)
        m[:3] = ngp_matrix_to_nerf(xf, CAP_SCALE, CAP_OFFSET)
        return m.tolist()

    def frame(i):  # numpy releases the GIL: one thread a frame
        if i < views:
            rgba = sphere_exposure(starts[i], ends[i], W, H, focal, CAP_SHUTTER, CAP_GT_SAMPLES)
        else:
            rgba = sphere_exposure(starts[i], starts[i], W, H, focal, np.zeros(4, np.float32), 1)
        return (np.clip(rgba[:, :3], 0.0, 1.0).reshape(H, W, 3) * 255.0 + 0.5).astype(np.uint8)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        pixels = list(pool.map(frame, range(views + held)))
    native.get_lib(native.JPEG_SOURCE)  # built with g++ at first use: not in the encoder's time
    encode_s = 0.0
    for i, rgb in enumerate(pixels):  # encoded one at a time, timed
        t0 = time.perf_counter()
        image_io.write_jpeg(root / ("images" if i < views else "test") / f"{i:03d}.jpg", rgb, CAP_QUALITY, "4:2:0")
        encode_s += time.perf_counter() - t0
    frames = []
    for i in range(views):
        light = rng.normal(size=3)
        frames.append({"file_path": f"images/{i:03d}.jpg", "transform_matrix": nerf(starts[i]),
                       "transform_matrix_end": nerf(ends[i]), "light_dir": (light / np.linalg.norm(light)).tolist()})
    held_paths = [root / "test" / f"{j:03d}.jpg" for j in range(views, views + held)]
    meta = {"fl_x": focal, "fl_y": focal, "cx": W / 2, "cy": H / 2, "w": W, "h": H, "scale": CAP_SCALE,
            "offset": CAP_OFFSET.tolist(), "aabb_scale": CAP_AABB, "rolling_shutter": CAP_SHUTTER.tolist(),
            "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))
    return starts[views:], held_paths, encode_s


def host_cpu() -> str:
    """The host CPU's model name (``/proc/cpuinfo``, else ``lscpu``), with
    the cores this process may use."""
    import os
    import platform

    name = ""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.lower().startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    if name.lower() in ("", "unknown"):
        name = ""
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
            name = next((l.split(":", 1)[1].strip() for l in out.splitlines() if l.startswith("Model name")), "")
        except (OSError, subprocess.SubprocessError):
            pass
    return f"{name or 'model not reported, ' + (platform.processor() or platform.machine())}, " \
           f"{len(os.sched_getaffinity(0))} cores"


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rodrigues64(v):
    """The axis-angle exp map in float64 numpy, the reference for the pose deltas."""
    theta = float(np.linalg.norm(v))
    k = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float64)
    if theta < 1e-12:
        return np.eye(3) + k
    return np.eye(3) + np.sin(theta) / theta * k + (1 - np.cos(theta)) / theta**2 * (k @ k)


def device_ops(prof, n=5):
    """The ``n`` ops of a profile with the most device time → [(name, ms, calls)]."""
    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0) or 0

    ops = sorted(prof.key_averages(), key=dev_us, reverse=True)[:n]
    return [(e.key[:100], round(dev_us(e) / 1e3, 4), e.count) for e in ops if dev_us(e) > 0]


def phase_captured(dev, train_steps_per_s, workdir: Path, config=None, views=CAP_VIEWS, W=CAP_W, H=CAP_H,
                   focal=CAP_FOCAL, steps=STEPS, batch=BATCH):
    """[captured]: the sphere in its backdrop as a captured ``transforms.json``
    scene of JPEG frames (:func:`write_captured_scene`) at ``aabb_scale`` 4 (three
    cascades, cone-angle steps of 1/256), with a rolling shutter, motion
    blur and light dirs, loaded through ``Testbed.load_training_data``
    (the port's JPEG decoder; its ms a frame with the host CPU's name) and
    trained ``steps`` steps at ``batch`` through captured chunks: the loss
    falls as [train]'s must, every cascade refreshed and the inner one
    occupied, the held-out views and two training views (at their start
    poses, against the still scene) ≥ 14 dB, the renders running the rgb
    MLP's 35-wide input (the default Composite's SH and light dims) through
    kernel C, which is then held to its plain version at that width; then
    the Testbed's surface on the
    card: the extrinsics' round trip in both conventions (ngp exactly, nerf
    within 4 float32 ulps: the scale and offset round), the pose deltas
    against a float64 exp map, ``n_params``, ``level_stats``,
    ``training_step``; a ``torch.profiler`` trace of :data:`CAP_PROFILED`
    steps and its largest device ops; ``reload_network_from_json`` resets
    the step and the loss → the path's launches (training, refreshes,
    held-out renders)."""
    from nerfshop_tpu_torch.common import TestbedMode
    from nerfshop_tpu_torch.config import default_nerf_config
    from nerfshop_tpu_torch.data import image_io
    from nerfshop_tpu_torch.ops import fused_mlp
    from nerfshop_tpu_torch.testbed import Testbed

    config = config or default_nerf_config()
    root = workdir / "captured"
    t0 = time.perf_counter()
    held_xf, held_paths, encode_s = write_captured_scene(root, views, CAP_HELD, W, H, focal)
    scene_s = time.perf_counter() - t0
    frames = sorted((root / "images").glob("*.jpg"))
    t0 = time.perf_counter()
    for path in frames:
        image_io.read_jpeg(path)
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    print(
        f"[captured] scene: the sphere in a backdrop of radius {CAP_ROOM}, {views} JPEG frames {W}x{H} (quality {CAP_QUALITY}, 4:2:0, "
        f"{sum(p.stat().st_size for p in frames) / len(frames) / 1024:.1f} KiB a frame) + {CAP_HELD} held out, "
        f"aabb_scale {CAP_AABB}, rolling shutter {CAP_SHUTTER.tolist()}, motion {CAP_MOTION}; written in "
        f"{scene_s:.2f} s (the port's encoder {encode_s * 1e3 / (views + CAP_HELD):.3f} ms a frame); the port's decoder "
        f"{decode_ms:.3f} ms a frame on the host ({host_cpu()})",
        flush=True,
    )
    tb = Testbed(TestbedMode.Nerf, config=config, device=dev, seed=0)
    t0 = time.perf_counter()
    tb.load_training_data(str(root))
    load_s = time.perf_counter() - t0
    ds, data, cfg = tb._dataset, tb._device_data, tb.train_config
    check(ds.n_images == views and ds.images.shape[1:3] == (H, W) and ds.aabb_scale == CAP_AABB,
          f"[captured] the scene loaded wrong: {ds.n_images} images {ds.images.shape}, aabb_scale {ds.aabb_scale}")
    check(cfg.n_cascades == 3 and cfg.cone_angle == 1.0 / 256, f"[captured] not three cascades: {cfg}")
    check(data.xforms_end is not None and data.rolling_shutter is not None and data.light_dirs is not None
          and tb.model.n_extra_dims == 3, "[captured] the shutter, end poses or light dirs did not reach training")

    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tb.train(n_steps=steps, batch_size=batch)
    sync(dev)
    train_s = time.perf_counter() - t0
    train_launches = read_launches()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    losses = [lv for _, lv in tb.loss_history]
    tail = float(np.mean(losses[-10:]))
    check(len(losses) == steps and all(math.isfinite(v) for v in losses), "[captured] non-finite or missing losses")
    check(tail < 0.35 * losses[0], f"[captured] loss did not fall enough: first {losses[0]:.4e} last-10 {tail:.4e}")
    check(tb.training_step == steps, f"[captured] training_step {tb.training_step} after {steps} steps")
    if dev.type == "cuda":
        check(tb.stats.captured_steps == steps, "[captured] a step ran outside the captured loop")
    grid = tb.grid
    refreshed = [bool((grid.density[c] != 0).any()) for c in range(grid.n_cascades)]
    occupied = [float(grid.occupancy[c].float().mean()) for c in range(grid.n_cascades)]
    check(all(refreshed), f"[captured] a cascade was never refreshed: {refreshed}")
    check(bool(grid.occupancy[0].any()), "[captured] no cell of the inner cascade is occupied")
    print(
        f"[captured] {steps} steps batch {batch} at three cascades in {train_s:.3f} s (the graphs' captures "
        f"included): {steps / train_s:.3f} steps/s ([train] at one cascade: {train_steps_per_s:.3f}), "
        f"{tb.stats.measured_samples_total / train_s:.6g} real samples/s, loss {losses[0]:.4e} -> last-10 "
        f"{tail:.4e} (ratio {tail / losses[0]:.3f}), final (rays, K) = ({tb.train_config.n_rays_per_batch}, "
        f"{tb.train_config.k_samples}); load {load_s:.2f} s; occupied share by cascade {occupied}; peak memory "
        f"{peak / 2**30:.3f} GiB",
        flush=True,
    )

    def frame_psnr(xf, gt):
        img = tb.render(W, H, spp=1, camera_matrix=xf, focal=np.array([focal, focal], np.float32),
                        principal=np.array([0.5, 0.5], np.float32), exact=True)
        check(img.shape == (H, W, 4) and np.isfinite(img).all(), "[captured] a frame is not finite")
        return psnr(img[..., :3], gt[..., :3])

    # two training views at their start poses against the still scene there
    # (the frames themselves are blurred by the shutter), and the held-out
    # views against their JPEGs
    still = np.zeros(4, np.float32)
    # the renders' rgb MLP calls and the launches of kernel C inside them
    rgb_calls, rgb_forward = collections.Counter(), tb.model.rgb_mlp.forward

    def rgb_spy(x):
        before = fused_mlp.fused_mlp_cuda.launches
        y = rgb_forward(x)
        rgb_calls[(x.shape[-1], fused_mlp.fused_mlp_cuda.launches - before)] += 1
        return y

    tb.model.rgb_mlp.forward = rgb_spy
    try:
        seen = [frame_psnr(ds.xforms[i], np.clip(sphere_exposure(ds.xforms[i], ds.xforms[i], W, H, focal, still, 1), 0, 1)
                           .reshape(H, W, 4)) for i in (0, views // 2)]
        values = [frame_psnr(xf, image_io.read_image(path, linear=False)) for xf, path in zip(held_xf, held_paths)]
    finally:
        del tb.model.rgb_mlp.forward
    launches = read_launches()
    render_launches = {k: launches[k] - train_launches[k] for k in launches}
    check(min(values) >= 14.0 and min(seen) >= 14.0,
          f"[captured] PSNR below 14 dB: held-out views {values}, training views {seen}")
    check_launched(launches, ("segsum", "grid_encode", "fused_mlp", "gather"), "[captured] path")
    check(train_launches["fused_mlp"] > 0, f"[captured] kernel C did not run in the grid refresh: {train_launches}")
    check(render_launches["fused_mlp"] > 0 and set(rgb_calls) == {(35, 1)},
          f"[captured] the renders' rgb MLP (input width, kernel C launches) a call: {dict(rgb_calls)}")

    # kernel C at the rgb MLP's input of a scene with light dirs: 16 density
    # features, 16 SH terms and the 3 light dims of the default Composite
    rgb_ws = [w.detach() for w in tb.model.rgb_mlp.weights]
    x35 = torch.rand((1 << 20, rgb_ws[0].shape[0]), generator=torch.Generator(dev).manual_seed(CAP_SEED), device=dev)
    with torch.no_grad():
        ker = fused_mlp.fused_mlp_cuda(x35, rgb_ws) if dev.type == "cuda" else fused_mlp.fused_mlp_plain(x35, rgb_ws)
        plain = fused_mlp.fused_mlp_plain(x35, rgb_ws)
    err = (ker - plain).abs()
    within = float((err <= 1e-6 + 1e-5 * plain.abs()).float().mean())
    check(rgb_ws[0].shape[0] == 35 and within >= 0.995 and float(err.max()) <= 1e-2 * float(plain.abs().max()),
          f"[captured] kernel C at {tuple(x35.shape)}: {within:.5f} within 1e-5 rel, max err {float(err.max()):.3e}")
    print(f"[captured] kernel C at the rgb MLP's {rgb_ws[0].shape[0]}-wide input (2^20 rows, 3 k-tiles, zero-padded "
          f"in the kernel): {within:.6f} of outputs within 1e-6+1e-5*|plain| (bound 0.995 as [mlp]), max_abs_err "
          f"{float(err.max()):.3e}", flush=True)


    # the Testbed's surface on the card
    for conv in ("ngp", "nerf"):
        for i in (0, views // 2, views - 1):
            m = tb.get_camera_extrinsics(i, conv)
            tb.set_camera_extrinsics(i, m, conv)
            back = tb.get_camera_extrinsics(i, conv)
            err = float(np.abs(back - m).max())
            ulps = float(np.spacing(np.float32(np.abs(m).max())))
            check(err == 0.0 if conv == "ngp" else err <= 4 * ulps,
                  f"[captured] extrinsics round trip ({conv}) off by {err} ({err / ulps:.1f} ulps)")
            check(np.array_equal(data.xforms[i].cpu().numpy(), ds.xforms[i]), "[captured] the device pose was not set")
    probe = Testbed(TestbedMode.Nerf, config=config, device=dev, seed=1)
    probe.nerf.training.optimize_extrinsics = True
    probe.set_training_data(ds)
    rng = np.random.default_rng(CAP_SEED)
    rot = rng.normal(size=(views, 3)).astype(np.float32) * 0.05
    trans = rng.normal(size=(views, 3)).astype(np.float32) * 0.05
    with torch.no_grad():
        probe._state.extra["camera.rot"].copy_(torch.from_numpy(rot))
        probe._state.extra["camera.trans"].copy_(torch.from_numpy(trans))
    delta_err = 0.0
    for i in range(views):
        xf = ds.xforms[i].astype(np.float64)
        ref = np.concatenate([rodrigues64(rot[i].astype(np.float64)) @ xf[:, :3], (xf[:, 3] + trans[i])[:, None]], 1)
        delta_err = max(delta_err, float(np.abs(probe.get_camera_extrinsics(i, "ngp") - ref).max()))
    check(delta_err < 1e-5, f"[captured] get_camera_extrinsics with deltas off the float64 exp map by {delta_err}")
    del probe
    stats = tb.level_stats()
    print(
        f"[captured] extrinsics round trip: ngp exact, nerf within 4 float32 ulps; with pose deltas (0.05 rad, 0.05 units) "
        f"against a float64 exp map: {delta_err:.3e}; n_params {tb.n_params()}; training_step {tb.training_step}; "
        f"level_stats mean |entry| by level {[round(s['mean_abs'], 6) for s in stats]}, hashed levels "
        f"{sum(s['hashed'] for s in stats)} of {len(stats)}; training views 0 and {views // 2} at their start poses "
        f"{[round(v, 2) for v in seen]} dB, held-out views {[round(v, 2) for v in values]} dB (bound 14 each); the "
        f"renders' launches {render_launches}, their rgb MLP calls by (input width, kernel C launches) {dict(rgb_calls)}",
        flush=True,
    )

    tb.start_profiler(str(workdir / "trace"))
    tb.train(n_steps=CAP_PROFILED, batch_size=batch)
    trace = tb.stop_profiler()
    check(Path(trace).stat().st_size > 0 and tb.training_step == steps + CAP_PROFILED,
          f"[captured] the profiled steps: trace {trace}, training_step {tb.training_step}")
    top = device_ops(tb.profiler)
    first = losses[0]
    tb.reload_network_from_json(config)
    check(tb.training_step == 0, f"[captured] training_step {tb.training_step} after the reload")
    tb.train(n_steps=16, batch_size=batch)
    again = tb.loss_history[-16][1]
    check(0.5 * first < again < 2.0 * first and again > 2.0 * tail,
          f"[captured] after the reload the loss {again:.4e} is not back near the first {first:.4e}")
    print(
        f"[captured] profiler: {CAP_PROFILED} steps traced to {trace} ({Path(trace).stat().st_size} bytes); largest "
        f"device ops (name, ms, calls): {top or 'not measured (no device time in the trace)'}; after "
        f"reload_network_from_json: training_step 0, first loss {again:.4e} (the run's first {first:.4e}); "
        f"launches {launches}",
        flush=True,
    )
    return launches


# ------------------------------------------------------- kernels K and L


#: K's output against its plain version, tables uniform in ±1: the same
#: products, fused into FMAs and summed over the 2^D corners in another order
XOR_TOL = 2e-6
#: L's position gradient against autograd of the plain version, relative to
#: its largest plain value: the terms fuse into FMAs and sum in another order
XOR_BWD_TOL = 2e-5
#: L's table gradient against the plain version's, relative to the sum of
#: the |terms| each slot adds: both add by atomics in an order that changes
#: every call, and a frame chunk (93% repeated positions) sends 10^5-10^6
#: terms to one coarse slot
XOR_SUM_TOL = 1e-4


def xor_reads(enc, x):
    """(distinct table rows, distinct mask cells) that kernel K reads on x:
    every corner of a level whose cell the mask keeps, and (Takikawa) each
    (sample, level)'s mask cell."""
    from nerfshop_tpu_torch.ops import xor_encode

    rows, cells = [], []
    for lv in enc.xor_levels:
        r, _, inside = xor_encode.level_corners(x, enc, lv, enc.takikawa)
        rows.append((r if inside is None else r[inside]).reshape(-1))
        if enc.takikawa:
            p0 = torch.floor(x.clamp(0, 1) * lv.res).long().clamp(0, lv.res - 1)
            mc = torch.clamp((p0 * lv.mask_res) // lv.res, 0, lv.mask_res - 1)
            cells.append(lv.mask_off + (mc[:, 0] * lv.mask_res + mc[:, 1]) * lv.mask_res + mc[:, 2])
    n_cells = int(torch.unique(torch.cat(cells)).numel()) if cells else 0
    return int(torch.unique(torch.cat(rows)).numel()), n_cells


def xor_index_pairs(enc, x, dout):
    """(rows [P], values [P, F]) of L's table scatter on x: the library
    call's ``index_add_`` inputs."""
    from nerfshop_tpu_torch.ops import xor_encode

    F = enc.n_features_per_level
    rows, vals = [], []
    for l, lv in enumerate(enc.xor_levels):
        r, w, inside = xor_encode.level_corners(x, enc, lv, enc.takikawa)
        if inside is not None:
            w = w * inside[:, None]
        g = dout if enc.sum_instead_of_concat else dout[:, l * F:(l + 1) * F]
        rows.append(r.reshape(-1))
        vals.append((w[:, :, None] * g[:, None, :]).reshape(-1, F))
    return torch.cat(rows), torch.cat(vals)


def xor_case(label, enc, table, x, g, tag="xor", timed=True):
    """Kernels K and L against their plain versions on x (a seeded output
    cotangent): K's out within ``XOR_TOL`` of max(1, max|plain|), L's table
    gradient within ``XOR_SUM_TOL`` of each slot's sum of |terms| and its
    position gradient within ``XOR_BWD_TOL`` of its largest plain value, L
    asked for one gradient alone equal to the one it gives with both (the
    position gradient bit for bit: it has no atomics). Timed: K
    and L by events and queued, their plain versions, L's table half
    beside one ``index_add_`` of the same pairs (K has no single library
    call), each beside its bytes bound → (K's numbers, L's numbers)."""
    from nerfshop_tpu_torch.ops import xor_encode as xe

    N = x.shape[0]
    out_k = xe.xor_encode_cuda(table, x, enc)
    out_p = xe.xor_encode_plain(table, x, enc)
    dout = torch.randn(tuple(out_k.shape), generator=g, device=x.device)
    dt_k, dx_k = xe.xor_encode_bwd_cuda(table, x, dout, enc)
    dt_p, dx_p = xe.xor_encode_bwd_plain(table, x, dout, enc)
    dt_only, none_x = xe.xor_encode_bwd_cuda(table, x, dout, enc, True, False)
    none_t, dx_only = xe.xor_encode_bwd_cuda(table, x, dout, enc, False, True)
    torch.cuda.synchronize()
    check(tuple(out_k.shape) == (N, enc.n_output_dims) and bool(torch.isfinite(out_k).all()), f"kernel K out bad ({label})")
    out_err = float((out_k - out_p).abs().max()) if N else 0.0
    out_max = float(out_p.abs().max()) if N else 0.0
    rows, vals = xor_index_pairs(enc, x, dout)
    dt_tol = torch.zeros_like(table).index_add_(0, rows, vals.abs()) * XOR_SUM_TOL + 1e-7
    dt_err = float((dt_k - dt_p).abs().max())
    dt_ratio = float(((dt_k - dt_p).abs() / dt_tol).max())
    dt_max = float(dt_p.abs().max())
    dx_err = float((dx_k - dx_p).abs().max()) if N else 0.0
    dx_max = float(dx_p.abs().max()) if N else 0.0
    check(out_err <= XOR_TOL * max(1.0, out_max), f"kernel K disagrees ({label}): {out_err:.3e} of {out_max:.3e}")
    check(dt_ratio <= 1.0, f"kernel L's d table disagrees ({label}): {dt_err:.3e} of {dt_max:.3e}, {dt_ratio:.3f} of its bound")
    check(dx_err <= XOR_BWD_TOL * dx_max + 1e-7, f"kernel L's d x disagrees ({label}): {dx_err:.3e} of {dx_max:.3e}")
    check(none_x is None and none_t is None and torch.equal(dx_only, dx_k), f"kernel L alone on d x differs ({label})")
    dt_alone = float((dt_only - dt_k).abs().max())
    check(bool(((dt_only - dt_k).abs() <= dt_tol).all()), f"kernel L alone on d table differs ({label}): {dt_alone:.3e}")
    kind = f"Takikawa F={enc.n_features_per_level}{' summed' if enc.sum_instead_of_concat else ''}" if enc.takikawa \
        else f"plain D={enc.n_input_dims}"
    line = (f"[{tag}] {label} ({kind}, L={enc.n_levels}, sizes {sorted(set(lv.m for lv in enc.xor_levels))[:4]}...) "
            f"N={N}: K out err {out_err:.3e} of max {out_max:.3e} (bound {XOR_TOL:g} x max(1, max)); L d table err "
            f"{dt_err:.3e} of max {dt_max:.3e} ({dt_ratio:.3f} of its bound {XOR_SUM_TOL:g} x the slot's sum of |terms|), "
            f"d x err {dx_err:.3e} of max {dx_max:.3e} (bound {XOR_BWD_TOL:g} x max); "
            f"L on one gradient alone: d x bit-equal, d table within {dt_alone:.3e}")
    if not timed:
        print(line, flush=True)
        return None, None
    del dt_tol
    k_ms, k_dev = both_ms(lambda: xe.xor_encode_cuda(table, x, enc))
    k_plain = median_ms(lambda: xe.xor_encode_plain(table, x, enc), runs=5)
    l_ms, l_dev = both_ms(lambda: xe.xor_encode_bwd_cuda(table, x, dout, enc))
    l_plain = median_ms(lambda: xe.xor_encode_bwd_plain(table, x, dout, enc), runs=5)
    lt_ms, lt_dev = both_ms(lambda: xe.xor_encode_bwd_cuda(table, x, dout, enc, True, False))
    lib = lambda: torch.zeros_like(table).index_add_(0, rows, vals)  # noqa: E731
    lib_err = float((lib() - dt_p).abs().max())
    lib_ms, lib_dev = both_ms(lib)
    del rows, vals
    n_rows, n_cells = xor_reads(enc, x)
    F = enc.n_features_per_level
    # K: x, the rows and mask cells it reads, out. L: x, dout, the cells,
    # the rows d x reads, the table gradient written whole, d x
    k_bytes = nbytes(x, out_k) + n_rows * F * 4 + n_cells
    l_bytes = nbytes(x, dout, table, dx_k) + n_rows * F * 4 + n_cells
    lt_bytes = nbytes(x, dout, table) + n_cells
    k_b, k_by = bound(k_bytes)
    l_b, l_by = bound(l_bytes)
    lt_b, _ = bound(lt_bytes)
    print(line + f"; K: events {k_ms:.4f} ms device {k_dev:.4f} ms plain {k_plain:.4f} ms bound {k_b:.4f} ms ({k_by}, "
          f"{k_bytes / 1e6:.1f} MB, {n_rows} of {enc.table_size} rows, {n_cells} mask cells), device/bound "
          f"{k_dev / k_b:.2f}; L (both gradients): events {l_ms:.4f} ms device {l_dev:.4f} ms plain {l_plain:.4f} ms "
          f"bound {l_b:.4f} ms ({l_by}, {l_bytes / 1e6:.1f} MB), device/bound {l_dev / l_b:.2f}; L (table alone): "
          f"events {lt_ms:.4f} ms device {lt_dev:.4f} ms, library index_add_ of the same {N * enc.n_levels * (1 << enc.n_input_dims)} "
          f"(row, value) pairs events {lib_ms:.4f} ms device {lib_dev:.4f} ms (err {lib_err:.3e}), bound {lt_b:.4f} ms",
          flush=True)
    k_row = dict(max_abs_err=out_err, ms=k_ms, device_ms=k_dev, plain_ms=k_plain, library_ms=None,
                 library_device_ms=None, bound_ms=k_b, bound_by=k_by)
    l_row = dict(max_abs_err=max(dt_err, dx_err), ms=l_ms, device_ms=l_dev, plain_ms=l_plain, library_ms=lib_ms,
                 library_device_ms=lib_dev, bound_ms=l_b, bound_by=l_by)
    return k_row, l_row


def unit_mesh(mesh):
    """``mesh``'s vertices normalised into the unit cube as the SDF testbed
    does it (0.9 of the side, centred) → (vertices, faces)."""
    v = np.asarray(mesh.vertices, np.float32)
    lo, hi = v.min(0), v.max(0)
    return (v - (lo + hi) / 2) * (0.9 / float((hi - lo).max())) + 0.5, np.asarray(mesh.faces, np.int64)


def near_surface(v, f, n, g, dev, spread):
    """n points on the mesh's triangles moved by up to ``spread`` an axis."""
    tri = torch.as_tensor(v[f], device=dev)
    i = torch.randint(tri.shape[0], (n,), generator=g, device=dev)
    b = torch.rand((n, 3), generator=g, device=dev)
    b = b / b.sum(1, keepdim=True)
    p = torch.einsum("nk,nkd->nd", b, tri[i])
    return (p + (torch.rand((n, 3), generator=g, device=dev) * 2 - 1) * spread).contiguous()


def xor_edge_points(enc, g, dev):
    """Points at the edges of kernels K and L's x-neighbour pairs: 64 on
    each face of the box (x_d = 0 and 1: the last cell and its clamped
    corner), and on every level of a plain grid 32 each at p0.x = 2, 3,
    res − 2 and res − 1 (pairs at even and odd p0.x, the last pair, the x
    corners clamped onto one slot); 2431 in all on the default grid, no
    whole number of warps."""
    D = enc.n_input_dims
    pts = []
    for d in range(D):
        for v in (0.0, 1.0):
            p = torch.rand((64, D), generator=g, device=dev)
            p[:, d] = v
            pts.append(p)
    for lv in [] if enc.takikawa else enc.xor_levels:
        for px in (2, 3, lv.res - 2, lv.res - 1):
            p = torch.rand((32, D), generator=g, device=dev)
            p[:, 0] = (px + 0.05 + 0.9 * torch.rand((32,), generator=g, device=dev) - 0.5) / lv.scale
            pts.append(p)
    return torch.cat(pts)[:-1].contiguous()


def repeated_points(g, dev, n: int = 1 << 16):
    """n positions in the middle of the box: one position n times (every
    lane of L's scatter on one slot), n / 16 positions repeated in runs of
    16 (the groups of neighbouring lanes that a frame chunk's repeated
    samples make), and n / 8 positions each on lanes i, i + 4, ... of a
    warp (groups that are no runs)."""
    one = (torch.rand((1, 3), generator=g, device=dev) * 0.4 + 0.3).expand(n, 3).contiguous()
    runs = (torch.rand((n // 16, 3), generator=g, device=dev) * 0.4 + 0.3).repeat_interleave(16, 0).contiguous()
    base = torch.rand((n // 8, 3), generator=g, device=dev) * 0.4 + 0.3
    i = torch.arange(n, device=dev)
    strided = base[(i // 32) * 4 + i % 4].contiguous()
    return {"2^16 identical positions": one, "2^12 positions in runs of 16": runs,
            "2^13 positions on every 4th lane of a warp": strided}


def phase_xor(dev, g):
    """Kernels K and L against their plain versions: the plain layout at the
    default config's grid (2^18 uniform samples with the box's corners and
    points outside it, N = 1, 129 and 257, ``xor_edge_points``,
    ``repeated_points``) and at configs/image/base.json's 2-D grid (2^16);
    the Takikawa encoding at JAX's defaults (10 levels from depth 4 of 8
    features, 2^19, levels of 4920, 35944 and 274632 slots) over the [sdf]
    mesh's octree, at 2^16 points half within a finest cell of the surface
    (and at N = 129 and the box's faces), and at F = 2 summed, F = 4 and
    F = 2 → (K's, L's numbers at the plain 2^18 batch)."""
    from nerfshop_tpu_torch import kernels
    from nerfshop_tpu_torch.config import default_image_config, default_nerf_config
    from nerfshop_tpu_torch.geometry.triangle_octree import TriangleOctree
    from nerfshop_tpu_torch.models.encodings import TakikawaEncoding, build_encoding
    from nerfshop_tpu_torch.models.nerf_network import build_nerf_network

    cfg = default_nerf_config()
    cfg["encoding"] = {**cfg["encoding"], "layout": "plain"}
    enc = build_nerf_network(cfg, device=dev, generator=g).pos_encoding
    check(enc.layout == "plain" and enc.n_levels == 16 and max(enc.level_sizes) == 1 << 19, "not the default plain grid")
    print(f"[xor] L's table scatter by {'float4' if kernels.load().nst_xor_vector_atomics() else 'scalar'} "
          "atomics", flush=True)
    with torch.no_grad():
        enc.table.uniform_(-1.0, 1.0, generator=g)
    table = enc.table.detach()
    x = torch.rand((1 << 18, 3), generator=g, device=dev)
    x[:8] = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)], dtype=torch.float32, device=dev)
    x[8:1032] = torch.rand((1024, 3), generator=g, device=dev) * 1.4 - 0.2
    rows = xor_case("2^18 samples, the box's corners, 1024 outside it", enc, table, x, g)
    for n in (1, 129, 257):
        xor_case(f"N={n}", enc, table, x[:n].contiguous(), g, timed=False)
    xor_case("the box's faces; p0.x even, odd, res - 2 and res - 1 on every level", enc, table,
             xor_edge_points(enc, g, dev), g, timed=False)
    for label, xr in repeated_points(g, dev).items():
        xor_case(label, enc, table, xr, g, timed=False)
    enc2 = build_encoding({**default_image_config()["encoding"], "layout": "plain"}, 2, device=dev, generator=g)
    with torch.no_grad():
        enc2.table.uniform_(-1.0, 1.0, generator=g)
    x2 = torch.rand((1 << 16, 2), generator=g, device=dev)
    x2[:4] = torch.tensor([[0, 0], [1, 1], [1, 0], [0, 1]], dtype=torch.float32, device=dev)
    xor_case("2^16 samples, configs/image/base.json's grid", enc2, enc2.table.detach(), x2, g)
    del enc2, x2

    v, f = unit_mesh(bumpy_mesh())
    t0 = time.perf_counter()
    octree = TriangleOctree.build(v, f, 14)
    build_s = time.perf_counter() - t0
    xt = torch.cat([near_surface(v, f, 1 << 15, g, dev, 1.0 / (1 << 13)), torch.rand((1 << 15, 3), generator=g, device=dev)])
    xt[:3] = torch.tensor([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 1]], dtype=torch.float32, device=dev)
    print(f"[xor] the [sdf] mesh's octree to depth 14 (dense to 8) in {build_s:.3f} s", flush=True)
    for F, summed, timed in ((8, False, True), (2, True, False), (4, False, False), (2, False, False)):
        te = TakikawaEncoding(octree, n_features_per_level=F, sum_instead_of_concat=summed, device=dev, generator=g)
        check(te.level_sizes[:3] == [4920, 35944, 274632], f"not JAX's default Takikawa sizes: {te.level_sizes}")
        with torch.no_grad():
            te.table.uniform_(-1.0, 1.0, generator=g)
        xor_case("2^16 points, half within a finest cell of the surface", te, te.table.detach(), xt, g, timed=timed)
        if not summed:
            xor_case("N=129", te, te.table.detach(), xt[:129].contiguous(), g, timed=False)
            xor_case("the box's faces", te, te.table.detach(), xor_edge_points(te, g, dev), g, timed=False)
    return rows


# ------------------------------------------------------------- .ingp


#: JAX's bound on the re-baked field and on a frame after an .ingp round
#: trip (tests/test_ingp.py:99, :138): mean |Δ|
INGP_TOL = 0.02
#: bounds on the same frame where the sphere is: mean |Δ| over the pixels
#: either frame lights (read 0.0152 on an H100) and the PSNR (read 43.8 dB);
#: the whole frame's mean divides an error there by ~16
INGP_LIT_TOL = 0.05
INGP_MIN_PSNR = 35.0
#: bound on the re-bake at JAX's test configuration at its full size (read
#: 0.02056 on an H100; JAX's own fit of its test's table reads 0.0197)
REBAKE_TOL = 0.025
INGP_STEPS = 64


def frame_delta(a, b) -> dict:
    """mean |Δ| over every pixel and over the pixels either frame lights
    (α > 0.01), and the PSNR of a's rgb against b's."""
    lit = (a[..., 3] > 0.01) | (b[..., 3] > 0.01)
    d = np.abs(a - b)
    return {"mean": float(d.mean()), "lit_mean": float(d[lit].mean()) if lit.any() else 0.0,
            "lit_share": float(lit.mean()), "psnr": psnr(a[..., :3], b[..., :3])}


def rebake_at_jax_test_config(dev, g):
    """The re-bake at JAX's test configuration (tests/test_ingp.py:138: 4
    levels of 2^9, base 4, scale 2, a table ~N(0, 0.1)) at its full size (300
    Adam steps of 2^14 points) → (the mean |Δ| of the fitted field on 2^14
    uniform points, the fit's MSE). Gated at ``REBAKE_TOL``, not at JAX's
    0.02: the plain table's hash collisions floor the error near 0.02 (JAX's
    own fit of its test's table reads 0.0197 on the CPU), and the table here
    is another draw of the same distribution."""
    from nerfshop_tpu_torch.io import ingp as ingp_lib
    from nerfshop_tpu_torch.models.encodings import GridEncoding
    from nerfshop_tpu_torch.ops import table_ops
    from nerfshop_tpu_torch.ops import xor_encode as xe

    enc = GridEncoding(n_levels=4, log2_hashmap_size=9, base_resolution=4, per_level_scale=2.0, device=dev)
    table = torch.randn(tuple(enc.table.shape), generator=g, device=dev) * 0.1
    enc_p, tp, mse = ingp_lib.rebake_plain_table(enc, table)
    x = torch.rand((1 << 14, 3), generator=g, device=dev)
    with torch.no_grad():
        err = float((xe.xor_encode(tp.half().float(), x, enc_p) - table_ops.grid_encode(table, x, enc, False)[0]).abs().mean())
    return err, mse


def phase_ingp(tb, dev, g, scene: Path, workdir: Path, W=1920, H=1080):
    """[ingp]: the trained default-config network saved as .ingp (re-baked
    into the plain layout through kernels B, K and L: seconds, MSE), loaded
    through ``run.main(["--load_snapshot", ...])`` into a fresh testbed with
    the sphere scene, a 1080p exact frame against the brick network's (mean
    |Δ| < 0.02, JAX's bound; over the lit pixels < 0.05, PSNR > 35 dB), kernels
    K and L against their plain versions at the frame's middle chunk and a
    training batch, 64 training steps on the plain table (captured, K and L
    in the graph; finite, falling), then .msgpack (no compression) the same
    way; and the re-bake at JAX's test config (mean |Δ| < 0.025) → ({path:
    launches}, K's numbers at the frame chunk)."""
    import warnings

    eye = CENTER + np.array([0.9, -0.9, 0.5], np.float32)
    tb.set_look_at(eye=eye)
    brick = tb.render(W, H, spp=1, exact=True)
    paths, results = {}, {}
    k_row = None
    for suffix in (".ingp", ".msgpack"):
        path = workdir / f"model{suffix}"
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tb.save_snapshot(str(path))
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t0
        save = read_launches()
        mse_note = next((str(w.message).split("MSE ")[1].split(" ")[0] for w in caught if "MSE" in str(w.message)), "0")
        check(save["xor_encode"] > 0 and save["xor_encode_bwd"] > 0 and save["grid_encode"] > 0,
              f"the re-bake did not run through kernels B, K and L: {save}")
        check((path.read_bytes()[:1] == b"\x78") == (suffix == ".ingp"), f"{path.name}: compression as the format says")
        argv = ["--load_snapshot", str(path), "--scene", str(scene), "--n_steps", "0", "--device", "cuda"]
        new, lines, t0, _ = stamped_main(argv)
        load_s = time.perf_counter() - t0
        check(new.model.pos_encoding.layout == "plain" and new.stats.step == tb.stats.step,
              f"the {suffix} load: layout {new.model.pos_encoding.layout}, step {new.stats.step}")
        new.set_look_at(eye=eye)
        torch.cuda.synchronize()
        reset_launches()
        with encode_input_of_call(new.model.pos_encoding, middle_chunk(W, H)) as kept:
            t1 = time.perf_counter()
            img = new.render(W, H, spp=1, exact=True)
            torch.cuda.synchronize()
            frame_s = time.perf_counter() - t1
        frame = read_launches()
        check(img.shape == (H, W, 4) and bool(np.isfinite(img).all()), f"the {suffix} frame is bad")
        check(frame["xor_encode"] > 0 and frame["grid_encode"] == 0 and frame["xor_encode_bwd"] == 0,
              f"the {suffix} frame did not encode through kernel K alone: {frame}")
        delta = frame_delta(img, brick)
        check(delta["mean"] < INGP_TOL, f"the {suffix} frame: mean |d| {delta['mean']:.4f} >= {INGP_TOL}")
        check(delta["lit_mean"] < INGP_LIT_TOL and delta["psnr"] > INGP_MIN_PSNR,
              f"the {suffix} frame where lit: mean |d| {delta['lit_mean']:.4f} (bound {INGP_LIT_TOL}), "
              f"PSNR {delta['psnr']:.2f} dB (bound {INGP_MIN_PSNR})")
        results[suffix] = r = dict(save_s=save_s, mse=mse_note, size=path.stat().st_size, load_s=load_s,
                                   frame_s=frame_s, **delta)
        print(f"[ingp] {suffix}: save with the re-bake {r['save_s']:.3f} s (fit MSE {r['mse']}), {r['size'] / 2**20:.2f} "
              f"MiB, run.main --load_snapshot {r['load_s']:.3f} s; {W}x{H} exact frame of the plain table "
              f"{r['frame_s'] * 1e3:.1f} ms against the brick network's: mean |d| {r['mean']:.5f} (bound {INGP_TOL}), "
              f"over the {r['lit_share']:.4f} of pixels either lights {r['lit_mean']:.5f} (bound {INGP_LIT_TOL}), PSNR "
              f"{r['psnr']:.2f} dB (bound {INGP_MIN_PSNR})",
              flush=True)
        paths[f"{suffix[1:]}_save"], paths[f"{suffix[1:]}_frame"] = save, frame
        if suffix == ".ingp":
            enc = new.model.pos_encoding
            table = new.inference_params["pos_encoding.table"]
            check(len(kept) == 1, "the middle chunk's positions were not captured")
            k_row, _ = xor_case("the 1080p frame's middle chunk", enc, table, kept[0], g, tag="ingp")
            xb = torch.rand((BATCH, 3), generator=g, device=dev)
            xor_case("2^18 uniform samples (a training batch's shape)", enc, table, xb, g, tag="ingp", timed=False)
            torch.cuda.synchronize()
            reset_launches()
            t1 = time.perf_counter()
            new.train(n_steps=INGP_STEPS, batch_size=BATCH)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t1
            train = read_launches()
            losses = [lv for _, lv in new.loss_history][-INGP_STEPS:]
            first, last = float(np.mean(losses[:16])), float(np.mean(losses[-16:]))
            check(len(losses) == INGP_STEPS and all(math.isfinite(v) for v in losses) and last < first,
                  f"training the plain table: losses {losses}")
            per_step = {k: v / 16 for k, v in new.stats.graph_launches.items()}
            check(train["xor_encode"] > 0 and train["xor_encode_bwd"] > 0 and new.stats.captured_steps >= INGP_STEPS - 16
                  and per_step.get("xor_encode_cuda.launches", 0) > 0 and per_step.get("xor_encode_bwd_cuda.launches", 0) > 0,
                  f"training the plain table did not run K and L in the captured loop: {train}, {per_step}")
            results[".ingp"].update(train_s=train_s, first16=first, last16=last, captured=new.stats.captured_steps)
            paths["ingp_train"] = train
        del new
    err, mse = rebake_at_jax_test_config(dev, g)
    check(math.isfinite(err) and err < REBAKE_TOL, f"the re-bake at JAX's test config: mean |d| {err:.5f} >= {REBAKE_TOL}")
    r = results[".ingp"]
    print(f"[ingp] {INGP_STEPS} steps batch {BATCH} on the plain table in {r['train_s']:.3f} s ({r['captured']} captured), "
          f"loss first-16 mean {r['first16']:.4e} -> last-16 mean {r['last16']:.4e}; the re-bake at JAX's test config "
          f"(4 levels of 2^9, 300 steps of 2^14 points): mean |d| {err:.5f} (bound {REBAKE_TOL}), fit MSE {mse:.3e}; "
          f"launches {paths}", flush=True)
    return paths, k_row


# --------------------------------------------------- Takikawa and the rest


def sdf_base_config() -> dict:
    """configs/sdf/base.json: the network, loss and optimizer of the SDF
    testbed's shipped config."""
    return json.loads((Path(__file__).resolve().parent / "configs" / "sdf" / "base.json").read_text())


def takikawa_main(workdir: Path, obj: Path, steps: int):
    """``run.main`` in SDF mode on the mesh ``obj`` with a Takikawa encoding
    at JAX's defaults (10 levels from depth 4, 8 features, 2^19) and
    configs/sdf/base.json's network, loss and optimizer, ``steps`` steps at
    2^16 → ``stamped_main``'s (testbed, lines, start time, launches)."""
    cfg = sdf_base_config()
    cfg["encoding"] = {"otype": "Takikawa", "n_levels": 10, "starting_level": 4, "n_features_per_level": 8,
                       "log2_hashmap_size": 19}
    path = workdir / "takikawa.json"
    path.write_text(json.dumps(cfg))
    return stamped_main(["--mode", "sdf", "--network", str(path), "--scene", str(obj), "--n_steps", str(steps),
                         "--batch_size", str(1 << 16), "--device", "cuda"])


def phase_takikawa(workdir: Path, obj: Path, W=1920, H=1080, steps=1000):
    """[takikawa]: the [sdf] mesh through ``run.main(["--mode", "sdf",
    "--network", cfg, ...])`` with a Takikawa encoding at JAX's defaults
    (10 levels from depth 4, 8 features, 2^19) and configs/sdf/base.json's
    network, loss and optimizer: 1000 steps at 2^16 (falling loss; the
    octree's build time), a 1080p frame with analytic normals (kernel L's
    position gradient; hit share in (0.05, 0.95)), the IoU and, on points
    within one finest cell of the surface, the share where the network
    gives exactly 0 and the sign agreement on the rest (printed, not gated:
    the encoding is zero outside the octree), kernels K and L
    against their plain versions on a training batch (F = 8, a level of
    4920 slots) → {path: launches}."""
    from nerfshop_tpu_torch.geometry import bvh as bvh_lib
    from nerfshop_tpu_torch.geometry.triangle_octree import TriangleOctree

    tb, lines, t0, train = takikawa_main(workdir, obj, steps)
    steps_s, losses, t_train = training_lines(lines, steps)
    sdf = tb.sdf
    enc = sdf.model.encoding
    check(enc.takikawa and enc.level_sizes[:3] == [4920, 35944, 274632] and enc.n_output_dims == 80,
          f"not JAX's default Takikawa encoding: {enc.level_sizes}")
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], f"the Takikawa SDF loss did not fall: {losses}")
    check(train["xor_encode"] > 0 and train["xor_encode_bwd"] > 0 and train["bvh_signed_distance"] == steps,
          f"Takikawa training did not run K, L and G: {train}")
    g = sdf.generator
    g.manual_seed(G_SEED)
    pos, _ = sdf._sample_batch(1 << 16)
    xor_case("a training batch (2^16)", enc, sdf.state.inference_params["encoding.table"], pos.contiguous(), g,
             tag="takikawa", timed=False)
    t1 = time.perf_counter()
    octree = TriangleOctree.build(sdf.mesh_vertices, sdf.mesh_faces, enc.octree.depth)
    octree_s = time.perf_counter() - t1
    check(all(np.array_equal(a, b) for a, b in zip(octree.levels, enc.octree.levels)),
          "a second octree build over the normalised mesh differs from the encoding's")
    torch.cuda.synchronize()
    reset_launches()
    iou = tb.calculate_iou()
    iou_launches = read_launches()
    cell = 1.0 / (1 << (enc.starting_level + enc.n_levels - 1))
    v, f = sdf.mesh_vertices, sdf.mesh_faces.astype(np.int64)
    near = near_surface(v, f, 1 << 18, g, sdf.device, cell)
    d_true = bvh_lib.signed_distance(sdf.packed_bvh, near)
    with torch.no_grad():
        d_net = sdf.model.apply(sdf.state.inference_params, near)
    # a bias-free ReLU MLP gives exactly 0 where every hidden unit is off,
    # which the 4/8 of each batch on the surface (target 0) teaches it:
    # neither sign there, so the agreement is over the others
    zero = d_net == 0
    clear = (d_true.abs() > 1e-6) & ~zero
    agree = float((torch.sign(d_net[clear]) == torch.sign(d_true[clear])).float().mean())
    tb.render(64, 36)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    img = tb.render(W, H)
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t1) * 1e3
    frame = read_launches()
    hit = float(img[..., 3].mean())
    check(img.shape == (H, W, 4) and bool(np.isfinite(img).all()) and 0.05 < hit < 0.95,
          f"the Takikawa SDF frame is bad: {img.shape}, hit share {hit}")
    check(frame["xor_encode"] > 0 and frame["xor_encode_bwd"] > 0 and frame["fused_mlp"] > 0,
          f"the Takikawa frame did not run K, L (analytic normals) and C: {frame}")
    check(iou_launches["fused_mlp"] > 0 and iou_launches["xor_encode"] > 0, f"the IoU did not run K and C: {iou_launches}")
    print(f"[takikawa] run.main --mode sdf --network (Takikawa at JAX's defaults, configs/sdf/base.json's network): "
          f"octree to depth {enc.octree.depth} built in {octree_s:.3f} s ({int(enc.mask.numel())} "
          f"mask cells on the card), load {t_train - t0:.3f} s, {steps} steps batch {1 << 16} at {steps_s:.3f} steps/s, "
          f"loss by 100 steps {losses}; launches {train}", flush=True)
    print(f"[takikawa] calculate_iou {iou:.5f} (not gated: zero features outside the octree); within one finest cell "
          f"({cell:.3e}) of the surface the network gives exactly 0 at {float(zero.float().mean()):.5f} of "
          f"{zero.numel()} points, and the sign agreement on the other {int(clear.sum())} is {agree:.5f}; {W}x{H} frame with "
          f"analytic normals {render_ms:.1f} ms, hit share {hit:.4f}, launches K {frame['xor_encode']} L "
          f"{frame['xor_encode_bwd']} C {frame['fused_mlp']} G {frame['bvh_signed_distance']}", flush=True)
    return {"takikawa_train": train, "takikawa_iou": iou_launches, "takikawa_render": frame}


#: [encodings]: otype, its option and C's input width at 3 input dims
ELEMENTWISE = (("Frequency", {"n_frequencies": 12}, 72), ("TriangleWave", {"n_frequencies": 12}, 36),
               ("OneBlob", {"n_bins": 16}, 48))


def phase_encodings(workdir: Path, steps=200, W=480, H=270):
    """[encodings]: a short SDF run each (200 steps at 2^16 on a 5120-face
    bumpy icosphere) with a Frequency, a TriangleWave and a OneBlob position
    encoding and configs/sdf/base.json's network: the loss falling, and
    kernel C launched at the MLP's 72, 36 and 48 inputs by the IoU and a
    frame → {path: launches}."""
    from nerfshop_tpu_torch.geometry import mesh_io

    obj = workdir / "bumpy_small.obj"
    mesh_io.save_obj(obj, bumpy_mesh(4))
    out = {}
    for otype, opts, width in ELEMENTWISE:
        cfg = sdf_base_config()
        cfg["encoding"] = {"otype": otype, **opts}
        path = workdir / f"{otype}.json"
        path.write_text(json.dumps(cfg))
        tb, lines, t0, train = stamped_main(["--mode", "sdf", "--network", str(path), "--scene", str(obj), "--n_steps",
                                             str(steps), "--batch_size", str(1 << 16), "--device", "cuda"])
        steps_s, losses, _ = training_lines(lines, steps)
        check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0], f"the {otype} SDF loss did not fall: {losses}")
        check(tb.model.network.weights[0].shape[0] == width, f"{otype}: the MLP takes {tb.model.network.weights[0].shape[0]} inputs")
        torch.cuda.synchronize()
        reset_launches()
        iou = tb.calculate_iou()
        img = tb.render(W, H)
        torch.cuda.synchronize()
        used = read_launches()
        check(used["fused_mlp"] > 0 and bool(np.isfinite(img).all()),
              f"{otype}: kernel C was not launched at {width} inputs: {used}")
        print(f"[encodings] {otype} {opts}: {steps} steps at {steps_s:.3f} steps/s, loss by 100 steps {losses}; IoU "
              f"{iou:.5f}, a {W}x{H} frame: kernel C launched {used['fused_mlp']} times at {width} inputs", flush=True)
        out[f"encodings_{otype}"] = {k: train[k] + used[k] for k in train}
    return out


KERNEL_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms", "library_device_ms")


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    seg = phase_segsum(dev, g)
    enc = phase_encode(dev, g)
    phase_backward(dev, g)
    mlp = phase_mlp(dev, g)
    _, l_row = phase_xor(dev, g)
    gat = phase_gather(dev, g)
    tb, focal, principal, train_launches, train_steps_per_s = phase_main_path(dev)
    phase_train_loop(tb)
    render_launches, chunk_x = phase_render(tb)
    bake_launches, baked_frame_launches, h_row, i_row = phase_baked(tb)
    compact_launches = phase_render_compact(tb)
    frame_launches = phase_frame(tb)
    xf = phase_held_out(tb, focal, principal)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    snapshot = phase_snapshot(tb, xf, focal, principal, workdir)
    fdx = phase_encode_dx(dev, g, tb, chunk_x)
    j_row, density_launches = phase_density(tb)
    extras_launches = phase_train_extras(dev, train_steps_per_s)
    normals_launches = phase_normals(tb)
    mesh_launches = phase_mesh(tb)
    cli_launches = phase_cli(dev, snapshot, workdir)
    ingp_paths, k_row = phase_ingp(tb, dev, g, workdir / "scene", workdir)
    shutil.rmtree(workdir)
    torch.cuda.synchronize()
    reset_launches()
    gs, op, edited_frame_launches, chunk_pts = phase_edit(tb, focal, principal)
    edit_launches = read_launches()
    check_launched(edit_launches, ("grid_encode", "fused_mlp", "gather", "cage_warp_samples", "cage_warp_positions"),
                   "edit path")
    paths = {"train": train_launches, "density": density_launches, "train_extras": extras_launches,
             "render": render_launches,
             "baked": {k: bake_launches[k] + baked_frame_launches[k] for k in bake_launches},
             "render_compact": compact_launches, "frame": frame_launches, "normals": normals_launches,
             "mesh": mesh_launches, "cli": cli_launches, "edit": edit_launches, **ingp_paths}
    check_launched(paths["baked"], ("grid_encode", "fused_mlp", "shear_warp_composite", "shear_warp_screen"),
                   "baked path")
    check_launched(normals_launches, ("grid_encode", "grid_encode_dx", "gather"), "Normals frame")
    check_launched(density_launches, ("grid_encode", "fused_mlp", "grid_encode_dx", "grid_encode_dx_bwd"),
                   "density module")
    for name in ("render", "baked", "render_compact", "frame", "normals", "mesh", "edit"):
        check(paths[name]["grid_encode_fracs"] == 0, f"kernel B wrote fracs on the {name} path: {paths[name]}")
    check(edited_frame_launches["grid_encode_fracs"] == 0, "kernel B wrote fracs in the edited frame")
    split = {k: (v["grid_encode_fracs"], v["grid_encode"] - v["grid_encode_fracs"]) for k, v in paths.items()}
    print(f"[launches] per path: {paths}; in one edited 1080p frame: {edited_frame_launches}", flush=True)
    print(f"[launches] kernel B (with fracs, without) per path: {split}", flush=True)
    phase_encode_frame(tb, chunk_x)
    tet = phase_tetlookup(op, g, chunk_pts)
    op_mem, tet["cage_warp_membrane"], membrane_launches = phase_membrane(tb, gs, op, g, chunk_pts)
    paths["membrane"] = membrane_launches
    paths["baked_edit"] = phase_baked_edit(tb, gs, op_mem)
    check_launched(paths["baked_edit"], ("grid_encode", "fused_mlp", "cage_warp_membrane"), "edited bake")
    paths["distill"] = phase_distill(tb)
    phase_native(tb, gs)
    paths["viewer"] = phase_viewer(tb)
    check_launched(paths["viewer"], ("grid_encode", "fused_mlp", "segsum", "shear_warp_composite", "shear_warp_screen"),
                   "viewer backend")
    print(f"[launches] one 1080p membrane frame: {membrane_launches}; distillation (300 steps): {paths['distill']}; "
          f"the edited bake: {paths['baked_edit']}; the viewer phase: {paths['viewer']}", flush=True)
    del tb, gs, op, op_mem
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    sdf_paths, g_row = phase_sdf(workdir)
    image_paths, b2_row, a2_row = phase_image(dev, g, workdir)
    volume_paths = phase_volume(dev, workdir)
    xor_paths = {**phase_takikawa(workdir, workdir / "bumpy.obj"), **phase_encodings(workdir)}
    shutil.rmtree(workdir)
    other = {**sdf_paths, **image_paths, **volume_paths, **xor_paths}
    print(f"[launches] the SDF, Image and Volume paths: {other}", flush=True)
    paths.update(other)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    paths["captured"] = phase_captured(dev, train_steps_per_s, workdir)
    shutil.rmtree(workdir)
    print(f"[launches] the captured scene's path: {paths['captured']}", flush=True)
    launches = {k: sum(p[k] for p in paths.values()) for k in train_launches}
    for k in ("segsum", "grid_encode"):
        launches[f"{k}_d3"] = launches[k] - launches[f"{k}_d2"]
    rows = (
        ("sorted_segment_rowsum", "segsum_d3", "segsum.cu", "nerfshop_tpu/ops/pallas_segsum.py:126", seg),
        ("grid_encode", "grid_encode_d3", "grid_encode.cu", "nerfshop_tpu/ops/table_ops.py:239", enc),
        ("grid_encode_dx", "grid_encode_dx", "grid_encode.cu", "nerfshop_tpu/ops/table_ops.py:263", fdx),
        ("grid_encode_dx_bwd", "grid_encode_dx_bwd", "grid_encode.cu", "nerfshop_tpu/torch_interop.py:55", j_row),
        ("fused_mlp", "fused_mlp", "fused_mlp.cu", "scratch/probe_arch.py:56", mlp),
        ("gather", "gather", "gather.cu", "scratch/probe_arch.py:32", gat),
        ("tet_lookup", "tet_lookup", "tet_lookup.cu", "nerfshop_tpu/editing/operators.py:74", tet["tet_lookup"]),
        ("cage_warp_samples", "cage_warp_samples", "tet_lookup.cu", "nerfshop_tpu/editing/operators.py:150",
         tet["cage_warp_samples"]),
        ("cage_warp_positions", "cage_warp_positions", "tet_lookup.cu", "nerfshop_tpu/editing/operators.py:177",
         tet["cage_warp_positions"]),
        ("cage_warp_membrane", "cage_warp_membrane", "tet_lookup.cu", "nerfshop_tpu/editing/operators.py:291",
         tet["cage_warp_membrane"]),
        ("sorted_segment_rowsum_d2", "segsum_d2", "segsum.cu", "nerfshop_tpu/ops/pallas_segsum.py:126", a2_row),
        ("grid_encode_d2", "grid_encode_d2", "grid_encode.cu", "nerfshop_tpu/ops/table_ops.py:239", b2_row),
        ("bvh_signed_distance", "bvh_signed_distance", "bvh.cu", "nerfshop_tpu/geometry/bvh.py:196", g_row),
        ("shear_warp_composite", "shear_warp_composite", "baked.cu", "nerfshop_tpu/render/baked.py:492", h_row),
        ("shear_warp_screen", "shear_warp_screen", "baked.cu", "nerfshop_tpu/render/baked.py:566", i_row),
        ("xor_encode", "xor_encode", "xor_encode.cu", "nerfshop_tpu/models/encodings.py:385", k_row),
        ("xor_encode_bwd", "xor_encode_bwd", "xor_encode.cu", "nerfshop_tpu/models/encodings.py:492", l_row),
    )
    kernels = [
        {"name": name, "route": "cuda", "source": f"nerfshop_tpu_torch/csrc/{src}", "replaces": repl,
         "launches": launches[key], **{k: r[k] for k in KERNEL_KEYS}}
        for name, key, src, repl, r in rows
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
