#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nerfshop_tpu_torch``) once on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one line of its own numbers:
  1. device: torch/CUDA versions, the card's name and power limit;
  2. build: compile the CUDA kernels of ``nerfshop_tpu_torch/csrc``;
  3. kernel A (sorted segment row-sum) against its plain PyTorch version;
  4. kernel B (hash-grid encode forward) against its plain version;
  5. the encode backward (sort + kernel A + corner rolls) against autograd
     of the plain forward;
  6. kernel C (fused MLP forward) against its plain version at 2^20 rows,
     for the density (32→64→16) and the rgb (32→64→64→3) MLP;
  7. the training path: the default tcnn-parity NeRF (16 levels × 2
     features, 2^19 table, 64-wide MLPs) trained through ``Testbed.train``
     with batch 2^18 on an analytic opaque-sphere scene;
  8. the render path: ``Testbed.render(1920, 1080, exact=True)`` of the
     trained model (one warm-up frame, then the median of 3), plus one
     256×256 frame each in Depth and Cost mode;
  9. the viewer path: ``Testbed.frame()`` (no training) three times into a
     1920×1080 frame buffer, through ``render_dynamic``'s dynamic
     resolution and its on-device bilinear upsample;
 10. held-out: one 128×128 view through ``Testbed.render``, scored in PSNR;
 11. snapshot: ``save_snapshot`` → a fresh ``Testbed`` → ``load_snapshot``
     renders the same view as before saving.
Then a JSON line with every kernel's launches on the main paths (training
render and frame), error and times, the ``nvidia-smi`` name/power-limit line, and
as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero; without a CUDA device it exits
non-zero before printing a result. Kernel times are medians over repeated
runs, measured with CUDA events after a warm-up.
"""

from __future__ import annotations

import json
import math
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


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def median_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, after 3 warm-up calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    from nerfshop_tpu.data.nerf_loader import CameraIntrinsics, NerfDataset

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


def phase_segsum(dev, g):
    """Kernel A at a main-path level (N = 2^18 keys over m = 2^19), a small
    dense level, and a skew beyond a training batch's (whose masked samples
    pile onto a few slots): 80% of the keys in one slot. Tolerance: |kernel − plain| ≤ 1e-5 · Σ|terms| of the row
    (fp32, other summation order)."""
    from nerfshop_tpu_torch.ops import segsum

    result = {}
    for label, m, N in (("hash", 1 << 19, 1 << 18), ("dense", 4096, 1 << 18), ("skewed", 1 << 19, 1 << 18)):
        key = torch.randint(0, m, (N,), generator=g, device=dev, dtype=torch.int32)
        if label == "skewed":
            key[: (N * 4) // 5] = 12345
        key = torch.sort(key).values.contiguous()
        w1 = torch.rand((N, 3), generator=g, device=dev)
        dout = torch.randn((N, 2), generator=g, device=dev)
        ker = segsum.sorted_segment_rowsum_cuda(key, w1, dout, m)
        plain = segsum.sorted_segment_rowsum_plain(key, w1, dout, m)
        absum = segsum.sorted_segment_rowsum_plain(key, w1, dout.abs(), m)
        torch.cuda.synchronize()
        err = (ker - plain).abs()
        check(bool((err <= 1e-5 * absum + 1e-30).all()), f"kernel A disagrees ({label}): max err {float(err.max())}")
        untouched = absum.sum(1) == 0
        check(bool((ker[untouched] == 0).all()), "kernel A left an unhit row non-zero")
        ms = median_ms(lambda: segsum.sorted_segment_rowsum_cuda(key, w1, dout, m))
        plain_ms = median_ms(lambda: segsum.sorted_segment_rowsum_plain(key, w1, dout, m))
        print(
            f"[segsum] {label} m={m} N={N}: max_abs_err {float(err.max()):.3e} "
            f"(bound 1e-5*row sum|terms|) kernel {ms:.4f} ms plain {plain_ms:.4f} ms",
            flush=True,
        )
        result[label] = (float(err.max()), ms, plain_ms)
    return max(r[0] for r in result.values()), result["hash"][1], result["hash"][2]


def _encoding(dev, g):
    from nerfshop_tpu.config import default_nerf_config
    from nerfshop_tpu_torch.models.nerf_network import build_nerf_network

    enc = build_nerf_network(default_nerf_config(), device=dev, generator=g).pos_encoding
    with torch.no_grad():
        enc.table.uniform_(-1.0, 1.0, generator=g)
    N = 1 << 18
    x = torch.rand((N, 3), generator=g, device=dev)
    x[:6] = torch.tensor([[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.5, 1, 0], [0, 1, 1], [1, 1, 0]], device=dev)
    return enc, x


def phase_encode(dev, g):
    """Kernel B: idx equal, w1 and out within 1e-6 absolute of the plain version."""
    from nerfshop_tpu_torch.ops import table_ops

    enc, x = _encoding(dev, g)
    table = enc.table.detach()
    out_k, idx_k, w1_k = table_ops.grid_encode_cuda(table, x, enc)
    out_p, idx_p, w1_p = table_ops.grid_encode_plain(table, x, enc)
    torch.cuda.synchronize()
    check(torch.equal(idx_k, idx_p), f"kernel B slots differ at {int((idx_k != idx_p).sum())} (sample, level) pairs")
    w1_err = float((w1_k - w1_p).abs().max())
    out_err = float((out_k - out_p).abs().max())
    check(w1_err <= 1e-6 and out_err <= 1e-6, f"kernel B disagrees: w1 {w1_err:.3e} out {out_err:.3e}")
    ms = median_ms(lambda: table_ops.grid_encode_cuda(table, x, enc))
    plain_ms = median_ms(lambda: table_ops.grid_encode_plain(table, x, enc))
    print(
        f"[encode] N={x.shape[0]} L={enc.n_levels}: slots equal, w1 err {w1_err:.3e} out err {out_err:.3e} "
        f"(bound 1e-6) kernel {ms:.4f} ms plain {plain_ms:.4f} ms",
        flush=True,
    )
    return out_err, ms, plain_ms


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

    def backward_ms(make):
        times = []
        for i in range(TIMING_RUNS + 3):
            t, out = make()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out.backward(ct)
            b.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(a.elapsed_time(b))
        return statistics.median(times)

    ms, plain_ms = backward_ms(ours), backward_ms(plain)
    print(
        f"[backward] d_table max err {err:.3e} (bound 1e-5*{ref_max:.3e}) "
        f"sorted+kernel A {ms:.4f} ms plain index_add autograd {plain_ms:.4f} ms",
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
    for label, dims in (("density", (32, 64, 16)), ("rgb", (32, 64, 64, 3))):
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
        ms = median_ms(lambda: fused_mlp.fused_mlp_cuda(x, ws))
        plain_ms = median_ms(lambda: fused_mlp.fused_mlp_plain(x, ws))
        print(
            f"[mlp] {label} {'->'.join(map(str, dims))} N={N}: {within:.6f} of outputs within 1e-6+1e-5*|plain| "
            f"(bound 0.995), max_abs_err {float(err.max()):.3e} of max|out| {ref_max:.3e} (bound 1e-2*max) "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms",
            flush=True,
        )
        result[label] = (float(err.max()), ms, plain_ms)
    return max(r[0] for r in result.values()), result["density"][1], result["density"][2]


def reset_launches():
    from nerfshop_tpu_torch.ops import fused_mlp, segsum, table_ops

    segsum.sorted_segment_rowsum_cuda.launches = 0
    table_ops.grid_encode_cuda.launches = 0
    fused_mlp.fused_mlp_cuda.launches = 0


def read_launches():
    from nerfshop_tpu_torch.ops import fused_mlp, segsum, table_ops

    return {
        "segsum": segsum.sorted_segment_rowsum_cuda.launches,
        "grid_encode": table_ops.grid_encode_cuda.launches,
        "fused_mlp": fused_mlp.fused_mlp_cuda.launches,
    }


def psnr(img, gt):
    return -10 * math.log10(float(np.mean((img - gt) ** 2)) + 1e-12)


def phase_main_path(dev):
    from nerfshop_tpu.common import TestbedMode
    from nerfshop_tpu.config import default_nerf_config
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
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched in training: {launches}")

    # one full grid refresh, timed on a copy of the grid
    g = tb.grid
    copy = grid_lib.OccupancyGrid(g.density.clone(), g.occupancy.clone(), g.mean_density.clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nerf_train.update_grid(tb.model, copy, tb.train_config, tb.generator, full_refresh=True, trained_mask=tb.trained_mask)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0

    print(
        f"[train] {STEPS} steps batch {BATCH} in {train_s:.3f} s: {STEPS / train_s:.3f} steps/s, "
        f"{tb.stats.measured_samples_total / train_s:.6g} real samples/s "
        f"({tb.stats.measured_samples_total} samples), loss {losses[0]:.4e} -> last-10 {tail:.4e} "
        f"(ratio {tail / losses[0]:.3f}), final (rays, K) = ({tb.train_config.n_rays_per_batch}, {tb.train_config.k_samples}), "
        f"occupancy {float(g.occupancy.float().mean()):.4f}",
        flush=True,
    )
    print(f"[train] grid full refresh {refresh_s:.4f} s, peak memory {peak / 2**30:.3f} GiB, launches {launches}", flush=True)
    return tb, focal, principal, launches


def phase_render(tb, W=1920, H=1080):
    """The render path: ``Testbed.render(W, H, exact=True)`` of the trained
    model; the launch counts are those of the warm-up frame."""
    from nerfshop_tpu.common import RenderMode

    tb.set_look_at(eye=CENTER + np.array([0.9, -0.9, 0.5], np.float32))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    img = tb.render(W, H, spp=1, exact=True)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    check(img.shape == (H, W, 4) and np.isfinite(img).all(), "1080p frame is not finite / of the expected shape")
    check(launches["grid_encode"] > 0 and launches["fused_mlp"] > 0, f"a kernel was not launched in the frame: {launches}")
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
    return launches


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
    check(launches["grid_encode"] > 0 and launches["fused_mlp"] > 0, f"a kernel was not launched in frame(): {launches}")
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


def phase_snapshot(tb, xf, focal, principal):
    """save_snapshot → fresh Testbed → load_snapshot → the same view: max |Δ| ≤ 1e-6."""
    from nerfshop_tpu_torch.testbed import Testbed

    kw = dict(camera_matrix=xf, focal=focal, principal=principal, exact=True)
    before = tb.render(RES, RES, **kw)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/model.snap"
        t0 = time.perf_counter()
        tb.save_snapshot(path)
        save_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
        fresh = Testbed(device=tb.device, seed=1)
        t0 = time.perf_counter()
        fresh.load_snapshot(path)
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
    tb, focal, principal, train_launches = phase_main_path(dev)
    render_launches = phase_render(tb)
    frame_launches = phase_frame(tb)
    xf = phase_held_out(tb, focal, principal)
    phase_snapshot(tb, xf, focal, principal)
    launches = {k: train_launches[k] + render_launches[k] + frame_launches[k] for k in train_launches}
    kernels = [
        {
            "name": "sorted_segment_rowsum", "route": "cuda", "source": "nerfshop_tpu_torch/csrc/segsum.cu",
            "replaces": "nerfshop_tpu/ops/pallas_segsum.py:126", "launches": launches["segsum"],
            "max_abs_err": seg[0], "ms": seg[1], "plain_ms": seg[2],
        },
        {
            "name": "grid_encode", "route": "cuda", "source": "nerfshop_tpu_torch/csrc/grid_encode.cu",
            "replaces": "nerfshop_tpu/ops/table_ops.py:239", "launches": launches["grid_encode"],
            "max_abs_err": enc[0], "ms": enc[1], "plain_ms": enc[2],
        },
        {
            "name": "fused_mlp", "route": "cuda", "source": "nerfshop_tpu_torch/csrc/fused_mlp.cu",
            "replaces": "scratch/probe_arch.py:56", "launches": launches["fused_mlp"],
            "max_abs_err": mlp[0], "ms": mlp[1], "plain_ms": mlp[2],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
