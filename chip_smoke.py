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
  6. the main path: the default tcnn-parity NeRF (16 levels × 2 features,
     2^19 table, 64-wide MLPs) trained through ``Testbed.train`` with batch
     2^18 on an analytic opaque-sphere scene, then one held-out view
     rendered (march "first", K = 512) and scored in PSNR.
Then a JSON line with every kernel's launches on the main path, error and
times, the ``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero; without a CUDA device it exits non-zero before printing a
result. Times are medians over repeated runs, measured with CUDA events
after a warm-up.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

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


@torch.no_grad()
def render_view(tb, xf, focal, principal, chunk=2048):
    """Held-out view: march "first" (K = 512) → network (EMA params) → composite on black."""
    from nerfshop_tpu_torch.ops import composite as comp, coords, march

    dev = tb.device
    cfg = tb.train_config
    aabb = coords.BoundingBox.from_aabb_scale(cfg.aabb_scale, device=dev)
    bundle = view_rays(xf, focal, principal, dev)
    params = tb.inference_params
    out = []
    for i in range(0, RES * RES, chunk):
        o, d = bundle.origins[i : i + chunk], bundle.directions[i : i + chunk]
        s = march.march_rays(o, d, tb.grid.occupancy, aabb.min, aabb.max, cfg.cone_angle, k_samples=512, t_start_min=0.05)
        R, K = s.t.shape
        pos_w, dir_w = march.samples_to_network_inputs(s, o, d, aabb)
        rgb, sigma = torch.func.functional_call(tb.model, params, (pos_w.reshape(-1, 3), dir_w.reshape(-1, 3)))
        res = comp.composite(sigma.reshape(R, K), rgb.reshape(R, K, 3), s.dt, s.t, s.valid, 1e-4)
        out.append(comp.composite_with_background(res, torch.zeros(3, device=dev)))
    return torch.cat(out).reshape(RES, RES, 3).cpu().numpy()


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


def phase_main_path(dev):
    from nerfshop_tpu.common import TestbedMode
    from nerfshop_tpu.config import default_nerf_config
    from nerfshop_tpu_torch.ops import segsum, table_ops
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
    segsum.sorted_segment_rowsum_cuda.launches = 0
    table_ops.grid_encode_cuda.launches = 0
    t0 = time.perf_counter()
    tb.train(n_steps=STEPS, batch_size=BATCH)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"segsum": segsum.sorted_segment_rowsum_cuda.launches, "grid_encode": table_ops.grid_encode_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    losses = [lv for _, lv in tb.loss_history]
    check(len(losses) == STEPS and all(math.isfinite(v) for v in losses), "non-finite or missing losses")
    tail = float(np.mean(losses[-10:]))
    check(tail < 0.35 * losses[0], f"loss did not fall enough: first {losses[0]:.4e} last-10 mean {tail:.4e}")
    check(tb.stats.measured_samples_total > 0, "no samples measured")
    check(launches["segsum"] > 0 and launches["grid_encode"] > 0, f"a kernel was not launched: {launches}")

    # one full grid refresh, timed on a copy of the grid
    g = tb.grid
    copy = grid_lib.OccupancyGrid(g.density.clone(), g.occupancy.clone(), g.mean_density.clone())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nerf_train.update_grid(tb.model, copy, tb.train_config, tb.generator, full_refresh=True, trained_mask=tb.trained_mask)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0

    xf = look_at(CENTER + np.array([0.9, 0.9, 0.5], np.float32))
    b = view_rays(xf, focal, principal, dev)
    gt = sphere_rgba(b.origins.cpu().numpy(), b.directions.cpu().numpy()).reshape(RES, RES, 4)
    img = render_view(tb, xf, focal, principal)
    check(img.shape == (RES, RES, 3) and np.isfinite(img).all(), "render is not finite / of the expected shape")
    psnr = -10 * math.log10(float(np.mean((img - gt[..., :3] * gt[..., 3:]) ** 2)) + 1e-12)
    check(psnr >= 14.0, f"held-out PSNR {psnr:.2f} dB < 14")
    print(
        f"[train] {STEPS} steps batch {BATCH} in {train_s:.3f} s: {STEPS / train_s:.3f} steps/s, "
        f"{tb.stats.measured_samples_total / train_s:.6g} real samples/s "
        f"({tb.stats.measured_samples_total} samples), loss {losses[0]:.4e} -> last-10 {tail:.4e} "
        f"(ratio {tail / losses[0]:.3f}), final (rays, K) = ({tb.train_config.n_rays_per_batch}, {tb.train_config.k_samples}), "
        f"occupancy {float(g.occupancy.float().mean()):.4f}",
        flush=True,
    )
    print(f"[train] grid full refresh {refresh_s:.4f} s, peak memory {peak / 2**30:.3f} GiB, launches {launches}", flush=True)
    print(f"[render] held-out {RES}x{RES} PSNR {psnr:.2f} dB (bound 14)", flush=True)
    return launches


def main() -> None:
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    seg = phase_segsum(dev, g)
    enc = phase_encode(dev, g)
    phase_backward(dev, g)
    launches = phase_main_path(dev)
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
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
