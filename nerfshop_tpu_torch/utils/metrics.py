"""Image quality metrics: MSE, PSNR, SSIM, L1, MAPE, SMAPE, relative MSE and
a FLIP-style perceptual error, in numpy on the host.

The port's own copy of ``nerfshop_tpu/utils/metrics.py``, so that the port
imports nothing of the JAX package; ``tests/test_torch_host_copies.py``
holds its code to the original's."""

from __future__ import annotations

import numpy as np


def luminance(img: np.ndarray) -> np.ndarray:
    return 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    m = mse(a, b)
    return float(10 * np.log10(max_val**2 / max(m, 1e-12)))


def l1(a, b) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def mape(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean(np.abs(a - b) / (np.abs(b) + 1e-2)))


def smape(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean(2 * np.abs(a - b) / (np.abs(a) + np.abs(b) + 1e-2)))


def relative_mse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.mean((a - b) ** 2 / (b**2 + 1e-2)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    k = np.outer(g, g)
    return k / k.sum()


def _filter2d(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """'valid' 2D correlation per channel via FFT-free sliding windows."""
    from numpy.lib.stride_tricks import sliding_window_view

    kh, kw = kernel.shape
    win = sliding_window_view(img, (kh, kw), axis=(0, 1))
    if img.ndim == 3:
        return np.einsum("ijckl,kl->ijc", win, kernel)
    return np.einsum("ijkl,kl->ij", win, kernel)


def ssim(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Standard single-scale SSIM with 11×11 gaussian window (Wang et al.)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], max_val) for c in range(a.shape[-1])]))
    k = _gaussian_kernel()
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_a = _filter2d(a, k)
    mu_b = _filter2d(b, k)
    var_a = _filter2d(a * a, k) - mu_a**2
    var_b = _filter2d(b * b, k) - mu_b**2
    cov = _filter2d(a * b, k) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return float(np.mean(s))


def _gauss1d(sigma: float) -> np.ndarray:
    r = max(int(np.ceil(3 * sigma)), 1)
    x = np.arange(-r, r + 1)
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur with edge padding (per channel)."""
    if sigma <= 0:
        return img
    k = _gauss1d(sigma)
    r = len(k) // 2
    pad = [(r, r), (r, r)] + [(0, 0)] * (img.ndim - 2)
    p = np.pad(img, pad, mode="edge")
    from numpy.lib.stride_tricks import sliding_window_view

    p = np.einsum("i...k,k->i...", sliding_window_view(p, len(k), axis=0), k)
    p = np.einsum("i...k,k->i...", sliding_window_view(p, len(k), axis=1), k)
    return p


def flip(pred: np.ndarray, gt: np.ndarray, ppd: float = 67.0) -> float:
    """ꟻLIP-style perceptual error (Andersson et al. 2020; the reference
    vendors NVIDIA's implementation under scripts/flip/). This is a faithful
    simplification: CSF-filtered YCxCz color difference (HyAB, Hunt-adjusted)
    combined with edge/point feature differences via the paper's
    ΔE = ΔEc^(1−ΔEf) amplification. Returns the mean FLIP value in [0, 1]."""
    a = np.clip(np.asarray(pred, np.float64)[..., :3], 0, 1)
    b = np.clip(np.asarray(gt, np.float64)[..., :3], 0, 1)

    def srgb_to_linear(c):
        return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)

    def to_ycxcz(c):
        lin = srgb_to_linear(c)
        y = lin @ np.array([0.2126729, 0.7151522, 0.0721750])
        cx = lin[..., 0] - lin[..., 1]
        cz = lin[..., 2] - y
        return np.stack([y, cx, cz], -1)

    ya, yb = to_ycxcz(a), to_ycxcz(b)
    # CSF as channel-specific gaussian low-pass; sigma in pixels from ppd
    sig = 0.0047 * ppd
    fa = np.stack([_blur(ya[..., 0], sig), _blur(ya[..., 1], 2 * sig), _blur(ya[..., 2], 4 * sig)], -1)
    fb = np.stack([_blur(yb[..., 0], sig), _blur(yb[..., 1], 2 * sig), _blur(yb[..., 2], 4 * sig)], -1)
    # Hunt adjustment: chroma scaled by luminance
    la = np.clip(fa[..., 0:1], 0, 1)
    lb = np.clip(fb[..., 0:1], 0, 1)
    ca = np.concatenate([fa[..., 0:1], fa[..., 1:] * la], -1)
    cb = np.concatenate([fb[..., 0:1], fb[..., 1:] * lb], -1)
    # HyAB: |ΔL| + ||Δchroma||
    de_c = np.abs(ca[..., 0] - cb[..., 0]) + np.linalg.norm(ca[..., 1:] - cb[..., 1:], axis=-1)
    de_c = np.clip(de_c / 1.0, 0, 1) ** 0.7

    # feature difference on luminance: edges (1st deriv) & points (2nd deriv)
    def grad_mag(y, sigma):
        g = _blur(y, sigma)
        gx = np.gradient(g, axis=1)
        gy = np.gradient(g, axis=0)
        return np.sqrt(gx**2 + gy**2)

    def lap_mag(y, sigma):
        g = _blur(y, sigma)
        return np.abs(
            -4 * g + np.roll(g, 1, 0) + np.roll(g, -1, 0) + np.roll(g, 1, 1) + np.roll(g, -1, 1)
        )

    s_f = 0.5 * ppd / 67.0
    edge = np.abs(grad_mag(ya[..., 0], s_f) - grad_mag(yb[..., 0], s_f))
    point = np.abs(lap_mag(ya[..., 0], s_f) - lap_mag(yb[..., 0], s_f))
    de_f = np.clip(np.maximum(edge, point) * 4.0, 0, 1) ** 0.5

    return float(np.mean(de_c ** (1.0 - de_f)))


ALL_METRICS = {
    "MSE": mse,
    "PSNR": psnr,
    "SSIM": ssim,
    "L1": l1,
    "MAPE": mape,
    "SMAPE": smape,
    "MRSE": relative_mse,
    "FLIP": flip,
}


def compute_error(metric: str, a: np.ndarray, b: np.ndarray) -> float:
    return ALL_METRICS[metric.upper()](a, b)
