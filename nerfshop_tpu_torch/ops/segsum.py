"""Per-row gradient sums over samples sorted by table slot.

Counterpart of ``nerfshop_tpu/ops/pallas_segsum.py::sorted_segment_rowsum``:
same inputs (one hash level's samples sorted by slot), same ``[m, 2^D·F]``
output. On a CUDA tensor the wrapper launches kernel A
(``csrc/segsum.cu``); on a CPU tensor it runs :func:`sorted_segment_rowsum_plain`.
"""

from __future__ import annotations

import torch

from nerfshop_tpu_torch import kernels

#: samples per block of kernel A (``kTile`` in ``csrc/segsum.cu``); the
#: scratch of the runs that cross a tile edge holds two rows per tile
TILE = 512


def corner_products(w1: torch.Tensor) -> torch.Tensor:
    """Folded per-axis lerp fractions w1 [..., D] → corner weights [..., 2^D]
    (w8_c = Π_d (w1_d if bit d of c is set else 1 − w1_d), d ascending)."""
    D = w1.shape[-1]
    cols = []
    for c in range(1 << D):
        w = None
        for d in range(D):
            f = w1[..., d] if (c >> d) & 1 else 1.0 - w1[..., d]
            w = f if w is None else w * f
        cols.append(w)
    return torch.stack(cols, dim=-1)


def sorted_segment_rowsum_plain(key_s: torch.Tensor, w1_s: torch.Tensor, dout_s: torch.Tensor, m: int) -> torch.Tensor:
    """Plain PyTorch version: scatter-add of the w8 ⊗ dout rows."""
    N, F = dout_s.shape
    w8 = corner_products(w1_s)
    ct = (w8[:, :, None] * dout_s[:, None, :]).reshape(N, w8.shape[1] * F)
    out = torch.zeros((m, ct.shape[1]), dtype=torch.float32, device=key_s.device)
    return out.index_add_(0, key_s.long(), ct)


@kernels.counted("launches", "d2_launches")
def sorted_segment_rowsum_cuda(key_s: torch.Tensor, w1_s: torch.Tensor, dout_s: torch.Tensor, m: int) -> torch.Tensor:
    """Kernel A → [m, 2^D·2]. Takes D = 3 or D = 2 (from w1_s), F = 2, and
    raises on anything else. Two launches (N = 0: one memset);
    deterministic. ``d2_launches`` counts the D = 2 instance."""
    dev = key_s.device
    if dev.type != "cuda":
        raise ValueError(f"segsum kernel: key_s on {dev}, expected a CUDA device")
    N = key_s.shape[0]
    D = w1_s.shape[-1] if w1_s.ndim == 2 else 0
    if not (
        key_s.dtype == torch.int32 and w1_s.dtype == torch.float32 and dout_s.dtype == torch.float32
        and key_s.ndim == 1 and D in (2, 3) and w1_s.shape == (N, D) and dout_s.shape == (N, 2)
        and w1_s.device == dev and dout_s.device == dev
        and key_s.is_contiguous() and w1_s.is_contiguous() and dout_s.is_contiguous()
    ):
        raise ValueError(
            "segsum kernel takes contiguous key_s [N] int32, w1_s [N, D] f32 with D = 2 or 3, dout_s [N, 2] f32 "
            "on one device; got "
            + ", ".join(f"{name} {tuple(t.shape)} {t.dtype} on {t.device}{'' if t.is_contiguous() else ' (strided)'}"
                        for name, t in (("key_s", key_s), ("w1_s", w1_s), ("dout_s", dout_s)))
        )
    W = (1 << D) * 2
    # the scratch of the runs that cross a tile edge (two rows per tile)
    # follows the m output rows in one allocation
    buf = torch.empty((m + 2 * (-(-N // TILE)), W), dtype=torch.float32, device=dev)
    out_p = buf.data_ptr()
    err = kernels.load().nst_segsum(
        key_s.data_ptr(), w1_s.data_ptr(), dout_s.data_ptr(), out_p, out_p + 4 * W * m, N, m, D,
        kernels.aligned16(key_s, w1_s, dout_s), kernels.stream_ptr(dev),
    )
    kernels.check(err, "segsum")
    sorted_segment_rowsum_cuda.launches += 1
    sorted_segment_rowsum_cuda.d2_launches += D == 2
    return buf[:m]


def sorted_segment_rowsum(key_s: torch.Tensor, w1_s: torch.Tensor, dout_s: torch.Tensor, m: int) -> torch.Tensor:
    """key_s [N] int32 sorted ascending, w1_s [N, D], dout_s [N, F] → [m, 2^D·F]:
    row r = Σ_{n: key_n = r} w8_n ⊗ dout_n. CPU tensors take the plain
    version; CUDA tensors launch kernel A or raise."""
    if key_s.device.type == "cpu":
        return sorted_segment_rowsum_plain(key_s, w1_s, dout_s, m)
    if key_s.device.type != "cuda":
        raise ValueError(f"sorted_segment_rowsum: unsupported device {key_s.device}")
    return sorted_segment_rowsum_cuda(key_s, w1_s, dout_s, m)
