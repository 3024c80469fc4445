"""Per-row gradient sums over samples sorted by table slot.

Counterpart of ``nerfshop_tpu/ops/pallas_segsum.py::sorted_segment_rowsum``:
same inputs (one hash level's samples sorted by slot), same ``[m, 2^D·F]``
output. On a CUDA tensor the wrapper launches kernel A
(``csrc/segsum.cu``); on a CPU tensor it runs :func:`sorted_segment_rowsum_plain`.
"""

from __future__ import annotations

import torch

from nerfshop_tpu_torch import kernels


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
    ct = (w8[:, :, None] * dout_s[:, None, :]).reshape(N, -1)
    out = torch.zeros((m, ct.shape[1]), dtype=torch.float32, device=key_s.device)
    return out.index_add_(0, key_s.long(), ct)


def sorted_segment_rowsum_cuda(key_s: torch.Tensor, w1_s: torch.Tensor, dout_s: torch.Tensor, m: int) -> torch.Tensor:
    """Kernel A. Takes D = 3, F = 2 (the hash grid's shape) and raises on anything else."""
    dev = key_s.device
    N = key_s.shape[0]
    kernels.require(key_s, "key_s", torch.int32, (N,), dev)
    kernels.require(w1_s, "w1_s", torch.float32, (N, 3), dev)
    kernels.require(dout_s, "dout_s", torch.float32, (N, 2), dev)
    out = torch.empty((m, 16), dtype=torch.float32, device=dev)
    lib = kernels.load()
    err = lib.nst_segsum(
        key_s.data_ptr(), w1_s.data_ptr(), dout_s.data_ptr(), out.data_ptr(),
        N, m, kernels.stream_ptr(dev),
    )
    kernels.check(err, "segsum")
    sorted_segment_rowsum_cuda.launches += 1
    return out


#: launches of kernel A since the last reset
sorted_segment_rowsum_cuda.launches = 0


def sorted_segment_rowsum(key_s: torch.Tensor, w1_s: torch.Tensor, dout_s: torch.Tensor, m: int) -> torch.Tensor:
    """key_s [N] int32 sorted ascending, w1_s [N, D], dout_s [N, F] → [m, 2^D·F]:
    row r = Σ_{n: key_n = r} w8_n ⊗ dout_n. CPU tensors take the plain
    version; CUDA tensors launch kernel A or raise."""
    if key_s.device.type == "cpu":
        return sorted_segment_rowsum_plain(key_s, w1_s, dout_s, m)
    if key_s.device.type != "cuda":
        raise ValueError(f"sorted_segment_rowsum: unsupported device {key_s.device}")
    return sorted_segment_rowsum_cuda(key_s, w1_s, dout_s, m)
