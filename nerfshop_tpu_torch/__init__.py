"""nerfshop_tpu_torch — the PyTorch/CUDA port of ``nerfshop_tpu``.

The JAX package beside it stays the reference: each module here mirrors the
JAX module of the same path, and every Pallas kernel on the ported path is a
CUDA kernel written by hand for Hopper (``csrc/``, built by ``kernels.py``).
This package imports ``torch`` and never ``jax``, and no module of the JAX
package: the host modules it needs (``common``, ``config``, ``data``, the
mesh helpers of ``geometry``) are its own copies.

The MLPs reproduce JAX's bf16-operand / fp32-result products with fp32
matmuls on bf16-rounded operands, which is exact only without TF32, so the
package turns TF32 off for matmuls and convolutions on import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from nerfshop_tpu_torch.common import TestbedMode  # noqa: E402


def __getattr__(name):
    if name == "Testbed":
        from nerfshop_tpu_torch.testbed import Testbed

        return Testbed
    raise AttributeError(f"module 'nerfshop_tpu_torch' has no attribute {name!r}")


__all__ = ["Testbed", "TestbedMode"]
