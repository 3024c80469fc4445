"""2D image fitting: the Image testbed.

Counterpart of ``nerfshop_tpu/train/image.py``: pixel coordinates in
[0,1]² → a 2-D hash grid (kernel B at D = 2 on the card) → an MLP → RGB,
with the L2 loss against the bilinearly sampled target. A training step
records the encode with fracs and takes the table gradient through kernel
A at D = 2; a render (``render_full_image``) encodes without fracs and runs
the MLP through kernel C.
"""

from __future__ import annotations

from typing import Tuple

import torch

from nerfshop_tpu_torch.models.field import FieldModel


class ImageModel(FieldModel):
    @classmethod
    def from_config(cls, config: dict, device=None, generator=None) -> "ImageModel":
        return cls.build(config, 2, 3, device, generator)

    def forward(self, xy: torch.Tensor) -> torch.Tensor:
        """xy in [0,1]² → rgb [N, 3]."""
        return self.raw(xy)


def sample_image_bilinear(image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """image [H, W, C], xy in [0,1]² (x = column, y = row) → [N, C];
    cell-centred."""
    H, W = image.shape[:2]
    px = xy[:, 0] * W - 0.5
    py = xy[:, 1] * H - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    x0 = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y0 = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    v00, v01 = image[y0, x0], image[y0, x1]
    v10, v11 = image[y1, x0], image[y1, x1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def train_step(model: ImageModel, state, loss_fn, image: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """One step at the uniform draws xy [B, 2] → the loss (a 0-d tensor;
    no host sync). ``state`` is the model's ``optim.TrainState``."""
    target = sample_image_bilinear(image, xy)[:, :3]
    names, params = zip(*model.named_parameters())
    with torch.enable_grad():
        loss = loss_fn(target, model(xy)).mean()
        grads = torch.autograd.grad(loss, params)
    state.apply_gradients(dict(zip(names, grads)))
    return loss.detach()


@torch.no_grad()
def render_full_image(model: ImageModel, params, resolution: Tuple[int, int], chunk: int = 1 << 18) -> torch.Tensor:
    """The field at every pixel centre → [H, W, 3], in chunks of ``chunk``
    pixels on the model's device."""
    H, W = resolution
    dev = next(model.parameters()).device
    ys, xs = torch.meshgrid(
        (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H,
        (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W,
        indexing="ij",
    )
    xy = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    outs = [model.apply(params, xy[i : i + chunk]) for i in range(0, xy.shape[0], chunk)]
    return torch.cat(outs).reshape(H, W, 3)


def compute_image_mse(pred: torch.Tensor, target: torch.Tensor, quantize: bool = False) -> torch.Tensor:
    """Mean squared error (the reference's ``Testbed::compute_image_mse``)."""
    if quantize:
        pred = torch.round(torch.clamp(pred, 0, 1) * 255) / 255
    return torch.mean(torch.square(pred - target))
