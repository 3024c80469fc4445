"""The NGP NeRF network: hash-encoded density MLP + SH-conditioned RGB MLP.

Counterpart of ``nerfshop_tpu/models/nerf_network.py``::

  pos [0,1]³ ──HashGrid──► density MLP ──► 16 feats (feats[0] = raw σ)
  dir warped ──SH(deg 4)──┐                 │
                          └──[feats ∥ SH]──► rgb MLP ──► 3 raw rgb

With ``n_extra_dims`` E (a scene's light directions, E = 3), the dir
encoding is built for 3 + E inputs and reads [dir ∥ extra]. The shipped
default's ``Composite`` (SH on the direction, Identity on the rest) passes
the extras to the rgb MLP (16 + 16 + 3 inputs); a plain
``SphericalHarmonics`` dir encoding is built at 3 dims whatever it is
given, so there, as in JAX, the extras reach no input (``ROADMAP.md``
Queue 3, F17).

Parameter names follow the JAX pytree paths (``pos_encoding.table``,
``density_mlp.weights.0``, ``rgb_mlp.weights.2``), see
:mod:`nerfshop_tpu_torch.weights`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from nerfshop_tpu_torch.models import encodings as enc
from nerfshop_tpu_torch.models import mlp as mlp_lib
from nerfshop_tpu_torch.ops import fused_mlp, xor_encode

DENSITY_FEATURES = 16
EXP_CLAMP = 15.0
RGB_EXP_CLAMP = 10.0


def density_activation_fn(raw: torch.Tensor, kind: str = "exponential") -> torch.Tensor:
    kind = kind.lower()
    if kind == "exponential":
        return torch.exp(torch.clamp(raw, -EXP_CLAMP, EXP_CLAMP))
    if kind == "relu":
        return torch.relu(raw)
    if kind == "logistic":
        return torch.sigmoid(raw)
    if kind == "none":
        return raw
    raise ValueError(kind)


def rgb_activation_fn(raw: torch.Tensor, kind: str = "logistic") -> torch.Tensor:
    kind = kind.lower()
    if kind == "logistic":
        return torch.sigmoid(raw)
    if kind == "exponential":
        return torch.exp(torch.clamp(raw, -RGB_EXP_CLAMP, RGB_EXP_CLAMP))
    if kind == "relu":
        return torch.relu(raw)
    if kind == "none":
        return raw
    raise ValueError(kind)


class NerfNetwork(nn.Module):
    def __init__(
        self,
        pos_encoding: nn.Module,
        dir_encoding: Optional[nn.Module],
        density_mlp: mlp_lib.MLP,
        rgb_mlp: mlp_lib.MLP,
        density_activation: str = "exponential",
        rgb_activation: str = "logistic",
        n_extra_dims: int = 0,
    ):
        super().__init__()
        self.pos_encoding = pos_encoding
        self.dir_encoding = dir_encoding
        self.density_mlp = density_mlp
        self.rgb_mlp = rgb_mlp
        self.density_activation = density_activation
        self.rgb_activation = rgb_activation
        self.n_extra_dims = n_extra_dims

    def density_features(self, pos: torch.Tensor) -> torch.Tensor:
        """pos warped [N, 3] → [N, 16] density features (feats[:, 0] = raw σ)."""
        return self.density_mlp(self.pos_encoding(pos))

    def density(self, pos: torch.Tensor, activated: bool = True) -> torch.Tensor:
        raw = self.density_features(pos)[..., 0]
        return density_activation_fn(raw, self.density_activation) if activated else raw

    def raw_forward(self, pos: torch.Tensor, direction: Optional[torch.Tensor] = None,
                    extra: Optional[torch.Tensor] = None):
        """Unactivated (raw_rgb [N, 3], raw_sigma [N]); ``extra`` [N, E] is
        appended to the direction before the dir encoding."""
        feats = self.density_features(pos)
        raw_sigma = feats[..., 0]
        if self.dir_encoding is not None:
            d_in = direction if extra is None else torch.cat([direction, extra], dim=-1)
            d = self.dir_encoding(d_in).float()
            rgb_in = torch.cat([feats.float(), d], dim=-1)
        else:
            rgb_in = feats.float()
        raw_rgb = self.rgb_mlp(rgb_in)[..., :3]
        return raw_rgb, raw_sigma

    def forward(self, pos: torch.Tensor, direction: Optional[torch.Tensor] = None,
                extra: Optional[torch.Tensor] = None):
        """pos warped [N, 3], direction warped [N, 3] (and ``extra`` [N, E])
        → activated (rgb [N, 3], sigma [N])."""
        raw_rgb, raw_sigma = self.raw_forward(pos, direction, extra)
        return (
            rgb_activation_fn(raw_rgb, self.rgb_activation),
            density_activation_fn(raw_sigma, self.density_activation),
        )


class _Density(nn.Module):
    """``model.density`` (or ``model.density_features``) as a module's
    forward, for ``functional_call``."""

    def __init__(self, model: NerfNetwork, features: bool = False):
        super().__init__()
        self.model = model
        self.features = features

    def forward(self, pos: torch.Tensor) -> torch.Tensor:
        return self.model.density_features(pos) if self.features else self.model.density(pos)


def _call_with(mod: _Density, params: Optional[dict], pos: torch.Tensor) -> torch.Tensor:
    if params is None:
        return mod(pos)
    return torch.func.functional_call(mod, {f"model.{k}": v for k, v in params.items()}, (pos,))


def density_with(model: NerfNetwork, params: Optional[dict], pos: torch.Tensor) -> torch.Tensor:
    """Activated density at warped ``pos`` with ``params`` (a state dict of
    ``model``, e.g. the EMA copy) in place of the model's own; the model's
    own when ``params`` is None."""
    return _call_with(_Density(model), params, pos)


def density_features_with(model: NerfNetwork, params: Optional[dict], pos: torch.Tensor) -> torch.Tensor:
    """The density MLP's output features [N, F] at warped ``pos``
    (``density_features``) with ``params`` in place of the model's own, as
    :func:`density_with`."""
    return _call_with(_Density(model, features=True), params, pos)


def forward_with(model: NerfNetwork, params: Optional[dict], pos: torch.Tensor, direction: torch.Tensor,
                 extra: Optional[torch.Tensor] = None):
    """Activated (rgb, σ) at warped ``pos`` and ``direction`` (and ``extra``)
    with ``params`` in place of the model's own (the model's own when None)."""
    if params is None:
        return model(pos, direction, extra)
    return torch.func.functional_call(model, params, (pos, direction, extra))


#: testbed mode → (n_input_dims of its grid, output width of its MLP) for
#: the modes with one position MLP (``train/sdf.py``, ``train/image.py``,
#: ``train/volume.py``)
FIELD_SHAPES = {"sdf": (3, 1), "image": (2, 3), "volume": (3, 4)}


def check_kernel_range(config: dict, device, mode="nerf", n_extra_dims: int = 0) -> None:
    """Raise ``ValueError`` when ``config`` builds a network that the CUDA
    kernels do not compute on ``device`` in testbed ``mode`` (a
    ``TestbedMode`` or its value): a brick grid level set other than (D,
    F) = (3, 2) or (2, 2) (kernels B and A; the Image mode's grid is 2-D,
    the others' 3-D), a plain grid or a Takikawa encoding outside kernels K
    and L (:func:`~nerfshop_tpu_torch.ops.xor_encode.check_supported`:
    plain at (3, 2) and (2, 2), Takikawa at D = 3 with F 2, 4 or 8), or an
    MLP outside kernel C's range
    (:func:`~nerfshop_tpu_torch.ops.fused_mlp.check_supported`): NeRF's
    density and rgb MLPs, or the other modes' one MLP from the encoding's
    width (the elementwise encodings' too) to 1 (SDF), 3 (Image) or 4
    (Volume) outputs. A grid layout the port lacks raises
    ``NotImplementedError`` naming it. The dir encoding takes 3 +
    ``n_extra_dims`` inputs, as :func:`build_nerf_network` builds it. Reads the config only and
    allocates nothing; the CPU's plain paths take every config, so a CPU
    device passes."""
    if torch.device(device).type != "cuda":
        return
    mode = getattr(mode, "value", mode)
    n_in, n_out = FIELD_SHAPES.get(mode, (3, None))
    pos_width, sets = enc.encoding_shape(dict(config.get("encoding", {})), n_in)
    for kind, D, F, L in sets:
        if kind in ("plain", "takikawa"):
            xor_encode.check_supported(D, F, kind == "takikawa", L)
        elif kind != "brick":
            raise NotImplementedError(f"grid layout {kind!r} is not ported (brick and plain only)")
        elif (D, F) not in ((3, 2), (2, 2)):
            raise ValueError(
                "kernels B (grid_encode) and A (segsum) take n_input_dims 3 or 2 and n_features_per_level 2 only; "
                f"the encoding has n_input_dims {D}, n_features_per_level {F}"
            )
    if n_out is not None:
        mlps = (("MLP", "network", pos_width, n_out),)
    else:
        dir_cfg = config.get("dir_encoding")
        dir_width = enc.encoding_shape(dict(dir_cfg), 3 + n_extra_dims)[0] if dir_cfg else 0
        mlps = (
            ("density MLP", "network", pos_width, DENSITY_FEATURES),
            ("rgb MLP", "rgb_network", DENSITY_FEATURES + dir_width, 3),
        )
    for name, key, n_in, n_out in mlps:
        cfg = dict(config.get(key, config.get("network", {})))
        try:
            fused_mlp.check_supported(
                n_in, cfg.get("n_neurons", 64), cfg.get("n_hidden_layers", 1), n_out,
                cfg.get("activation", "ReLU"), cfg.get("output_activation", "None"),
            )
        except ValueError as e:
            raise ValueError(f"{name} ('{key}'): {e}") from None


def build_nerf_network(
    config: dict,
    aabb_scale: int = 1,
    is_hdr: bool = False,
    desired_resolution: float = 2048.0,
    device=None,
    generator: Optional[torch.Generator] = None,
    n_extra_dims: int = 0,
) -> NerfNetwork:
    """Construct from the JSON config tree, with the hash grid's automatic
    per_level_scale = exp(ln(desired_res · aabb_scale / base_res) / (L − 1))
    and the dir encoding built for 3 + ``n_extra_dims`` inputs. On a CUDA
    device a config outside the kernels' range raises
    (:func:`check_kernel_range`) before anything is allocated."""
    if device is not None:
        check_kernel_range(config, device, n_extra_dims=n_extra_dims)
    enc_cfg = dict(config.get("encoding", {}))
    n_levels = enc_cfg.get("n_levels", 16)
    base_res = enc_cfg.get("base_resolution", 16)
    per_level_scale = enc_cfg.get("per_level_scale")
    if per_level_scale is None and n_levels > 1:
        per_level_scale = math.exp(math.log(desired_resolution * aabb_scale / base_res) / (n_levels - 1))
    pos_encoding = enc.build_encoding(enc_cfg, 3, per_level_scale, device, generator)

    dir_cfg = config.get("dir_encoding")
    dir_encoding = enc.build_encoding(dict(dir_cfg), 3 + n_extra_dims, device=device) if dir_cfg else None

    density_mlp = mlp_lib.build_network(
        dict(config.get("network", {})), pos_encoding.n_output_dims, DENSITY_FEATURES, device, generator
    )
    rgb_in = DENSITY_FEATURES + (dir_encoding.n_output_dims if dir_encoding is not None else 0)
    rgb_mlp = mlp_lib.build_network(
        dict(config.get("rgb_network", config.get("network", {}))), rgb_in, 3, device, generator
    )
    return NerfNetwork(
        pos_encoding=pos_encoding,
        dir_encoding=dir_encoding,
        density_mlp=density_mlp,
        rgb_mlp=rgb_mlp,
        density_activation="exponential",
        rgb_activation="exponential" if is_hdr else "logistic",
        n_extra_dims=n_extra_dims,
    )
