"""Shared enums & constants.

Mirrors the mode/render-mode surface of the reference
(include/neural-graphics-primitives/common.h:149-213) without copying its
implementation; values are re-chosen for a Python-first API.
"""

from __future__ import annotations

import enum
import math


class TestbedMode(enum.Enum):
    Nerf = "nerf"
    Sdf = "sdf"
    Image = "image"
    Volume = "volume"


class RenderMode(enum.Enum):
    AO = "ao"
    Shade = "shade"
    Normals = "normals"
    Positions = "positions"
    Depth = "depth"
    Distance = "distance"
    Stepsize = "stepsize"
    Distortion = "distortion"
    Cost = "cost"
    Slice = "slice"


class ColorSpace(enum.Enum):
    Linear = "linear"
    SRGB = "srgb"


class TonemapCurve(enum.Enum):
    Identity = "identity"
    ACES = "aces"
    Hable = "hable"
    Reinhard = "reinhard"


class GroundTruthRenderMode(enum.Enum):
    Shade = "shade"
    Depth = "depth"


class LossType(enum.Enum):
    L2 = "L2"
    L1 = "L1"
    Mape = "Mape"
    Smape = "Smape"
    Huber = "Huber"
    LogL1 = "LogL1"
    RelativeL2 = "RelativeL2"


# --- NeRF marching constants (same *semantics* as the reference;
#     common_nerf.h:16-26, testbed_nerf.cu:56-59) ---------------------------

#: occupancy grid resolution per cascade
GRID_RESOLUTION = 128
#: log2 of the above
GRID_LOG2_RES = 7
#: number of cells per cascade
GRID_VOLUME = GRID_RESOLUTION**3
#: maximum number of cascades (aabb_scale up to 16 uses 5; we allow up to 8)
MAX_CASCADES = 8
#: minimum step size as a fraction of the unit-cube diagonal
SQRT3 = math.sqrt(3.0)
#: number of fine steps to cross the unit cube
N_STEPS_PER_UNIT = 1024
MIN_CONE_STEPSIZE = SQRT3 / N_STEPS_PER_UNIT
#: max step never exceeds one fine-grid cell of the coarsest cascade
MAX_CONE_STEPSIZE = SQRT3 * MAX_CASCADES / N_STEPS_PER_UNIT * (1 << (MAX_CASCADES - 1)) / GRID_RESOLUTION
#: EMA decay for the density grid
DENSITY_GRID_DECAY = 0.95
#: density threshold scale for bitfield occupancy
NERF_MIN_OPTICAL_THICKNESS = 0.01

#: default minimum transmittance: render / eval
MIN_TRANSMITTANCE_RENDER = 1e-2
MIN_TRANSMITTANCE_EVAL = 1e-4

#: default training batch (samples per step) and steps per frame
DEFAULT_BATCH_SIZE = 1 << 18
DEFAULT_STEPS_PER_FRAME = 16

#: loss scale used by the fp16 reference (testbed.h:277). bf16 on TPU has the
#: full fp32 exponent range, so we keep 1.0 by default but expose the knob.
DEFAULT_LOSS_SCALE = 1.0
