"""The SDF fits of ``chip_smoke.py``'s [encodings] phase in both packages on
the CPU: configs/sdf/base.json's network with a Frequency (12), a
TriangleWave (12) or a OneBlob (16) position encoding, trained on the
5120-face bumpy icosphere at batch 2^16 from a fixed seed, the loss every
100 steps and the IoU after the last, through the JAX package's Testbed
(``--packages jax torch`` adds the port's on the CPU). Beside the port's
numbers from the card it shows whether a poor fit is the encoding's or the
port's.

Run from the root of a checkout (a few minutes an encoding):
  env JAX_PLATFORMS=cpu python tests/sdf_encoding_fits.py [--steps 400]
      [--seeds 0 1] [--encodings TriangleWave]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the phase's mesh, config and encodings)


def fit(package: str, cfg: dict, obj: Path, steps: int, seed: int, batch: int):
    """(losses every 100 steps, IoU, seconds) of one SDF fit."""
    if package == "jax":
        import jax

        from nerfshop_tpu.testbed import Testbed

        tb = Testbed("sdf", config=cfg)
        tb._rng = jax.random.PRNGKey(seed)  # its constructor seeds from the clock
    else:
        from nerfshop_tpu_torch.testbed import Testbed

        tb = Testbed("sdf", config=cfg, device="cpu", seed=seed)
    t0 = time.perf_counter()
    tb.load_training_data(str(obj))
    losses = []
    for _ in range(steps // 100):
        losses.append(float(tb.train(100, batch)))
        print(f"  {package} step {100 * len(losses)} loss {losses[-1]:.6f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return losses, float(tb.calculate_iou()), time.perf_counter() - t0


def main() -> None:
    names = [e[0] for e in chip_smoke.ELEMENTWISE]
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch_size", type=int, default=1 << 16)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--encodings", nargs="+", default=names, choices=names)
    ap.add_argument("--packages", nargs="+", default=["jax"], choices=["jax", "torch"],
                    help="the port's CPU path takes its ground truth by brute force: hours at this size")
    args = ap.parse_args()
    from nerfshop_tpu_torch.geometry import mesh_io

    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "bumpy_small.obj"
        mesh_io.save_obj(obj, chip_smoke.bumpy_mesh(4))
        for otype, opts, _ in chip_smoke.ELEMENTWISE:
            if otype not in args.encodings:
                continue
            cfg = chip_smoke.sdf_base_config()
            cfg["encoding"] = {"otype": otype, **opts}
            for seed in args.seeds:
                for package in args.packages:
                    losses, iou, s = fit(package, cfg, obj, args.steps, seed, args.batch_size)
                    print(f"{package} {otype} {opts} seed {seed}: loss by 100 steps {losses}; IoU {iou:.5f} "
                          f"({s:.1f} s on the CPU)", flush=True)


if __name__ == "__main__":
    main()
