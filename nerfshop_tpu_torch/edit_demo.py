"""Headless NeRFshop edit and distillation of a scene, the port's entry point.

The counterpart of ``scripts/edit_demo.py`` for ``nerfshop_tpu_torch``:
train (or load a snapshot) → project a scribble → grow a region → proxy
cage → tet cage → translate → membrane → edited render → distill →
distilled-vs-edited PSNR, with the same arguments and defaults, the same
printed lines, and one JSON line of the same keys, also written as
``result.json`` next to the screenshots (``1_before.png``,
``2_edited.png``, ``3_distilled.png``). Two differences: ``--scene`` must
be named (no scene ships with the repository), and ``--device`` (default
``cuda``; ``--device cpu`` runs the plain versions of the kernels).

Usage:
    python -m nerfshop_tpu_torch.edit_demo --scene data/nerf/fox --out edit_demo
    python -m nerfshop_tpu_torch.edit_demo --scene data/nerf/fox --snapshot fox.snap --distill_steps 300
    python -m nerfshop_tpu_torch.edit_demo --device cpu --scene tiny_scene \\
        --train_steps 200 --distill_steps 100 --downscale 1 --out /tmp/edit_demo
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import NamedTuple, Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--snapshot", default="", help="load instead of training")
    ap.add_argument("--save_snapshot", default="", help="save after training")
    ap.add_argument("--train_steps", type=int, default=2000)
    ap.add_argument("--distill_steps", type=int, default=1500)
    ap.add_argument("--batch_size", type=int, default=1 << 18)
    ap.add_argument("--downscale", type=int, default=4, help="eval/render downscale")
    ap.add_argument(
        "--offset", type=float, nargs=3, default=None,
        help="world-space cage translation; default: 0.3 units along the scene's up axis (estimated from the "
        "camera rig), so the moved content lands in free space",
    )
    ap.add_argument("--view", type=int, default=0, help="scribble/eval view index")
    ap.add_argument("--out", default="scratch/edit_demo")
    ap.add_argument("--device", default="cuda", help="torch device; the CPU runs only when named")
    return ap.parse_args(argv)


def scribble_pixels(W: int, H: int) -> np.ndarray:
    """The scribble: a disc of pixel coordinates [n, 2] (x, y) around the
    image centre, every other pixel of a 13 × 13 grid at W/64 and H/64."""
    uv = [[W / 2 + dx * W / 64, H / 2 + dy * H / 64]
          for dy in range(-6, 7, 2) for dx in range(-6, 7, 2) if dx * dx + dy * dy <= 36]
    return np.asarray(uv, np.float32)


class EvalView(NamedTuple):
    """The scribble and eval view of the scene at the render downscale."""

    xforms: np.ndarray  # every view's camera-to-world [V, 3, 4]
    xform: np.ndarray
    intr: object  # nerf_loader's intrinsics of the view
    gt: np.ndarray  # [H, W, 4]
    W: int
    H: int


def load_testbed(args: argparse.Namespace):
    """Stage 1: the scene trained for ``--train_steps`` (saved to
    ``--save_snapshot``), or loaded from ``--snapshot`` → the ``Testbed``."""
    from nerfshop_tpu_torch.common import TestbedMode
    from nerfshop_tpu_torch.testbed import Testbed

    tb = Testbed(TestbedMode.Nerf, device=args.device)
    if args.snapshot and os.path.exists(args.snapshot):
        tb.load_snapshot(args.snapshot)
        tb.load_training_data(args.scene)
        tb.load_snapshot(args.snapshot)  # the scene's fresh network takes the snapshot's weights
        return tb
    tb.load_training_data(args.scene)
    t0 = time.perf_counter()
    done = 0
    while done < args.train_steps:
        n = min(256, args.train_steps - done)
        loss = tb.train(n, args.batch_size)
        done += n
        print(f"  step {done:6d}  loss {loss:.6f}", flush=True)
    train_s = time.perf_counter() - t0
    print(f"trained {args.train_steps} steps in {train_s:.1f}s", flush=True)
    if args.save_snapshot:
        tb.save_snapshot(args.save_snapshot)
        print(f"snapshot saved to {args.save_snapshot}", flush=True)
    return tb


def eval_view(scene: str, view: int, downscale: int) -> EvalView:
    """The scene's view ``view`` (the last where there are fewer) at
    ``downscale``."""
    from nerfshop_tpu_torch.data import nerf_loader

    tf = os.path.join(scene, "transforms.json")
    if not os.path.exists(tf):
        tf = scene
    ds = nerf_loader.load_nerf(tf, downscale=downscale)
    view = min(view, len(ds.xforms) - 1)
    gt = np.asarray(ds.images[view])
    xforms = np.asarray(ds.xforms)
    return EvalView(xforms, xforms[view], ds.intrinsics[view], gt, gt.shape[1], gt.shape[0])


def render_view(tb, v: EvalView, out_dir: Path, label: str) -> np.ndarray:
    """The view through the ``Testbed`` render path under run.py's eval
    protocol, written as ``label``.png → [H, W, 4]."""
    from nerfshop_tpu_torch.data import image_io

    img = tb.render(v.W, v.H, spp=2, linear=False, camera_matrix=v.xform, focal=v.intr.focal,
                    principal=v.intr.principal, distortion=v.intr.distortion)
    image_io.write_image(out_dir / f"{label}.png", img, linear_input=False)
    return img


def select_region(tb, v: EvalView):
    """Stage 2: the scribble projected from the view, the region grown 9000
    steps, its proxy and tet cage → (the growing selection, scribble hits,
    cells grown)."""
    import torch

    from nerfshop_tpu_torch.ops import rays as rays_lib

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=tb.device)

    gs = tb.begin_cage_edit()
    bundle = rays_lib.pixel_to_ray(t(scribble_pixels(v.W, v.H)), t(v.xform), t(v.intr.focal), t(v.intr.principal),
                                   t([v.W, v.H]))
    hits = gs.project(tb.inference_params, tb.grid, bundle.origins, bundle.directions)
    print(f"scribble projection: {hits} hits", flush=True)
    grown = gs.grow_region(tb.grid, 9000)
    print(f"region grow: {grown} cells", flush=True)
    gs.compute_proxy()
    gs.extract_cage()
    print(f"cage: {len(gs.cage.vertices_original)} verts, {len(gs.tet_mesh.tets)} tets", flush=True)
    return gs, hits, grown


def scene_up_offset(xforms: np.ndarray) -> np.ndarray:
    """0.3 units along the scene's up: −the mean camera y axis (image y
    points down, so the rig's shared "down" is the mean second column of
    the camera-to-world rotations)."""
    up = -np.mean(xforms[:, :, 1], axis=0)
    up = up / (np.linalg.norm(up) + 1e-9)
    return (0.3 * up).astype(np.float32)


def build_operator(tb, gs, offset: np.ndarray):
    """Stage 3: the cage translated by ``offset``, its operator and membrane
    → (the operator, the LUT's seconds)."""
    import torch

    from nerfshop_tpu_torch.editing import poisson
    from nerfshop_tpu_torch.ops import coords

    dev = tb.device
    aabb = coords.BoundingBox.from_aabb_scale(tb.train_config.aabb_scale, device=dev)
    t0 = time.perf_counter()
    gs.translate_cage(offset)
    op = gs.make_operator()
    lut_s = time.perf_counter() - t0
    directions = poisson.membrane_directions(torch.Generator(device=dev).manual_seed(5), device=dev)
    membrane = poisson.compute_membrane(tb.model, tb.inference_params, gs.cage, gs.tet_mesh, aabb, directions,
                                        grid=tb.grid)
    return op._replace(membrane=membrane), lut_s


def distill_edit(tb, operators: tuple, n_steps: int):
    """Stage 4: the testbed's field edited by ``operators`` (marched through
    its grid) distilled into a student for ``n_steps`` steps, in the trained
    config's scene box and cone → (the student's train state, seconds)."""
    import torch

    from nerfshop_tpu_torch.train import distill as distill_lib
    from nerfshop_tpu_torch.train import nerf as nerf_train

    dev = tb.device
    data = nerf_train.DeviceDataset.from_dataset(tb._dataset, dev)
    t0 = time.perf_counter()
    # the scene geometry must be the trained config's: the default
    # DistillConfig (aabb_scale 1, cone_angle 0) warps a larger scene into
    # the wrong box (distill raises on a cascade mismatch)
    dcfg = distill_lib.DistillConfig(aabb_scale=tb.train_config.aabb_scale, cone_angle=tb.train_config.cone_angle)
    student = distill_lib.distill(tb.model, tb.inference_params, operators, data, tb.grid,
                                  torch.Generator(device=dev).manual_seed(7), n_steps=n_steps, cfg=dcfg)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return student, time.perf_counter() - t0


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the demo that ``argv`` (``sys.argv[1:]`` when None) asks for → its
    result (the printed JSON line)."""
    args = parse_args(argv)
    from nerfshop_tpu_torch.utils import metrics

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    t_all = time.perf_counter()

    tb = load_testbed(args)
    v = eval_view(args.scene, args.view, args.downscale)
    tb.nerf.render_min_transmittance = 1e-4  # the eval protocol
    tb.background_color = np.asarray([0, 0, 0, 1], np.float32)
    tb.dynamic_res = False

    img_before = render_view(tb, v, out_dir, "1_before")
    psnr_clean = float(metrics.psnr(img_before[..., :3], v.gt[..., :3] * v.gt[..., 3:4]))
    print(f"clean render vs GT: {psnr_clean:.2f} dB", flush=True)

    gs, _, _ = select_region(tb, v)

    if args.offset is None:
        offset = scene_up_offset(v.xforms)
        print(f"auto offset along scene up: {offset.round(3).tolist()}", flush=True)
    else:
        offset = np.asarray(args.offset, np.float32)
    op, lut_s = build_operator(tb, gs, offset)
    tb.add_edit_operator(op)
    print(f"operator built in {lut_s*1e3:.0f} ms (LUT) + membrane", flush=True)

    img_edited = render_view(tb, v, out_dir, "2_edited")
    edited_opacity = float(img_edited[..., 3].mean())

    tb.refresh_grid_for_edits()
    student, distill_s = distill_edit(tb, tuple(tb.edit_operators), args.distill_steps)

    # swap the student in, drop the operators, render
    teacher = (tb._state, tb._model, tb._edit_operators)
    tb._state, tb._model, tb._edit_operators = student, student.model, []
    try:
        tb.refresh_grid_for_edits()
        img_distilled = render_view(tb, v, out_dir, "3_distilled")
    finally:
        tb._state, tb._model, tb._edit_operators = teacher

    # compare only over the finite pixels of both renders
    fin = np.isfinite(img_edited[..., :3]).all(-1) & np.isfinite(img_distilled[..., :3]).all(-1)
    psnr_distill = float(metrics.psnr(img_distilled[..., :3][fin], img_edited[..., :3][fin]))
    result = {
        "metric": "edit_demo",
        "scene": args.scene,
        "clean_psnr_vs_gt_db": round(psnr_clean, 2),
        "distilled_vs_edited_psnr_db": round(psnr_distill, 2),
        "edited_opacity": round(edited_opacity, 4),
        "cage_verts": int(len(gs.cage.vertices_original)),
        "tets": int(len(gs.tet_mesh.tets)),
        "lut_build_seconds": round(lut_s, 3),
        "distill_seconds": round(distill_s, 1),
        "total_seconds": round(time.perf_counter() - t_all, 1),
        "screenshots": str(out_dir),
    }
    write_result(out_dir, result)
    return result


def write_result(out_dir: Path, result: dict) -> None:
    """The result as ``result.json`` in ``out_dir`` and as one printed JSON
    line."""
    (out_dir / "result.json").write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
