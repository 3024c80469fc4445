"""Headless train / eval / screenshot / video / mesh driver of the port.

The counterpart of ``scripts/run.py`` for ``nerfshop_tpu_torch``: the same
arguments and the same stages in the same order (load a snapshot, load a
scene, load edits, train in chunks of 100 steps, save a snapshot, save a
marching-tets mesh, score held-out views in PSNR / SSIM, screenshots, the
frames of a camera path), the same printed lines and the same final JSON
of ``psnr_mean``, ``ssim_mean`` and ``n_views``. One argument more:
``--device`` (default ``cuda``; ``--device cpu`` runs the plain versions).
``--mode`` is nerf, sdf, image or volume, or inferred from the scene's
suffix (``infer_mode``); in Image mode a last JSON line gives
``image_mse`` and ``image_psnr``. ``--save_mesh`` (NeRF's density mesh)
raises in the other modes.

A loaded snapshot survives a scene loaded after it: loading the scene
builds a fresh network for it, so the snapshot's weights are put back.

Usage examples:
    python -m nerfshop_tpu_torch.run --scene data/nerf/fox --n_steps 2000 --save_snapshot fox.nst
    python -m nerfshop_tpu_torch.run --mode sdf --scene armadillo.obj --n_steps 1000 --batch_size 65536
    python -m nerfshop_tpu_torch.run --scene albert.png --n_steps 1000   # Image mode, from the suffix
    python -m nerfshop_tpu_torch.run --load_snapshot fox.nst \\
        --test_transforms data/nerf/lego/transforms_test.json
    python -m nerfshop_tpu_torch.run --device cpu --load_snapshot fox.nst \\
        --screenshot_dir shots --width 320 --height 240
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", default="", choices=["", "nerf", "sdf", "image", "volume"])
    p.add_argument("--scene", default="")
    p.add_argument("--network", default="", help="network config json")
    p.add_argument("--load_snapshot", default="")
    p.add_argument("--edits", default="", help="edits json (operator stack) to load before rendering")
    p.add_argument("--save_snapshot", default="")
    p.add_argument("--n_steps", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=1 << 18)
    p.add_argument("--test_transforms", default="", help="transforms.json with held-out views")
    p.add_argument("--screenshot_transforms", default="")
    p.add_argument("--screenshot_dir", default="")
    p.add_argument("--screenshot_frames", nargs="*", type=int)
    p.add_argument("--screenshot_spp", type=int, default=8)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--near_distance", type=float, default=-1)
    p.add_argument("--eval_subsample", type=int, default=1, help="evaluate every Nth test view")
    p.add_argument("--downscale", type=int, default=1, help="image downscale factor (train + eval)")
    p.add_argument("--video_camera_path", default="", help="camera path json → render video frames")
    p.add_argument("--video_n_frames", type=int, default=60)
    p.add_argument("--video_output", default="video_frames")
    p.add_argument("--video_spp", type=int, default=2)
    p.add_argument("--save_mesh", default="", help="marching-cubes mesh output (.obj/.ply)")
    p.add_argument("--marching_cubes_res", type=int, default=256)
    p.add_argument("--marching_cubes_density_thresh", type=float, default=2.5)
    p.add_argument("--unwrap", action="store_true", help="quad-atlas UVs + debug texture on .obj mesh export")
    p.add_argument("--device", default="cuda", help="torch device; the CPU runs only when named")
    return p.parse_args(argv)


def infer_mode(scene: str) -> str:
    s = scene.lower()
    if s.endswith((".obj", ".stl", ".ply")):
        return "sdf"
    if s.endswith((".exr", ".png", ".jpg", ".jpeg", ".bin")):
        return "image"
    if s.endswith((".nvdb", ".vdb")):
        return "volume"
    return "nerf"


def main(argv: Optional[Sequence[str]] = None):
    """Run the stages that ``argv`` (``sys.argv[1:]`` when None) asks for →
    the ``Testbed``."""
    args = parse_args(argv)
    from nerfshop_tpu_torch.common import TestbedMode
    from nerfshop_tpu_torch.data import image_io
    from nerfshop_tpu_torch.testbed import Testbed
    from nerfshop_tpu_torch.utils import metrics

    mode = args.mode or (infer_mode(args.scene) if args.scene else "nerf")
    tb = Testbed(TestbedMode(mode), config=args.network or None, device=args.device)

    if args.load_snapshot:
        tb.load_snapshot(args.load_snapshot)
    if args.scene:
        if mode == "nerf":
            tb.load_training_data(args.scene, downscale=args.downscale)
        else:
            tb.load_training_data(args.scene)
        if args.load_snapshot:
            tb.load_snapshot(args.load_snapshot)  # the scene's fresh network takes the snapshot's weights
    if args.near_distance >= 0:
        tb.nerf.training.near_distance = args.near_distance
    if args.edits:
        tb.load_edits(args.edits)
        print(f"loaded edit stack from {args.edits}")

    n_steps = args.n_steps
    if n_steps < 0 and not args.load_snapshot:
        n_steps = 2000

    if n_steps > 0:
        print(f"training {n_steps} steps (batch {args.batch_size})")
        t0 = time.perf_counter()
        chunk = 100
        done = 0
        while done < n_steps:
            k = min(chunk, n_steps - done)
            loss = tb.train(k, args.batch_size)
            done += k
            el = time.perf_counter() - t0
            print(f"  step {done:6d}  loss {loss:.6f}  {done/el:7.1f} steps/s", flush=True)
        print(f"trained in {time.perf_counter()-t0:.1f}s")

    if args.save_snapshot:
        tb.save_snapshot(args.save_snapshot)
        print(f"saved snapshot → {args.save_snapshot}")

    if args.save_mesh:
        res = args.marching_cubes_res or 256
        print(f"marching cubes at {res}^3 → {args.save_mesh}")
        tb.compute_and_save_marching_cubes_mesh(
            args.save_mesh, res, args.marching_cubes_density_thresh, unwrap=args.unwrap,
        )

    if args.test_transforms:
        from nerfshop_tpu_torch.data import nerf_loader

        print(f"evaluating on {args.test_transforms}")
        ds = nerf_loader.load_nerf(args.test_transforms, downscale=args.downscale)
        tb.nerf.render_min_transmittance = 1e-4  # the eval protocol
        tb.background_color = np.array([0, 0, 0, 1], np.float32)
        psnrs, ssims = [], []
        for i in range(0, ds.n_images, args.eval_subsample):
            gt = ds.images[i]
            H, W = gt.shape[:2]
            intr = ds.intrinsics[i]
            img = tb.render(
                W, H, spp=args.screenshot_spp, linear=False,
                camera_matrix=ds.xforms[i], focal=intr.focal, principal=intr.principal,
                distortion=intr.distortion, exact=True,
            )
            # protocol: composite GT over black via straight alpha, sRGB space
            gt_rgb = gt[..., :3] * gt[..., 3:4]
            pred_rgb = img[..., :3]
            psnrs.append(metrics.psnr(pred_rgb, gt_rgb))
            ssims.append(metrics.ssim(pred_rgb, gt_rgb))
            print(f"  view {i:3d}: PSNR {psnrs[-1]:6.2f}  SSIM {ssims[-1]:.4f}", flush=True)
        print(
            json.dumps(
                {"psnr_mean": float(np.mean(psnrs)), "ssim_mean": float(np.mean(ssims)), "n_views": len(psnrs)}
            )
        )

    if args.screenshot_dir:
        out = Path(args.screenshot_dir)
        out.mkdir(parents=True, exist_ok=True)
        if args.screenshot_transforms:
            from nerfshop_tpu_torch.data import nerf_loader

            ds = nerf_loader.load_nerf(args.screenshot_transforms)
            idxs = args.screenshot_frames or range(ds.n_images)
            for i in idxs:
                intr = ds.intrinsics[i]
                img = tb.render(args.width, args.height, spp=args.screenshot_spp,
                                camera_matrix=ds.xforms[i], focal=intr.focal,
                                principal=intr.principal, distortion=intr.distortion)
                image_io.write_image(out / f"{i:04d}.png", img, linear_input=False)
                print(f"  wrote {out / f'{i:04d}.png'}")
        else:
            tb.screenshot(str(out / "screenshot.png"), args.width, args.height, args.screenshot_spp)
            print(f"  wrote {out / 'screenshot.png'}")

    if args.video_camera_path:
        from nerfshop_tpu_torch.render import camera_path as cp

        path = cp.CameraPath.load(args.video_camera_path)
        out = Path(args.video_output)
        out.mkdir(parents=True, exist_ok=True)
        for i in range(args.video_n_frames):
            t = i / max(args.video_n_frames - 1, 1)
            kf = path.eval(t)
            tb.fov_deg = float(kf.fov_deg)
            img = tb.render(args.width, args.height, spp=args.video_spp,
                            camera_matrix=np.asarray(kf.camera_matrix(), np.float32))
            image_io.write_image(out / f"frame_{i:04d}.png", img, linear_input=False)
            print(f"  video frame {i+1}/{args.video_n_frames}", flush=True)
        print(f"wrote {args.video_n_frames} frames to {out}")

    if mode == "image" and tb._image_target is not None:
        m = tb.compute_image_mse()
        print(json.dumps({"image_mse": m, "image_psnr": -10 * np.log10(max(m, 1e-12))}))
    return tb


if __name__ == "__main__":
    main()
