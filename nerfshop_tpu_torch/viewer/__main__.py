"""python -m nerfshop_tpu_torch.viewer --scene <dir> [--snapshot a.snap] [--port 8080] [--device cuda]

The scene is loaded first and the snapshot's weights after it, so that a
snapshot given with a scene is kept (the JAX viewer loads them in the other
order, and the scene's fresh network replaces the snapshot's: ``ROADMAP.md``
Queue 3, F12)."""

import argparse


def make_testbed(scene: str = "", snapshot: str = "", device: str = "cuda"):
    """A NeRF ``Testbed`` on ``device`` with the scene, then the snapshot, loaded."""
    from nerfshop_tpu_torch.common import TestbedMode
    from nerfshop_tpu_torch.testbed import Testbed

    tb = Testbed(TestbedMode.Nerf, device=device)
    if scene:
        tb.load_training_data(scene)
    if snapshot:
        tb.load_snapshot(snapshot)
    return tb


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="")
    p.add_argument("--snapshot", default="")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from nerfshop_tpu_torch.viewer.server import ViewerServer

    ViewerServer(make_testbed(args.scene, args.snapshot, args.device), args.port).serve_forever()


if __name__ == "__main__":
    main()
