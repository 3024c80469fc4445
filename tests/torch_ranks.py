"""Ranks of a ``torch.distributed`` group, one fresh interpreter a rank:
the launcher of the port's parallel tests (gloo on the CPU) and of
``chip_smoke.py``'s [parallel] phase (gloo or NCCL on the card).

:func:`run_ranks` writes a payload to a temporary directory, starts
``world`` processes of this file (``python torch_ranks.py JOB RANK WORLD
DIR BACKEND CARDS``), and gives them a deadline from their start (120 s
by default): a rank that hangs or fails fails the caller, and the others
are killed. The ranks meet through a ``FileStore`` in that directory, not
a TCP port (pytest-xdist runs several workers side by side). With
``CARDS`` 0 a rank runs on the CPU on one intra-op thread, as
``tests/torch_one_thread.py`` does; else on ``cuda:(RANK mod CARDS)``.
Each rank runs ``JOB`` (``module:function``, or a function of this
module) on its mesh and the payload, imports neither JAX nor the JAX
package, and saves what the job returns for :func:`run_ranks` to return,
rank by rank.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
#: seconds a rank may take before the test fails
RANK_TIMEOUT = 120.0


def run_ranks(job: str, world: int, payload, tmp: Path, backend: str = "gloo", n_cards: int = 0,
              timeout: float = RANK_TIMEOUT, env: dict | None = None) -> list:
    """Run ``job`` on ``world`` ranks of a ``backend`` group (on the CPU with
    ``n_cards`` 0, else over that many cards) → what each rank returned.
    Fails as soon as a rank fails, and when a rank has not ended ``timeout``
    seconds after the start; every rank still running is then killed.
    ``env`` adds to the ranks' environment."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(payload, tmp / "payload.pt")
    env = dict(os.environ, **(env or {}), PYTHONPATH=os.pathsep.join([str(HERE.parent), str(HERE)]))
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    deadline = time.monotonic() + timeout
    procs = [
        subprocess.Popen([sys.executable, str(HERE / "torch_ranks.py"), job, str(r), str(world), str(tmp), backend,
                          str(n_cards)], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)
    ]
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                break
            if time.monotonic() > deadline:
                late = [r for r, p in enumerate(procs) if p.poll() is None]
                raise AssertionError(f"ranks {late} of {job} ({backend}) did not end within {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            log = (tmp / f"rank{r}.log").read_text()
            raise AssertionError(f"rank {r} of {job} ({backend}) exited {p.returncode}:\n{log[-6000:]}")
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


# ------------------------------------------------------------------ the jobs


def _model(p):
    from nerfshop_tpu_torch.models import encodings as tenc
    from nerfshop_tpu_torch.models import mlp as tmlp
    from nerfshop_tpu_torch.models import nerf_network as tnn

    model = tnn.NerfNetwork(
        pos_encoding=tenc.GridEncoding(device="cpu", **p["grid"]),
        dir_encoding=tenc.SphericalHarmonicsEncoding(degree=4),
        density_mlp=tmlp.MLP(8, 16, n_neurons=16, n_hidden_layers=1),
        rgb_mlp=tmlp.MLP(32, 3, n_neurons=16, n_hidden_layers=1),
    )
    model.load_state_dict(p["weights"])
    return model


def _state_tensors(state) -> dict:
    """Every tensor of a TrainState by name: parameters, Adam's moments and
    step, the EMA, the learning rate."""
    out = {"lr": state.lr.clone()}
    for name, prm in state.named:
        out[f"param.{name}"] = prm.detach().clone()
        for k, v in state.optimizer.state[prm].items():
            out[f"adam.{k}.{name}"] = v.clone()
    for name, v in (state.ema or {}).items():
        out[f"ema.{name}"] = v.clone()
    return out


def parallel_job(mesh, p) -> dict:
    """The port's side of ``tests/test_torch_parallel.py`` on one rank of a
    2-rank gloo group: the data-parallel step and its error-map variant on
    JAX's per-shard draws, the one-process gradients over the union of the
    draws (rank 0), the sharded render and the serial one (rank 0), and a
    3-step run with the EMA and a grid refresh whose state and grid every
    rank returns."""
    from nerfshop_tpu_torch.ops import grid as grid_lib
    from nerfshop_tpu_torch.parallel import mesh as mesh_lib
    from nerfshop_tpu_torch.render import renderer
    from nerfshop_tpu_torch.train import nerf as tnerf
    from nerfshop_tpu_torch.train import optim as toptim

    out = {}
    model = _model(p)
    data = tnerf.DeviceDataset(**p["data"])
    cfg = tnerf.NerfTrainConfig(**p["cfg"])
    spec = toptim.build_optimizer(p["optimizer"])
    grid = grid_lib.OccupancyGrid.create(1)
    draws = p["draws"][mesh.rank]

    state = toptim.TrainState(copy.deepcopy(model), spec)
    step = mesh_lib.make_parallel_train_step(model, spec, cfg, mesh)
    grads, aux, _ = step.grads(state, grid, data, draws)
    state.apply_gradients(grads)
    out.update({f"grad.{k}": v.clone() for k, v in grads.items()}, loss=aux["loss"])
    out.update(_state_tensors(state))
    if mesh.rank == 0:
        union = tuple(torch.cat(parts) for parts in zip(*p["draws"]))
        ugrads, uaux = tnerf.grads_from_draws(copy.deepcopy(model), grid, data, cfg, *union)
        out.update({f"union.{k}": v for k, v in ugrads.items()}, union_loss=uaux["loss"])

    cfg_em = dataclasses.replace(cfg, use_error_map=True, error_map_resolution=8, error_map_decay=0.9)
    state_em = toptim.TrainState(copy.deepcopy(model), spec)
    aux_em, new_em = mesh_lib.make_parallel_train_step(model, spec, cfg_em, mesh)(
        state_em, grid, data, draws=p["em_draws"][mesh.rank], error_map=p["error_map"])
    out.update(em=new_em, em_loss=aux_em["loss"], **{f"em.{k}": v for k, v in _state_tensors(state_em).items()})

    r = p["render"]
    ball = grid_lib.OccupancyGrid(r["density"], r["occupancy"], torch.zeros(()))
    opts = renderer.RenderOptions(**r["opts"])
    rgba, depth = mesh_lib.render_frame_sharded(model, None, ball, mesh, r["resolution"], r["xform"], r["focal"],
                                                opts=opts)
    out.update(rgba=rgba, depth=depth)
    if mesh.rank == 0:
        serial = renderer.render_frame(model, None, ball, r["resolution"], r["xform"], r["focal"], opts=opts)
        out.update(serial_rgba=serial.rgba, serial_depth=serial.depth)

    # three steps with the EMA from the ranks' own generators, the grid
    # refreshed between the second and the third with draws alike on every
    # rank; then a grid that differs on rank 1, replicated from rank 0
    spec_ema = toptim.build_optimizer({"otype": "Ema", "decay": 0.95, "nested": p["optimizer"]})
    state3 = toptim.TrainState(copy.deepcopy(model), spec_ema)
    step3 = mesh_lib.make_parallel_train_step(model, spec_ema, cfg, mesh)
    gen = mesh_lib.rank_generator(mesh, 11)
    grid3 = grid_lib.OccupancyGrid.create(1)
    for i in range(3):
        if i == 2:
            shared = torch.Generator().manual_seed(12)
            tnerf.update_grid(state3.model, grid3, cfg, shared, full_refresh=False)
        out[f"run.loss{i}"] = step3(state3, grid3, data, generator=gen)["loss"]
    out.update({f"run.{k}": v for k, v in _state_tensors(state3).items()}, **{
        "run.step": torch.tensor(state3.step), "run.grid.density": grid3.density.clone(),
        "run.grid.occupancy": grid3.occupancy.clone(), "run.grid.mean": grid3.mean_density.clone()})
    other = grid_lib.OccupancyGrid(grid3.density + mesh.rank, grid3.occupancy ^ bool(mesh.rank),
                                   grid3.mean_density + mesh.rank)
    mesh_lib.replicate(mesh, other)
    out.update({"rep.density": other.density, "rep.occupancy": other.occupancy, "rep.mean": other.mean_density})
    return out


def hang_job(mesh, p) -> None:
    """The launcher's own check: rank 1 sleeps past any deadline; the others
    check that they run on the CPU on one thread, and return."""
    if mesh.rank == 1:
        time.sleep(p["seconds"])
    assert mesh.device.type == "cpu" and torch.get_num_threads() == 1


def main(job: str, rank: int, world: int, tmp: str, backend: str, n_cards: int) -> None:
    import torch.distributed as dist

    from nerfshop_tpu_torch.parallel import mesh as mesh_lib

    module, _, name = job.rpartition(":")
    fn = getattr(importlib.import_module(module) if module else sys.modules[__name__], name)
    if n_cards:
        device = torch.device("cuda", rank % n_cards)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, f"store_{backend}"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    try:
        payload = torch.load(os.path.join(tmp, "payload.pt"))
        result = fn(mesh_lib.make_mesh(device), payload)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], int(sys.argv[6]))
