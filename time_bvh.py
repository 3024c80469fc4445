#!/usr/bin/env python3
"""Kernel G's first version against this checkout's, timed on one NVIDIA
GPU on the same seeded points; with ``--ray``, two versions of kernel N.

Run from the root of a checkout:
  python3 time_bvh.py --parent FILE
  python3 time_bvh.py --ray --parent FILE

With ``--ray``, ``FILE`` is another ``csrc/bvh.cu`` with kernel N
(``nst_bvh_ray``), for example an earlier commit's (``git show
<commit>:nerfshop_tpu_torch/csrc/bvh.cu``): both are built as below, their
ray walks' registers, stack frames and spills printed, and both walks timed by
``chip_smoke.both_ms`` on ``chip_smoke.n_rays``' sets (the 1080p frame of the
[sdf] testbed's camera, rays from outside, from inside, axis-parallel), the
file's first, then this checkout's, then reversed; their t and triangles
are compared.

``FILE`` is the first version's ``csrc/bvh.cu`` (one thread a point over
the ``BvhArrays``, C entry ``nst_bvh_sdf(args, points, out, n, stream)``),
for example ``git show <commit>:nerfshop_tpu_torch/csrc/bvh.cu``. It and
this checkout's ``csrc/bvh.cu`` are built into libraries of their own under
``build/bvh_versions/``, one ``nvcc -Xptxas -v`` each, both started
together (``build_versions``, which ``profile_render.py --composite`` and
``--dx-bwd`` use for kernels H and J too); their walks' registers, stack
frames, spills and shared memory are printed.

The points are ``chip_smoke.g_points`` on the [sdf] testbed of
``chip_smoke.py`` (the 81920-face bumpy icosphere, untrained: the points do
not depend on the network): a training batch's 2^15 ground-truth points,
its near-surface and uniform parts alone, and the IoU's 2^18 uniform ones.
Each walk is timed alone by both of ``chip_smoke.both_ms``'s methods, the
two versions in order and then reversed, and the package's whole call
(``bvh_signed_distance_cuda``) beside them. Every output of this checkout's
walk is compared with the first version's.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

import chip_smoke
from nerfshop_tpu_torch.kernels import ptxas_lines  # profile_render.py takes it from here too

#: the points timed: chip_smoke.g_points's training batch ("2^15"), its
#: near-surface three quarters and its uniform quarter alone, and its 2^18
#: uniform points
SIZES = ("2^15", "2^15 near-surface part", "2^15 uniform part", "2^18")
V1, V2 = "v1 (parent)", "v2 (this checkout)"


class V1Args(ctypes.Structure):
    """The first version's ``struct BvhArgs``: the ``BvhArrays`` in field
    order."""

    _fields_ = [
        (name, ctypes.c_void_p) for name in
        ("node_min", "node_max", "node_left", "node_leaf", "leaf_tris", "tri_a", "tri_ab", "tri_ac",
         "tri_pseudo_v", "tri_pseudo_e", "tri_n")
    ]


def build_versions(sources: dict, out_dir: Path, stem: str) -> dict:
    """{label: (library, ptxas log)}: each source of ``sources`` ({label:
    path}) built alone into ``out_dir/lib<stem>_<i>.so`` with ``-Xptxas
    -v``, all started together; the caller binds the entries."""
    from nerfshop_tpu_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (label, src) in enumerate(sources.items()):
        so = out_dir / f"lib{stem}_{i}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(so), str(src)]
        procs.append((label, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for label, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {label}:\n{log}")
        libs[label] = (ctypes.CDLL(str(so)), log)
    return libs


def build_both(parent: Path, out_dir: Path) -> dict:
    """{label: (library, ptxas log)} for the first version and this
    checkout's, built in parallel."""
    from nerfshop_tpu_torch import kernels

    libs = build_versions({V1: parent, V2: kernels.CSRC / "bvh.cu"}, out_dir, "bvh")
    p, i = ctypes.c_void_p, ctypes.c_int
    for label, (lib, _) in libs.items():
        lib.nst_bvh_sdf.restype = i
        lib.nst_bvh_sdf.argtypes = [ctypes.POINTER(V1Args if label == V1 else kernels.BvhArgs), p, p, i, p]
    return libs


def sdf_testbed(dev):
    """The [sdf] testbed of chip_smoke.py with its mesh loaded, untrained (the
    facade; its ``.sdf`` holds the mesh and the packed BVH)."""
    from nerfshop_tpu_torch.geometry import mesh_io
    from nerfshop_tpu_torch.testbed import Testbed

    tb = Testbed("sdf", device=dev, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bumpy.obj"
        mesh_io.save_obj(path, chip_smoke.bumpy_mesh())
        tb.load_training_data(str(path))
    return tb


def time_rays(other: Path, dev, smi: str) -> None:
    """``--ray``: kernel N of ``other`` against this checkout's."""
    from nerfshop_tpu_torch import kernels

    labels = (f"{other.name}", "this checkout")
    libs = build_versions(dict(zip(labels, (other, kernels.CSRC / "bvh.cu"))), kernels.BUILD_DIR.parent / "bvh_versions",
                          "bvh_ray")
    p, i = ctypes.c_void_p, ctypes.c_int
    for label, (lib, log) in libs.items():
        lib.nst_bvh_ray.restype = i
        lib.nst_bvh_ray.argtypes = [ctypes.POINTER(kernels.BvhArgs), p, p, p, p, i, p]
        print(f"[ptxas] {label}: {' | '.join(ptxas_lines(log, 'bvh_ray_kernel'))}", flush=True)
    tb = sdf_testbed(dev)
    W, H = 1920, 1080
    sets = chip_smoke.n_rays(tb.sdf, W, H, tb.camera_matrix, tb._focal_for(W, H))
    packed = tb.sdf.packed_bvh
    args = kernels.BvhArgs(*(t.data_ptr() for t in (packed.nodes, packed.tris, packed.bvh.tri_pseudo_v,
                                                    packed.bvh.tri_pseudo_e, packed.bvh.tri_n)))
    stream = kernels.stream_ptr(dev)
    packed_bytes = chip_smoke.nbytes(packed.nodes, packed.tris)
    for name in ("frame", "outside", "inside", "axis"):
        o, d = sets[name]
        N = o.shape[0]
        t_out = {label: torch.empty(N, device=dev) for label in labels}
        tri_out = {label: torch.empty(N, dtype=torch.int32, device=dev) for label in labels}

        def run(label):
            kernels.check(libs[label][0].nst_bvh_ray(ctypes.byref(args), o.data_ptr(), d.data_ptr(),
                                                     t_out[label].data_ptr(), tri_out[label].data_ptr(), N, stream),
                          label)

        times = {label: [] for label in labels}
        for order in (labels, labels[::-1]):
            for label in order:
                times[label].append(chip_smoke.both_ms(lambda: run(label)))
        torch.cuda.synchronize()
        b_ms, _ = chip_smoke.bound(chip_smoke.nbytes(o, d) + 8 * N + packed_bytes)
        same = torch.equal(t_out[labels[0]], t_out[labels[1]]) and torch.equal(tri_out[labels[0]], tri_out[labels[1]])
        hit = float((tri_out[labels[1]] >= 0).float().mean())
        for label in labels:
            print(f"[ray] {name} ({N} rays, hit share {hit:.4f}) {label}: device "
                  f"{' / '.join(f'{t[1]:.4f}' for t in times[label])} ms, events "
                  f"{' / '.join(f'{t[0]:.4f}' for t in times[label])} ms (forward / reversed pass), bound {b_ms:.4f} "
                  f"ms; outputs equal: {same}", flush=True)
    print(f"[ray] {smi}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True, help="the other version's bvh.cu")
    ap.add_argument("--ray", action="store_true", help="time kernel N (the nearest ray hit) instead of G")
    args = ap.parse_args()
    smi = chip_smoke.phase_device()
    dev = torch.device("cuda", 0)
    chip_smoke.phase_build()
    if args.ray:
        time_rays(args.parent.resolve(), dev, smi)
        return
    from nerfshop_tpu_torch import kernels
    from nerfshop_tpu_torch.geometry import bvh as bvh_lib

    libs = build_both(args.parent.resolve(), kernels.BUILD_DIR.parent / "bvh_versions")
    for label, (_, log) in libs.items():
        print(f"[ptxas] {label}: {' | '.join(ptxas_lines(log, 'bvh_sdf_kernel'))}", flush=True)

    sdf = sdf_testbed(dev).sdf
    packed = sdf.packed_bvh
    bvh = packed.bvh
    pts = chip_smoke.g_points(sdf)
    bvh_bytes = sum(chip_smoke.nbytes(t) for t in bvh)
    v1_args = V1Args(*(getattr(bvh, k).data_ptr() for k in bvh_lib.BvhArrays._fields))
    v2_args = kernels.BvhArgs(*(t.data_ptr() for t in (packed.nodes, packed.tris, bvh.tri_pseudo_v,
                                                         bvh.tri_pseudo_e, bvh.tri_n)))
    print(f"[bvh] card: {smi}; {bvh.node_min.shape[0]} nodes, BvhArrays {bvh_bytes / 1e6:.3f} MB; packed "
          f"{packed.nodes.shape[0]} records, {packed.tris.shape[0]} triangles, "
          f"{chip_smoke.nbytes(packed.nodes, packed.tris) / 1e6:.3f} MB, depth {packed.depth}", flush=True)

    n_near = sdf.batch_sizes(1 << 16)[1]  # the batch's offset points come first, its uniform ones last
    pts["2^15 near-surface part"], pts["2^15 uniform part"] = pts["2^15"][:n_near], pts["2^15"][n_near:]
    stream = kernels.stream_ptr(dev)
    for size in SIZES:
        p = pts[size]
        N = p.shape[0]
        runs = {
            V1: lambda o: kernels.check(libs[V1][0].nst_bvh_sdf(ctypes.byref(v1_args), p.data_ptr(), o.data_ptr(),
                                                                  N, stream), "v1"),
            V2: lambda o: kernels.check(libs[V2][0].nst_bvh_sdf(ctypes.byref(v2_args), p.data_ptr(), o.data_ptr(),
                                                                  N, stream), "v2"),
        }
        times = {label: [] for label in runs}
        outs = {}
        for order in (list(runs), list(runs)[::-1]):
            for label in order:
                out = torch.empty(N, device=dev)
                times[label].append(chip_smoke.both_ms(lambda: runs[label](out)))
                runs[label](out)
                torch.cuda.synchronize()
                outs[label] = out
        b_ms, _ = chip_smoke.bound(chip_smoke.nbytes(p) + N * 4 + bvh_bytes)
        med = {label: statistics.median([t[1] for t in times[label]]) for label in runs}
        for label in runs:
            ev = [t[0] for t in times[label]]
            dv = [t[1] for t in times[label]]
            diff = int((outs[label] != outs[V1]).sum())
            print(f"[bvh] {size} {label} walk: device {' / '.join(f'{t:.4f}' for t in dv)} ms, events "
                  f"{' / '.join(f'{t:.4f}' for t in ev)} ms (forward / reversed pass); device/bound "
                  f"{med[label] / b_ms:.1f}; max |d - v1| {float((outs[label] - outs[V1]).abs().max()):.3e}, "
                  f"{diff} of {N} differ", flush=True)
        g_ms = chip_smoke.both_ms(lambda: bvh_lib.bvh_signed_distance_cuda(packed, p))
        print(f"[bvh] {size} v1/v2 (device medians) {med[V1] / med[V2]:.2f}x; the package's whole call: events "
              f"{g_ms[0]:.4f} ms, device {g_ms[1]:.4f} ms; bound {b_ms:.4f} ms (bytes)", flush=True)
    print(f"[bvh] {smi}")


if __name__ == "__main__":
    main()
