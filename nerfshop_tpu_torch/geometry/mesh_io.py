"""Triangle-mesh I/O: OBJ / PLY / STL load+save (host numpy).

Replaces the reference's tinyobjloader wrapper
(src/tinyobj_loader_wrapper.cpp) and the OBJ/PLY writers in
src/marching_cubes.cu (save_mesh). Only what the framework needs:
vertices + triangle faces (+ optional vertex colors/normals on save).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np


@dataclass
class TriMesh:
    vertices: np.ndarray  # [V, 3] float32
    faces: np.ndarray  # [F, 3] int32
    colors: Optional[np.ndarray] = None  # [V, 3] float32
    normals: Optional[np.ndarray] = None  # [V, 3] float32

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_faces(self) -> int:
        return len(self.faces)

    def face_normals(self) -> np.ndarray:
        v = self.vertices
        f = self.faces
        n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-20)

    def vertex_normals(self) -> np.ndarray:
        """Area-weighted (1-ring) vertex normals."""
        fn = np.cross(
            self.vertices[self.faces[:, 1]] - self.vertices[self.faces[:, 0]],
            self.vertices[self.faces[:, 2]] - self.vertices[self.faces[:, 0]],
        )  # area-weighted (unnormalized)
        vn = np.zeros_like(self.vertices)
        for k in range(3):
            np.add.at(vn, self.faces[:, k], fn)
        return vn / (np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-20)

    def bounds(self):
        return self.vertices.min(0), self.vertices.max(0)


def load_obj(path: str | Path) -> TriMesh:
    verts, faces = [], []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:]]
                idx = [int(i) for i in idx]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan-triangulate polygons
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))


def load_stl(path: str | Path) -> TriMesh:
    data = Path(path).read_bytes()
    if data[:5].lower() == b"solid" and b"facet" in data[:500]:
        # ASCII STL
        verts = []
        for line in data.decode(errors="ignore").splitlines():
            line = line.strip()
            if line.startswith("vertex"):
                verts.append([float(x) for x in line.split()[1:4]])
        v = np.asarray(verts, np.float32)
    else:
        (n_tri,) = struct.unpack_from("<I", data, 80)
        arr = np.frombuffer(data, np.uint8, count=n_tri * 50, offset=84).reshape(n_tri, 50)
        v = arr[:, 12:48].copy().view("<f4").reshape(n_tri * 3, 3)
        v = np.ascontiguousarray(v, np.float32)
    faces = np.arange(len(v), dtype=np.int32).reshape(-1, 3)
    return TriMesh(v, faces)


def load_ply(path: str | Path) -> TriMesh:
    """Minimal PLY (ascii & binary_little_endian, float verts / int faces)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="ignore").splitlines()
    fmt = "ascii"
    n_v = n_f = 0
    v_props = []
    cur = None
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = t[1]
            if t[1] == "vertex":
                n_v = int(t[2])
            elif t[1] == "face":
                n_f = int(t[2])
        elif t[0] == "property" and cur == "vertex":
            v_props.append((t[-1], t[1]))
    if fmt == "ascii":
        body = data[header_end:].decode("ascii", errors="ignore").split()
        ncols = len(v_props)
        vdata = np.asarray(body[: n_v * ncols], np.float32).reshape(n_v, ncols)
        verts = vdata[:, :3]
        rest = body[n_v * ncols :]
        faces = []
        pos = 0
        for _ in range(n_f):
            cnt = int(rest[pos])
            idx = [int(x) for x in rest[pos + 1 : pos + 1 + cnt]]
            for k in range(1, cnt - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
            pos += cnt + 1
        return TriMesh(np.asarray(verts, np.float32), np.asarray(faces, np.int32))
    # binary little endian
    sizes = {"float": 4, "float32": 4, "double": 8, "uchar": 1, "uint8": 1, "int": 4, "uint": 4}
    stride = sum(sizes[t] for _, t in v_props)
    raw = data[header_end:]
    verts = np.zeros((n_v, 3), np.float32)
    off = 0
    vbuf = np.frombuffer(raw, np.uint8, count=n_v * stride).reshape(n_v, stride)
    col = 0
    for i, (name, typ) in enumerate(v_props):
        if name in ("x", "y", "z"):
            j = "xyz".index(name)
            verts[:, j] = vbuf[:, col : col + 4].copy().view("<f4")[:, 0]
        col += sizes[typ]
    pos = header_end + n_v * stride
    faces = []
    for _ in range(n_f):
        cnt = data[pos]
        idx = np.frombuffer(data, "<i4", count=cnt, offset=pos + 1)
        for k in range(1, cnt - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
        pos += 1 + 4 * cnt
    return TriMesh(verts, np.asarray(faces, np.int32))


def load_mesh(path: str | Path) -> TriMesh:
    suffix = Path(path).suffix.lower()
    if suffix == ".obj":
        return load_obj(path)
    if suffix == ".stl":
        return load_stl(path)
    if suffix == ".ply":
        return load_ply(path)
    raise ValueError(f"unsupported mesh format {suffix}")


def _unwrap_atlas(n_faces: int):
    """The reference's trivial per-triangle-pair quad atlas
    (save_mesh src/marching_cubes.cu:779-785, 863-885): every two triangles
    share one quadresx×quadresy texel quad laid out row-major; returns
    (uv [3·F, 2] one vt per face corner, tex [texh, texw, 3] uint8 debug
    texture with a flat pseudo-random color per triangle)."""
    numquads = (n_faces + 1) // 2
    numquadsx = max(4, int(np.sqrt(numquads) + 4) & ~3)
    numquadsy = (numquads + numquadsx - 1) // numquadsx
    quadresy = 8
    quadresx = quadresy + 3
    texw, texh = quadresx * numquadsx, quadresy * numquadsy

    i = np.arange(3 * n_faces)
    q = i // 6
    x = (q % numquadsx) * quadresx
    y = (q // numquadsx) * quadresy
    d = quadresy - 1
    m = i % 6
    x = x + np.choose(m, [0, d, 0, 3, 3 + d, 3 + d])
    y = y + np.choose(m, [0, d, d, 0, 0, d])
    uv = np.stack([(x + 0.5) / texw, 1.0 - (y + 0.5) / texh], axis=-1)

    yy, xx = np.mgrid[0:texh, 0:texw]
    qq = xx // quadresx + (yy // quadresy) * numquadsx
    t = qq * 2 + ((xx % quadresx) > (yy % quadresy) + 1)
    tex = np.stack([(t * 923) & 255, (t * 3572) & 255, (t * 5423) & 255], -1)
    return uv.astype(np.float32), tex.astype(np.uint8)


def save_obj(path: str | Path, mesh: TriMesh, unwrap: bool = False) -> None:
    with open(path, "w") as f:
        if unwrap:
            f.write("mtllib nerf.mtl\n")
        if mesh.colors is not None:
            for v, c in zip(mesh.vertices, mesh.colors):
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in mesh.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if mesh.normals is not None:
            for n in mesh.normals:
                f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        if unwrap:
            uv, tex = _unwrap_atlas(mesh.n_faces)
            for u in uv:
                f.write(f"vt {u[0]:.5f} {u[1]:.5f}\n")
            f.write("g default\nusemtl nerf\ns 1\n")
            for fi, face in enumerate(mesh.faces + 1):
                t = 3 * fi
                f.write(
                    f"f {face[0]}/{t + 1} {face[1]}/{t + 2} {face[2]}/{t + 3}\n"
                )
            try:
                from PIL import Image

                Image.fromarray(tex).save(Path(path).with_suffix(".png"))
            except Exception:
                pass
        else:
            for face in mesh.faces + 1:
                f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def save_ply(path: str | Path, mesh: TriMesh) -> None:
    with open(path, "wb") as f:
        has_c = mesh.colors is not None
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {mesh.n_vertices}"]
        hdr += ["property float x", "property float y", "property float z"]
        if has_c:
            hdr += ["property uchar red", "property uchar green", "property uchar blue"]
        hdr += [f"element face {mesh.n_faces}", "property list uchar int vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if has_c:
            cols = (np.clip(mesh.colors, 0, 1) * 255).astype(np.uint8)
            for v, c in zip(mesh.vertices.astype("<f4"), cols):
                f.write(v.tobytes() + c.tobytes())
        else:
            f.write(np.ascontiguousarray(mesh.vertices, "<f4").tobytes())
        cnt = np.full((mesh.n_faces, 1), 3, np.uint8)
        fb = np.ascontiguousarray(mesh.faces, "<i4")
        for i in range(mesh.n_faces):
            f.write(cnt[i].tobytes() + fb[i].tobytes())


def save_mesh(path: str | Path, mesh: TriMesh, unwrap: bool = False) -> None:
    suffix = Path(path).suffix.lower()
    if suffix == ".obj":
        save_obj(path, mesh, unwrap=unwrap)
    elif suffix == ".ply":
        save_ply(path, mesh)
    else:
        raise ValueError(f"unsupported mesh format {suffix}")
