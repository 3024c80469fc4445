"""Volume ingest for the Volume testbed: the port's own copy of
``nerfshop_tpu/data/volume_io.py`` (host numpy, no JAX), the same code
below this docstring (``tests/test_torch_host_copies.py`` holds it to the
original).

Formats: ``.npy`` / ``.npz`` (a 3-D float density array, key ``density`` or
the first array of an npz), ``.raw`` with a sidecar ``.json`` ({"dims":
[X, Y, Z], "dtype": "float32"}), and ``.nvdb``, uncompressed NanoVDB float
grids, read natively by :func:`load_nanovdb`; ``.vdb`` raises with a
conversion hint. → density [X, Y, Z] float32.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

NANOVDB_MAGIC = 0x304244566F6E614E  # "NanoVDB0"

# NanoVDB v32.3 ABI constants (reference vendored header,
# dependencies/nanovdb/nanovdb/NanoVDB.h; file wrapper structs match
# src/testbed_volume.cu:536-561 NanoVDBFileHeader/NanoVDBMetaData)
_FILE_HEADER = np.dtype(
    [("magic", "<u8"), ("version", "<u4"), ("gridCount", "<u2"), ("codec", "<u2")]
)
_FILE_META = np.dtype(
    [
        ("gridSize", "<u8"), ("fileSize", "<u8"), ("nameKey", "<u8"), ("voxelCount", "<u8"),
        ("gridType", "<u4"), ("gridClass", "<u4"),
        ("worldBBox", "<f8", (2, 3)), ("indexBBox", "<i4", (2, 3)),
        ("voxelSize", "<f8", (3,)), ("nameSize", "<u4"),
        ("nodeCount", "<u4", (4,)), ("tileCount", "<u4", (3,)),
        ("codec", "<u2"), ("padding", "<u2"), ("version", "<u4"),
    ]
)
_GRIDDATA_SIZE = 672  # sizeof(GridData), NanoVDB.h:2184
_TREEDATA_OFF = _GRIDDATA_SIZE  # TreeData follows GridData
_LEAF_HEADER = 96  # CoordT(12)+bboxDif(3)+flags(1)+mask(64)+min/max/avg/std(16)
_LEAF_SIZE_F32 = _LEAF_HEADER + 512 * 4  # + alignas(32) float values, 8^3
_GRIDTYPE_FLOAT = 1


def load_nanovdb(path: str | Path) -> np.ndarray:
    """Minimal native .nvdb reader (uncompressed float grids, first grid) —
    the reference's own loader path (src/testbed_volume.cu:563-640).

    Decodes LEAF nodes directly: every NanoVDB leaf stores its absolute
    index-space origin (LeafData.mBBoxMin, NanoVDB.h:3364) plus a dense 8³
    value array, so the dense volume assembles without walking the
    root/internal tree. Active constant TILES — root tiles (4096³ regions)
    and internal-node tiles (upper: 128³, lower: 8³; InternalData.mTable
    union slots whose child-mask bit is off and value-mask bit is on,
    NanoVDB.h:3042-3116) — are expanded coarse-to-fine before the leaves,
    so uniform interior regions decode exactly.
    """
    raw = Path(path).read_bytes()
    hdr = np.frombuffer(raw, _FILE_HEADER, count=1)[0]
    if int(hdr["magic"]) != NANOVDB_MAGIC:
        raise ValueError(f"{path}: not a NanoVDB file")
    if int(hdr["codec"]) != 0:
        raise NotImplementedError("compressed .nvdb (codec != 0) is not supported")
    if int(hdr["gridCount"]) == 0:
        raise ValueError("no grids in file")
    off = _FILE_HEADER.itemsize
    meta = np.frombuffer(raw, _FILE_META, count=1, offset=off)[0]
    off += _FILE_META.itemsize
    off += int(meta["nameSize"])  # grid name
    if int(meta["codec"]) != 0:
        raise NotImplementedError("compressed .nvdb grid is not supported")
    if int(meta["gridType"]) != _GRIDTYPE_FLOAT:
        raise NotImplementedError(f"gridType {int(meta['gridType'])} != Float")
    grid = raw[off : off + int(meta["gridSize"])]

    # TreeData (NanoVDB.h:2500): node offsets are relative to the TREE
    tree = np.frombuffer(grid, "<u8", count=4, offset=_TREEDATA_OFF)
    node_count = np.frombuffer(grid, "<u4", count=3, offset=_TREEDATA_OFF + 32)
    leaf_off = _TREEDATA_OFF + int(tree[0])
    n_leaf = int(node_count[0])
    root_off = _TREEDATA_OFF + int(tree[3])
    # RootData: mBBox (24B) + mTableSize (4B) + mBackground (NanoVDB.h:2718)
    background = float(np.frombuffer(grid, "<f4", count=1, offset=root_off + 28)[0])

    bb = np.asarray(meta["indexBBox"], np.int64)
    lo, hi = bb[0], bb[1]
    dims = np.maximum(hi - lo + 1, 1)
    vol = np.full(tuple(dims), background, np.float32)

    def fill(org, span, value):
        """Fill the cube [org, org+span) (absolute index coords) clipped."""
        d0 = org - lo
        a = np.maximum(d0, 0)
        b = np.minimum(d0 + span, dims)
        if (b > a).all():
            vol[a[0] : b[0], a[1] : b[1], a[2] : b[2]] = value

    # --- root constant tiles (RootData::Tile, NanoVDB.h:2729-2752):
    # child == 0 ⇒ constant tile over an upper-node footprint (4096³);
    # state != 0 ⇒ active. Key packs x/y/z >> 12 into 21-bit fields.
    n_root_tiles = int(np.frombuffer(grid, "<u4", count=1, offset=root_off + 24)[0])
    if n_root_tiles:
        rt = np.frombuffer(
            grid, np.uint8, count=n_root_tiles * 32, offset=root_off + 64
        ).reshape(n_root_tiles, 32)
        keys = rt[:, 0:8].copy().view("<u8").reshape(-1)
        childs = rt[:, 8:16].copy().view("<i8").reshape(-1)
        states = rt[:, 16:20].copy().view("<u4").reshape(-1)
        vals = rt[:, 20:24].copy().view("<f4").reshape(-1)
        M21 = (1 << 21) - 1
        for t in np.nonzero((childs == 0) & (states != 0))[0]:
            k = int(keys[t])
            org = np.asarray(
                [
                    np.int32(np.uint32(((k >> 42) & M21) << 12)),
                    np.int32(np.uint32(((k >> 21) & M21) << 12)),
                    np.int32(np.uint32((k & M21) << 12)),
                ],
                np.int64,
            )
            fill(org, 1 << 12, float(vals[t]))

    # --- internal-node constant tiles (InternalData, NanoVDB.h:3042):
    # header = mBBox(24) + mFlags(8), then value/child Masks, 16B stats,
    # alignas(32) Tile table of union{f32 value, i64 child} (8B slots).
    def expand_internal(node_off_rel, n_nodes, log2dim, child_total):
        if n_nodes == 0:
            return
        mask_bytes = (1 << (3 * log2dim)) // 8
        table_off = -(-(32 + 2 * mask_bytes + 16) // 32) * 32
        n_tiles = 1 << (3 * log2dim)
        node_size = table_off + n_tiles * 8
        span_child = 1 << child_total
        span_node = span_child << log2dim
        nodes = np.frombuffer(
            grid, np.uint8, count=n_nodes * node_size, offset=node_off_rel
        ).reshape(n_nodes, node_size)
        bbox_min = nodes[:, :12].copy().view("<i4").reshape(n_nodes, 3)
        origins = bbox_min & ~(span_node - 1)  # mBBoxMin is the ACTIVE bbox
        vmask = np.unpackbits(nodes[:, 32 : 32 + mask_bytes], axis=1, bitorder="little")
        cmask = np.unpackbits(
            nodes[:, 32 + mask_bytes : 32 + 2 * mask_bytes], axis=1, bitorder="little"
        )
        vals = (
            nodes[:, table_off:].copy().view("<f4").reshape(n_nodes, n_tiles, 2)[:, :, 0]
        )
        active = (vmask == 1) & (cmask == 0)
        dim_mask = (1 << log2dim) - 1
        for n, t in zip(*np.nonzero(active)):
            # offset n = x·2^(2·LOG2DIM) + y·2^LOG2DIM + z (i-major, like leaves)
            tx, ty, tz = (t >> (2 * log2dim)), (t >> log2dim) & dim_mask, t & dim_mask
            org = origins[n] + np.asarray([tx, ty, tz], np.int64) * span_child
            fill(org, span_child, float(vals[n, t]))

    n_lower, n_upper = int(node_count[1]), int(node_count[2])
    upper_off = _TREEDATA_OFF + int(tree[2])
    lower_off = _TREEDATA_OFF + int(tree[1])
    expand_internal(upper_off, n_upper, log2dim=5, child_total=7)  # 128³ tiles
    expand_internal(lower_off, n_lower, log2dim=4, child_total=3)  # 8³ tiles
    if n_leaf:
        leaves = np.frombuffer(grid, np.uint8, count=n_leaf * _LEAF_SIZE_F32, offset=leaf_off)
        leaves = leaves.reshape(n_leaf, _LEAF_SIZE_F32)
        bbox_min = leaves[:, :12].copy().view("<i4").reshape(n_leaf, 3)
        # LeafData.mBBoxMin is the leaf's ACTIVE-voxel bbox min after
        # gridStats/updateBBox (NanoVDB.h:3883) — NOT the leaf origin; the
        # origin is its 8-aligned floor, origin() = mBBoxMin & ~MASK
        # (NanoVDB.h:3734). Partially-active boundary leaves in real files
        # have unaligned mBBoxMin, so aligning here is load-bearing.
        origins = bbox_min & ~7
        values = leaves[:, _LEAF_HEADER:].copy().view("<f4").reshape(n_leaf, 8, 8, 8)
        # leaf-local layout: offset = ((i&7)<<6)|((j&7)<<3)|(k&7) → [i, j, k]
        for n in range(n_leaf):
            d0 = origins[n] - lo  # may be negative when lo is unaligned
            s0 = np.maximum(-d0, 0)  # low-side clip, leaf-local
            i0, j0, k0 = np.maximum(d0, 0)
            i1 = min(d0[0] + 8, dims[0])
            j1 = min(d0[1] + 8, dims[1])
            k1 = min(d0[2] + 8, dims[2])
            if i1 <= i0 or j1 <= j0 or k1 <= k0:
                continue
            vol[i0:i1, j0:j1, k0:k1] = values[n][
                s0[0] : s0[0] + i1 - i0, s0[1] : s0[1] + j1 - j0, s0[2] : s0[2] + k1 - k0
            ]
    return vol


def load_volume(path: str | Path) -> np.ndarray:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".npy":
        vol = np.load(path)
    elif suffix == ".npz":
        z = np.load(path)
        vol = z["density"] if "density" in z else z[list(z.keys())[0]]
    elif suffix == ".raw":
        meta = json.loads(path.with_suffix(".json").read_text())
        dims = meta["dims"]
        dtype = np.dtype(meta.get("dtype", "float32"))
        vol = np.fromfile(path, dtype=dtype).reshape(dims)
    elif suffix == ".nvdb":
        vol = load_nanovdb(path)
    elif suffix == ".vdb":
        raise NotImplementedError(
            f"OpenVDB ingest: convert {path.name} to .nvdb (nanovdb_convert) "
            "or .npy first (the OpenVDB tree format is not parsed natively)"
        )
    else:
        raise ValueError(f"unsupported volume format {suffix!r}")
    vol = np.asarray(vol, np.float32)
    if vol.ndim != 3:
        raise ValueError(f"volume must be 3D, got {vol.shape}")
    return vol
