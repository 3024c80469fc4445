"""The port's own PNG codec (``nerfshop_tpu_torch/data/image_io.py`` with the
row unfiltering of ``csrc/image_ops.cpp``) against PIL, which only this
test imports: every colour type at 8 and 16 bits and every row filter
decode as PIL decodes them, write → read is bit-exact, the quantization is
the JAX writer's, and a PNG scene loads with PIL absent."""

import io
import json
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from nerfshop_tpu.data import image_io as jio
from nerfshop_tpu.data import nerf_loader as jloader
from nerfshop_tpu_torch import native
from nerfshop_tpu_torch.data import image_io as tio
from torch_one_thread import one_thread  # noqa: F401

#: PNG colour type → channels
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _encode(a, ctype, depth, filters, interlace=0):
    """A PNG of ``a`` [H, W, C] (uint8 or uint16) with row y filtered by
    ``filters[y % len(filters)]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = a.shape
    raw = a.astype(">u2").view(np.uint8) if depth == 16 else a.astype(np.uint8)
    raw = raw.reshape(h, -1).astype(np.int32)
    bpp = c * depth // 8
    rows, prev = [], np.zeros(raw.shape[1], np.int32)
    for y in range(h):
        cur = raw[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = filters[y % len(filters)]
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
        prev = cur
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (tio.PNG_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype", sorted(CHANNELS), ids=["gray", "rgb", "gray_alpha", "rgba"])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (4, 3, 1, 0, 2)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_decodes_as_pil(tmp_path, ctype, depth, filters):
    # bit-equal to np.asarray(Image.open(...)): the same dtype, shape and
    # values (PIL's 16-bit gray keeps 16 bits, its other 16-bit types the
    # high bytes, and widens 16-bit gray + alpha to RGBA)
    rng = np.random.default_rng(ctype * 100 + depth)
    a = rng.integers(0, 1 << depth, (7, 11, CHANNELS[ctype]))
    a[0, :] = (1 << depth) - 1  # a row of maximal bytes makes every predictor wrap
    path = tmp_path / "x.png"
    path.write_bytes(_encode(a, ctype, depth, filters))
    ours, ref = tio.read_png(path), np.asarray(Image.open(path))
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
def test_reads_pil_written_pngs_as_the_jax_reader(tmp_path, mode):
    # PIL's own encoder (its filter choice and zlib levels); read_image, in
    # both colour spaces, equals the JAX package's read_image through PIL
    rng = np.random.default_rng(len(mode))
    shape = {"L": (13, 17), "LA": (13, 17, 2), "RGB": (13, 17, 3), "RGBA": (13, 17, 4), "I;16": (13, 17)}[mode]
    a = rng.integers(0, 65536 if mode == "I;16" else 256, shape).astype(np.uint16 if mode == "I;16" else np.uint8)
    for level, opt in ((9, True), (1, False)):
        path = tmp_path / f"x{level}.png"
        img = Image.fromarray(a)
        assert img.mode == mode
        img.save(path, compress_level=level, optimize=opt)
        np.testing.assert_array_equal(tio.read_png(path), np.asarray(Image.open(path)))
        for linear in (False, True):
            ours, ref = tio.read_image(path, linear=linear), jio.read_image(path, linear=linear)
            assert ours.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("shape", [(9, 14), (9, 14, 1), (9, 14, 2), (9, 14, 3), (9, 14, 4)],
                         ids=["2d", "gray", "gray_alpha", "rgb", "rgba"])
def test_write_read_round_trip(tmp_path, shape):
    # write_image quantizes as the JAX writer, (clip·255 + 0.5) → uint8, the
    # file decodes the same in PIL, and read_image gives those levels back
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    img = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    img.reshape(-1)[:3] = [0.5 / 255, 1.5 / 255, 254.5 / 255]  # round-half-up points
    ours, ref = tmp_path / "ours.png", tmp_path / "ref.png"
    tio.write_image(ours, img, linear_input=False)
    jio.write_image(ref, img, linear_input=False)
    levels = (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), np.asarray(Image.open(ref)))
    np.testing.assert_array_equal(tio.read_png(ours), levels[..., 0] if levels.ndim == 3 and levels.shape[-1] == 1 else levels)
    back = tio.read_image(ours, linear=False)
    np.testing.assert_array_equal(back, (levels.reshape(back.shape).astype(np.float32) / 255.0))
    # linear input: the sRGB curve before quantizing, as JAX
    tio.write_image(ours, img, linear_input=True)
    jio.write_image(ref, img, linear_input=True)
    np.testing.assert_array_equal(tio.read_png(ours), np.asarray(Image.open(ref)))


@pytest.mark.parametrize("shape", [(9, 14), (9, 14, 3), (9, 14, 4)], ids=["gray", "rgb", "rgba"])
def test_encode_png_is_what_write_png_writes(tmp_path, shape):
    data = np.random.default_rng(shape[-1]).integers(0, 256, shape, dtype=np.uint8)
    tio.write_png(tmp_path / "a.png", data)
    png = tio.encode_png(data)
    assert png == (tmp_path / "a.png").read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), data)


def test_unsupported_files_raise(tmp_path):
    # interlaced PNGs, palette PNGs and progressive JPEGs raise
    # NotImplementedError naming the file and the format; a bad filter byte
    # and a foreign file ValueError. A baseline JPEG decodes (the JPEG codec
    # is tested in tests/test_torch_jpeg.py), whatever its suffix, as PIL
    # tells the format by its first bytes
    a = np.zeros((4, 4, 3), np.uint8)
    path = tmp_path / "adam7.png"
    path.write_bytes(_encode(a, 2, 8, (0,), interlace=1))
    with pytest.raises(NotImplementedError, match="adam7.png.*interlaced"):
        tio.read_image(path)
    Image.fromarray(a).convert("P").save(tmp_path / "palette.png")
    with pytest.raises(NotImplementedError, match="palette.png.*colour type 3"):
        tio.read_image(tmp_path / "palette.png")
    Image.fromarray(a).save(tmp_path / "photo.jpg", progressive=True)
    with pytest.raises(NotImplementedError, match="photo.jpg.*progressive JPEG"):
        tio.read_image(tmp_path / "photo.jpg")
    Image.fromarray(a).save(tmp_path / "baseline.jpg")
    (tmp_path / "jpeg_named.png").write_bytes((tmp_path / "baseline.jpg").read_bytes())
    np.testing.assert_array_equal(tio.read_image(tmp_path / "jpeg_named.png"), jio.read_image(tmp_path / "jpeg_named.png"))
    (tmp_path / "text.png").write_text("not an image")
    with pytest.raises(ValueError, match="not a PNG"):
        tio.read_image(tmp_path / "text.png")
    raw = np.zeros((2, 1 + 4), np.uint8)
    raw[1, 0] = 5
    with pytest.raises(ValueError, match="row 1 has filter type 5"):
        native.png_unfilter(raw, 2, 4, 1)
    with pytest.raises(NotImplementedError, match="x.tga"):
        tio.write_image(tmp_path / "x.tga", np.zeros((2, 2, 3), np.float32))


def _png_scene(root, n=3, h=8, w=10):
    rng = np.random.default_rng(9)
    (root / "images").mkdir()
    frames = []
    for i in range(n):
        m = np.eye(4)
        m[:3, 3] = rng.uniform(-1, 1, 3)
        tio.write_image(root / "images" / f"{i}.png", rng.uniform(0, 1, (h, w, 4)).astype(np.float32), linear_input=False)
        frames.append({"file_path": f"images/{i}", "transform_matrix": m.tolist()})
    meta = {"camera_angle_x": 0.7, "aabb_scale": 2, "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))


def test_load_training_data_without_pil(tmp_path, monkeypatch):
    # a PNG scene loads in the port's Testbed while importing PIL fails, and
    # its images are the JAX loader's (which reads through PIL)
    from nerfshop_tpu_torch.testbed import Testbed

    _png_scene(tmp_path)
    ref = jloader.load_nerf(tmp_path / "transforms.json")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    tb = Testbed(device="cpu", seed=0, config={
        "encoding": {"otype": "HashGrid", "n_levels": 2, "log2_hashmap_size": 10, "base_resolution": 4},
        "network": {"n_neurons": 64, "n_hidden_layers": 1},
        "dir_encoding": {"otype": "SphericalHarmonics", "degree": 4},
        "rgb_network": {"n_neurons": 64, "n_hidden_layers": 1},
    })
    tb.load_training_data(str(tmp_path))
    ds = tb._dataset
    assert ds.n_images == 3 and ds.aabb_scale == 2
    np.testing.assert_array_equal(ds.images, ref.images)
    np.testing.assert_array_equal(ds.xforms, ref.xforms)
    assert tb.model is not None and isinstance(tb.model.pos_encoding.table, torch.Tensor)
