"""The port's own JPEG codec (``nerfshop_tpu_torch/csrc/jpeg.cpp`` through
``native.jpeg_decode`` / ``native.jpeg_encode`` and ``data/image_io.py``)
against PIL, which only this test imports.

Tolerances: the decoder is held to PIL's decode (libjpeg-turbo's default:
the islow IDCT, fancy upsampling, fixed-point YCbCr → RGB) bit for bit, 0
levels, on every variant: it computes the same integer arithmetic. The
encoder computes libjpeg's quantized coefficients (the same colour
conversion, downsampling, forward DCT and quantization), so PIL's decode of
the port's file equals PIL's decode of PIL's own file at the same quality
and sampling, also at 0 levels."""

import io
import json
import sys

import numpy as np
import pytest
from PIL import Image

from nerfshop_tpu.data import image_io as jio
from nerfshop_tpu.data import nerf_loader as jloader
from nerfshop_tpu_torch import native
from nerfshop_tpu_torch.data import image_io as tio
from torch_one_thread import one_thread  # noqa: F401

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def photo(h, w, channels=3, seed=0, noise=20.0):
    """Smooth colour waves plus noise: the DCT sees both low and high
    frequencies, and every sample value is reachable."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k) * 100 + 128 + rng.normal(0, noise, (h, w))
                  for k in range(channels)], -1)
    a = np.clip(a, 0, 255).astype(np.uint8)
    return a[..., 0] if channels == 1 else a


def pil_jpeg(a, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG", **kw)
    return b.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
def test_decode_matches_pil(sub, quality):
    data = pil_jpeg(photo(37, 45), quality=quality, subsampling=SUBSAMPLING[sub])
    np.testing.assert_array_equal(native.jpeg_decode(data), pil_decode(data))


@pytest.mark.parametrize("size", [(23, 37), (1, 1), (2, 3), (5, 4), (9, 17), (16, 8), (17, 33)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
def test_decode_sizes_off_the_mcu_match_pil(size):
    # the right and bottom edges: partial MCUs, chroma rows and columns
    # repeated at the edge, and libjpeg's plain upsampling where a
    # downsampled row is at most 2 samples wide
    for sub in SUBSAMPLING.values():
        data = pil_jpeg(photo(*size, seed=sub), quality=90, subsampling=sub)
        np.testing.assert_array_equal(native.jpeg_decode(data), pil_decode(data))


def test_decode_grayscale_restarts_and_exif_match_pil():
    gray = pil_jpeg(photo(23, 37, channels=1), quality=80)
    out = native.jpeg_decode(gray)
    assert out.shape == (23, 37)
    np.testing.assert_array_equal(out, pil_decode(gray))
    for kw in (dict(restart_marker_blocks=3), dict(restart_marker_rows=1)):
        data = pil_jpeg(photo(40, 53), quality=90, **kw)
        assert b"\xff\xdd" in data  # a DRI segment
        np.testing.assert_array_equal(native.jpeg_decode(data), pil_decode(data))
    exif = Image.Exif()
    exif[0x010F] = "nerfshop"  # Make
    data = pil_jpeg(photo(30, 40), exif=exif.tobytes(), quality=85)
    assert b"Exif\x00\x00" in data
    np.testing.assert_array_equal(native.jpeg_decode(data), pil_decode(data))


@pytest.mark.parametrize("linear", [True, False])
def test_read_image_matches_jax(tmp_path, linear):
    for name, a in (("rgb.jpg", photo(21, 34)), ("gray.jpeg", photo(13, 11, channels=1))):
        Image.fromarray(a).save(tmp_path / name, quality=88)
        got = tio.read_image(tmp_path / name, linear=linear)
        ref = jio.read_image(tmp_path / name, linear=linear)
        assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_unsupported_and_corrupt_files_raise(tmp_path):
    a = photo(24, 32)
    path = tmp_path / "prog.jpg"
    path.write_bytes(pil_jpeg(a, progressive=True))
    with pytest.raises(NotImplementedError, match="prog.jpg: progressive JPEG"):
        tio.read_image(path)
    cmyk = io.BytesIO()
    Image.fromarray(np.concatenate([a, a[..., :1]], -1), "CMYK").save(cmyk, "JPEG")
    with pytest.raises(NotImplementedError, match="4-component"):
        native.jpeg_decode(cmyk.getvalue(), "cmyk.jpg")
    data = pil_jpeg(a, quality=90)
    for cut in (len(data) // 2, len(data) - 2, 100, 10):
        (tmp_path / "cut.jpg").write_bytes(data[:cut])
        with pytest.raises(ValueError, match="cut.jpg: corrupt JPEG.*truncated"):
            tio.read_image(tmp_path / "cut.jpg")
    sos = data.index(b"\xff\xda")
    bad = bytearray(data)
    bad[sos + 20: sos + 40] = b"\xff" * 20  # an all-ones Huffman code: no table has it
    with pytest.raises(ValueError, match="corrupt JPEG"):
        native.jpeg_decode(bytes(bad), "bad.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        native.jpeg_decode(b"\x89PNG\r\n\x1a\n", "x.jpg")


@pytest.mark.parametrize("sub", list(SUBSAMPLING))
def test_encoder_matches_pil(sub):
    # PIL's decode of the port's file against PIL's decode of PIL's own at
    # the same quality and sampling, at 0 levels
    for quality, size in ((75, (37, 45)), (90, (23, 17)), (50, (8, 16)), (100, (33, 9)), (20, (1, 3))):
        a = photo(*size, seed=quality)
        mine = native.jpeg_encode(a, quality, sub)
        np.testing.assert_array_equal(pil_decode(mine), pil_decode(pil_jpeg(a, quality=quality,
                                                                             subsampling=SUBSAMPLING[sub])))
        np.testing.assert_array_equal(native.jpeg_decode(mine), pil_decode(mine))
    gray = photo(19, 27, channels=1)
    np.testing.assert_array_equal(pil_decode(native.jpeg_encode(gray, 85)), pil_decode(pil_jpeg(gray, quality=85)))


def test_write_read_round_trip_and_write_image(tmp_path):
    a = photo(40, 56, noise=0.0)
    tio.write_jpeg(tmp_path / "a.jpg", a, quality=90, subsampling="4:2:0")
    np.testing.assert_array_equal(tio.read_jpeg(tmp_path / "a.jpg"), pil_decode((tmp_path / "a.jpg").read_bytes()))
    assert np.abs(tio.read_jpeg(tmp_path / "a.jpg").astype(int) - a).mean() < 3  # a close copy of smooth a
    # write_image at PIL's defaults (quality 75, 4:2:0): the same pixels as
    # the JAX writer's file; an alpha channel is dropped where PIL raises
    img = np.random.default_rng(3).uniform(0, 1, (20, 30, 4)).astype(np.float32)
    jio.write_image(tmp_path / "jax.jpg", img[..., :3])
    tio.write_image(tmp_path / "port.jpg", img[..., :3])
    np.testing.assert_array_equal(tio.read_image(tmp_path / "port.jpg"), jio.read_image(tmp_path / "jax.jpg"))
    tio.write_image(tmp_path / "rgba.jpeg", img)
    np.testing.assert_array_equal(tio.read_image(tmp_path / "rgba.jpeg"), tio.read_image(tmp_path / "port.jpg"))
    with pytest.raises(OSError):
        jio.write_image(tmp_path / "jax_rgba.jpg", img)
    with pytest.raises(ValueError, match="subsampling"):
        native.jpeg_encode(a, 75, "4:1:1")


def _jpeg_scene(root, n=3, h=16, w=24):
    rng = np.random.default_rng(9)
    (root / "images").mkdir()
    frames = []
    for i in range(n):
        m = np.eye(4)
        m[:3, 3] = rng.uniform(-1, 1, 3)
        end = m.copy()
        end[:3, 3] += 0.01
        Image.fromarray(photo(h, w, seed=i)).save(root / "images" / f"{i}.jpg", quality=90)
        frames.append({"file_path": f"images/{i}", "transform_matrix": m.tolist(),
                       "transform_matrix_end": end.tolist(), "light_dir": rng.normal(size=3).tolist()})
    meta = {"camera_angle_x": 0.7, "aabb_scale": 4, "rolling_shutter": [0.0, 0.2, 0.1, 0.05], "frames": frames}
    (root / "transforms.json").write_text(json.dumps(meta))


def test_jpeg_scene_loads_without_pil(tmp_path, monkeypatch):
    # a JPEG scene with a rolling shutter and light dirs loads in the port's
    # Testbed while importing PIL fails; its images, poses, end poses, light
    # dirs and shutter are the JAX loader's (which reads through PIL), and
    # it renders a JPEG screenshot (tests/test_torch_capture_options.py
    # trains with the shutter and the light dirs)
    from nerfshop_tpu_torch.testbed import Testbed

    _jpeg_scene(tmp_path)
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
    assert ds.n_images == 3 and ds.aabb_scale == 4 and ds.has_light_dirs
    for name in ("images", "xforms", "xforms_end", "light_dirs", "rolling_shutter"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(ref, name), err_msg=name)
    assert tb.model.n_extra_dims == 3 and tb.train_config.n_cascades == 3
    assert tb._device_data.xforms_end is not None and tb._device_data.light_dirs is not None
    out = tb.screenshot(str(tmp_path / "shot.jpg"), 12, 8, spp=1)
    assert out.shape == (8, 12, 4) and tio.read_image(tmp_path / "shot.jpg").shape == (8, 12, 3)
