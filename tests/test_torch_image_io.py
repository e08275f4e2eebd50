"""The port's image readers and writers (utils/image.py, utils/piz.py,
utils/ply.py) against the JAX package's: read_exr gives the same arrays,
channel names and attributes on ZIP, ZIPS, RLE, uncompressed, half and
single-channel files (each written here; the RLE, ZIPS and uncompressed
ones by a small scanline writer below); PFM and QOI files written by
either package are byte-identical and read back the same in both;
write_ply gives byte-identical files and read_ply the same meshes
(binary and ascii); read_image and the metrics agree.  The PIZ reference
images are read as tests/test_image_io.py reads them, when mounted."""
import os
import struct
import zlib

import numpy as np
import pytest

from acceleratedvolrenderer_tpu.utils import image as jim
from acceleratedvolrenderer_tpu.utils import ply as jply
from acceleratedvolrenderer_tpu_torch.utils import image as tim
from acceleratedvolrenderer_tpu_torch.utils import ply as tply

from test_image_io import REF


def _rle_encode(data: bytes) -> bytes:
    """OpenEXR's RLE: a run of 3+ equal bytes as (count - 1, byte), other
    bytes as (-count, literal bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += struct.pack("<b", j - i - 1) + data[i:i + 1]
            i = j
            continue
        j = i
        while j < n and j - i < 127 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += struct.pack("<b", -(j - i)) + data[i:j]
        i = j
    return bytes(out)


def _write_scanline_exr(path, img, compression):
    """A float scanline EXR, one line per chunk, with compression 0 (none),
    1 (RLE) or 2 (ZIPS)."""
    h, w, c = img.shape
    names = ("B", "G", "R")[:c] if c == 3 else ("Y",)
    order = {"R": 0, "G": 1, "B": 2, "Y": 0}
    header = b"".join([
        tim._attr("channels", "chlist", tim._chlist(sorted(names))),
        tim._attr("compression", "compression", bytes([compression])),
        tim._attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1,
                                                     h - 1)),
        tim._attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0,
                                                        w - 1, h - 1)),
        tim._attr("lineOrder", "lineOrder", b"\0"),
        tim._attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        tim._attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0)),
        tim._attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    ]) + b"\0"
    chunks = []
    for y in range(h):
        raw = b"".join(img[y, :, order[nm]].astype("<f4").tobytes()
                       for nm in sorted(names))
        if compression == 1:
            data = _rle_encode(tim._zip_filter_encode(raw))
        elif compression == 2:
            data = zlib.compress(tim._zip_filter_encode(raw))
        else:
            data = raw
        if len(data) >= len(raw):
            data = raw
        chunks.append(struct.pack("<ii", y, len(data)) + data)
    head = struct.pack("<II", tim._EXR_MAGIC, 2) + header
    offset = len(head) + 8 * h
    table = b""
    for ch in chunks:
        table += struct.pack("<Q", offset)
        offset += len(ch)
    with open(path, "wb") as f:
        f.write(head + table + b"".join(chunks))


def _image(shape, seed=0):
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) * 4.0).astype(np.float32)
    img[: shape[0] // 3] = 0.5          # runs for RLE and ZIP
    return img


def _read_both(path):
    a, an, aa = jim.read_exr(path)
    b, bn, ba = tim.read_exr(path)
    np.testing.assert_array_equal(b, a)
    assert bn == an
    assert set(ba) == set(aa)
    for k in aa:
        if isinstance(aa[k], np.ndarray):
            np.testing.assert_array_equal(ba[k], aa[k])
        else:
            assert ba[k] == aa[k], k
    return b, bn, ba


@pytest.mark.parametrize("compression", [0, 1, 2])
@pytest.mark.parametrize("channels", [3, 1])
def test_read_scanline_exr_matches_jax(tmp_path, compression, channels):
    img = _image((19, 23, channels), seed=compression)
    p = str(tmp_path / "s.exr")
    _write_scanline_exr(p, img, compression)
    back, names, _ = _read_both(p)
    np.testing.assert_array_equal(back, img)
    assert names == (["R", "G", "B"] if channels == 3 else ["Y"])


def test_rle_chunks_are_compressed():
    raw = tim._zip_filter_encode(np.zeros(256, "<f4").tobytes())
    enc = _rle_encode(raw)
    assert len(enc) < len(raw) / 10
    assert tim._rle_decode(enc) == raw == jim._rle_decode(enc)


def test_zip_roundtrip_with_metadata(tmp_path):
    img = _image((65, 97, 3))
    p = str(tmp_path / "t.exr")
    md = tim.ImageMetadata(render_time_seconds=2.5, samples_per_pixel=64,
                           mse=0.125, world_to_camera=np.eye(4))
    tim.write_exr(p, img, md)
    out, names, attrs = _read_both(p)
    np.testing.assert_array_equal(out, img)
    assert names == ["R", "G", "B"]
    assert attrs["renderTimeSeconds"] == 2.5
    assert attrs["samplesPerPixel"] == 64 and attrs["MSE"] == 0.125


def test_half_and_single_channel(tmp_path):
    img = _image((33, 40, 3), seed=1)
    p = str(tmp_path / "h.exr")
    tim.write_exr(p, img, half=True)
    out, _, _ = _read_both(p)
    np.testing.assert_allclose(out, img, atol=2e-3)
    y = np.arange(64, dtype=np.float32).reshape(8, 8)
    p = str(tmp_path / "y.exr")
    tim.write_exr(p, y, channel_names=("Y",))
    out, names, _ = _read_both(p)
    np.testing.assert_array_equal(out[:, :, 0], y)
    assert names == ["Y"]


def test_read_exr_rejects_other_files(tmp_path):
    p = tmp_path / "x.exr"
    p.write_bytes(b"\0" * 64)
    with pytest.raises(ValueError, match="not an EXR"):
        tim.read_exr(str(p))


@pytest.mark.skipif(not os.path.exists(REF), reason="reference not mounted")
@pytest.mark.parametrize("name", ["cube.exr", "disney-cloud.exr"])
def test_piz_read_reference(name):
    img, names, attrs = _read_both(os.path.join(REF, name))
    assert np.isfinite(img).all() and img.min() >= 0.0


def test_pfm_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    for a in (rng.random((17, 23, 3)).astype(np.float32),
              rng.random((9, 5)).astype(np.float32)):
        pj, pt = str(tmp_path / "j.pfm"), str(tmp_path / "t.pfm")
        jim.write_pfm(pj, a)
        tim.write_pfm(pt, a)
        assert open(pj, "rb").read() == open(pt, "rb").read()
        np.testing.assert_array_equal(tim.read_pfm(pj), a)
        np.testing.assert_array_equal(jim.read_pfm(pt), a)


def test_pfm_big_endian_scale(tmp_path):
    a = np.random.default_rng(5).random((4, 6, 3)).astype(np.float32)
    p = tmp_path / "b.pfm"
    p.write_bytes(b"PF\n6 4\n2.0\n" + a[::-1].astype(">f4").tobytes())
    np.testing.assert_array_equal(tim.read_pfm(str(p)), jim.read_pfm(str(p)))
    np.testing.assert_allclose(tim.read_pfm(str(p)), a * 2.0)


def test_qoi_byte_identical(tmp_path):
    rng = np.random.default_rng(1)
    g = np.zeros((16, 16, 3), np.float32)
    g[:8] = 0.5
    g[:, :4] += 0.01
    for a in (rng.random((13, 11, 3)).astype(np.float32), g):
        pj, pt = str(tmp_path / "j.qoi"), str(tmp_path / "t.qoi")
        jim.write_qoi(pj, a)
        tim.write_qoi(pt, a)
        assert open(pj, "rb").read() == open(pt, "rb").read()
        b = tim.read_qoi(pj)
        np.testing.assert_array_equal(b, jim.read_qoi(pt))
        assert np.abs(b - a).max() < 0.005


def test_read_image_and_metrics(tmp_path):
    img = _image((6, 7, 3))
    p = str(tmp_path / "r.exr")
    tim.write_exr(p, img)
    a, _ = tim.read_image(p)
    b, _ = jim.read_image(p)
    np.testing.assert_array_equal(a, b)
    other = img + 0.25
    for f in ("mse", "mrse", "mae"):
        assert getattr(tim, f)(img, other) == getattr(jim, f)(img, other)
    assert tim.mse(np.ones((4, 4, 3)), np.zeros((4, 4, 3))) == 1.0


def test_write_png_matches_jax(tmp_path):
    pytest.importorskip("PIL")
    img = _image((5, 9, 3))
    tim.write_png(str(tmp_path / "t.png"), img)
    jim.write_png(str(tmp_path / "j.png"), img)
    a, _ = tim.read_image(str(tmp_path / "t.png"))
    b, _ = jim.read_image(str(tmp_path / "j.png"))
    np.testing.assert_array_equal(a, b)


MESH_V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
MESH_F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)


@pytest.mark.parametrize("extras", ["none", "normals", "uvs", "both"])
def test_write_ply_byte_identical(tmp_path, extras):
    kw = {}
    if extras in ("normals", "both"):
        kw["normals"] = np.tile(np.float32([0, 0, 1]), (4, 1))
    if extras in ("uvs", "both"):
        kw["uvs"] = MESH_V[:, :2].copy()
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jply.write_ply(pj, MESH_V, MESH_F, **kw)
    tply.write_ply(pt, MESH_V, MESH_F, **kw)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    a, b = jply.read_ply(pt), tply.read_ply(pj)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
    np.testing.assert_array_equal(b["faces"], MESH_F)


def test_read_ascii_ply_fan_triangulation(tmp_path):
    p = tmp_path / "a.ply"
    p.write_text("ply\nformat ascii 1.0\nelement vertex 5\nproperty float x\n"
                 "property float y\nproperty float z\nelement face 1\n"
                 "property list uchar int vertex_indices\nend_header\n"
                 "0 0 0\n1 0 0\n1 1 0\n0 1 0\n0.5 1.5 0\n5 0 1 2 4 3\n")
    a, b = jply.read_ply(str(p)), tply.read_ply(str(p))
    assert b["faces"].shape == (3, 3)
    np.testing.assert_array_equal(b["faces"], a["faces"])
    np.testing.assert_array_equal(b["vertices"], a["vertices"])
