"""The port's ICO and ICNS writers (utils/image_write.py), its resampling
(utils/resample.py) and its ICNS reader (utils/image_read.py) against
PIL 12.1.0, which the JAX package's write_png and read_image go through.

ICO and ICNS files hold PNG entries (encode_png's, PIL's bytes): the port's
files are PIL's byte for byte, and the ground fixture's files are those
images.json records, whole and by each entry's IDAT stream
(chip_smoke.icon_entries, png_idat_stream).  resample.py's resize (BICUBIC) and
thumbnail (LANCZOS, reducing_gap=None) equal PIL's pixel for pixel, up
and down.  read_image of an ICNS gives what the reference's gives
(np.asarray of PIL's image, RGB entries garbled as PIL packs them), on
the port's files, PIL's and hand-built legacy ones (it32 run-length RGB
with and without its t8mk mask, is32 raw), and decode_icns gives the
entry PIL loads."""
import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.utils import (
    image, image_read, image_write, jpeg2000_write, resample)

from chip_smoke import icon_entries, png_idat_stream
from torch_write_util import KINDS, SIZES, linear_image, write_both


FIXTURES = Path(__file__).resolve().parent / "data" / "images"


def _same_icons(got: bytes, want: bytes):
    assert got == want


@pytest.mark.parametrize("tonemap", [True, False], ids=["tonemap", "linear"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES + ((300, 17), (260, 300)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_ico_matches_reference(tmp_path, size, kind, tonemap):
    got, want = write_both(tmp_path, "frame.ico",
                           linear_image(kind, *size), tonemap)
    _same_icons(got.read_bytes(), want.read_bytes())


@pytest.mark.parametrize("case", [("noise", (8, 8), True),
                                  ("gradient", (37, 23), False),
                                  ("few", (64, 48), True)],
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def test_icns_matches_reference(tmp_path, case):
    kind, size, tonemap = case
    got, want = write_both(tmp_path, "frame.icns",
                           linear_image(kind, *size), tonemap)
    _same_icons(got.read_bytes(), want.read_bytes())
    # both files read back as the reference reads them
    for p in (got, want):
        assert np.array_equal(image.read_image(str(p))[0],
                              jimage.read_image(str(p))[0])


def test_icon_records_are_pils(tmp_path):
    """images.json's ICO and ICNS records (chip_smoke.py phase 36 holds the
    port's files to them): PIL's files of the ground's 128x96 crop, whole
    and by each PNG entry's IDAT stream, and the port's files are those
    bytes."""
    name = "ground_1024x512_q90.webp"
    rec = json.loads((FIXTURES / "images.json").read_text())[name]
    w, h = rec["written_crop"]
    px = np.ascontiguousarray(np.asarray(Image.open(FIXTURES / name))[:h, :w])
    assert sorted(rec["pil_icon_files"]) == [".icns", ".ico"]
    for ext, r in rec["pil_icon_files"].items():
        path = tmp_path / f"fixture{ext}"
        Image.fromarray(px).save(path)
        pil = path.read_bytes()
        assert (len(pil), hashlib.sha256(pil).hexdigest()) == (r["bytes"],
                                                               r["sha256"])
        assert [hashlib.sha256(png_idat_stream(e)).hexdigest()
                for e in icon_entries(pil)[1]] == r["idat_streams"]
        assert image_write.encode(str(path), px) == pil


def test_hazard_ico_under_16_pixels(tmp_path):
    """An image under 16 pixels on a side gets an ICO of no entries, 6
    bytes, as PIL writes it; PIL cannot open it and neither does the
    port."""
    got, want = write_both(tmp_path, "small.ico",
                           linear_image("noise", 40, 15))
    assert got.read_bytes() == want.read_bytes() == b"\0\0\1\0\0\0"
    with pytest.raises(Exception):
        Image.open(want).load()
    with pytest.raises(ValueError):
        image.read_image(str(got))


@pytest.mark.parametrize("size", [(16, 16), (24, 24), (1, 1), (5, 9),
                                  (128, 128), (1024, 1024), (200, 40)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("src", [(37, 23), (64, 48), (1280, 720), (3, 200)],
                         ids=lambda s: f"from{s[0]}x{s[1]}")
def test_resample_matches_pil(src, size):
    rng = np.random.default_rng(src[0] * 7 + size[0])
    px = rng.integers(0, 256, (src[1], src[0], 3), np.uint8)
    im = Image.fromarray(px)
    assert np.array_equal(resample.resize(px, size), np.asarray(
        im.resize(size)))
    t = im.copy()
    t.thumbnail(size, Image.Resampling.LANCZOS, reducing_gap=None)
    assert np.array_equal(resample.thumbnail(px, size), np.asarray(t))
    assert np.array_equal(resample.resize(px, size, "lanczos"), np.asarray(
        im.resize(size, Image.Resampling.LANCZOS)))


def test_thumbnail_sizes_are_pils():
    """Image.thumbnail's aspect-preserving sizes: 1280x720 into each ICO
    square gives 16x9 ... 256x144."""
    got = [resample.thumbnail_size(1280, 720, (s, s))
           for s in image_write.ICO_SIZES]
    assert got == [(16, 9), (24, 14), (32, 18), (48, 27), (64, 36),
                   (128, 72), (256, 144)]
    for w, h in ((37, 23), (23, 37), (17, 300), (300, 299), (5, 5)):
        for s in (4, 16, 24, 33):
            im = Image.new("RGB", (w, h))
            im.thumbnail((s, s), reducing_gap=None)
            fit = resample.thumbnail_size(w, h, (s, s))
            assert (fit or (w, h)) == im.size


# ---------------------------------------------------------------- reading


def _icns(*entries):
    body = b"".join(k + struct.pack(">I", 8 + len(d)) + d for k, d in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def _runs(plane: bytes) -> bytes:
    """The legacy ICNS run-length code of one channel: runs of 3 to 130
    equal bytes as (count + 125, byte), the rest as literals of up to
    128 bytes (count - 1, bytes)."""
    out, lit, i = bytearray(), bytearray(), 0
    while i < len(plane):
        j = i
        while j < len(plane) and plane[j] == plane[i] and j - i < 130:
            j += 1
        if j - i >= 3:
            for k in range(0, len(lit), 128):
                out += bytes([len(lit[k:k + 128]) - 1]) + lit[k:k + 128]
            lit = bytearray()
            out += bytes([j - i + 125, plane[i]])
            i = j
        else:
            lit.append(plane[i])
            i += 1
    for k in range(0, len(lit), 128):
        out += bytes([len(lit[k:k + 128]) - 1]) + lit[k:k + 128]
    return bytes(out)


def _legacy_rgb(side, seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (side, side, 3), np.uint8)
    px[side // 3:, :side // 2] = [10, 200, 30]          # long runs
    return px


@pytest.mark.parametrize("mask", [True, False], ids=["t8mk", "nomask"])
def test_icns_legacy_it32(tmp_path, mask):
    """A hand-built it32 (4 zero bytes, then R, G, B in runs) with or
    without its t8mk mask: the port reads what PIL reads (with the mask,
    RGBA; without, RGB, which the reference's np.asarray garbles)."""
    px = _legacy_rgb(128, 1)
    rle = b"".join(_runs(px[..., c].tobytes()) for c in range(3))
    alpha = np.random.default_rng(2).integers(0, 256, (128, 128), np.uint8)
    entries = [(b"it32", b"\0\0\0\0" + rle)]
    if mask:
        entries.append((b"t8mk", alpha.tobytes()))
    data = _icns(*entries)
    path = tmp_path / "legacy.icns"
    path.write_bytes(data)
    im = Image.open(path)
    im.load()
    got, mode = image_read.decode_icns(data)
    assert mode == im.mode == ("RGBA" if mask else "RGB")
    assert np.array_equal(got, np.asarray(im))
    assert np.array_equal(got[..., :3], px)
    assert np.array_equal(image_read.icns_array(data),
                          np.asarray(Image.open(path)))
    assert np.array_equal(image.read_image(str(path))[0],
                          jimage.read_image(str(path))[0])


def test_icns_legacy_raw(tmp_path):
    """A raw ih32 (3 x 48 x 48 bytes, RGB interleaved) without a mask:
    read as PIL reads it, and as the reference's np.asarray garbles it."""
    px = _legacy_rgb(48, 5)
    data = _icns((b"ih32", px.tobytes()))
    path = tmp_path / "raw.icns"
    path.write_bytes(data)
    im = Image.open(path)
    im.load()
    assert np.array_equal(image_read.decode_icns(data)[0], np.asarray(im))
    assert np.array_equal(np.asarray(im), px)
    assert np.array_equal(image_read.icns_array(data),
                          np.asarray(Image.open(path)))


def test_icns_legacy_raw_and_best_size(tmp_path):
    """Raw is32 (3 x 256 bytes) beside a larger il32 in runs with l8mk:
    the 32x32 one is loaded, as PIL loads the largest."""
    small = _legacy_rgb(16, 3)
    big = _legacy_rgb(32, 4)
    alpha = np.full((32, 32), 200, np.uint8)
    data = _icns((b"is32", small.tobytes()),
                 (b"il32", b"".join(_runs(big[..., c].tobytes())
                                    for c in range(3))),
                 (b"l8mk", alpha.tobytes()))
    path = tmp_path / "two.icns"
    path.write_bytes(data)
    want = np.asarray(Image.open(path))
    assert np.array_equal(image_read.icns_array(data), want)
    assert np.array_equal(want[..., :3], big)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_icns_png_entry_modes(tmp_path, mode):
    """A PNG entry of each mode: RGBA read as stored, RGB as the reference
    garbles it, others refused with PIL's words."""
    rng = np.random.default_rng(6)
    im = Image.fromarray(rng.integers(0, 256, (64, 64, 4), np.uint8),
                         "RGBA").convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG")
    data = _icns((b"icp6", buf.getvalue()))
    path = tmp_path / "m.icns"
    path.write_bytes(data)
    try:
        want = np.asarray(Image.open(path))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            image_read.icns_array(data)
        return
    assert np.array_equal(image_read.icns_array(data), want)
    assert mode in ("RGB", "RGBA")


def test_icns_jpeg2000_entry(tmp_path):
    """A JP2 entry (the port's lossless one) is made RGBA, as PIL does."""
    px = image.to_8bit(linear_image("gradient", 32, 32))
    data = _icns((b"ic05", b""), (b"ic12",
                                  jpeg2000_write.encode_jp2(px)))
    path = tmp_path / "j.icns"
    path.write_bytes(data)
    want = np.asarray(Image.open(path))
    got = image_read.icns_array(data)
    assert got.shape == (32, 32, 4)
    assert np.array_equal(got, want)
    assert np.array_equal(got[..., :3], px)
