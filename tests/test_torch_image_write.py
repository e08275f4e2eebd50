"""The port's write_png (utils/image.py, utils/image_write.py) against the
JAX package's, which saves through PIL and so picks the format by the
path's extension: for every extension the port writes (but those
test_torch_image_write_*.py hold), at 37x23 and 64x48
(odd sizes: JPEG's edge MCUs), of a gradient that leaves [0, 1], noise
and a constant, tonemapped and not, the two files are the same bytes
(PNG and APNG too: encode_png takes PIL's filters and deflate settings,
and the tests run where the zlib is PIL's).  Every
other extension PIL knows, and unknown or missing ones, raise what the
JAX package raises (type and words), except the formats PIL writes and
the port does not yet, which raise ValueError naming the format.

imgtool's convert --tonemap and falsecolor write the JAX imgtool's files;
the hashes of PIL's files of the committed ground fixture (cropped to
128x96) are the ones images.json records, which chip_smoke.py's phase 33
holds the port's files to on a machine without PIL; the reference's two
hazards around write_png's .qoi and .pfm (item 3 of ROADMAP's list) stay
as they are; and no file of the port or chip_smoke.py imports PIL.

encode_png equals PIL's Image.save byte for byte on L, LA, RGB, RGBA and
16-bit gray images, noise (stored blocks), zeros, a ramp whose rows tie
Up, Sub and Paeth, 1x1, 3x2 and 37x23 images and a 3x16400 strip (IDAT
cut at 4 * width); images.json's PNG records (chip_smoke.py phases 33
and 36) are PIL's files and their IDAT streams'; a .dib write_png writes
reads back through read_image as the reference reads it.
"""
import hashlib
import io
import json
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.cli import imgtool as jimgtool
from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.cli import imgtool as timgtool
from acceleratedvolrenderer_tpu_torch.utils import image as timage
from acceleratedvolrenderer_tpu_torch.utils import image_write

from chip_smoke import png_idat_stream

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "images"

# formats whose files tests/test_torch_image_write_*.py hold to PIL's
HELD_ELSEWHERE = ("EPS", "PDF", "GIF", "JPEG2000", "ICO", "ICNS")
WRITTEN = sorted(e for e, f in image_write.EXTENSIONS.items()
                 if f in image_write.WRITERS and f not in HELD_ELSEWHERE)
NOT_YET = sorted(e for e, f in image_write.EXTENSIONS.items()
                 if f in image_write.NOT_YET)
RAISING = sorted(e for e, f in image_write.EXTENSIONS.items()
                 if f not in image_write.WRITERS
                 and f not in image_write.NOT_YET)


def _image(kind, w, h):
    """A linear float image (h, w, 3)."""
    if kind == "gradient":
        yy, xx = np.mgrid[0:h, 0:w]
        return np.stack([xx / (w - 1) * 1.3 - 0.1, yy / (h - 1),
                         (xx + yy) / (w + h - 2) * 0.5], -1).astype(np.float32)
    if kind == "noise":
        return np.random.default_rng(w * h).uniform(
            0, 1, (h, w, 3)).astype(np.float32)
    return np.full((h, w, 3), [0.7, 0.05, 0.3], np.float32)


def _both(tmp_path, ext, img, tonemap=True):
    """The port's and the JAX package's files, of one name in two folders."""
    paths = []
    for tag, mod in (("t", timage), ("j", jimage)):
        (tmp_path / tag).mkdir(exist_ok=True)
        p = tmp_path / tag / f"frame{ext}"
        mod.write_png(str(p), img, tonemap=tonemap)
        paths.append(p)
    return paths


def test_extension_table_is_pils():
    """The port's table names every extension PIL registers, each with
    PIL's format."""
    Image.init()
    assert image_write.EXTENSIONS == Image.registered_extensions()


@pytest.mark.parametrize("tonemap", [True, False], ids=["tonemap", "linear"])
@pytest.mark.parametrize("kind", ["gradient", "noise", "constant"])
@pytest.mark.parametrize("size", [(37, 23), (64, 48)], ids=["37x23", "64x48"])
@pytest.mark.parametrize("ext", WRITTEN)
def test_write_png_matches_reference(tmp_path, ext, size, kind, tonemap):
    got, want = _both(tmp_path, ext, _image(kind, *size), tonemap)
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("ext", [".JPG", ".Tif", ".PCX"])
def test_extension_case_ignored(tmp_path, ext):
    got, want = _both(tmp_path, ext, _image("noise", 37, 23))
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("ext", NOT_YET)
def test_formats_not_yet_written_raise(tmp_path, ext):
    """PIL writes these; the port raises ValueError naming the format and
    writes nothing."""
    path = tmp_path / f"frame{ext}"
    jimage.write_png(str(tmp_path / f"j{ext}"), _image("noise", 8, 8))
    fmt = image_write.EXTENSIONS[ext]
    with pytest.raises(ValueError, match=f"writing {fmt} images is not "
                       "ported yet"):
        timage.write_png(str(path), _image("noise", 8, 8))
    assert not path.exists()


@pytest.mark.parametrize("name", [f"frame{e}" for e in RAISING] + [
    "frame.xyz", "frame", ".jpg", "frame.jpg.", "frame.exr2"])
def test_refused_extensions_raise_as_reference(tmp_path, name):
    """Where PIL refuses (RGB not writable, no handler, a read-only format,
    an unknown or missing extension), the port raises the same exception
    with the same words, and leaves no file."""
    errors = []
    for tag, mod in (("t", timage), ("j", jimage)):
        (tmp_path / tag).mkdir()
        with pytest.raises(Exception) as e:
            mod.write_png(str(tmp_path / tag / name), _image("noise", 8, 8))
        errors.append((type(e.value), str(e.value)))
        assert list((tmp_path / tag).iterdir()) == []
    assert errors[0] == errors[1]


def _exr(path, img):
    timage.write_exr(str(path), img)
    return str(path)


@pytest.mark.parametrize("ext", [".jpg", ".bmp", ".tif"])
@pytest.mark.parametrize("cmd", ["convert", "falsecolor"])
def test_imgtool_outputs_match_reference(tmp_path, capsys, cmd, ext):
    img = _image("gradient", 37, 23) * 1.5
    img[3:9, 5:30] = _image("noise", 25, 6)
    src = _exr(tmp_path / "in.exr", img)
    outs = []
    for tag, main in (("t", timgtool.main), ("j", jimgtool.main)):
        (tmp_path / tag).mkdir()
        out = tmp_path / tag / f"out{ext}"
        argv = [cmd, src, str(out)] + (["--tonemap"] if cmd == "convert"
                                       else [])
        assert main(argv) == 0
        outs.append(out.read_bytes())
    capsys.readouterr()
    assert outs[0] == outs[1]


# the files phase 33 of chip_smoke.py holds to images.json's hashes
FIXTURE_EXTS = (".bmp", ".dds", ".im", ".jpg", ".pcx", ".ppm", ".qoi",
                ".sgi", ".tga", ".tif")


def test_fixture_file_hashes_are_pils(tmp_path):
    """images.json's hashes are those of PIL's files (named fixture.<ext>:
    SGI and IM embed the name) of the ground fixture's first 128x96
    pixels, and the port's files have them too (chip_smoke.py phase 33
    checks the port's on the card's machine, which has no PIL)."""
    name = "ground_1024x512_q90.webp"
    rec = json.loads((FIXTURES / "images.json").read_text())[name]
    w, h = rec["written_crop"]
    assert (w, h) == (128, 96)
    px = np.asarray(Image.open(FIXTURES / name))[:h, :w]
    hashes = rec["sha256_of_pil_files"]
    assert tuple(sorted(hashes)) == FIXTURE_EXTS
    for ext, digest in hashes.items():
        path = tmp_path / f"fixture{ext}"
        Image.fromarray(px).save(path)
        assert hashlib.sha256(path.read_bytes()).hexdigest() == digest, ext
        port = image_write.encode(str(path), px)
        assert hashlib.sha256(port).hexdigest() == digest, ext


def test_hazard_qoi_read_back_linearised(tmp_path):
    """write_png's .qoi is PIL's QOI (index starting empty); imgtool's
    loader reads a .qoi through read_qoi (index starting at opaque black)
    and linearises it, where a PNG of the same frame is read as stored.
    The port does both as the reference does."""
    img = _image("gradient", 37, 23)
    got, want = _both(tmp_path, ".qoi", img)
    assert got.read_bytes() == want.read_bytes()
    t = timgtool._load(str(got))[0]
    assert np.array_equal(t, jimgtool._load(str(want))[0])
    png = _both(tmp_path, ".png", img)[0]
    assert not np.allclose(t, timgtool._load(str(png))[0], atol=1e-3)


def test_hazard_pfm_is_p6(tmp_path):
    """write_png's .pfm holds P6 bytes (PIL writes RGB as P6 whatever the
    netpbm extension), which imgtool's loader, reading .pfm as PFM,
    refuses in both packages."""
    got, want = _both(tmp_path, ".pfm", _image("noise", 37, 23))
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes()[:3] == b"P6\n"
    for load, p in ((timgtool._load, got), (jimgtool._load, want)):
        with pytest.raises(ValueError, match="not a PFM file"):
            load(str(p))


_PIL_IMPORT = re.compile(r"^\s*(?:import|from)\s+PIL\b", re.M)


def test_no_port_file_imports_pil():
    files = sorted((ROOT / "acceleratedvolrenderer_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = [str(f.relative_to(ROOT)) for f in files
           if _PIL_IMPORT.search(f.read_text())]
    assert bad == []
    assert _PIL_IMPORT.search("    from PIL import Image")


def _smooth(h, w, c, seed=0):
    """Sinusoids with a little noise, uint8 (h, w, c): rows that pick
    different filters."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.sin(xx / 17.0) * 60 + np.cos(yy / 11.0) * 50 + 128
    a = np.stack([base + 10 * k for k in range(c)], -1)
    a = a + np.random.default_rng(seed).integers(0, 6, (h, w, c))
    return np.clip(a, 0, 255).astype(np.uint8)


PNG_CASES = {
    "L": lambda: _smooth(60, 70, 1)[..., 0],
    "LA": lambda: _smooth(40, 33, 2, 1),
    "RGB": lambda: _smooth(48, 64, 3, 2),
    "RGBA": lambda: _smooth(50, 61, 4, 3),
    "gray16": lambda: (_smooth(40, 50, 1, 4)[..., 0].astype(np.uint16) * 257
                       + np.random.default_rng(5).integers(
                           0, 50, (40, 50))).astype(np.uint16),
    "noise": lambda: np.random.default_rng(6).integers(
        0, 256, (90, 120, 3), np.uint8),
    "zero": lambda: np.zeros((30, 40, 3), np.uint8),
    "ramp_ties": lambda: np.tile(np.arange(64, dtype=np.uint8)[None, :, None],
                                 (20, 1, 3)),
    "1x1": lambda: np.array([[[1, 2, 3]]], np.uint8),
    "3x2": lambda: _smooth(2, 3, 3, 7),
    "37x23": lambda: _smooth(23, 37, 3, 8),
    "strip_3x16400": lambda: _smooth(3, 16400, 3, 9),
}


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_encode_png_is_pils(case):
    """encode_png's file is PIL's Image.save's, byte for byte (the ramp's
    rows cost Up, Sub and Paeth alike: PIL keeps the first that is
    strictly better than None, tried in that order)."""
    px = PNG_CASES[case]()
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "PNG")
    assert timage.encode_png(px) == buf.getvalue()


def test_png_filter_order_and_chunks():
    """The filters PIL chooses (never Average) and its IDAT cut: the strip's
    stream in chunks of 4 * width bytes."""
    px = PNG_CASES["strip_3x16400"]()
    data = timage.encode_png(px)
    sizes = []
    i = 8
    while i < len(data):
        n, kind = struct.unpack_from(">I4s", data, i)
        if kind == b"IDAT":
            sizes.append(n)
        i += 12 + n
    assert sizes[:-1] == [4 * 16400] * (len(sizes) - 1) and len(sizes) > 1
    stream = png_idat_stream(timage.encode_png(_smooth(200, 300, 3)))
    types = set(stream[::1 + 300 * 3])
    assert types <= {0, 1, 2, 4} and len(types) > 1


def test_png_records_are_pils(tmp_path):
    """images.json's PNG records (chip_smoke.py phases 33 and 36 hold the
    port's files to them on the card's host, which has no PIL): PIL's
    files of the ground's crops, the SHA-256 of zlib.decompress of their
    IDAT chunks, and the port's files are the same bytes; the recorded
    zlib is PIL's and the one the tests run with."""
    from PIL import features

    name = "ground_1024x512_q90.webp"
    rec = json.loads((FIXTURES / "images.json").read_text())[name]
    assert rec["pil_zlib"] == features.version("zlib") == \
        zlib.ZLIB_RUNTIME_VERSION
    ground = np.asarray(Image.open(FIXTURES / name))
    assert sorted(rec["pil_png_files"]) == ["1024x512", "128x96", "37x23"]
    for size, r in rec["pil_png_files"].items():
        w, h = map(int, size.split("x"))
        px = np.ascontiguousarray(ground[:h, :w])
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "PNG")
        pil = buf.getvalue()
        assert (len(pil), hashlib.sha256(pil).hexdigest()) == (
            r["bytes"], r["sha256"])
        assert hashlib.sha256(png_idat_stream(pil)).hexdigest() == r[
            "sha256_of_idat_stream"]
        assert timage.encode_png(px) == pil


@pytest.mark.parametrize("kind", ["gradient", "noise"])
def test_dib_read_back_as_reference(tmp_path, kind):
    """write_png's .dib (PIL's DIB: a BMP without its file header) reads
    back through read_image as the reference's read_image reads it."""
    got, want = _both(tmp_path, ".dib", _image(kind, 37, 23))
    assert got.read_bytes() == want.read_bytes()
    lin = timage.read_image(str(got))[0]
    assert np.array_equal(lin, jimage.read_image(str(want))[0])
    assert np.array_equal(timage._decode_image(str(got), got.read_bytes()),
                          np.asarray(Image.open(want)))
