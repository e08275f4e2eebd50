"""The port's write_png (utils/image.py, utils/image_write.py) against the
JAX package's, which saves through PIL and so picks the format by the
path's extension: for every extension the port writes (but those
test_torch_image_write_*.py hold), at 37x23 and 64x48
(odd sizes: JPEG's edge MCUs), of a gradient that leaves [0, 1], noise
and a constant, tonemapped and not, the two files are the same bytes
(PNG: the same pixels, PIL's filters and zlib stream differ).  Every
other extension PIL knows, and unknown or missing ones, raise what the
JAX package raises (type and words), except the formats PIL writes and
the port does not yet, which raise ValueError naming the format.

imgtool's convert --tonemap and falsecolor write the JAX imgtool's files;
the hashes of PIL's files of the committed ground fixture (cropped to
128x96) are the ones images.json records, which chip_smoke.py's phase 33
holds the port's files to on a machine without PIL; the reference's two
hazards around write_png's .qoi and .pfm (item 3 of ROADMAP's list) stay
as they are; and no file of the port or chip_smoke.py imports PIL.
"""
import hashlib
import json
import re
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.cli import imgtool as jimgtool
from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.cli import imgtool as timgtool
from acceleratedvolrenderer_tpu_torch.utils import image as timage
from acceleratedvolrenderer_tpu_torch.utils import image_write

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
    if image_write.EXTENSIONS[ext] == "PNG":
        assert np.array_equal(timage.decode_png(got.read_bytes()),
                              np.asarray(Image.open(want)))
    else:
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
