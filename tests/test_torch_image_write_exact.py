"""The port's EPS, PDF, GIF and JPEG 2000 writers (utils/image_write.py,
utils/gif_write.py, utils/jpeg2000_write.py) against the JAX package's
write_png, which saves through PIL 12.1.0: for every extension of these
formats, numpy-seeded gradient, noise, constant and few-colour images at
8x8, 37x23 and 64x48, tonemapped and linear, give the same bytes (PDF
under a fixed time.gmtime, which both stamp).  Also: GIF's palette and
indices equal PIL's convert("P", ADAPTIVE) (median cut) where the colours
exceed the hash's 65,536 and where they do not; the number of JPEG 2000
resolutions is PIL's at sizes from 1 to 300; every JPEG 2000 file the
port writes reads back through the port's own decoder equal to its
8-bit input (lossless); imgtool convert writes the JAX imgtool's bytes;
and images.json's hashes of PIL's files of the ground fixture's 128x96
crop (which chip_smoke.py's phase 36 holds the port's files to on a
machine without PIL) are PIL's and the port's."""
import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.cli import imgtool as jimgtool
from acceleratedvolrenderer_tpu_torch.cli import imgtool as timgtool
from acceleratedvolrenderer_tpu_torch.utils import (
    gif_write, image, image_write, jpeg2000, jpeg2000_write)

from torch_write_util import (KINDS, SIZES, linear_image, pdf_clock,
                              write_both)

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "images"
EXACT = sorted(e for e, f in image_write.EXTENSIONS.items()
               if f in ("EPS", "PDF", "GIF", "JPEG2000"))


def test_formats_left_to_write():
    assert image_write.NOT_YET == ("AVIF",)
    assert len(EXACT) == 10


@pytest.mark.parametrize("tonemap", [True, False], ids=["tonemap", "linear"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("ext", EXACT)
def test_write_png_matches_reference(tmp_path, ext, size, kind, tonemap):
    got, want = write_both(tmp_path, f"frame{ext}",
                           linear_image(kind, *size), tonemap)
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("name", ["a.pdf", "f (x)\\y.pdf", "café.pdf",
                                  "résumé 中.PDF", "x.y.pdf"])
def test_pdf_title_matches_reference(tmp_path, name):
    """The PDF's title is the file's stem, UTF-16 with PdfParser's escapes
    of backslashes and parentheses."""
    got, want = write_both(tmp_path, name, linear_image("noise", 9, 7))
    assert got.read_bytes() == want.read_bytes()


def test_pdf_stamped_now(tmp_path):
    """Without a fixed clock, the dates are the current UTC second's."""
    import time

    before = time.strftime("%Y%m%d%H%M%S", time.gmtime())
    data = image_write.encode("x.pdf", np.zeros((4, 4, 3), np.uint8))
    after = time.strftime("%Y%m%d%H%M%S", time.gmtime())
    stamp = data.split(b"/CreationDate (D:")[1][:14].decode()
    assert before <= stamp <= after
    assert f"/ModDate (D:{stamp}Z)".encode() in data


def _pil_palette(px):
    im = Image.fromarray(px).convert("P", palette=Image.Palette.ADAPTIVE)
    return (np.array(im.getpalette(None), np.uint8).reshape(-1, 3),
            np.asarray(im))


@pytest.mark.parametrize("case", ["few", "noise_8x8", "noise_64x48",
                                  "smooth_over_65536", "noise_over_65536"])
def test_gif_quantize_matches_pil(case):
    """Quant.c's median cut: the palette and the indices, below and above
    the hash's 65,536 colours (where the colours are scaled)."""
    rng = np.random.default_rng(3)
    if case == "few":
        px = (255 * linear_image("few", 37, 23)).astype(np.uint8)
    elif case.startswith("noise_") and "x" in case:
        w, h = map(int, case.split("_")[1].split("x"))
        px = rng.integers(0, 256, (h, w, 3), np.uint8)
    else:
        h, w = 300, 260
        yy, xx = np.mgrid[0:h, 0:w]
        sigma = 3 if case.startswith("smooth") else 60
        px = np.clip(np.stack([xx * 0.9 + yy * 0.2, yy * 0.8, (xx + yy) / 2],
                              -1) + rng.normal(0, sigma, (h, w, 3)), 0,
                     255).astype(np.uint8)
        assert len(np.unique(px.reshape(-1, 3), axis=0)) > 65536
    pal, idx = gif_write.quantize(px)
    want_pal, want_idx = _pil_palette(px)
    assert np.array_equal(pal, want_pal)
    assert np.array_equal(idx, want_idx)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "GIF")
    assert gif_write.encode_gif(px) == buf.getvalue()


def test_gif_large_frame_table_resets(tmp_path):
    """A 600x480 frame (over 512 x 512 pixels: no palette optimization;
    LZW clear codes when the table fills) is PIL's file."""
    rng = np.random.default_rng(5)
    px = rng.integers(0, 256, (480, 600, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "GIF")
    codes, _ = gif_write.lzw_codes(gif_write._interlaced(
        gif_write.quantize(px)[1]).tobytes())
    assert (codes == 256).sum() > 1
    assert gif_write.encode_gif(px) == buf.getvalue()


def test_jpeg2000_resolutions_are_pils(tmp_path):
    """PIL's encoder lowers the number of resolutions until the smaller
    side holds 2 ** (resolutions - 1) samples: the COD's decomposition
    levels at sizes around each power of two."""
    sizes = [(1, 1), (2, 3), (3, 2), (4, 9), (7, 8), (15, 100), (16, 16),
             (31, 40), (32, 33), (63, 64), (200, 3), (300, 257)]
    for w, h in sizes:
        path = tmp_path / "s.j2k"
        Image.fromarray(np.zeros((h, w, 3), np.uint8)).save(path)
        data = path.read_bytes()
        levels = data[data.find(b"\xff\x52") + 9]
        assert jpeg2000_write.resolutions(w, h) == levels + 1, (w, h)


@pytest.mark.parametrize("ext", [".jp2", ".j2k", ".jpx"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", SIZES + ((1, 1), (5, 3), (130, 70)),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_jpeg2000_round_trip(ext, size, kind):
    """The port's file read back by the port's own decoder is its input."""
    px = image.to_8bit(linear_image(kind, *size))
    data = image_write.encode(f"x{ext}", px)
    dec = jpeg2000.decode_j2k if ext == ".j2k" else jpeg2000.decode_jp2
    assert data[:4] == (jpeg2000.J2K_MAGIC if ext == ".j2k"
                        else jpeg2000.JP2_MAGIC[:4])
    assert np.array_equal(dec(data), px)


@pytest.mark.parametrize("ext", [".gif", ".jp2", ".j2k", ".eps", ".pdf"])
def test_imgtool_convert_matches_reference(tmp_path, capsys, ext):
    img = linear_image("gradient", 37, 23) * 1.5
    img[3:9, 5:30] = linear_image("noise", 25, 6)
    src = tmp_path / "in.exr"
    image.write_exr(str(src), img)
    outs = []
    for tag, main in (("t", timgtool.main), ("j", jimgtool.main)):
        (tmp_path / tag).mkdir()
        out = tmp_path / tag / f"out{ext}"
        with pdf_clock():
            assert main(["convert", str(src), str(out), "--tonemap"]) == 0
        outs.append(out.read_bytes())
    capsys.readouterr()
    assert outs[0] == outs[1]


def _ground_crop():
    name = "ground_1024x512_q90.webp"
    rec = json.loads((FIXTURES / "images.json").read_text())[name]
    w, h = rec["written_crop"]
    return np.asarray(Image.open(FIXTURES / name))[:h, :w], rec


def test_fixture_exact_hashes_are_pils(tmp_path):
    """images.json's hashes of PIL's EPS, PS, PDF (at its recorded clock),
    GIF and JPEG 2000 files of the ground crop are PIL's and the port's."""
    import time
    from unittest import mock

    px, rec = _ground_crop()
    hashes = rec["sha256_of_pil_files_exact"]
    assert sorted(hashes) == EXACT
    clock = mock.patch("time.gmtime", return_value=time.struct_time(
        tuple(rec["pdf_gmtime"])))
    for ext, digest in hashes.items():
        path = tmp_path / f"fixture{ext}"
        with clock:
            Image.fromarray(px).save(path)
            port = image_write.encode(str(path), px)
        assert hashlib.sha256(path.read_bytes()).hexdigest() == digest, ext
        assert hashlib.sha256(port).hexdigest() == digest, ext
