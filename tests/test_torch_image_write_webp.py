"""The port's WebP writer (utils/webp_write.py over native/vp8_enc.cpp)
against PIL 12.1.0's Image.save (libwebp 1.6.0, lossy, quality 80, method
4), on the committed fixtures' samples (the ground's first 128x96 and
37x23 pixels and the whole 1024x512, the sky's first 1280x720 and the
whole 2048x1024), uniform noise, a 16x16, a 1x1, a flat 50x40 and
write_png's 8-bit images of the gradient, noise and constant kinds at
37x23 and 64x48.

On each image the port's file is PIL's, byte for byte, and so meets the
looser rules a file that is not would be held to: PIL opens it and
utils/webp.py's decode_webp gives PIL's decode of it; its RIFF layout and
VP8 header fields are PIL's (key frame, profile, size, colour space and
clamping, filter type, sharpness, partitions, no loop-filter deltas,
segments on or off, absolute segment values); its base quantizer is
PIL's, each segment's quantizer within 1 and filter level within 2; its
RGB PSNR is no worse than PIL's file's minus 0.5 dB; on images of 64x64
and up its size is within 10% of PIL's; and two encodes give the same
bytes.  images.json's records of PIL's WebP files of the fixtures
(chip_smoke.py phase 36 (b) holds the port's files to them on the card's
machine, which has no PIL) are PIL's; write_png, image_write.encode and
imgtool write .webp as the JAX package's PIL does; and without g++ the
writer raises, naming it, as there is no fallback encoder.
"""
import hashlib
import io
import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.cli import imgtool as jimgtool
from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch import native
from acceleratedvolrenderer_tpu_torch.cli import imgtool as timgtool
from acceleratedvolrenderer_tpu_torch.utils import image as timage
from acceleratedvolrenderer_tpu_torch.utils import image_write, webp_write
from acceleratedvolrenderer_tpu_torch.utils.webp import decode_webp

from chip_smoke import psnr_rgb
from torch_write_util import linear_image

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "images"
GROUND = "ground_1024x512_q90.webp"
SKY = "sky_2048x1024_q90.webp"


@lru_cache(maxsize=None)
def _fixture(name):
    return np.asarray(Image.open(FIXTURES / name).convert("RGB"))


def _crop(name, w, h):
    return lambda: np.ascontiguousarray(_fixture(name)[:h, :w])


def _kind(kind, w, h):
    return lambda: timage.to_8bit(linear_image(kind, w, h))


IMAGES = {
    "ground_128x96": _crop(GROUND, 128, 96),
    "ground_1024x512": _crop(GROUND, 1024, 512),
    "sky_2048x1024": _crop(SKY, 2048, 1024),
    "sky_1280x720": _crop(SKY, 1280, 720),
    "noise_96x64": lambda: (np.random.default_rng(0).random((64, 96, 3))
                            * 255).astype(np.uint8),
    "ground_37x23": _crop(GROUND, 37, 23),
    "noise_16x16": lambda: np.random.default_rng(16).integers(
        0, 256, (16, 16, 3)).astype(np.uint8),
    "pixel_1x1": lambda: np.array([[[200, 30, 90]]], np.uint8),
    "flat_50x40": lambda: np.full((40, 50, 3), [90, 140, 30], np.uint8),
}
for _k in ("gradient", "noise", "constant"):
    for _w, _h in ((37, 23), (64, 48)):
        IMAGES[f"{_k}_{_w}x{_h}"] = _kind(_k, _w, _h)
NAMES = sorted(IMAGES)
# where the port's bytes equal PIL's (every image here)
BYTES_EQUAL = NAMES


def _pil_file(px):
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "WEBP")
    return buf.getvalue()


@lru_cache(maxsize=None)
def _files(name):
    """(source px, the port's file, PIL's file)."""
    px = IMAGES[name]()
    return px, webp_write.encode_webp(px), _pil_file(px)


def _decode_pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("name", BYTES_EQUAL)
def test_bytes_are_pils(name):
    _, ours, pils = _files(name)
    assert ours == pils


@pytest.mark.parametrize("name", NAMES)
def test_pil_opens_and_decode_webp_agrees(name):
    """PIL reads the port's file, and the port's decoder gives PIL's
    samples of it (which is why it stands in for PIL on the card)."""
    px, ours, _ = _files(name)
    im = Image.open(io.BytesIO(ours))
    assert im.format == "WEBP" and im.size == px.shape[1::-1]
    assert np.array_equal(decode_webp(ours), _decode_pil(ours))


@pytest.mark.parametrize("name", NAMES)
def test_header_and_quantizers_within_rule(name):
    px, ours, pils = _files(name)
    got, want = (webp_write.header_fields(d) for d in (ours, pils))
    assert ours[:4] == b"RIFF" and ours[8:16] == b"WEBPVP8 "
    assert got["file_size"] == len(ours) == got["riff_size"] + 8
    assert got["chunk_size"] == len(ours) - 20
    for key in ("key_frame", "profile", "show", "start_code", "width",
                "height", "colorspace", "clamping", "filter_type",
                "sharpness", "partitions", "lf_deltas", "segments",
                "absolute", "base_quant"):
        assert got[key] == want[key], key
    assert (got["width"], got["height"]) == (px.shape[1], px.shape[0])
    assert (got["profile"], got["filter_type"], got["partitions"],
            got["lf_deltas"]) == (0, "normal", 1, 0)
    if want["segments"]:
        pairs = zip(sorted(zip(got["quant"], got["level"])),
                    sorted(zip(want["quant"], want["level"])))
        for (q, lvl), (wq, wlvl) in pairs:
            assert abs(q - wq) <= 1 and abs(lvl - wlvl) <= 2
    else:
        assert abs(got["filter_level"] - want["filter_level"]) <= 2


@pytest.mark.parametrize("name", NAMES)
def test_quality_and_size_within_rule(name):
    px, ours, pils = _files(name)
    want = psnr_rgb(_decode_pil(pils), px)
    if np.isfinite(want):
        assert psnr_rgb(_decode_pil(ours), px) >= want - 0.5
    if px.shape[0] >= 64 and px.shape[1] >= 64:
        assert 0.9 * len(pils) <= len(ours) <= 1.1 * len(pils)


@pytest.mark.parametrize("name", NAMES)
def test_two_encodes_same_bytes(name):
    px, ours, _ = _files(name)
    assert webp_write.encode_webp(px.copy()) == ours


def test_fixture_records_are_pils():
    """images.json's pil_webp_files (phase 36 (b)'s oracle) are PIL's
    files of the fixtures' top-left crops, and the port's files are
    those bytes."""
    records = json.loads((FIXTURES / "images.json").read_text())
    seen = []
    for name in (GROUND, SKY):
        for size, rec in records[name]["pil_webp_files"].items():
            w, h = map(int, size.split("x"))
            px, ours, pils = _files(f"{name.split('_')[0]}_{size}")
            assert px.shape == (h, w, 3)
            assert rec["bytes"] == len(pils)
            assert rec["sha256"] == hashlib.sha256(pils).hexdigest()
            assert rec["psnr_rgb"] == pytest.approx(
                psnr_rgb(_decode_pil(pils), px), abs=1e-9)
            assert rec["header"] == webp_write.header_fields(pils)
            assert hashlib.sha256(ours).hexdigest() == rec["sha256"]
            seen.append((name, size))
    assert len(seen) == 5


@pytest.mark.parametrize("tonemap", [True, False], ids=["tonemap", "linear"])
def test_write_png_and_encode_write_reference_files(tmp_path, tonemap):
    img = linear_image("gradient", 41, 29) * 1.4
    files = []
    for tag, mod in (("t", timage), ("j", jimage)):
        (tmp_path / tag).mkdir()
        path = tmp_path / tag / "frame.WebP"
        mod.write_png(str(path), img, tonemap=tonemap)
        files.append(path.read_bytes())
    assert files[0] == files[1]
    px = timage.to_8bit(img, tonemap)
    assert image_write.encode("x.webp", px) == files[0]


@pytest.mark.parametrize("cmd", ["convert", "falsecolor"])
def test_imgtool_writes_reference_webp(tmp_path, capsys, cmd):
    img = linear_image("gradient", 37, 23) * 1.5
    img[3:9, 5:30] = linear_image("noise", 25, 6)
    src = tmp_path / "in.exr"
    timage.write_exr(str(src), img)
    outs = []
    for tag, main in (("t", timgtool.main), ("j", jimgtool.main)):
        (tmp_path / tag).mkdir()
        out = tmp_path / tag / "out.webp"
        argv = [cmd, str(src), str(out)] + (["--tonemap"] if cmd == "convert"
                                            else [])
        assert main(argv) == 0
        outs.append(out.read_bytes())
    capsys.readouterr()
    assert outs[0] == outs[1]


def test_only_avif_left_to_port(tmp_path):
    assert image_write.NOT_YET == ("AVIF",)
    assert "WEBP" in image_write.WRITERS
    for ext in (".avif", ".avifs"):
        with pytest.raises(ValueError, match="writing AVIF images is not "
                           "ported yet"):
            timage.write_png(str(tmp_path / f"x{ext}"),
                             linear_image("noise", 8, 8))


def test_writer_raises_without_compiler(monkeypatch, tmp_path):
    """No fallback encoder: where g++ is missing, writing .webp raises the
    build's error, which names g++."""
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError(2, "No such file or directory", "g++")

    monkeypatch.setattr(native, "_vp8_lib", None)
    monkeypatch.setattr(native, "VP8_LIB_PATH", tmp_path / "libvp8.so")
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    px = timage.to_8bit(linear_image("noise", 8, 8))
    with pytest.raises(RuntimeError, match="g\\+\\+.*no fallback"):
        image_write.encode("x.webp", px)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        timage.write_png(str(tmp_path / "x.webp"), linear_image("noise", 8, 8))
    assert not (tmp_path / "x.webp").exists()
