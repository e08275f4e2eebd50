"""The port's TIFF reader (acceleratedvolrenderer_tpu_torch/utils/tiff.py,
through utils/image.py's read_image) against the reference's read_image,
which opens the file with PIL.

Files come from PIL (its libtiff writer: raw, LZW, Deflate, PackBits, the
horizontal and floating-point predictors) and from
tests/torch_image_writers.py's encode_tiff (old-style LZW, big-endian,
tiles, planar configuration 2, palettes), at 37x23 and 300x200.

Where PIL returns the image's colours (8-bit RGB, RGBA and gray, either
polarity) read_image equals the reference's bit for bit.  Where it returns
something else the port reads the colours, held to PIL's convert() or to
the written samples (ROADMAP Queue 3, "Differences in the reference
itself"): a bilevel image as 0 / 255 (PIL: booleans), a palette expanded
(PIL: the indices), gray + alpha as gray (PIL: two channels), CMYK as
PIL's convert("RGB"), 16-bit samples over 65535 (PIL: raw gray values, or
RGB truncated to 8 bits), and 32-bit floats as linear values without the
sRGB curve (PIL: the floats, which the reference divides by 255).
"""
import io

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.utils import image as timage
from acceleratedvolrenderer_tpu_torch.utils import tiff as ttiff

import torch_image_writers as tiw


def _linear(u8):
    x = u8.astype(np.float32) / 255.0
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _pil_tiff(im, **kw):
    b = io.BytesIO()
    im.save(b, "TIFF", **kw)
    return b.getvalue()


def _read(tmp_path, data, name="t.tif"):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


COMPRESSIONS = {"raw": {}, "lzw": dict(compression="tiff_lzw"),
                "deflate": dict(compression="tiff_adobe_deflate"),
                "packbits": dict(compression="packbits"),
                "lzw_predictor": dict(compression="tiff_lzw",
                                      tiffinfo={317: 2}),
                "deflate_predictor": dict(compression="tiff_deflate",
                                          tiffinfo={317: 2})}


@pytest.mark.parametrize("size", [(37, 23), (300, 200)])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L"])
@pytest.mark.parametrize("comp", sorted(COMPRESSIONS))
def test_pil_tiff_matches_reference(tmp_path, comp, mode, size):
    img = Image.fromarray(tiw.scene(*size)).convert(mode)
    path = _read(tmp_path, _pil_tiff(img, **COMPRESSIONS[comp]))
    want, _ = jimage.read_image(path)
    got, attrs = timage.read_image(path)
    assert got.dtype == np.float32 and attrs == {}
    assert np.array_equal(got, want)


HAND_BUILT = {
    "lzw_old": dict(compression="lzw_old"),
    "lzw_old_predictor": dict(compression="lzw_old", predictor=2),
    "big_endian_lzw": dict(compression="lzw", big_endian=True),
    "big_endian_predictor": dict(compression="lzw", predictor=2,
                                 big_endian=True),
    "tiles_deflate": dict(compression="deflate", tile=(16, 16)),
    "tiles_lzw_predictor": dict(compression="lzw", predictor=2,
                                tile=(32, 16)),
    "planar_lzw": dict(compression="lzw", planar=2, rows_per_strip=7),
    "planar_predictor": dict(compression="deflate", predictor=2, planar=2,
                             rows_per_strip=5),
    "strips_packbits": dict(compression="packbits", rows_per_strip=3),
    "strips_raw": dict(compression="none", rows_per_strip=4),
}


@pytest.mark.parametrize("case", sorted(HAND_BUILT))
def test_hand_built_tiff_matches_reference(tmp_path, case):
    px = tiw.scene(37, 23, seed=2)
    path = _read(tmp_path, tiw.encode_tiff(px, **HAND_BUILT[case]))
    assert np.array_equal(timage._decode_image(path, open(path, "rb").read()),
                          px)
    assert np.array_equal(timage.read_image(path)[0],
                          jimage.read_image(path)[0])


def test_white_is_zero_gray_matches_reference(tmp_path):
    px = tiw.scene(37, 23)[..., 0]
    path = _read(tmp_path, tiw.encode_tiff(255 - px, "lzw", photometric=0))
    assert np.array_equal(timage.read_image(path)[0],
                          jimage.read_image(path)[0])
    assert np.array_equal(timage.read_image(path)[0],
                          np.repeat(_linear(px)[..., None], 3, 2))


@pytest.mark.parametrize("comp", ["raw", "lzw", "packbits"])
def test_bilevel_reads_its_colours(tmp_path, comp):
    """PIL returns booleans (the reference: 1/255 for white); the port 0 or
    1, PIL's convert("L") over 255."""
    img = Image.fromarray(tiw.scene(37, 23)[..., 0]).convert("1")
    path = _read(tmp_path, _pil_tiff(img, **COMPRESSIONS[comp]))
    gray = np.asarray(Image.open(path).convert("L"))
    assert np.array_equal(timage.read_image(path)[0],
                          np.repeat(_linear(gray)[..., None], 3, 2))


@pytest.mark.parametrize("source", ["pil", "hand_built"])
def test_palette_expanded(tmp_path, source):
    """PIL returns the indices; the port the palette's colours (16-bit
    map entries >> 8), as convert("RGB")."""
    px = tiw.scene(37, 23)
    if source == "pil":
        img = Image.fromarray(px).convert("P", palette=Image.ADAPTIVE,
                                          colors=50)
        data = _pil_tiff(img, compression="tiff_lzw")
    else:
        cmap = np.stack([np.arange(256) * 257, (255 - np.arange(256)) * 257,
                         np.arange(256) * 100]).astype(np.uint16)
        data = tiw.encode_tiff(px[..., 0], "lzw", colormap=cmap)
    path = _read(tmp_path, data)
    rgb = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(timage.read_image(path)[0], _linear(rgb))


def test_gray_alpha_reads_gray(tmp_path):
    img = Image.fromarray(tiw.scene(37, 23)[..., :2], "LA")
    path = _read(tmp_path, _pil_tiff(img, compression="tiff_lzw"))
    gray = np.asarray(Image.open(path).convert("L"))
    assert np.array_equal(timage.read_image(path)[0],
                          np.repeat(_linear(gray)[..., None], 3, 2))


@pytest.mark.parametrize("comp", ["raw", "lzw"])
def test_cmyk_converted_as_pil(tmp_path, comp):
    img = Image.fromarray(tiw.scene(37, 23)).convert("CMYK")
    path = _read(tmp_path, _pil_tiff(img, **COMPRESSIONS[comp]))
    rgb = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(timage.read_image(path)[0], _linear(rgb))


SIXTEEN = {"gray_pil_raw": ("pil", {}), "gray_pil_lzw_predictor":
           ("pil", dict(compression="tiff_lzw", tiffinfo={317: 2})),
           "rgb_lzw_predictor": ("hand", dict(compression="lzw",
                                              predictor=2)),
           "rgb_deflate_big_endian": ("hand", dict(compression="deflate",
                                                   big_endian=True)),
           "rgb_tiles": ("hand", dict(compression="lzw", tile=(16, 16)))}


@pytest.mark.parametrize("case", sorted(SIXTEEN))
def test_16bit_scaled_by_65535(tmp_path, case):
    """PIL returns raw gray values (the reference: over 255) or RGB cut to
    8 bits; the port the samples over 65535, as its 16-bit PNG."""
    src, kw = SIXTEEN[case]
    px = (tiw.scene(37, 23).astype(np.uint16) * 257 + 5)
    if src == "pil":
        px = px[..., :1]
        data = _pil_tiff(Image.fromarray(px[..., 0]), **kw)
    else:
        data = tiw.encode_tiff(px, **kw)
    path = _read(tmp_path, data)
    got = timage._decode_image(path, data)
    assert got.dtype == np.uint16 and np.array_equal(got, px)
    x = px.astype(np.float32) / 65535.0
    lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    want = np.repeat(lin, 3, 2) if lin.shape[2] == 1 else lin
    assert np.array_equal(timage.read_image(path)[0], want.astype(np.float32))


@pytest.mark.parametrize("predictor", [1, 2, 3])
def test_float_read_linear(tmp_path, predictor):
    """PIL returns the floats (the reference divides them by 255 and
    applies the sRGB curve); the port keeps them, linear, as EXR and PFM."""
    px = (tiw.scene(37, 23)[..., 0].astype(np.float32) / 37.0 - 2.0)
    data = _pil_tiff(Image.fromarray(px), compression="tiff_lzw",
                     tiffinfo={317: predictor})
    path = _read(tmp_path, data)
    assert np.array_equal(np.asarray(Image.open(path)), px)
    got, _ = timage.read_image(path)
    assert np.array_equal(got, np.repeat(px[..., None], 3, 2))


RAISES = {
    "jpeg_in_tiff": (7, "JPEG TIFF"), "ccitt": (3, "CCITT"),
    "zstd": (50000, "Zstandard"), "unknown": (12345, "compression 12345")}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_other_compressions_raise_naming_them(tmp_path, case):
    code, words = RAISES[case]
    data = bytearray(tiw.encode_tiff(tiw.scene(8, 4), "none"))
    ifd = int.from_bytes(data[4:8], "little")
    for i in range(int.from_bytes(data[ifd:ifd + 2], "little")):
        e = ifd + 2 + 12 * i
        if int.from_bytes(data[e:e + 2], "little") == 259:
            data[e + 8:e + 10] = code.to_bytes(2, "little")
    with pytest.raises(ValueError, match=words):
        timage.read_image(_read(tmp_path, bytes(data)))


def test_lzw_round_trips_long_and_repetitive_data():
    """Past one table (the clear code and 12-bit codes), both bit orders."""
    rng = np.random.default_rng(3)
    data = bytes(rng.integers(0, 7, 40000, np.uint8)) + b"\1" * 9000
    for msb, early in ((True, 1), (False, 0)):
        enc = tiw.lzw_encode(data, msb=msb, early=early)
        assert ttiff.lzw_decode(enc, msb=msb, early=early) == data
