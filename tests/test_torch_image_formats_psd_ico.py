"""The port's PSD, ICO, CUR, BigTIFF, 2- and 4-plane PCX and palette DDS
readers (utils/image_read.py, utils/tiff.py, through utils/image.py's
read_image and cli/imgtool.py's loader) against PIL 12.1.0, which the
reference's read_image uses, on the same bytes.

Files: PIL's own ICO (PNG and bitmap entries) and BigTIFF (uncompressed;
PIL writes its LZW, Deflate and PackBits TIFFs classic whatever it is
asked, so those come from scripts/block_maps.py's bigtiff, which moves a
classic file's strips under a BigTIFF header); PSD, CUR, ICO bitmaps of
every depth, palette DDS and 2- and 4-plane PCX from the writers of
tests/torch_image_writers.py, which PIL does not write.  PSD: every
colour mode PIL reads at 8 bits (and 1-bit bitmaps), raw and PackBits,
with and without a layer, and RGB with more channels than PIL reads
(whose PackBits table PIL misreads, as the port does).  The samples equal
PIL's (palettes and 1-bit expanded, CMYK as PIL's convert("RGB")), and
read_image and imgtool's loader equal the reference's where PIL gives the
reference colours, else the linearised colours.
"""
import io
import warnings

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.cli import imgtool as jimgtool
from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.cli import imgtool as timgtool
from acceleratedvolrenderer_tpu_torch.utils import image as timage

import torch_image_writers as tiw

H, W = 23, 37


def _rng(seed=0):
    return np.random.default_rng(seed)


def _linear(u8):
    x = u8.astype(np.float32) / 255.0
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _check(tmp_path, data, ext):
    """The port's samples equal PIL's (colours for P, 0 / 255 for 1, RGB for
    CMYK); read_image and imgtool's loader equal the reference's where PIL
    gives L, RGB or RGBA, else the linearised colours and the colours."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # PIL's ICO size warning
        im = Image.open(io.BytesIO(data))
        im.load()
    mode = im.mode
    conv = {"P": "RGBA" if "transparency" in im.info or (
        im.palette and im.palette.mode == "RGBA") else "RGB",
        "1": "L", "CMYK": "RGB"}.get(mode)
    want = np.asarray(im.convert(conv) if conv else im)
    want = want[..., None] if want.ndim == 2 else want
    got = timage._decode_image(f"t{ext}", data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    path = tmp_path / f"t{ext}"
    path.write_bytes(data)
    lin, attrs = timage.read_image(str(path))
    loaded = timgtool._load(str(path))[0]
    assert attrs == {} and lin.dtype == np.float32
    if mode in ("L", "RGB", "RGBA"):
        assert np.array_equal(lin, jimage.read_image(str(path))[0])
        if mode != "L":
            assert np.array_equal(loaded, jimgtool._load(str(path))[0])
    rgb = np.asarray(im.convert("RGB"))
    assert np.array_equal(lin, _linear(rgb))
    assert np.array_equal(loaded, rgb.astype(np.float32) / 255.0)


# ---------------------------------------------------------------- PSD

PSD_CASES = {"L": ("L", 1), "RGB": ("RGB", 3), "RGBA": ("RGB", 4),
             "RGB_5_channels": ("RGB", 5), "CMYK": ("CMYK", 4),
             "P": ("P", 1), "multichannel": ("multichannel", 2),
             "duotone": ("duotone", 1), "bitmap": ("1", 1)}


@pytest.mark.parametrize("layer", [False, True], ids=["flat", "layer"])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "packbits"])
@pytest.mark.parametrize("case", sorted(PSD_CASES))
def test_psd_matches_pil(tmp_path, case, rle, layer):
    mode, c = PSD_CASES[case]
    planes = _rng().integers(0, 256, (c, H, W)).astype(np.uint8)
    planes[:, :, :12] = planes[:, :1, :1]           # runs for PackBits
    planes[:, 5:9] = 77
    if mode == "1":
        planes = np.packbits(planes[:1] > 128, axis=2)
    pal = _rng(1).integers(0, 256, (256, 3)) if mode == "P" else None
    _check(tmp_path, tiw.psd_file(planes, mode, rle=rle, palette=pal,
                                  layer=layer), ".psd")


@pytest.mark.parametrize("mode,depth,words", [
    ("LAB", None, "LAB"), ("RGB", 16, "16-bit RGB"),
    ("L", 32, "32-bit grayscale")])
def test_psd_unread_modes_raise(tmp_path, mode, depth, words):
    """LAB (PIL has no colours for it) and 16- and 32-bit files (PIL has no
    mode for them) raise, naming themselves."""
    path = tmp_path / "t.psd"
    path.write_bytes(tiw.psd_file(np.zeros((3, 4, 4), np.uint8), mode,
                                  depth=depth))
    with pytest.raises(ValueError, match=words):
        timage.read_image(str(path))


def test_packbits_rows_round_trip():
    """The writer's PackBits rows (runs of 3+ as repeats, split at 128)
    decode back through the port's whole-array decoder, by lines or as
    one stream; a packet past its line loses its excess, as in PIL."""
    from acceleratedvolrenderer_tpu_torch.utils.tiff import packbits_decode

    rows = _rng(2).integers(0, 3, (40, 300)).astype(np.uint8)
    rows[:, 20:290] = 5                             # a run past 128
    rows[3, :] = 9
    body, counts = tiw.packbits_rows(rows)
    assert counts.sum() == len(body)
    for line in (300, None):
        got = packbits_decode(body, rows.size, line)
        assert np.array_equal(got.reshape(rows.shape), rows)
    # a run of 4 over lines of 3, then a literal: "aaa" "bc"
    assert packbits_decode(bytes([253, 97, 1, 98, 99]), 5, 3).tobytes() \
        == b"aaabc"
    assert packbits_decode(bytes([253, 97, 1, 98, 99]), 5).tobytes() == \
        b"aaaab"


# ---------------------------------------------------------------- ICO, CUR


def _rgba(h=H, w=W, seed=3):
    px = _rng(seed).integers(0, 256, (h, w, 4)).astype(np.uint8)
    px[..., 3] = np.where(px[..., 3] > 90, px[..., 3], 0)
    return px


def _pil_ico(fmt, mode="RGBA"):
    b = io.BytesIO()
    Image.fromarray(_rgba(48, 48)[..., :len(mode)], mode).save(
        b, "ICO", sizes=[(16, 16), (32, 32), (48, 48)], bitmap_format=fmt)
    return b.getvalue()


def _icon(bpp, cursor=False, w=W, h=H, seed=4):
    mask = _rng(seed).integers(0, 2, (h, w))
    if bpp <= 8:
        pal = _rng(seed + 1).integers(0, 256, (1 << bpp, 3))
        idx = _rng(seed + 2).integers(0, 1 << bpp, (h, w))
        dib = tiw.icon_dib(idx, bpp, mask=mask, palette=pal)
    elif bpp == 24:
        dib = tiw.icon_dib(_rgba(h, w, seed)[..., :3], 24, mask=mask)
    else:
        dib = tiw.icon_dib(_rgba(h, w, seed), 32)
    return tiw.icon_file([(w, h, bpp, dib)], cursor=cursor)


def _png_entry():
    from acceleratedvolrenderer_tpu_torch.utils.image import encode_png

    return encode_png(_rgba(24, 24, 7))


ICONS = {
    "pil_png": lambda: _pil_ico("png"),
    "pil_bmp": lambda: _pil_ico("bmp"),
    "pil_bmp_rgb": lambda: _pil_ico("bmp", "RGB"),
    "bitmap_1": lambda: _icon(1),
    "bitmap_4": lambda: _icon(4),
    "bitmap_8": lambda: _icon(8),
    "bitmap_24": lambda: _icon(24),
    "bitmap_32": lambda: _icon(32),
    # the largest entry wins, and of equal sizes the lowest depth
    "largest_then_shallowest": lambda: tiw.icon_file([
        (8, 8, 32, tiw.icon_dib(_rgba(8, 8), 32)),
        (24, 24, 32, _png_entry()),
        (24, 24, 8, _icon(8, w=24, h=24)[22:])]),
    # of equal size and depth the first
    "first_of_equals": lambda: tiw.icon_file([
        (24, 24, 32, _png_entry()),
        (24, 24, 32, tiw.icon_dib(_rgba(24, 24), 32))]),
}


@pytest.mark.parametrize("case", sorted(ICONS))
def test_ico_matches_pil(tmp_path, case):
    _check(tmp_path, ICONS[case](), ".ico")


CURSORS = {
    "bitmap_1": lambda: _icon(1, True),
    "bitmap_4": lambda: _icon(4, True),
    "bitmap_8": lambda: _icon(8, True),
    "bitmap_24": lambda: _icon(24, True),
    # one 32-bit cursor at byte 22: PIL's BMP reader takes its alpha
    "bitmap_32_at_22": lambda: _icon(32, True),
    # a later entry larger in both sizes wins; its 32-bit bitmap is not at
    # byte 22, so it has no alpha
    "larger_later": lambda: tiw.icon_file([
        (8, 8, 24, tiw.icon_dib(_rgba(8, 8)[..., :3], 24)),
        (W, H, 32, tiw.icon_dib(_rgba(), 32))], cursor=True),
}


@pytest.mark.parametrize("case", sorted(CURSORS))
def test_cur_matches_pil(tmp_path, case):
    _check(tmp_path, CURSORS[case](), ".cur")


def test_cur_png_entry_raises(tmp_path):
    data = tiw.icon_file([(24, 24, 32, _png_entry())], cursor=True)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()
    path = tmp_path / "t.cur"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="CUR with a PNG"):
        timage.read_image(str(path))


# ---------------------------------------------------------------- BigTIFF


def _tiff_image(mode):
    a = _rng(5).integers(0, 256, (H, W, 4)).astype(np.uint8)
    a[:, :9] = 40
    return Image.fromarray({"L": a[..., 0], "RGB": a[..., :3],
                            "RGBA": a}[mode], mode)


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw",
                                         "tiff_adobe_deflate", "packbits"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_bigtiff_matches_pil(tmp_path, mode, compression):
    b = io.BytesIO()
    if compression == "raw":
        _tiff_image(mode).save(b, "TIFF", big_tiff=True)
        data = b.getvalue()
    else:
        _tiff_image(mode).save(b, "TIFF", compression=compression)
        data = tiw.bigtiff(b.getvalue())
    assert data[:4] == b"II+\0"
    _check(tmp_path, data, ".tif")


def test_bigtiff_of_the_predictor_writer(tmp_path):
    """The 8-bit LZW TIFF with the horizontal predictor of
    scripts/time_image_decode.py (chip_smoke phase 34's BigTIFF)."""
    _check(tmp_path, tiw.bigtiff(tiw.encode_tiff(tiw.sky(W, H, 255))),
           ".tif")


# ---------------------------------------------------------------- PCX


@pytest.mark.parametrize("even", [True, False], ids=["even", "odd"])
@pytest.mark.parametrize("size", [(37, 23), (9, 4), (3, 2)],
                         ids=["37x23", "9x4", "3x2"])
@pytest.mark.parametrize("planes", [2, 4])
def test_pcx_planes_match_pil(tmp_path, planes, size, even):
    """1-bit samples in 2 or 4 planes (PIL's P;2L / P;4L) through the
    header's 16 colours, rows of an even stride or of the bytes they
    need."""
    w, h = size
    idx = _rng(6).integers(0, 1 << planes, (h, w))
    pal = _rng(7).integers(0, 256, (16, 3))
    _check(tmp_path, tiw.pcx_1bit(idx, planes, pal, even), ".pcx")


# ---------------------------------------------------------------- DDS


@pytest.mark.parametrize("size", [(37, 23), (1, 1)], ids=["37x23", "1x1"])
def test_palette_dds_matches_pil(tmp_path, size):
    w, h = size
    idx = _rng(8).integers(0, 256, (h, w))
    pal = _rng(9).integers(0, 256, (256, 4))
    _check(tmp_path, tiw.palette_dds(idx, pal), ".dds")
