"""The port's readers of the formats PIL reads but does not write: DCX,
PIXAR, FTEX, GBR, XV thumbnails, McIDAS, IMT, FITS, IPTC, FLI / FLC and
PhotoCD (utils/image_read_pil.py, through utils/image.py's _decode_image
and read_image) against PIL 12.1.0, which the reference's read_image
uses, on the same bytes.

Files: from the writers of tests/torch_image_writers.py
(scripts/pil_only_formats.py), PIL's PCX as DCX pages and PIL's JPEG in
IPTC records.  Each variant of each format is held to PIL's samples with
the rule of the port's readers: colours where PIL gives palette indices
(mode P), PIL's dtype in native byte order (uint16 for I;16 and I;16B,
int32 for I, float32 for F).  read_image equals the reference's where
PIL hands the reference 8-bit samples (L, RGB, RGBA, CMYK); elsewhere
each test states the reference's value (indices, 16- or 32-bit integers
or floats over 255, linearised) beside the port's (colours linearised;
integers over 65535 or 2**31 - 1 by png_unit's rule, linearised; floats
as stored).  What PIL refuses, the port refuses with a ValueError naming
the format and what it refuses.  The dispatch follows PIL's order of
plugins where a format has no magic bytes (IMT, IPTC, PhotoCD) or a
loose test (GBR); every file under tests/data/images/ decodes to PIL's
samples, and the committed fixtures (images.json entries read by
utils/image_read_pil.py) to the recorded SHA-256 of PIL's samples.
"""
import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.utils import image as timage
from acceleratedvolrenderer_tpu_torch.utils import image_read_pil as pil
from acceleratedvolrenderer_tpu_torch.utils.image_write import encode_pcx

import torch_image_writers as tiw

FIXTURES = Path(__file__).resolve().parent / "data" / "images"


def _rng(seed=0):
    return np.random.default_rng(seed)


def _linear(x):
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def _pil_colours(data):
    """PIL's samples of a file, (H, W, C) in native byte order, under the
    port's rule (colours for mode 1 and P); and PIL's mode."""
    im = Image.open(io.BytesIO(data))
    mode = im.mode
    if mode == "1":
        im = im.convert("L")
    elif mode == "P":
        im = im.convert("RGB")
    a = np.asarray(im)
    a = a.astype(a.dtype.newbyteorder("="))
    return (a[..., None] if a.ndim == 2 else a), mode


def _check(tmp_path, data, ext, fmt):
    """_decode_image equals PIL's samples (and PIL reads the file as fmt);
    read_image equals the reference's where PIL gives it 8-bit samples,
    else the stated difference."""
    assert Image.open(io.BytesIO(data)).format == fmt
    want, mode = _pil_colours(data)
    got = timage._decode_image(f"t{ext}", data)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == np.ascontiguousarray(want).tobytes()
    path = tmp_path / f"t{ext}"
    path.write_bytes(data)
    lin, attrs = timage.read_image(str(path))
    assert attrs == {} and lin.dtype == np.float32
    ref = jimage.read_image(str(path))[0]
    rgb = np.repeat(want, 3, axis=2) if want.shape[2] == 1 else want[..., :3]
    raw = np.asarray(Image.open(path), np.float32)
    raw = np.repeat(raw[..., None], 3, 2) if raw.ndim == 2 else raw[..., :3]
    assert np.array_equal(ref, _linear(raw / 255.0), equal_nan=True)
    if mode in ("L", "RGB", "RGBA", "CMYK"):
        assert np.array_equal(lin, ref)
    elif mode == "F":
        assert np.array_equal(lin, rgb, equal_nan=True)
    elif mode == "P":
        assert np.array_equal(lin, _linear(rgb.astype(np.float32) / 255.0))
    else:               # I;16, I;16B, I: over the dtype's maximum
        top = np.float32(np.iinfo(want.dtype).max)
        assert np.array_equal(lin, _linear(rgb.astype(np.float32) / top))
    return got


def _refused(tmp_path, data, ext, words):
    """PIL cannot open or load the file; the port raises ValueError with
    words."""
    path = tmp_path / f"t{ext}"
    path.write_bytes(data)
    with pytest.raises(Exception):
        np.asarray(Image.open(path))
    with pytest.raises(ValueError, match=words):
        timage.read_image(str(path))


def _patched(data, offset, fmt, value):
    data = bytearray(data)
    struct.pack_into(fmt, data, offset, value)
    return bytes(data)


def _px(w=37, h=23, seed=0):
    return tiw.scene(w, h) if seed == 0 else _rng(seed).integers(
        0, 256, (h, w, 3), np.uint8)


def _gray(w=37, h=23, seed=1):
    g = _rng(seed).integers(0, 256, (h, w), np.uint8)
    g[: h // 3, : w // 2] = 200                 # runs
    return g


def _pil_file(im, fmt, **kw):
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


# ---------------------------------------------------------------- DCX


def _pcx_p(seed):
    im = Image.fromarray(_px(37, 23, seed)).quantize(64)
    return _pil_file(im, "PCX")


DCX = {
    "rgb_pages": lambda: tiw.dcx_file([encode_pcx(_px()),
                                       encode_pcx(_px(seed=3))]),
    "one_page": lambda: tiw.dcx_file([encode_pcx(_px(16, 5, 2))]),
    # page 0's palette is read from the end of the file: the last page's
    "palette_pages": lambda: tiw.dcx_file([_pcx_p(4), _pcx_p(5)]),
    "bilevel_page": lambda: tiw.dcx_file([_pil_file(Image.fromarray(
        _gray()).convert("1"), "PCX")]),
}


@pytest.mark.parametrize("case", sorted(DCX))
def test_dcx(tmp_path, case):
    _check(tmp_path, DCX[case](), ".dcx", "DCX")


def test_dcx_refused(tmp_path):
    data = tiw.dcx_file([])                    # an empty page table
    _refused(tmp_path, data + bytes(64), ".dcx", "DCX: no pages")


# ---------------------------------------------------------------- PIXAR


@pytest.mark.parametrize("size", [(37, 23), (1, 1), (300, 2)])
def test_pixar(tmp_path, size):
    _check(tmp_path, tiw.pixar_file(_px(*size, seed=6)), ".pxr", "PIXAR")


def test_pixar_refused(tmp_path):
    _refused(tmp_path, tiw.pixar_file(_px(), words=(14, 1)), ".pxr",
             r"PIXAR: channel words \(14, 1\)")


# ---------------------------------------------------------------- FTEX


def _blocks(w, h, seed):
    return _rng(seed).integers(0, 256, ((w + 3) // 4) * ((h + 3) // 4) * 8,
                               np.uint8).tobytes()


FTEX = {
    "rgb": lambda: tiw.ftex_rgb(_px()),
    "dxt1_image": lambda: tiw.ftex_dxt1(_px(40, 24)),
    "dxt1_image_37x23": lambda: tiw.ftex_dxt1(_px()),
    # random blocks: both colour modes, transparent black
    "dxt1_random": lambda: tiw.ftex_file(16, 12, _blocks(16, 12, 7), 0),
}


@pytest.mark.parametrize("case", sorted(FTEX))
def test_ftex(tmp_path, case):
    _check(tmp_path, FTEX[case](), ".ftc", "FTEX")


FTEX_REFUSED = {
    "two_formats": (lambda: tiw.ftex_file(8, 8, _blocks(8, 8, 1), 0,
                                          n_formats=2), "2 formats"),
    "format_3": (lambda: tiw.ftex_file(8, 8, _blocks(8, 8, 1), 3),
                 "invalid texture compression format 3"),
    "truncated": (lambda: tiw.ftex_file(8, 8, _blocks(8, 8, 1)[:20], 0),
                  "FTEX: image file is truncated"),
}


@pytest.mark.parametrize("case", sorted(FTEX_REFUSED))
def test_ftex_refused(tmp_path, case):
    make, words = FTEX_REFUSED[case]
    _refused(tmp_path, make(), ".ftc", words)


# ---------------------------------------------------------------- GBR

GBR = {
    "v1_gray": lambda: tiw.gbr_file(_gray(), version=1),
    "v2_gray": lambda: tiw.gbr_file(_gray(), version=2),
    "v2_rgba": lambda: tiw.gbr_file(_rng(2).integers(0, 256, (23, 37, 4),
                                                     np.uint8)),
    "v2_long_comment": lambda: tiw.gbr_file(_gray(9, 7), comment=b"x" * 300),
}


@pytest.mark.parametrize("case", sorted(GBR))
def test_gbr(tmp_path, case):
    _check(tmp_path, GBR[case](), ".gbr", "GBR")


def test_gbr_refused(tmp_path):
    _refused(tmp_path, tiw.gbr_file(_gray())[:-5], ".gbr",
             "GBR: not enough image data")


# ---------------------------------------------------------------- XV

XV = {
    "comments": lambda: tiw.xvthumb_file(tiw.rgb_to_332(_px())),
    "no_comments": lambda: tiw.xvthumb_file(tiw.rgb_to_332(_px(16, 5, 3)),
                                            comments=()),
    "every_index": lambda: tiw.xvthumb_file(
        np.arange(256, dtype=np.uint8).reshape(16, 16)),
}


@pytest.mark.parametrize("case", sorted(XV))
def test_xvthumb(tmp_path, case):
    _check(tmp_path, XV[case](), ".xvthumb", "XVThumb")


def test_xvthumb_refused(tmp_path):
    data = tiw.xvthumb_file(tiw.rgb_to_332(_px())).replace(b"37 23 255",
                                                            b"37")
    _refused(tmp_path, data, ".xvthumb", "XV thumbnail: bad size line")


# ---------------------------------------------------------------- McIDAS


def _mcidas_values(nb, w=37, h=23, seed=4):
    lo, hi = (-2 ** 31, 2 ** 31) if nb == 4 else (0, 2 ** (8 * nb))
    return _rng(seed).integers(lo, hi, (h, w), np.int64)


MCIDAS = {}
for _nb in (1, 2, 4):
    MCIDAS[f"{_nb}byte"] = lambda nb=_nb: tiw.mcidas_file(
        _mcidas_values(nb), nb)
    MCIDAS[f"{_nb}byte_prefix_bands_offset"] = lambda nb=_nb: tiw.mcidas_file(
        _mcidas_values(nb, 16, 5, nb), nb, prefix=5, bands=3, offset=400)


@pytest.mark.parametrize("case", sorted(MCIDAS))
def test_mcidas(tmp_path, case):
    _check(tmp_path, MCIDAS[case](), ".area", "MCIDAS")


def test_mcidas_refused(tmp_path):
    data = _patched(tiw.mcidas_file(_mcidas_values(1), 1), 40, ">i", 3)
    _refused(tmp_path, data, ".area", "McIDAS: 3-byte samples")


# ---------------------------------------------------------------- IMT

IMT = {
    "plain": lambda: tiw.imt_file(_gray(), extra=()),
    "comment_and_other_keys": lambda: tiw.imt_file(
        _gray(16, 5, 2), extra=(b"* a comment", b"format tools",
                                b"author x")),
    "long_header": lambda: tiw.imt_file(_gray(9, 7, 3), extra=tuple(
        b"* " + bytes([65 + i]) * 60 for i in range(5))),
}


@pytest.mark.parametrize("case", sorted(IMT))
def test_imt(tmp_path, case):
    _check(tmp_path, IMT[case](), ".imt", "IMT")


IMT_REFUSED = {
    "no_form_feed": (lambda: b"width 4\nheight 2\npixel n8\n" + bytes(8),
                     "IMT: no image data"),
    "bad_width": (lambda: b"width x4\nheight 2\npixel n8\n\x0c" + bytes(8),
                  "IMT: bad value"),
}


@pytest.mark.parametrize("case", sorted(IMT_REFUSED))
def test_imt_refused(tmp_path, case):
    make, words = IMT_REFUSED[case]
    _refused(tmp_path, make(), ".imt", words)


# ---------------------------------------------------------------- FITS


def _fits_values(bitpix, w=37, h=23, seed=5):
    r = _rng(seed)
    if bitpix == 8:
        return r.integers(0, 256, (h, w))
    if bitpix == 16:
        return r.integers(-2 ** 15, 2 ** 15, (h, w))
    if bitpix == 32:
        return r.integers(-2 ** 31, 2 ** 31, (h, w))
    return r.normal(3.0, 2.0, (h, w))


FITS = {}
for _bp in (8, 16, 32, -32, -64):
    FITS[f"bitpix{_bp}"] = lambda bp=_bp: tiw.fits_file(_fits_values(bp), bp)
FITS["image_extension"] = lambda: tiw.fits_file(_fits_values(16), 16,
                                                extension=True)
FITS["naxis1"] = lambda: tiw.fits_file(_fits_values(8, 9, 7), 8,
                                       naxis1=True)
# BZERO and BSCALE do not change PIL's samples
FITS["bzero_bscale"] = lambda: tiw.fits_file(
    _fits_values(16), 16, extra=(("BZERO", 32768), ("BSCALE", 2)))
for _bp in (8, 16, 32):
    FITS[f"gzip_zbitpix{_bp}"] = lambda bp=_bp: tiw.fits_gzip_file(
        _fits_values(bp), bp)


@pytest.mark.parametrize("case", sorted(FITS))
def test_fits(tmp_path, case):
    _check(tmp_path, FITS[case](), ".fits", "FITS")


def test_fits_hazards():
    """PIL's quirks, which the port keeps (ROADMAP's hazards): BITPIX 16
    and 32 come back byte-swapped, -32 as its bytes read little-endian,
    -64 as float32 from the data's first half, rows bottom first, BZERO
    ignored."""
    v = np.array([[1, 2, 3], [4, 5, 6]])
    got = timage._decode_image("t.fits", tiw.fits_file(v, 16))[..., 0]
    assert np.array_equal(got, v.astype(">u2").view("<u2"))
    got = timage._decode_image("t.fits", tiw.fits_file(v, 32))[..., 0]
    assert np.array_equal(got, v.astype(">i4").view("<i4"))
    f = np.array([[1.5, 3.0], [4.5, 6.0]])
    got = timage._decode_image("t.fits", tiw.fits_file(f, -32))[..., 0]
    assert np.array_equal(got, f.astype(">f4").view("<f4")) and \
        np.abs(got).max() < 1e-38
    got = timage._decode_image("t.fits", tiw.fits_file(f, -64))[..., 0]
    half = f[::-1].astype(">f8").tobytes()[:16]
    assert np.array_equal(got, np.frombuffer(half, "<f4").reshape(2, 2)[::-1])
    got = timage._decode_image("t.fits", tiw.fits_file(
        v, 8, extra=(("BZERO", 100),)))[..., 0]
    assert np.array_equal(got, v)


FITS_REFUSED = {
    "bitpix64": (lambda: tiw.fits_file(_fits_values(8), 8).replace(
        b"BITPIX  =                    8", b"BITPIX  =                   64"),
        "FITS: BITPIX 64"),
    "no_image": (lambda: tiw.fits_file(_fits_values(8), 8).replace(
        b"NAXIS   =                    2", b"NAXIS   =                    0"),
        "FITS: no image data"),
    "gzip_float": (lambda: tiw.fits_gzip_file(_fits_values(8), -32),
                   "FITS: not enough image data"),
}


@pytest.mark.parametrize("case", sorted(FITS_REFUSED))
def test_fits_refused(tmp_path, case):
    make, words = FITS_REFUSED[case]
    _refused(tmp_path, make(), ".fits", words)


# ---------------------------------------------------------------- IPTC


def _gray_jpeg(w=37, h=23):
    return tiw.encode_jpeg(_px(w, h)[..., :1], sampling=((1, 1),),
                           space="gray")


IPTC = {
    "raw_L": lambda: tiw.iptc_file(_gray().tobytes(), 37, 23),
    "raw_rgb_band2": lambda: tiw.iptc_file(_gray().tobytes(), 37, 23,
                                           layers=3, band=1),
    "raw_rgb_no_band": lambda: tiw.iptc_file(_gray().tobytes(), 37, 23,
                                             layers=3),
    "raw_cmyk_band4": lambda: tiw.iptc_file(_gray().tobytes(), 37, 23,
                                            layers=4, band=3),
    "raw_extra_bytes": lambda: tiw.iptc_file(_gray().tobytes() + bytes(50),
                                             37, 23),
    "raw_split_records": lambda: tiw.iptc_file(_gray().tobytes(), 37, 23,
                                               chunk=100),
    "raw_extended_length": lambda: tiw.iptc_file(_gray().tobytes(), 37, 23,
                                                 extended=True),
    "jpeg_L": lambda: tiw.iptc_file(_gray_jpeg(), 37, 23, compression=5),
    "jpeg_rgb_band3": lambda: tiw.iptc_file(_gray_jpeg(), 37, 23, layers=3,
                                            band=2, compression=5),
}


@pytest.mark.parametrize("case", sorted(IPTC))
def test_iptc(tmp_path, case):
    _check(tmp_path, IPTC[case](), ".iim", "IPTC")


def test_iptc_one_band():
    """PIL's placement, which the port keeps (ROADMAP's hazards): a
    3-layer raw image is the first w x h bytes in band (3:65) - 1, the
    other bands 0."""
    v = np.arange(8, dtype=np.uint8).reshape(2, 4)
    got = timage._decode_image("t.iim", tiw.iptc_file(v.tobytes(), 4, 2,
                                                      layers=3, band=1))
    assert got.tolist()[0][:2] == [[0, 0, 0], [0, 1, 0]]
    assert np.array_equal(got[..., 1], v) and not got[..., [0, 2]].any()


IPTC_REFUSED = {
    "compression3": (lambda: tiw.iptc_file(_gray().tobytes(), 37, 23,
                                           compression=3),
                     "IPTC: unknown image compression 3"),
    "rgb_jpeg_in_a_band": (lambda: tiw.iptc_file(tiw.encode_jpeg(_px()), 37,
                                                 23, layers=3,
                                                 compression=5),
                           "IPTC: a 37x23 JPEG of 3 channels"),
    "truncated": (lambda: tiw.iptc_file(_gray().tobytes()[:500], 37, 23),
                  "IPTC: image file is truncated"),
}


@pytest.mark.parametrize("case", sorted(IPTC_REFUSED))
def test_iptc_refused(tmp_path, case):
    make, words = IPTC_REFUSED[case]
    _refused(tmp_path, make(), ".iim", words)


# ---------------------------------------------------------------- FLI


def _idx(w=37, h=23, seed=8):
    i = _rng(seed).integers(0, 256, (h, w), np.uint8)
    i[: h // 3, : w // 2] = 9                   # runs
    i[h // 2, :] = np.repeat(_rng(seed).integers(0, 256, (w + 1) // 2),
                             2)[:w]             # repeated words
    return i


def _pal(seed=9, top=256):
    return _rng(seed).integers(0, top, (256, 3))


FLI = {
    "color256_brun": lambda: tiw.fli_file(37, 23, [[
        tiw.fli_color(_pal()), tiw.fli_brun(_idx())]]),
    "color64_copy_fli": lambda: tiw.fli_file(37, 23, [[
        tiw.fli_color(_pal(top=64), kind=11), tiw.fli_copy(_idx())]],
        flc=False),
    # COLOR_64's values above 63 shift past 255 and wrap, as PIL's o8 wraps
    "color64_wraps": lambda: tiw.fli_file(37, 23, [[
        tiw.fli_color(_pal(), kind=11), tiw.fli_copy(_idx())]]),
    "lc": lambda: tiw.fli_file(37, 23, [[
        tiw.fli_color(_pal()), tiw.fli_lc(np.zeros((23, 37)), _idx())]]),
    "lc_wide_skips": lambda: tiw.fli_file(600, 3, [[
        tiw.fli_lc(np.zeros((3, 600)), np.pad(_idx(20, 3), ((0, 0),
                                                            (570, 10))))]]),
    "ss2_odd_width": lambda: tiw.fli_file(37, 23, [[
        tiw.fli_color(_pal()), tiw.fli_ss2(np.zeros((23, 37)), _idx())]]),
    "ss2_even_width_skipped_lines": lambda: tiw.fli_file(36, 23, [[
        tiw.fli_ss2(np.zeros((23, 36)), np.where(
            (np.arange(23) % 5 == 1)[:, None], _idx(36), 0))]]),
    "black_then_lc": lambda: tiw.fli_file(37, 23, [[
        tiw.fli_copy(_idx()), tiw.fli_black(),
        tiw.fli_lc(np.zeros((23, 37)), _idx(seed=2))]]),
    "pstamp_skipped": lambda: tiw.fli_file(37, 23, [[
        tiw.fli_pstamp(_idx(seed=3)), tiw.fli_brun(_idx())]]),
    "gray_without_palette": lambda: tiw.fli_file(37, 23, [[
        tiw.fli_brun(_idx())]]),
    "frame0_of_two": lambda: tiw.fli_file(37, 23, [
        [tiw.fli_color(_pal()), tiw.fli_copy(_idx())],
        [tiw.fli_color(_pal(2)), tiw.fli_black(), tiw.fli_copy(_idx())]]),
}


@pytest.mark.parametrize("case", sorted(FLI))
def test_fli(tmp_path, case):
    _check(tmp_path, FLI[case](), ".flc", "FLI")


def test_fli_frame0_only():
    """np.asarray sees frame 0 of a fresh file (ROADMAP's hazards): the
    second frame's palette and pixels do not show."""
    data = FLI["frame0_of_two"]()
    want = _pal()[_idx()].astype(np.uint8)
    assert np.array_equal(timage._decode_image("t.flc", data), want)


FLI_REFUSED = {
    "chunk_type_99": (lambda: tiw.fli_file(37, 23, [[
        tiw.fli_chunk(99, bytes(8)), tiw.fli_copy(_idx())]]),
        "FLI: chunk type 99"),
    # a 6-byte chunk last in the frame: FliDecode.c wants 10 bytes left
    "black_last": (lambda: tiw.fli_file(37, 23, [[
        tiw.fli_copy(_idx()), tiw.fli_black()]]), "chunk header"),
    # PIL decodes frame 0 from byte 128, where the prefix chunk stands
    "prefix_chunk": (lambda: tiw.fli_file(37, 23, [[tiw.fli_copy(_idx())]],
                                          prefix=True),
                     "frame 0 is not a frame chunk"),
    "truncated": (lambda: tiw.fli_file(37, 23, [[tiw.fli_copy(_idx())]])
                  [:-40], "FLI: image file is truncated"),
}


@pytest.mark.parametrize("case", sorted(FLI_REFUSED))
def test_fli_refused(tmp_path, case):
    make, words = FLI_REFUSED[case]
    _refused(tmp_path, make(), ".flc", words)


# ---------------------------------------------------------------- PhotoCD


@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 7])
def test_pcd(tmp_path, orientation):
    """The base image, turned by 90 / 270 degrees for orientation bits 1
    / 3 (bit 2 is not read)."""
    data = tiw.pcd_of_rgb(tiw.sky(768, 512, 255), orientation)
    got = _check(tmp_path, data, ".pcd", "PCD")
    assert got.shape == ((768, 512, 3) if orientation & 1 else
                         (512, 768, 3))


def test_pcd_tables_on_every_input():
    """PIL's YCC;P conversion on every (Y, C1, C2): 43 base images of
    2x2 blocks, each block one (C1, C2) pair and four Y values, and
    ycc_to_rgb equals PIL on all 16,777,216 inputs."""
    blocks = 256 * 384
    for k in range(-(-64 * 65536 // blocks)):
        b = np.minimum(k * blocks + np.arange(blocks), 64 * 65536 - 1)
        pair, ybase = b % 65536, 4 * (b // 65536)
        c1 = (pair // 256).astype(np.uint8).reshape(256, 384)
        c2 = (pair % 256).astype(np.uint8).reshape(256, 384)
        yb = ybase.reshape(256, 384)
        y = np.zeros((512, 768), np.uint8)
        for j, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            y[dy::2, dx::2] = yb + j
        want = np.asarray(Image.open(io.BytesIO(tiw.pcd_file(y, c1, c2))))
        up = lambda c: np.repeat(np.repeat(c, 2, 0), 2, 1)  # noqa: E731
        assert np.array_equal(pil.ycc_to_rgb(y, up(c1), up(c2)), want)


def test_pcd_refused(tmp_path):
    data = tiw.pcd_of_rgb(tiw.sky(768, 512, 255))[:-3000]
    _refused(tmp_path, data, ".pcd", "PCD: image file is truncated")


# ---------------------------------------------------------------- dispatch


def _pcd_behind(prefix):
    data = bytearray(tiw.pcd_of_rgb(tiw.sky(768, 512, 255)))
    data[:len(prefix)] = prefix
    return bytes(data)


DISPATCH = {
    # IPTC's and IMT's parsers decline the first bytes; PIL reads PCD
    "pcd_behind_iptc_and_imt": (lambda: _pcd_behind(
        b"\x1c\x02\x00\x00\x02width 9\n\xff"), "PCD"),
    # GBR's test passes, its parser declines (depth 3): PIL reads PCD
    "pcd_behind_gbr": (lambda: _pcd_behind(struct.pack(">5I", 28, 2, 4, 4,
                                                       3)), "PCD"),
    # IMT comes before PCD: an IMT file with PCD_ at 2048 is IMT
    "imt_before_pcd": (lambda: tiw.imt_file(np.frombuffer(
        bytes(2030) + b"PCD_" + bytes(4096 - 2034), np.uint8).reshape(
        64, 64), extra=()), "IMT"),
    # the XV thumbnail is not read as netpbm
    "xvthumb_not_netpbm": (lambda: XV["comments"](), "XVThumb"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_in_pils_order(tmp_path, case):
    make, fmt = DISPATCH[case]
    _check(tmp_path, make(), ".bin", fmt)


def _image_files():
    return sorted(p.name for p in FIXTURES.iterdir()
                  if p.name != "images.json")


@pytest.mark.parametrize("name", _image_files())
def test_every_fixture_decodes_as_pil_does(name):
    """Each file under tests/data/images/, of every format the port reads:
    _decode_image gives PIL's samples (colours for modes 1 and P), so no
    check of a format sits where it claims another format's file."""
    data = (FIXTURES / name).read_bytes()
    want, _ = _pil_colours(data)
    got = timage._decode_image(name, data)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _fixtures():
    record = json.loads((FIXTURES / "images.json").read_text())
    return {k: v for k, v in record.items()
            if v.get("read_by") == "utils/image_read_pil.py"}


@pytest.mark.parametrize("name", sorted(_fixtures()))
def test_committed_fixtures_hashes(name):
    """Each committed fixture: its bytes, PIL's samples (colours) and the
    port's decode all have the recorded hashes."""
    rec = _fixtures()[name]
    data = (FIXTURES / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == rec["sha256_of_bytes"]
    want, mode = _pil_colours(data)
    assert mode == rec["pil_mode"]
    assert hashlib.sha256(want.tobytes()).hexdigest() == rec[
        "sha256_of_pil_samples"]
    got = timage._decode_image(name, data)
    assert got.shape == tuple(rec["shape"])
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec[
        "sha256_of_pil_samples"]


def test_phase38_maps_hashes():
    """chip_smoke.py phase 38's PhotoCD sky and FTEX ground, written by
    scripts/pil_only_formats.py from the 768x512 sinusoid sky and the
    ground fixture's samples: their bytes and PIL's samples at
    images.json's hashes, and the port's decodes PIL's."""
    import pil_only_formats as pof

    record = json.loads((FIXTURES / "images.json").read_text())
    ground = np.asarray(Image.open(FIXTURES / "ground_1024x512_q90.webp"))
    files = pof.phase38_files(tiw.sky(768, 512, 255), ground)
    assert sorted(files) == sorted(
        k for k, v in record.items()
        if v.get("rebuilt_by") == "scripts/pil_only_formats.py")
    for name, data in files.items():
        rec = record[name]
        assert hashlib.sha256(data).hexdigest() == rec["sha256_of_bytes"]
        want, mode = _pil_colours(data)
        assert mode == rec["pil_mode"] and list(want.shape) == rec["shape"]
        assert hashlib.sha256(want.tobytes()).hexdigest() == rec[
            "sha256_of_pil_samples"]
        assert np.array_equal(timage._decode_image(name, data), want)


def test_fixture_decode_timer(capsys):
    """scripts/pil_only_formats.py's decode_fixtures, which chip_smoke.py's
    phase 37 runs on the card's host: every committed fixture decoded and
    at its record."""
    import pil_only_formats as pof

    rows = pof.decode_fixtures()
    assert len(rows) == len(_fixtures()) and rows
    assert all(ok for *_, ok in rows)
    pof.main()
    out = capsys.readouterr().out
    assert out.startswith("host CPU: ") and "WRONG" not in out


# ---------------------------------------------------------------- the slice


@pytest.fixture
def pcd_ftex_scene(tmp_path):
    """test_torch_image_formats_scene's ground quad under a PhotoCD sky
    (the 768x512 sinusoids), its imagemap an FTEX of DXT1 blocks."""
    from test_torch_image_formats_scene import _scene_text

    (tmp_path / "sky.pcd").write_bytes(tiw.pcd_of_rgb(tiw.sky(768, 512,
                                                              255)))
    (tmp_path / "ground.ftc").write_bytes(tiw.ftex_dxt1(tiw.scene(48, 32)))
    path = tmp_path / "scene.pbrt"
    path.write_text(_scene_text(tmp_path / "sky.pcd", "ground.ftc"))
    return path


def test_pcd_sky_and_ftex_ground_render_like_jax(pcd_ftex_scene):
    """Both packages parse the file into equal scenes (the port with its
    warnings made errors: no uniform-sky fallback) and the port's 32x24
    frame on the CPU equals the JAX package's under jax.disable_jit."""
    import warnings

    import jax

    from acceleratedvolrenderer_tpu.parallel import render as jrender
    from acceleratedvolrenderer_tpu.scene import parser as jparser
    from acceleratedvolrenderer_tpu_torch.models import lights as tlights
    from acceleratedvolrenderer_tpu_torch.parallel import render as trender
    from acceleratedvolrenderer_tpu_torch.scene import parser as tparser
    from test_torch_scene_parser import _scenes_equal

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ts = tparser.load_scene(str(pcd_ftex_scene), device="cpu")
    js = jparser.load_scene(str(pcd_ftex_scene))
    assert isinstance(ts.lights[1], tlights.ImageInfiniteLight)
    _scenes_equal(js, ts)
    with jax.disable_jit():
        ref, _ = jrender.render(js)
    img, _ = trender.render(ts, device="cpu")
    assert img.shape == ref.shape == (24, 32, 3) and img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-5
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- read_image


def test_read_image_int32_rule(tmp_path):
    """int32 samples (PIL's mode I: 4-byte McIDAS, FITS BITPIX 32) over
    2**31 - 1 by png_unit's rule, gray repeated, sRGB linearised; the
    reference divides PIL's integers by 255."""
    v = np.array([[0, 2 ** 30, 2 ** 31 - 1], [-5, 12345, 2 ** 29]])
    path = tmp_path / "t.area"
    path.write_bytes(tiw.mcidas_file(v, 4))
    lin = timage.read_image(str(path))[0]
    unit = v.astype(np.float32) / np.float32(2 ** 31 - 1)
    assert np.array_equal(lin, _linear(np.repeat(unit[..., None], 3, 2)))
    assert np.array_equal(timage.png_unit(v.astype(np.int32)), unit)
    ref = jimage.read_image(str(path))[0]
    assert np.array_equal(ref, _linear(np.repeat(
        v.astype(np.float32)[..., None] / 255.0, 3, 2)))
