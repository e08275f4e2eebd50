"""The port's JPEG, TGA and BMP decoders (utils/image.py, numpy only)
against the files' decoding by PIL, which the reference's read_image
(acceleratedvolrenderer_tpu/utils/image.py) uses; PIL writes the files
here, in the tests only.

JPEG: baseline and progressive, 4:4:4, 4:2:2 and 4:2:0, gray, a restart
interval, 37x23 and 300x200 (sizes not a multiple of the MCU).  The
decoder follows libjpeg-turbo's islow IDCT, fancy upsampling and colour
tables, as PIL decodes: the 8-bit samples must equal PIL's on at least
99.9% and lie within 1 of them everywhere (every case here is equal on
all of them), and read_image must equal the reference's after
linearisation on the same share, within 0.01 everywhere.

TGA (true color with and without alpha, gray; raw and RLE; bottom-left
and top-left origin) and BMP (24- and 32-bit, bottom-up and top-down,
32-bit bit masks): read_image equals the reference's bit for bit.  Where
the reference returns something else (a gray + alpha TGA gives it two
channels, a palette BMP its indices), the port expands as pbrt does and
is held to PIL's RGB conversion.  The formats this file once held as
unread (arithmetic-coded, lossless and CMYK JPEG, GIF, TIFF, WebP,
colour-mapped TGA, RLE and 16-bit BMP; then PCX, SGI, IM and
uncompressed DDS; then block-compressed DDS, PSD, ICO and BigTIFF; then
XBM, MSP, SPIDER, BLP, SUN, XPM and DIB) are read now and held to the
same rule (a SPIDER image's floats as stored); every format left unread
raises, naming itself.  The new readers' own tests are in
tests/test_torch_image_formats_{tiff,webp,more,scene,readback,bcn,psd_ico,
pil_more}.py.
"""
import io
import struct

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.utils import image as timage

import torch_image_writers as tiw

SHARE = 0.999


def _scene(w, h, seed=0):
    """Smooth gradients and noise: every coefficient band in use."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0),
                    128 + 90 * np.cos(yy / 5.0 + xx / 11.0),
                    (xx * 3 + yy * 5) % 256], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def _linear(u8):
    x = u8.astype(np.float32) / 255.0
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


JPEG_CASES = {
    "baseline_444": dict(subsampling=0),
    "baseline_422": dict(subsampling=1),
    "baseline_420": dict(subsampling=2),
    "progressive_444": dict(subsampling=0, progressive=True),
    "progressive_422": dict(subsampling=1, progressive=True),
    "progressive_420": dict(subsampling=2, progressive=True),
    "restart_420": dict(subsampling=2, restart_marker_blocks=3),
    "progressive_restart": dict(subsampling=2, progressive=True,
                                restart_marker_rows=1),
    "gray": "L",
    "gray_progressive": "L_progressive",
}


@pytest.mark.parametrize("size", [(37, 23), (300, 200)])
@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_matches_pil(tmp_path, case, size):
    kw = JPEG_CASES[case]
    img = _scene(*size)
    path = str(tmp_path / "t.jpg")
    if isinstance(kw, str):
        Image.fromarray(img[..., 0]).save(path, quality=90,
                                          progressive="progressive" in kw)
    else:
        Image.fromarray(img).save(path, quality=85, **kw)
    ref = np.asarray(Image.open(path))
    with open(path, "rb") as f:
        got = timage.decode_jpeg(f.read())
    assert got.dtype == np.uint8
    assert got.shape == (ref.shape if ref.ndim == 3 else ref.shape + (1,))
    d = np.abs(got.astype(int) - ref.reshape(got.shape).astype(int))
    assert (d == 0).mean() >= SHARE and d.max() <= 1
    want, _ = jimage.read_image(path)
    lin, attrs = timage.read_image(path)
    assert lin.dtype == np.float32 and lin.shape == want.shape and attrs == {}
    assert (lin == want).mean() >= SHARE
    np.testing.assert_allclose(lin, want, atol=0.01, rtol=0)


def _tga_image(mode):
    img = _scene(37, 23, seed=1)
    img[5:15, 3:30] = [10, 200, 30]             # runs for the RLE packets
    alpha = np.random.default_rng(2).integers(0, 256, (23, 37, 1), np.uint8)
    return {"RGB": img, "RGBA": np.concatenate([img, alpha], -1),
            "L": img[..., 1], "LA": np.stack([img[..., 1], alpha[..., 0]],
                                             -1)}[mode]


@pytest.mark.parametrize("origin", [-1, 1], ids=["bottom_left", "top_left"])
@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_tga_matches_reference(tmp_path, mode, rle, origin):
    path = str(tmp_path / "t.tga")
    kw = dict(orientation=origin)
    if rle:
        kw["compression"] = "tga_rle"
    Image.fromarray(_tga_image(mode), mode).save(path, **kw)
    with open(path, "rb") as f:
        assert bool(f.read()[17] & 0x20) == (origin == 1)
    lin, _ = timage.read_image(path)
    assert lin.shape == (23, 37, 3)
    if mode == "LA":        # the reference returns its two channels
        gray = np.asarray(Image.open(path).convert("L"))
        assert np.array_equal(lin, np.repeat(_linear(gray)[..., None], 3, 2))
    else:
        assert np.array_equal(lin, jimage.read_image(path)[0])


def _bmp(px, bpp=24, top_down=False, masks=None):
    """A BITMAPINFOHEADER BMP of (H, W, 3) RGB pixels: 24-bit BGR rows or
    32-bit BGRX words (with masks: BI_BITFIELDS, pixels packed by them)."""
    h, w, _ = px.shape
    rows = px if top_down else px[::-1]
    if bpp == 24:
        raw = rows[..., ::-1]
        stride = (w * 3 + 3) // 4 * 4
        body = b"".join(r.tobytes() + b"\0" * (stride - 3 * w) for r in raw)
    else:
        shifts = [(m & -m).bit_length() - 1 for m in (masks or (
            0xFF0000, 0xFF00, 0xFF))]
        v = sum(rows[..., i].astype(np.uint32) << s
                for i, s in enumerate(shifts))
        body = v.astype("<u4").tobytes()
    extra = struct.pack("<III", *masks) if masks else b""
    off = 14 + 40 + len(extra)
    head = struct.pack("<2sIHHI", b"BM", off + len(body), 0, 0, off)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       3 if masks else 0, len(body), 2835, 2835, 0, 0)
    return head + info + extra + body


BMP_CASES = {
    "24_bottom_up": dict(bpp=24),
    "24_top_down": dict(bpp=24, top_down=True),
    "32_bottom_up": dict(bpp=32),
    "32_top_down": dict(bpp=32, top_down=True),
    "32_bitfields": dict(bpp=32, masks=(0xFF000000, 0xFF0000, 0xFF00)),
}


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_bmp_matches_reference(tmp_path, case):
    px = _scene(37, 23, seed=3)
    path = tmp_path / "t.bmp"
    path.write_bytes(_bmp(px, **BMP_CASES[case]))
    assert np.array_equal(timage.decode_bmp(path.read_bytes()), px)
    assert np.array_equal(np.asarray(Image.open(path).convert("RGB")), px)
    lin, _ = timage.read_image(str(path))
    assert np.array_equal(lin, jimage.read_image(str(path))[0])


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "1"])
def test_bmp_written_by_pil(tmp_path, mode):
    """PIL's own BMPs (24-bit, 32-bit, 8-bit palette, 1-bit palette):
    palettes expanded, as pbrt does, where the reference returns the
    indices."""
    img = _scene(37, 23, seed=4)
    im = {"RGB": lambda: Image.fromarray(img),
          "RGBA": lambda: Image.fromarray(img).convert("RGBA"),
          "P": lambda: Image.fromarray(img).convert(
              "P", palette=Image.ADAPTIVE, colors=50),
          "1": lambda: Image.fromarray(img[..., 0]).convert("1")}[mode]()
    path = str(tmp_path / "t.bmp")
    im.save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(timage.decode_bmp(open(path, "rb").read()), want)
    lin, _ = timage.read_image(path)
    assert np.array_equal(lin, _linear(want))


def _cmyk_jpeg():
    b = io.BytesIO()
    Image.fromarray(_scene(37, 23)).convert("CMYK").save(b, "JPEG")
    return b.getvalue()


def _other(fmt, **kw):
    b = io.BytesIO()
    Image.fromarray(_scene(37, 23)).save(b, fmt, **kw)
    return b.getvalue()


def _j2k_patched(data, offset, bits):
    """A JPEG 2000 file with bits set in byte `offset` of its COD segment's
    body (8: the code-block style, 0: Scod)."""
    data = bytearray(data)
    data[data.index(b"\xff\x52") + 4 + offset] |= bits
    return bytes(data)


def _palette_tga():
    b = io.BytesIO()
    Image.fromarray(_scene(37, 23)).convert("P").save(b, "TGA")
    return b.getvalue()


def _jpeg_in_tiff():
    """A PIL TIFF whose compression field says JPEG (7)."""
    data = bytearray(_other("TIFF"))
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        e = ifd + 2 + 12 * i
        if struct.unpack_from("<H", data, e)[0] == 259:
            struct.pack_into("<H", data, e + 8, 7)
    return bytes(data)


UNREAD = {
    "jpeg_in_tiff": (".tif", _jpeg_in_tiff, "JPEG TIFF"),
    "arithmetic_lossless_jpeg": (".jpg", lambda: tiw.patch_sof(
        tiw.pil_jpeg(), 0xCB), "arithmetic-coded lossless"),
    "hierarchical_jpeg": (".jpg", lambda: tiw.patch_sof(tiw.pil_jpeg(), 0xC5),
                          "hierarchical"),
    "lossless_ycbcr_jpeg": (".jpg", lambda: tiw.encode_jpeg_lossless(
        _scene(37, 23), jfif=True), "lossless JPEG in YCbCr"),
    "12bit_jpeg": (".jpg", lambda: tiw.patch_sof(tiw.pil_jpeg(), precision=12),
                   "12-bit"),
    # JPEG 2000 is read (test_torch_image_formats_j2k.py); what PIL's
    # writer cannot make is refused, naming it
    "jpeg2000": (".jp2", lambda: _j2k_patched(_other("JPEG2000"), 8, 1),
                 "code-block mode switches"),
    "jpeg2000_codestream": (".j2k", lambda: _j2k_patched(_other(
        "JPEG2000", no_jp2=True), 0, 2), "SOP / EPH markers"),
    "pam": (".pam", lambda: b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\n"
            b"ENDHDR\n" + bytes(6), "PAM"),
    "pfm": (".pfm", lambda: b"PF\n2 1\n-1.0\n" + bytes(24), "PFM"),
    "unknown": (".xyz", lambda: b"\x00\x01\x02\x03" * 8,
                "not an EXR, PNG, JPEG, BMP, DIB, TIFF, WebP, GIF, QOI, "
                "netpbm, AVIF, PCX, DCX, SGI, IM, DDS, PSD, ICO, CUR, ICNS, JPEG "
                "2000, BLP, MSP, SPIDER, SUN, XBM, XPM, FITS, FLI, FTEX, GBR, "
                "IMT, IPTC, McIDAS, PhotoCD, PIXAR, XV thumbnail or TGA "
                "image"),
}


@pytest.mark.parametrize("case", sorted(UNREAD))
def test_unread_formats_raise_naming_them(tmp_path, case):
    ext, make, words = UNREAD[case]
    path = tmp_path / f"t{ext}"
    path.write_bytes(make())
    with pytest.raises(ValueError, match=words):
        timage.read_image(str(path))


def _bilevel(fmt):
    b = io.BytesIO()
    Image.fromarray(_scene(37, 23)).convert("1").save(b, fmt)
    return b.getvalue()


def _other_p(fmt):
    b = io.BytesIO()
    Image.fromarray(_scene(37, 23)).convert("P").save(b, fmt)
    return b.getvalue()


def _rle8_bmp():
    idx = (_scene(37, 23)[..., 0] // 4).astype(np.uint8)
    pal = np.concatenate([np.random.default_rng(6).integers(
        0, 256, (64, 3), np.uint8), np.zeros((64, 1), np.uint8)], 1)
    return tiw.bmp_file(tiw.rle8(idx), 37, 23, 8, 1, pal.tobytes())


NOW_READ = {
    # the cases test_unread_formats_raise_naming_them held until these
    # formats were read: each now held to the reference bit for bit
    # ("reference") or, where PIL returns something other than the
    # colours, to PIL's convert("RGB") ("convert")
    "arithmetic_jpeg": (".jpg", lambda: tiw.encode_jpeg_arith(
        _scene(37, 23)), "reference"),
    "lossless_jpeg": (".jpg", lambda: tiw.encode_jpeg_lossless(
        _scene(37, 23)), "reference"),
    "cmyk_jpeg": (".jpg", _cmyk_jpeg, "convert"),
    "gif": (".gif", lambda: _other("GIF"), "convert"),
    "tiff": (".tif", lambda: _other("TIFF"), "reference"),
    "webp": (".webp", lambda: _other("WEBP", quality=80), "reference"),
    "palette_tga": (".tga", _palette_tga, "convert"),
    "rle_bmp": (".bmp", _rle8_bmp, "convert"),
    "16bit_bmp": (".bmp", lambda: _bmp(_scene(8, 4))[:28] + struct.pack(
        "<H", 16) + _bmp(_scene(8, 4))[30:], "reference"),
    "dds": (".dds", lambda: _other("DDS"), "reference"),
    "pcx": (".pcx", lambda: _other("PCX"), "reference"),
    "sgi": (".sgi", lambda: _other("SGI"), "reference"),
    "im": (".im", lambda: _other("IM"), "reference"),
    "dds_dxt1": (".dds", lambda: _other("DDS", pixel_format="DXT1"),
                 "reference"),
    "psd": (".psd", lambda: tiw.psd_file(_scene(37, 23).transpose(2, 0, 1),
                                         "RGB", rle=True), "reference"),
    "ico": (".ico", lambda: _other("ICO"), "reference"),
    "bigtiff": (".tif", lambda: _other("TIFF", big_tiff=True), "reference"),
    # then XBM, MSP, SPIDER (its floats kept as stored: "stored"), BLP,
    # SUN and XPM (tests/test_torch_image_formats_pil_more.py holds each
    # kind) and DIB
    "xbm": (".xbm", lambda: _bilevel("XBM"), "convert"),
    "msp": (".msp", lambda: _bilevel("MSP"), "convert"),
    "spider": (".spi", lambda: _other("SPIDER"), "stored"),
    "blp": (".blp", lambda: _other_p("BLP"), "reference"),
    "sun": (".ras", lambda: tiw.sun_file(_scene(37, 23), 24, rle=True),
            "reference"),
    "xpm": (".xpm", lambda: tiw.xpm_file(_scene(37, 23)[..., 0] // 32,
                                         _scene(8, 1)[0]), "convert"),
    "dib": (".dib", lambda: _other("DIB"), "reference"),
}


@pytest.mark.parametrize("case", sorted(NOW_READ))
def test_formerly_unread_formats_now_read(tmp_path, case):
    ext, make, rule = NOW_READ[case]
    path = tmp_path / f"t{ext}"
    path.write_bytes(make())
    lin, attrs = timage.read_image(str(path))
    assert attrs == {} and lin.dtype == np.float32
    if rule == "reference":
        assert np.array_equal(lin, jimage.read_image(str(path))[0])
    elif rule == "stored":
        px = np.asarray(Image.open(path), np.float32)[..., None]
        assert np.array_equal(lin, np.repeat(px, 3, axis=2))
    else:
        rgb = np.asarray(Image.open(path).convert("RGB"))
        assert np.array_equal(lin, _linear(rgb))
