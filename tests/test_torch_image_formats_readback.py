"""The port's PCX, SGI, IM, DDS and DIB readers (utils/image_read.py,
utils/image.py's decode_dib, through
utils/image.py's read_image) against PIL, which the reference's
read_image uses, on the files write_png now writes and their other kinds:
PIL's own files in every mode it writes each format in (L, P, RGB and
RGBA, and 1 and LA where it writes them), and files PIL does not write
(RLE and 16-bit SGI, 1-bit PCX, DDS of other bit masks and a DX10 header,
IM with a lookup table, DIB under 12-, 40-, 108- and 124-byte headers)
from tests/torch_image_writers.py or built here.
The samples equal PIL's (palettes and 1-bit expanded to colours, as
PIL's convert gives them), and read_image equals the reference's where
PIL hands the reference colours (L, RGB, RGBA), else the linearised
colours.  PIL's block-compressed DDS files (DXT1, DXT3, DXT5, BC3, BC5)
are read too (tests/test_torch_image_formats_bcn.py holds every kind).
"""
import io
import struct

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.utils import image as timage
from acceleratedvolrenderer_tpu_torch.utils import image_read

import torch_image_writers as tiw

SIZES = [(37, 23), (2, 3)]


def _pixels(w, h, seed=0):
    """RGBA samples with runs (the left third one colour) and noise."""
    a = np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)
    a[:, : w // 3] = a[0, 0]
    return a


def _pil_image(mode, w, h):
    a = _pixels(w, h)
    if mode == "P":
        return Image.fromarray(a[..., :3]).convert(
            "P", palette=Image.ADAPTIVE, colors=40)
    if mode == "1":
        return Image.fromarray(a[..., 0]).convert("1")
    return Image.fromarray({"L": a[..., 0], "LA": a[..., :2],
                            "RGB": a[..., :3], "RGBA": a}[mode], mode)


def _pil_samples(data):
    """PIL's samples of a file, (H, W, C): colours for palette and 1-bit
    images."""
    im = Image.open(io.BytesIO(data))
    if im.mode == "P":
        im = im.convert("RGB")
    elif im.mode == "1":
        im = im.convert("L")
    a = np.asarray(im)
    return a[..., None] if a.ndim == 2 else a


def _linear(u8):
    x = u8.astype(np.float32) / 255.0
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _check(tmp_path, data, ext, decode):
    """decode equals PIL's samples; read_image equals the reference's where
    PIL gives it colours, else the linearised colours."""
    want = _pil_samples(data)
    got = decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    path = tmp_path / f"t{ext}"
    path.write_bytes(data)
    lin, attrs = timage.read_image(str(path))
    assert attrs == {} and lin.dtype == np.float32
    mode = Image.open(path).mode
    if mode in ("L", "RGB", "RGBA"):
        assert np.array_equal(lin, jimage.read_image(str(path))[0])
    else:
        rgb = np.asarray(Image.open(path).convert("RGB"))
        assert np.array_equal(lin, _linear(rgb))


PIL_WRITTEN = {"PCX": ("1", "L", "P", "RGB"), "SGI": ("L", "RGB", "RGBA"),
               "IM": ("1", "L", "LA", "P", "RGB", "RGBA"),
               "DDS": ("L", "LA", "RGB", "RGBA")}
DECODERS = {"PCX": (".pcx", image_read.decode_pcx),
            "SGI": (".sgi", image_read.decode_sgi),
            "IM": (".im", image_read.decode_im),
            "DDS": (".dds", image_read.decode_dds)}


@pytest.mark.parametrize("size", SIZES, ids=["37x23", "2x3"])
@pytest.mark.parametrize("fmt,mode", [(f, m) for f in sorted(PIL_WRITTEN)
                                      for m in PIL_WRITTEN[f]])
def test_pil_written_files(tmp_path, fmt, mode, size):
    b = io.BytesIO()
    _pil_image(mode, *size).save(b, fmt)
    ext, decode = DECODERS[fmt]
    _check(tmp_path, b.getvalue(), ext, decode)


@pytest.mark.parametrize("rle", [False, True], ids=["verbatim", "rle"])
@pytest.mark.parametrize("bpc", [1, 2], ids=["8bit", "16bit"])
@pytest.mark.parametrize("z", [1, 3, 4])
def test_sgi_rle_and_16bit(tmp_path, z, bpc, rle):
    """PIL keeps a 16-bit sample's high byte; RLE rows of runs and copies,
    1, 3 and 4 channels."""
    a = _pixels(37, 23, seed=z)[..., :z]
    if bpc == 2:
        a = a.astype(np.uint16) * 257 + np.random.default_rng(9).integers(
            0, 256, a.shape).astype(np.uint16)
    _check(tmp_path, tiw.sgi_file(a, rle=rle, bpc=bpc, name=b"t"), ".sgi",
           image_read.decode_sgi)


@pytest.mark.parametrize("size", [(37, 23), (16, 5), (3, 2)],
                         ids=["37x23", "16x5", "3x2"])
def test_pcx_1bit(tmp_path, size):
    bits = (_pixels(*size, seed=4)[..., 0] > 100).astype(np.uint8)
    _check(tmp_path, tiw.pcx_1bit(bits), ".pcx", image_read.decode_pcx)


def _dds(px_bytes, w, h, flags, bitcount, masks, fourcc=0, dx10=None):
    head = (b"DDS " + struct.pack("<7I", 124, 0x100F, h, w, 0, 0, 0)
            + b"\0" * 44 + struct.pack("<4I", 32, flags, fourcc, bitcount)
            + struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0,
                                                       0, 0))
    if dx10 is not None:
        head += struct.pack("<5I", dx10, 3, 0, 1, 0)
    return head + px_bytes


def _dds_packed(bitcount, masks, alpha):
    """A DDS of 37x23 random words under the bit masks (R, G, B, A)."""
    v = np.random.default_rng(bitcount).integers(
        0, 1 << bitcount, 37 * 23, dtype=np.uint64)
    raw = v.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :bitcount // 8]
    return _dds(raw.tobytes(), 37, 23, 0x40 | (1 if alpha else 0), bitcount,
                masks)


DDS_CRAFTED = {
    "rgb565": lambda: _dds_packed(16, (0xF800, 0x7E0, 0x1F, 0), False),
    "argb4444": lambda: _dds_packed(16, (0xF00, 0xF0, 0xF, 0xF000), True),
    "bgrx32": lambda: _dds_packed(32, (0xFF, 0xFF00, 0xFF0000, 0), False),
    "abgr32": lambda: _dds_packed(32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                                  True),
    "bgr24": lambda: _dds_packed(24, (0xFF, 0xFF00, 0xFF0000, 0), False),
    "dx10_rgba8": lambda: _dds(_pixels(37, 23).tobytes(), 37, 23, 0x4, 0,
                               (0, 0, 0, 0), fourcc=0x30315844, dx10=28),
}


@pytest.mark.parametrize("case", sorted(DDS_CRAFTED))
def test_dds_masks_and_dx10(tmp_path, case):
    _check(tmp_path, DDS_CRAFTED[case](), ".dds", image_read.decode_dds)


def _im_with_lut(lut):
    """An L IM file of 37x23 with the lookup table lut (256, 3)."""
    px = _pixels(37, 23)[..., 0]
    head = (b"Image type: Greyscale image\r\nName: t.im\r\n"
            b"Image size (x*y): 37*23\r\nFile size (no of images): 1\r\n"
            b"Lut: 1\r\n")
    head += b"\0" * (511 - len(head)) + b"\x1a"
    return head + lut.T.astype(np.uint8).tobytes() + px[::-1].tobytes()


IM_LUTS = {
    "colour": lambda: np.random.default_rng(3).integers(0, 256, (256, 3)),
    "gray_inverted": lambda: np.repeat(255 - np.arange(256)[:, None], 3, 1),
}


@pytest.mark.parametrize("case", sorted(IM_LUTS))
def test_im_lookup_tables(tmp_path, case):
    """A colour table makes PIL's P (colours); a gray one PIL ignores."""
    _check(tmp_path, _im_with_lut(IM_LUTS[case]()), ".im",
           image_read.decode_im)


BLOCK_COMPRESSED = {
    "DXT1": dict(pixel_format="DXT1"), "DXT3": dict(pixel_format="DXT3"),
    "DXT5": dict(pixel_format="DXT5"), "BC3": dict(pixel_format="BC3"),
    "BC5": dict(pixel_format="BC5"),
}


@pytest.mark.parametrize("name", sorted(BLOCK_COMPRESSED))
def test_block_compressed_dds_read(tmp_path, name):
    """PIL's DXT / BCn files (DX10 headers for BC3 and BC5), which raised
    until the block decoders came: PIL's samples, the reference's
    read_image."""
    b = io.BytesIO()
    Image.fromarray(_pixels(8, 8)[..., :3]).save(b, "DDS",
                                                 **BLOCK_COMPRESSED[name])
    _check(tmp_path, b.getvalue(), ".dds", image_read.decode_dds)


def _dib_case(hsize, bpp, masks=None, n_colours=None, seed=0):
    px = _pixels(37, 23, seed)
    if bpp <= 8:
        n = n_colours or 1 << bpp
        pal = np.random.default_rng(seed + 1).integers(0, 256, (n, 3))
        idx = px[..., 0].astype(np.int64) % n
        return tiw.dib_file(idx, bpp, hsize, palette=pal)
    return tiw.dib_file(px[..., :3], bpp, hsize, masks=masks)


DIB_CASES = {
    "core12_8bit": lambda: _dib_case(12, 8),
    "core12_24bit": lambda: _dib_case(12, 24, seed=1),
    "core12_1bit": lambda: _dib_case(12, 1, seed=2),
    "info40_4bit_12_colours": lambda: _dib_case(40, 4, n_colours=12, seed=3),
    "info40_24bit": lambda: _dib_case(40, 24, seed=4),
    "info40_bitfields565": lambda: _dib_case(40, 16, (0xF800, 0x7E0, 0x1F),
                                             seed=5),
    "v4_108_24bit": lambda: _dib_case(108, 24, seed=6),
    "v4_108_bitfields555": lambda: _dib_case(108, 16, (0x7C00, 0x3E0, 0x1F),
                                             seed=7),
    "v5_124_8bit_100_colours": lambda: _dib_case(124, 8, n_colours=100,
                                                 seed=8),
    "v5_124_bitfields_bgrx": lambda: _dib_case(
        124, 32, (0xFF0000, 0xFF00, 0xFF), seed=9),
}


@pytest.mark.parametrize("case", sorted(DIB_CASES))
def test_dib_read_back(tmp_path, case):
    """DIBs (PIL's DibImageFile: the header size at offset 0) of each
    header size: PIL's samples, the reference's read_image."""
    _check(tmp_path, DIB_CASES[case](), ".dib", timage.decode_dib)
