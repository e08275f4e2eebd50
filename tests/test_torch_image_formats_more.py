"""The port's GIF, QOI, netpbm, JPEG (CMYK / YCCK, RGB-coded, other sampling,
arithmetic-coded, lossless), TGA and BMP readers
(acceleratedvolrenderer_tpu_torch/utils/image.py) against the
reference's read_image, which opens the file with PIL.  Files come from
PIL and, where PIL cannot write them, from tests/torch_image_writers.py's
writers (JPEG of any sampling, colour space and markers; GIF; QOI;
netpbm) or hand-built bytes (TGA colour maps, BMP RLE and 16-bit).

Bit for bit with the reference where PIL returns the image's colours: QOI,
netpbm at maxval 255 (and below, scaled as PIL scales), a GIF PIL opens as
gray, 16-bit TGA, 16-bit BMP, and the JPEG kinds (RGB-coded, every
integer sampling ratio, which libjpeg-turbo upsamples fancy for 2x1, 1x2
and 2x2 and by replication otherwise; arithmetic-coded sequential and
progressive, and 8-bit lossless, which the libjpeg-turbo under PIL here
reads, from the writers' files).  Otherwise the colours, held to
PIL's convert() or the written samples (ROADMAP Queue 3): GIF and
colour-mapped TGA palettes expanded (PIL: the indices), a CMYK or YCCK
JPEG's inks as PIL's convert("RGB"), a bilevel PBM as 0 / 255 (PIL:
booleans), 16-bit netpbm samples over 65535 (PIL: raw gray values, or RGB
rounded to 8 bits), RLE BMP palettes expanded.
"""
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.utils import image as timage

import torch_image_writers as tiw


def _linear(u8, top=255.0):
    x = u8.astype(np.float32) / np.float32(top)
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _rgb(x):
    return np.repeat(x, 3, 2) if x.shape[2] == 1 else x[..., :3]


def _path(tmp_path, data, ext):
    p = tmp_path / f"t{ext}"
    p.write_bytes(data)
    return str(p)


def _same_as_reference(path):
    got, attrs = timage.read_image(path)
    assert attrs == {} and got.dtype == np.float32
    assert np.array_equal(got, jimage.read_image(path)[0])


# ---------------------------------------------------------------- GIF

GIF = {"plain": {}, "interlaced": dict(interlace=True),
       "transparent": dict(transparent=3),
       "offset_frame": dict(screen=(50, 40), offset=(5, 7)),
       "offset_transparent": dict(screen=(50, 40), offset=(5, 7),
                                  transparent=2)}


@pytest.mark.parametrize("case", sorted(GIF))
def test_gif_reads_colours(tmp_path, case):
    """PIL opens a GIF as palette indices (the reference reads them as
    gray); the port the palette's colours, held to convert("RGB")."""
    px = tiw.scene(37, 23)
    pal = np.random.default_rng(1).integers(0, 256, (16, 3), np.uint8)
    kw = GIF[case]
    path = _path(tmp_path, tiw.encode_gif((px[..., 0] >> 4).astype(np.uint8),
                                          pal, **kw), ".gif")
    im = Image.open(path)
    want = np.asarray(im.convert("RGBA" if "transparent" in kw else "RGB"))
    assert np.array_equal(timage.decode_gif(open(path, "rb").read()), want)
    assert np.array_equal(timage.read_image(path)[0], _linear(want[..., :3]))


@pytest.mark.parametrize("mode", ["RGB", "P", "1"])
def test_gif_written_by_pil(tmp_path, mode):
    img = Image.fromarray(tiw.scene(300, 200)).convert(mode)
    path = str(tmp_path / "t.gif")
    img.save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(timage.read_image(path)[0], _linear(want))
    if Image.open(path).mode == "L":        # a gray GIF: PIL's colours
        _same_as_reference(path)


# ---------------------------------------------------------------- QOI

@pytest.mark.parametrize("source", ["pil", "writer"])
@pytest.mark.parametrize("channels", [3, 4])
def test_qoi_matches_reference(tmp_path, channels, source):
    px = tiw.scene(300, 200)
    if channels == 4:
        px = np.concatenate([px, (px[..., :1] // 3 + 90)], -1)
    if source == "pil":
        b = io.BytesIO()
        Image.fromarray(px).save(b, "QOI")
        data = b.getvalue()
    else:
        data = tiw.encode_qoi(px)
    path = _path(tmp_path, data, ".qoi")
    assert np.array_equal(timage.decode_qoi(data), px)
    _same_as_reference(path)


def test_read_qoi_reads_write_qoi_like_reference(tmp_path):
    """write_qoi's index starts opaque black, so black after a colour is
    written as index op 53; read_qoi starts its index the same way (as the
    reference's does), and later diff, luma and index ops stay right."""
    colour, black, dark = (200, 100, 50), (0, 0, 0), (1, 0, 1)
    row = np.array([colour, black, dark, colour, dark, black, colour, dark,
                    (9, 4, 6), dark], np.uint8)[None]
    path = str(tmp_path / "t.qoi")
    timage.write_qoi(path, row / np.float32(255), linear_input=False)
    data = Path(path).read_bytes()
    assert 53 in data[14:-8]
    for to_linear in (False, True):
        got = timage.read_qoi(path, to_linear)
        assert np.array_equal(got, jimage.read_qoi(path, to_linear))
    assert np.array_equal(np.round(timage.read_qoi(path, False) * 255), row)
    # qoi.h's zeroed index (read_image's, as PIL's) reads index op 53 as
    # transparent black
    assert not np.array_equal(timage.decode_qoi(data)[..., :3], row)


# ---------------------------------------------------------------- netpbm

@pytest.mark.parametrize("plain", [False, True], ids=["binary", "ascii"])
@pytest.mark.parametrize("maxval", [255, 1, 7, 100, 254])
@pytest.mark.parametrize("kind", ["ppm", "pgm"])
def test_netpbm_8bit_matches_reference(tmp_path, kind, maxval, plain):
    px = tiw.scene(37, 23).astype(np.int64) * maxval // 255
    if kind == "pgm":
        px = px[..., 0]
    path = _path(tmp_path, tiw.encode_netpbm(px, maxval, plain), "." + kind)
    _same_as_reference(path)


@pytest.mark.parametrize("plain", [False, True], ids=["binary", "ascii"])
def test_pbm_reads_white_as_one(tmp_path, plain):
    bits = tiw.scene(37, 23)[..., 0] > 120
    path = _path(tmp_path, tiw.encode_netpbm(bits, plain=plain), ".pbm")
    gray = np.asarray(Image.open(path).convert("L"))
    assert np.array_equal(timage.read_image(path)[0],
                          _rgb(_linear(gray)[..., None]))


@pytest.mark.parametrize("maxval", [256, 1000, 65535])
@pytest.mark.parametrize("kind", ["ppm", "pgm"])
def test_netpbm_16bit_scaled(tmp_path, kind, maxval):
    """Samples over 255: the port reads v / maxval at 16 bits (rounded to
    65535ths as PIL rounds its gray ones), where the reference divides
    PIL's raw gray values by 255 or reads RGB rounded to 8 bits."""
    px = tiw.scene(37, 23).astype(np.int64) * maxval // 255
    if kind == "pgm":
        px = px[..., :1]
    path = _path(tmp_path, tiw.encode_netpbm(px, maxval), "." + kind)
    q = np.round(px / maxval * 65535)
    assert np.array_equal(timage.read_image(path)[0],
                          _rgb(_linear(q, 65535.0)))
    if kind == "pgm":                       # PIL's rounding, to 65535ths
        assert np.array_equal(np.asarray(Image.open(path)), q[..., 0])


def test_netpbm_by_extension_and_comments(tmp_path):
    px = tiw.scene(9, 5)
    data = b"P6 # a comment\n9 # width\n5\n255\n" + px.tobytes()
    path = _path(tmp_path, data, ".ppm")
    _same_as_reference(path)


# ---------------------------------------------------------------- JPEG

SAMPLING = {"h1v2": ((1, 2), (1, 1), (1, 1)), "h4v1": ((4, 1), (1, 1), (1, 1)),
            "h4v2": ((4, 2), (1, 1), (1, 1)), "h3v1": ((3, 1), (1, 1), (1, 1)),
            "h1v4": ((1, 4), (1, 1), (1, 1)), "h2v2_mixed": ((2, 2), (2, 1),
                                                            (1, 2)),
            "chroma_larger": ((1, 1), (2, 2), (1, 1)),
            "h2v1": ((2, 1), (1, 1), (1, 1))}


@pytest.mark.parametrize("size", [(37, 23), (300, 200), (2, 9)])
@pytest.mark.parametrize("case", sorted(SAMPLING))
def test_jpeg_sampling_matches_reference(tmp_path, case, size):
    data = tiw.encode_jpeg(tiw.scene(*size), SAMPLING[case])
    path = _path(tmp_path, data, ".jpg")
    ref = np.asarray(Image.open(path))
    assert np.array_equal(timage.decode_jpeg(data), ref)
    _same_as_reference(path)


RGB_CODED = {"adobe_0": dict(adobe=0, jfif=False),
             "ids_rgb": dict(jfif=False, ids=[82, 71, 66])}


@pytest.mark.parametrize("case", sorted(RGB_CODED))
def test_rgb_coded_jpeg_matches_reference(tmp_path, case):
    data = tiw.encode_jpeg(tiw.scene(37, 23), ((1, 1),) * 3, space="rgb",
                           **RGB_CODED[case])
    _same_as_reference(_path(tmp_path, data, ".jpg"))


def test_jfif_wins_over_adobe_and_ids(tmp_path):
    """libjpeg-turbo takes YCbCr when a JFIF marker is present, whatever an
    Adobe marker or the ids say; YCbCr again without any marker or ids."""
    for kw in (dict(jfif=True, adobe=0), dict(jfif=True, ids=[82, 71, 66]),
               dict(jfif=False, adobe=1), dict(jfif=False)):
        data = tiw.encode_jpeg(tiw.scene(37, 23), **kw)
        _same_as_reference(_path(tmp_path, data, ".jpg"))


CMYK = {"pil_444": ("pil", 0), "pil_420": ("pil", 2),
        "adobe_cmyk": ("cmyk", dict(adobe=0)),
        "no_marker_cmyk": ("cmyk", dict(jfif=False)),
        "ycck": ("ycck", dict(adobe=2, jfif=False)),
        "ycck_subsampled": ("ycck", dict(adobe=2, jfif=False,
                                         sampling=((2, 2), (1, 1), (1, 1),
                                                   (2, 2))))}


@pytest.mark.parametrize("case", sorted(CMYK))
def test_cmyk_jpeg_converted_as_pil(tmp_path, case):
    """PIL returns the C, M, Y inks (the reference reads them as R, G, B);
    the port converts as PIL's convert("RGB")."""
    kind, kw = CMYK[case]
    px = tiw.scene(37, 23)
    if kind == "pil":
        b = io.BytesIO()
        Image.fromarray(px).convert("CMYK").save(b, "JPEG", quality=90,
                                                 subsampling=kw)
        data = b.getvalue()
    else:
        kw = dict(kw)
        samp = kw.pop("sampling", ((1, 1),) * 4)
        data = tiw.encode_jpeg(np.concatenate([px, px[..., :1] // 3], -1),
                               samp, space=kind, **kw)
    path = _path(tmp_path, data, ".jpg")
    assert Image.open(path).mode == "CMYK"
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(timage.decode_jpeg(data), want)
    assert np.array_equal(timage.read_image(path)[0], _linear(want))


ARITH = {"seq_420": {}, "seq_444": dict(sampling=((1, 1),) * 3),
         "seq_restart": dict(restart=5),
         "seq_dac": dict(dac={(0, 0): 0x52, (0, 1): 0x31, (1, 0): 2,
                              (1, 1): 9}),
         "progressive": dict(progressive=True),
         "progressive_restart": dict(progressive=True, restart=7),
         "progressive_422": dict(progressive=True,
                                 sampling=((2, 1), (1, 1), (1, 1)))}


@pytest.mark.parametrize("case", sorted(ARITH))
def test_arithmetic_jpeg_matches_reference(tmp_path, case):
    """Arithmetic-coded (SOF9, SOF10), which libjpeg-turbo here reads:
    files from torch_image_writers.encode_jpeg_arith (libjpeg's jcarith.c
    coder), whose PIL decode is the source to 24 dB."""
    px = tiw.scene(37, 23)
    data = tiw.encode_jpeg_arith(px, **ARITH[case])
    path = _path(tmp_path, data, ".jpg")
    ref = np.asarray(Image.open(path))
    assert 10 * np.log10(255 ** 2 / np.mean((ref - px.astype(float)) ** 2)) \
        > 24
    assert np.array_equal(timage.decode_jpeg(data), ref)
    _same_as_reference(path)


def test_arithmetic_gray_progressive_and_garbage_match_reference(tmp_path):
    """A gray progressive file, and a Huffman stream under an SOF9 marker,
    which libjpeg decodes (warning) to what the port decodes."""
    data = tiw.encode_jpeg_arith(tiw.scene(37, 23)[..., :1],
                                 progressive=True)
    _same_as_reference(_path(tmp_path, data, ".jpg"))
    _same_as_reference(_path(tmp_path, tiw.patch_sof(tiw.pil_jpeg(), 0xC9),
                             ".jpeg"))


LOSSLESS = {f"predictor{p}": dict(predictor=p) for p in range(1, 8)}
LOSSLESS.update({"point_transform": dict(predictor=4, pt=2),
                 "restart": dict(predictor=6, restart_rows=5),
                 "ids_rgb": dict(predictor=7, ids=[82, 71, 66]),
                 "adobe_rgb": dict(predictor=1, adobe=0)})


@pytest.mark.parametrize("case", sorted(LOSSLESS))
def test_lossless_jpeg_matches_reference(tmp_path, case):
    """8-bit lossless (SOF3), which libjpeg-turbo here reads (as RGB unless
    a marker says YCbCr, which it refuses): the source samples exactly
    (less the point transform's bits)."""
    px = tiw.scene(37, 23)
    kw = LOSSLESS[case]
    path = _path(tmp_path, tiw.encode_jpeg_lossless(px, **kw), ".jpg")
    pt = kw.get("pt", 0)
    assert np.array_equal(np.asarray(Image.open(path)), px >> pt << pt)
    _same_as_reference(path)


def test_lossless_gray_jpeg_matches_reference(tmp_path):
    data = tiw.encode_jpeg_lossless(tiw.scene(37, 23)[..., :1], predictor=5)
    _same_as_reference(_path(tmp_path, data, ".jpg"))


# ---------------------------------------------------------------- TGA

def _tga(px_bytes, w, h, itype, depth, cmap=None, cm_depth=0, cm_first=0,
         desc=0x20):
    cm = b"" if cmap is None else cmap
    n = 0 if cmap is None else len(cmap) // (cm_depth // 8)
    head = struct.pack("<BBBHHBHHHHBB", 0, 1 if cmap is not None else 0,
                       itype, cm_first, n, cm_depth, 0, 0, w, h, depth, desc)
    return head + cm + px_bytes


def _rle(rows, bpp):
    """TGA RLE packets: runs of equal pixels, raw packets otherwise."""
    flat = rows.reshape(-1, bpp)
    out = bytearray()
    i = 0
    while i < len(flat):
        j = i + 1
        while j < len(flat) and j - i < 128 and (flat[j] == flat[i]).all():
            j += 1
        if j - i > 1:
            out += bytes([0x80 | (j - i - 1)]) + flat[i].tobytes()
        else:
            out += bytes([0]) + flat[i].tobytes()
        i = j
    return bytes(out)


TGA_MAPS = {"map24": 24, "map16": 16}


@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
@pytest.mark.parametrize("case", sorted(TGA_MAPS))
def test_colour_mapped_tga_expanded(tmp_path, case, rle):
    """PIL opens a colour-mapped TGA as its indices (the reference reads
    them as gray); the port the map's colours, held to convert("RGB")."""
    depth = TGA_MAPS[case]
    rng = np.random.default_rng(4)
    idx = (tiw.scene(37, 23)[..., 0] >> 3).astype(np.uint8) + 3
    n = 40
    if depth == 16:
        cmap = rng.integers(0, 1 << 16, n).astype("<u2").tobytes()
    else:
        cmap = rng.integers(0, 256, (n, depth // 8), np.uint8).tobytes()
    body = _rle(idx[::-1], 1) if rle else idx[::-1].tobytes()
    path = _path(tmp_path, _tga(body, 37, 23, 9 if rle else 1, 8, cmap,
                                depth, cm_first=0, desc=0), ".tga")
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(timage.read_image(path)[0], _linear(want))


@pytest.mark.parametrize("rle", [False, True], ids=["raw", "rle"])
def test_16bit_tga_matches_reference(tmp_path, rle):
    v = np.random.default_rng(5).integers(0, 1 << 16, (23, 37)).astype("<u2")
    v[4:9, 2:30] = 0x7FFF
    rows = v.view(np.uint8).reshape(23, 37, 2)
    body = _rle(rows, 2) if rle else rows.tobytes()
    path = _path(tmp_path, _tga(body, 37, 23, 10 if rle else 2, 16), ".tga")
    _same_as_reference(path)


@pytest.mark.parametrize("case", ["15bit", "map15", "map32"])
def test_tga_kinds_pil_refuses_raise(tmp_path, case):
    """A 15-bit true-colour TGA and a 15-bit map PIL refuses to open; an
    image through a 32-bit map it opens and fails to load."""
    if case == "15bit":
        data = _tga(b"\0" * 2 * 8 * 4, 8, 4, 2, 15)
        words = "15-bit true-color TGA"
    else:
        depth = int(case[3:])
        data = _tga(b"\0" * 32, 8, 4, 1, 8, b"\0" * 4 * (depth // 8),
                    depth)
        words = f"{depth}-bit entries"
    with pytest.raises(ValueError, match=words):
        timage.read_image(_path(tmp_path, data, ".tga"))


# ---------------------------------------------------------------- BMP

@pytest.mark.parametrize("kind", ["rle8", "rle4"])
def test_rle_bmp_expanded(tmp_path, kind):
    rng = np.random.default_rng(6)
    n = 256 if kind == "rle8" else 16
    idx = (tiw.scene(37, 23)[..., 0] // (256 // n)).astype(np.uint8)
    idx[3:6, 4:30] = 5                          # runs
    if kind == "rle4":                          # runs of equal pairs
        idx[10:13] = np.where(np.arange(37) % 2, 3, 7)
    pal = np.concatenate([rng.integers(0, 256, (n, 3), np.uint8),
                          np.zeros((n, 1), np.uint8)], 1).tobytes()
    body = tiw.rle8(idx) if kind == "rle8" else tiw.rle4(idx)
    bpp, comp = (8, 1) if kind == "rle8" else (4, 2)
    path = _path(tmp_path, tiw.bmp_file(body, 37, 23, bpp, comp, pal), ".bmp")
    want = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(timage.read_image(path)[0], _linear(want))


@pytest.mark.parametrize("case", ["555", "bitfields_565", "bitfields_555"])
def test_16bit_bmp_matches_reference(tmp_path, case):
    v = np.random.default_rng(7).integers(0, 1 << 16, (23, 37)).astype("<u2")
    if case != "bitfields_565":
        v &= 0x7FFF
    stride = (37 * 2 + 3) // 4 * 4
    body = b"".join(r.tobytes() + b"\0" * (stride - 74) for r in v)
    masks = {"555": b"", "bitfields_565": struct.pack(
        "<III", 0xF800, 0x7E0, 0x1F), "bitfields_555": struct.pack(
        "<III", 0x7C00, 0x3E0, 0x1F)}[case]
    path = _path(tmp_path, tiw.bmp_file(body, 37, 23, 16, 3 if masks else 0,
                                masks=masks), ".bmp")
    _same_as_reference(path)


def test_decode_timer_runs_small(monkeypatch, capsys):
    """scripts/time_image_decode.py end to end at 64x32 (chip_smoke phase 32
    (d) calls its time_formats at 2048x1024): every decode equal to its
    source."""
    import time_image_decode as tid

    records = tid.time_formats(64, 32, reps=1)
    assert len(records) == 6 and all(ok for *_, ok in records)
    monkeypatch.setattr(sys, "argv", ["time_image_decode.py", "--width",
                                      "64", "--height", "32"])
    tid.main()
    out = capsys.readouterr().out
    assert out.startswith("host CPU: ") and "WRONG" not in out
