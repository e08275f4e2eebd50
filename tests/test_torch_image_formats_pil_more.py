"""The port's XBM, MSP, SPIDER, BLP, SUN raster and XPM readers
(utils/image_read_more.py, through utils/image.py's read_image) against
PIL 12.1.0, which the reference's read_image uses, on the same bytes.

Files: PIL's own XBM, MSP (version 1), SPIDER and BLP (BLP1 and BLP2 with
a palette, the only kinds PIL writes), and, from the writers of
tests/torch_image_writers.py, what PIL does not write: XBM with a hotspot
or odd hex, MSP version 2 (runs, literals, blank rows), SPIDER in either
byte order and stacks, BLP1 with a palette and alpha or JPEG (YCbCr, gray,
CMYK), BLP2 with a palette at alpha depths 0, 1, 4 and 8 and DXT1 / DXT3
/ DXT5 blocks (random bytes as blocks, and widths that are not multiples
of 4, which PIL lays out sheared), SUN at depths 1, 4, 8, 24 and 32, raw
(types 1 and 3) and run-length coded (type 2), and XPM of 1 and 2
characters per pixel, over 256 colours and with a `c None` entry.

The samples equal PIL's, with the rule of the port's readers: where PIL
gives booleans (mode 1) or palette indices (mode P) the port gives the
colours PIL's convert gives (0 / 255, the palette's); a float SPIDER
image is kept as stored.  read_image equals the reference's where PIL
hands the reference colours (L, RGB, RGBA); elsewhere each test states
the reference's value (booleans or indices over 255, linearised; a float
image over 255, linearised) beside the port's (the colours linearised;
the floats as stored).  What PIL refuses, the port refuses with a
ValueError naming the format and what it refuses.  The committed fixtures
(images.json entries read by utils/image_read_more.py) decode to the
recorded SHA-256 of PIL's samples.
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
from acceleratedvolrenderer_tpu_torch.utils import image_read_more as more

import torch_image_writers as tiw

FIXTURES = Path(__file__).resolve().parent / "data" / "images"


def _rng(seed=0):
    return np.random.default_rng(seed)


def _linear(x):
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def _pil_colours(data):
    """PIL's samples of a file, (H, W, C), under the port's rule: colours
    for mode 1 and P; and PIL's mode."""
    im = Image.open(io.BytesIO(data))
    mode = im.mode
    if mode == "1":
        im = im.convert("L")
    elif mode == "P":
        im = im.convert("RGB")
    a = np.asarray(im)
    return (a[..., None] if a.ndim == 2 else a), mode


def _check(tmp_path, data, ext, decode):
    """decode equals PIL's samples (colours); read_image equals the
    reference's where PIL gives it colours, else the stated difference."""
    want, mode = _pil_colours(data)
    got = decode(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    path = tmp_path / f"t{ext}"
    path.write_bytes(data)
    lin, attrs = timage.read_image(str(path))
    assert attrs == {} and lin.dtype == np.float32
    ref = jimage.read_image(str(path))[0]
    rgb = np.repeat(want, 3, axis=2) if want.shape[2] == 1 else want[..., :3]
    if mode in ("L", "RGB", "RGBA"):
        assert np.array_equal(lin, ref)
    elif mode == "F":
        # the port: the floats as stored; the reference: over 255, linearised
        assert np.array_equal(lin, rgb)
        assert np.array_equal(ref, _linear(rgb / np.float32(255.0)))
    else:
        # the port: the colours, linearised; the reference: the booleans
        # (mode 1) or the palette indices (mode P) over 255, linearised
        assert np.array_equal(lin, _linear(rgb.astype(np.float32) / 255.0))
        raw = np.asarray(Image.open(path), np.float32)[..., None] / 255.0
        assert np.array_equal(ref, _linear(np.repeat(raw, 3, axis=2)))
    return got


def _refused(tmp_path, data, ext, words):
    """PIL cannot open or load the file; the port raises ValueError with
    words."""
    path = tmp_path / f"t{ext}"
    path.write_bytes(data)
    with pytest.raises(Exception):
        Image.open(path).load()
    with pytest.raises(ValueError, match=words):
        timage.read_image(str(path))


def _bits(w, h, seed=0):
    b = _rng(seed).integers(0, 2, (h, w), np.uint8)
    b[: h // 3, : w // 2] = 1                   # runs
    return b


def _pil_file(im, fmt, **kw):
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


# ---------------------------------------------------------------- XBM

XBM = {
    "pil": lambda: _pil_file(Image.fromarray(_bits(37, 23) * 255).convert(
        "1"), "XBM"),
    "pil_hotspot": lambda: _pil_file(Image.fromarray(
        _bits(16, 5, 1) * 255).convert("1"), "XBM", hotspot=(3, 2)),
    "upper_hex": lambda: tiw.xbm_file(_bits(9, 7, 2), name="a_b",
                                      per_line=5, upper=True),
    "hotspot": lambda: tiw.xbm_file(_bits(8, 8, 3), hotspot=(1, 7)),
    "one_pixel": lambda: tiw.xbm_file(np.ones((1, 1), np.uint8)),
    # a one-digit byte takes the next character too (',' counts 0), and
    # an 'x' in a comment starts a byte
    "odd_hex": lambda: (b"#define t_width 12\n#define t_height 2\n"
                        b"static char t_bits[] = {\n0x5, 0xf0,/*x1f*/ 0xa3 "
                        b"};\n"),
}


@pytest.mark.parametrize("case", sorted(XBM))
def test_xbm(tmp_path, case):
    _check(tmp_path, XBM[case](), ".xbm", more.decode_xbm)


def test_xbm_refused(tmp_path):
    """No _bits[] in the first 512 bytes: PIL finds no format."""
    data = (b"#define t_width 8\n#define t_height 1\n" + b" " * 512
            + b"static char t_bits[] = { 0x01 };\n")
    _refused(tmp_path, data, ".xbm", "XBM: no width and height")


# ---------------------------------------------------------------- MSP

MSP = {
    "pil_v1": lambda: _pil_file(Image.fromarray(_bits(37, 23) * 255).convert(
        "1"), "MSP"),
    "v1": lambda: tiw.msp_v1(_bits(16, 5, 1)),
    "v2": lambda: tiw.msp_v2(_bits(37, 23, 2)),
    "v2_blank_rows": lambda: tiw.msp_v2(_bits(20, 9, 3), blank=(0, 4, 8)),
    "v2_long_runs": lambda: tiw.msp_v2(np.ones((3, 2100), np.uint8)),
}


@pytest.mark.parametrize("case", sorted(MSP))
def test_msp(tmp_path, case):
    _check(tmp_path, MSP[case](), ".msp", more.decode_msp)


def test_msp_refused(tmp_path):
    data = bytearray(tiw.msp_v1(_bits(16, 5)))
    data[24] ^= 1                               # the checksum fails
    _refused(tmp_path, bytes(data), ".msp", "MSP: bad header checksum")


# ---------------------------------------------------------------- SPIDER


def _floats(w, h, seed=0):
    return _rng(seed).normal(0, 40, (h, w)).astype(np.float32)


SPIDER = {
    "pil": lambda: _pil_file(Image.fromarray(_floats(37, 23), "F"),
                             "SPIDER"),
    "big_endian": lambda: tiw.spider_file(_floats(16, 5, 1)),
    "little_endian": lambda: tiw.spider_file(_floats(300, 3, 2),
                                             big_endian=False),
    "stack_first_image": lambda: tiw.spider_file([_floats(9, 7, 3),
                                                  _floats(9, 7, 4)]),
}


@pytest.mark.parametrize("case", sorted(SPIDER))
def test_spider(tmp_path, case):
    got = _check(tmp_path, SPIDER[case](), ".spi", more.decode_spider)
    assert got.dtype == np.float32


@pytest.mark.parametrize("case", ["volume", "image_in_stack"])
def test_spider_refused(tmp_path, case):
    data = bytearray(tiw.spider_file(_floats(9, 7)))
    if case == "volume":                        # iform 3
        struct.pack_into(">f", data, 16, 3.0)
        words = "not a 2D image"
    else:                                       # an image's own header
        struct.pack_into(">f", data, 26 * 4, 2.0)
        words = "image header of a stack"
    _refused(tmp_path, bytes(data), ".spi", words)


# ---------------------------------------------------------------- BLP


def _palette_bgra(seed, alpha=True):
    p = _rng(seed).integers(0, 256, (256, 4), np.uint8)
    if not alpha:
        p[:, 3] = 0
    return p


def _idx(w, h, seed=0):
    i = _rng(seed).integers(0, 256, (h, w), np.uint8)
    i[: h // 3, : w // 2] = 7
    return i


def _pil_blp(version, rgba):
    px = tiw.scene(37, 23)
    im = Image.fromarray(px).convert("P", palette=Image.ADAPTIVE, colors=50)
    if rgba:
        im = Image.fromarray(np.concatenate(
            [px, _rng(1).integers(0, 256, (23, 37, 1), np.uint8)], -1),
            "RGBA").quantize(40)
    return _pil_file(im, "BLP", blp_version=version)


def _jpeg(space, w=37, h=23):
    px = tiw.scene(w, h)
    if space == "gray":
        return tiw.encode_jpeg(px[..., :1], sampling=((1, 1),), space="gray")
    if space in ("cmyk", "ycck"):
        return tiw.encode_jpeg(np.concatenate([px, px[..., :1]], -1),
                               sampling=((1, 1),) * 4, space=space,
                               adobe=2 if space == "ycck" else None,
                               jfif=space == "cmyk")
    return tiw.encode_jpeg(px)


def _random_blocks(kind, w, h, seed=0):
    n = ((w + 3) // 4) * ((h + 3) // 4) * (8 if kind == "DXT1" else 16)
    return _rng(seed).integers(0, 256, n, np.uint8).tobytes()


def _image_blocks(kind, w, h):
    px = np.concatenate([tiw.scene(w, h), _rng(5).integers(
        0, 256, (h, w, 1), np.uint8)], -1)
    return tiw.dxt_blocks(px, kind)


BLP = {
    "pil_blp1_palette": lambda: _pil_blp("BLP1", False),
    "pil_blp2_palette": lambda: _pil_blp("BLP2", False),
    "pil_blp2_palette_rgba": lambda: _pil_blp("BLP2", True),
    "blp1_palette_alpha": lambda: tiw.blp1_palette(
        _idx(37, 23), _palette_bgra(1), alpha=True, encoding=5),
    "blp1_jpeg_ycc": lambda: tiw.blp1_jpeg(_jpeg("ycc"), 37, 23),
    "blp1_jpeg_gray": lambda: tiw.blp1_jpeg(_jpeg("gray"), 37, 23),
    "blp1_jpeg_cmyk": lambda: tiw.blp1_jpeg(_jpeg("cmyk"), 37, 23),
    "blp1_jpeg_ycck": lambda: tiw.blp1_jpeg(_jpeg("ycck"), 37, 23),
    "blp1_jpeg_alpha": lambda: tiw.blp1_jpeg(_jpeg("ycc"), 37, 23,
                                             alpha=True),
}
for _depth in (0, 1, 4, 8):
    BLP[f"blp2_palette_alpha{_depth}"] = (
        lambda d=_depth: tiw.blp2_palette(_idx(37, 23, d), _palette_bgra(d),
                                          alpha_depth=d))
for _kind in ("DXT1", "DXT3", "DXT5"):
    for _alpha in (0, 8):
        BLP[f"blp2_{_kind.lower()}_random_alpha{_alpha}"] = (
            lambda k=_kind, a=_alpha: tiw.blp2_blocks(
                _random_blocks(k, 16, 12), 16, 12, k, alpha_depth=a))
    BLP[f"blp2_{_kind.lower()}_image_37x23"] = (
        lambda k=_kind: tiw.blp2_blocks(_image_blocks(k, 40, 24), 37, 23, k))


@pytest.mark.parametrize("case", sorted(BLP))
def test_blp(tmp_path, case):
    _check(tmp_path, BLP[case](), ".blp", more.decode_blp)


def _patched(data, offset, fmt, value):
    data = bytearray(data)
    struct.pack_into(fmt, data, offset, value)
    return bytes(data)


BLP_REFUSED = {
    "blp1_compression": (lambda: _patched(tiw.blp1_palette(
        _idx(8, 8), _palette_bgra(0)), 4, "<i", 2), "BLP1 compression 2"),
    "blp1_encoding": (lambda: _patched(tiw.blp1_palette(
        _idx(8, 8), _palette_bgra(0)), 20, "<i", 3), "BLP1 encoding 3"),
    "blp2_compression": (lambda: _patched(tiw.blp2_palette(
        _idx(8, 8), _palette_bgra(0)), 4, "<i", 0), "BLP2 compression 0"),
    "blp2_raw_bgra": (lambda: tiw.blp2_blocks(bytes(256), 8, 8, "DXT1",
                                              encoding=3),
                      "BLP2 encoding 3"),
    "blp2_alpha_encoding": (lambda: tiw.blp2_blocks(
        bytes(256), 8, 8, 2), "alpha encoding 2"),
}


@pytest.mark.parametrize("case", sorted(BLP_REFUSED))
def test_blp_refused(tmp_path, case):
    """What PIL raises BLPFormatError for."""
    make, words = BLP_REFUSED[case]
    data = make()
    with pytest.raises(NotImplementedError):
        Image.open(io.BytesIO(data)).load()
    _refused(tmp_path, data, ".blp", words)


# ---------------------------------------------------------------- SUN


def _sun_values(depth, w, h, seed=0):
    if depth == 1:
        return _bits(w, h, seed)
    if depth in (4, 8):
        v = _rng(seed).integers(0, 1 << depth, (h, w), np.uint8)
        v[: h // 3, : w // 2] = 3
        return v
    v = _rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    v[: h // 3, : w // 2] = (0x80, 7, 0x80)
    return v


SUN = {}
for _depth in (1, 4, 8, 24, 32):
    for _w in (37, 16):
        for _rle in (False, True):
            SUN[f"d{_depth}_w{_w}_{'rle' if _rle else 'raw'}"] = (
                lambda d=_depth, w=_w, r=_rle: tiw.sun_file(
                    _sun_values(d, w, 9, d), d, rle=r))
for _depth in (24, 32):
    SUN[f"d{_depth}_rgb_order"] = (lambda d=_depth: tiw.sun_file(
        _sun_values(d, 37, 9), d, rgb_order=True))
SUN["d8_palette"] = lambda: tiw.sun_file(
    _sun_values(8, 37, 9), 8, palette=_rng(2).integers(0, 256, (256, 3)))
SUN["d8_short_palette_rle"] = lambda: tiw.sun_file(
    _sun_values(8, 37, 9), 8, rle=True,
    palette=_rng(3).integers(0, 256, (100, 3)))
SUN["d4_palette"] = lambda: tiw.sun_file(
    _sun_values(4, 37, 9), 4, palette=_rng(4).integers(0, 256, (16, 3)))


@pytest.mark.parametrize("case", sorted(SUN))
def test_sun(tmp_path, case):
    _check(tmp_path, SUN[case](), ".ras", more.decode_sun)


SUN_REFUSED = {
    "depth16": (lambda: _patched(tiw.sun_file(_sun_values(8, 16, 4), 8),
                                 12, ">I", 16), "depth 16"),
    "map_type2": (lambda: _patched(tiw.sun_file(
        _sun_values(8, 16, 4), 8, palette=np.zeros((4, 3))), 24, ">I", 2),
        "colour map type 2"),
    "map_too_long": (lambda: tiw.sun_file(
        _sun_values(8, 16, 4), 8, palette=np.zeros((400, 3))),
        "colour map of 1200 bytes"),
    "map_on_1bit": (lambda: tiw.sun_file(
        _sun_values(1, 37, 9), 1, palette=[[255, 0, 0], [0, 0, 255]]),
        "colour map on a 1-bit image"),
    "map_on_24bit": (lambda: tiw.sun_file(
        _sun_values(24, 16, 4), 24, palette=[[255, 0, 0], [0, 0, 255]]),
        "colour map on a 24-bit image"),
    "type6": (lambda: _patched(tiw.sun_file(_sun_values(8, 16, 4), 8),
                               20, ">I", 6), "file type 6"),
}


@pytest.mark.parametrize("case", sorted(SUN_REFUSED))
def test_sun_refused(tmp_path, case):
    make, words = SUN_REFUSED[case]
    _refused(tmp_path, make(), ".ras", words)


# ---------------------------------------------------------------- XPM


def _xpm_case(n, cpp, w=37, h=23, seed=0, **kw):
    idx = _rng(seed).integers(0, n, (h, w))
    idx[: h // 3, : w // 2] = 1
    pal = _rng(seed + 1).integers(0, 256, (n, 3))
    return tiw.xpm_file(idx, pal, cpp=cpp, **kw)


XPM = {
    "cpp1": lambda: _xpm_case(20, 1),
    "cpp2_none_entry": lambda: _xpm_case(60, 2, seed=2, none_key="  "),
    "over_256_colours": lambda: _xpm_case(300, 2, seed=3),
    "no_pixels_line_m_key": lambda: _xpm_case(5, 1, seed=4,
                                              pixels_line=False,
                                              extra_words=True),
    "cpp3": lambda: _xpm_case(9, 3, 16, 5, seed=5),
}


@pytest.mark.parametrize("case", sorted(XPM))
def test_xpm(tmp_path, case):
    _check(tmp_path, XPM[case](), ".xpm", more.decode_xpm)


XPM_REFUSED = {
    "named_colour": (lambda: _xpm_case(4, 1).replace(b"c #", b"c red #", 1),
                     "colour red is not read"),
    "none_used": (lambda: _xpm_case(4, 1, none_key="z").replace(
        b'"a', b'"z', 2), "names no colour"),
    "no_size_line": (lambda: b"/* XPM */\nstatic char *x[] = {\n};\n",
                     "no size line"),
}


@pytest.mark.parametrize("case", sorted(XPM_REFUSED))
def test_xpm_refused(tmp_path, case):
    make, words = XPM_REFUSED[case]
    _refused(tmp_path, make(), ".xpm", words)


# ---------------------------------------------------------------- fixtures


def _fixtures():
    record = json.loads((FIXTURES / "images.json").read_text())
    return {k: v for k, v in record.items()
            if v.get("read_by") == "utils/image_read_more.py"}


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


def test_fixture_decode_timer(capsys):
    """scripts/more_read_formats.py's decode_fixtures, which chip_smoke.py's
    phase 37 runs on the card's host: every committed fixture decoded and
    at its record."""
    import more_read_formats as mrf

    rows = mrf.decode_fixtures()
    assert len(rows) == len(_fixtures()) == 14
    assert all(ok for *_, ok in rows)
    mrf.main()
    out = capsys.readouterr().out
    assert out.startswith("host CPU: ") and "WRONG" not in out
