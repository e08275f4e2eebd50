"""The port's JPEG 2000 reader (acceleratedvolrenderer_tpu_torch/utils/
jpeg2000.py, tier 1 in utils/j2k_t1.py and native/j2k_t1.cpp) against
PIL 12.1.0 (OpenJPEG 2.5), which the reference's read_image and imgtool
use, on the same bytes.  PIL writes the files here from seeded numpy
images (1x1 to 130x70): L, I;16, LA, RGB, RGBA; reversible 5/3 and
irreversible 9/7 with mct 0 and 1; 1 to 7 resolutions; the five
progressions; one and three quality layers; tiles with offsets; code-blocks
of 64x64, 32x32, 64x16 and 16x4; user precincts; signed samples, PLT,
comments; JP2 and raw codestreams.  Headers PIL cannot write are made by
patching its files (COC, QCC, tile-part COD / QCD, two tile-parts,
packets cut off, TLM, PLM and CRG, derived quantization, 4- and 12-bit
samples, palettes, sYCC, CMYK, cdef, res), and PIL decodes each patched
file as it stands; files cut inside their headers raise, as in PIL.

Every case is exact: 5/3 and 9/7 alike equal PIL sample for sample (the
bound the 9/7 cases were allowed, max |diff| 1 on 0.1% of the samples, is
not needed: the measured share is 0).  Each case runs the C++ tier 1; the
cases of at most 40x40 pixels also run the numpy twin, which must give the
same samples.  Every refusal raises ValueError naming its feature.  The
committed fixtures under tests/data/images/ are held to images.json.
"""
import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest

from acceleratedvolrenderer_tpu.cli import imgtool as jimgtool
from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.cli import imgtool as timgtool
from acceleratedvolrenderer_tpu_torch.utils import image as timage
from acceleratedvolrenderer_tpu_torch.utils import jpeg2000 as j2k
from acceleratedvolrenderer_tpu_torch.utils.image import read_exr

import torch_image_writers as tiw

Image = pytest.importorskip("PIL.Image")

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
TWIN_PIXELS = 40 * 40


def _scene(w, h, c=3, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0),
                    128 + 90 * np.cos(yy / 5.0 + xx / 11.0),
                    (xx * 3 + yy * 5) % 256, (xx * 7 + yy) % 256], -1)
    return np.clip(img[..., :c] + rng.normal(0, 12, (h, w, c)), 0,
                   255).astype(np.uint8)


def _image(mode, w, h, seed=0):
    if mode == "I;16":
        rng = np.random.default_rng(seed)
        base = _scene(w, h, 1, seed)[..., 0].astype(np.uint16) * 257
        im = Image.fromarray(base ^ rng.integers(0, 64, (h, w),
                                                 dtype=np.uint16))
    else:
        c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        px = _scene(w, h, c, seed)
        im = Image.fromarray(px[..., 0] if c == 1 else px)
    assert im.mode == mode
    return im


def _save(im, **kw):
    b = io.BytesIO()
    im.save(b, "JPEG2000", **kw)
    return b.getvalue()


def _pil(data, convert=None):
    im = Image.open(io.BytesIO(data))
    if convert or im.mode in ("P", "CMYK"):
        im = im.convert(convert or ("RGBA" if im.mode == "P" and
                                    im.palette.mode == "RGBA" else "RGB"))
    a = np.asarray(im)
    return a.reshape(a.shape[0], a.shape[1], -1)


def _decode(data, native=None):
    fn = j2k.decode_jp2 if data[:12] == j2k.JP2_MAGIC else j2k.decode_j2k
    return fn(data, native=native)


def _check(tmp_path, data, convert=None):
    """The port's samples equal PIL's (both tier-1 twins where the image
    is small), and read_image equals the reference's where PIL gives the
    colours, else PIL's samples by the port's conventions."""
    want = _pil(data, convert)
    got = _decode(data, native=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
    if want.shape[0] * want.shape[1] <= TWIN_PIXELS:
        assert np.array_equal(_decode(data, native=False), want)
    path = tmp_path / ("t.jp2" if data[:12] == j2k.JP2_MAGIC else "t.j2k")
    path.write_bytes(data)
    lin, attrs = timage.read_image(str(path))
    assert attrs == {}
    mode = Image.open(io.BytesIO(data)).mode
    if mode in ("L", "RGB", "RGBA"):
        assert np.array_equal(lin, jimage.read_image(str(path))[0])
    else:
        x = timage.png_unit(want)
        x = np.repeat(x[..., :1], 3, 2) if x.shape[2] < 3 else x[..., :3]
        assert np.allclose(lin, np.where(x <= 0.04045, x / 12.92, (
            (x + 0.055) / 1.055) ** 2.4), rtol=0, atol=1e-6)


SIZES = {"1x1": (1, 1), "6x5": (6, 5), "37x23": (37, 23), "64x64": (64, 64),
         "130x70": (130, 70)}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("mode", ["L", "I;16", "LA", "RGB", "RGBA"])
def test_modes_and_sizes_match_pil(tmp_path, mode, size):
    _check(tmp_path, _save(_image(mode, *SIZES[size])))


OPTIONS = {
    "53": {}, "97": dict(irreversible=True), "53_mct": dict(mct=1),
    "97_mct": dict(irreversible=True, mct=1),
    **{f"res{n}": dict(num_resolutions=n) for n in range(1, 8)},
    **{f"{p}_layers3": dict(progression=p, quality_layers=[40, 20, 8],
                            precinct_size=(32, 32), tile_size=(64, 48),
                            num_resolutions=4)
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    **{f"{p}_97": dict(progression=p, irreversible=True,
                       quality_layers=[30, 10], precinct_size=(64, 32),
                       codeblock_size=(16, 16))
       for p in ("RPCL", "PCRL", "CPRL")},
    "layers1": dict(quality_layers=[20]),
    "layers3": dict(quality_layers=[60, 20, 10]),
    "layers3_97": dict(quality_layers=[60, 20, 10], irreversible=True),
    "layers_db": dict(quality_mode="dB", quality_layers=[25, 35, 45]),
    "tiles": dict(tile_size=(32, 32)),
    "offset": dict(offset=(5, 3), tile_size=(256, 256)),
    "offset_tiles": dict(offset=(7, 5), tile_offset=(3, 2),
                         tile_size=(32, 24)),
    "offset_tiles_97": dict(offset=(9, 4), tile_offset=(1, 1),
                            tile_size=(48, 40), irreversible=True, mct=1),
    "cb32x32": dict(codeblock_size=(32, 32)),
    "cb64x16": dict(codeblock_size=(64, 16)),
    "cb16x4": dict(codeblock_size=(16, 4)),
    "precincts": dict(precinct_size=(32, 32)),
    "precincts_64x16": dict(precinct_size=(64, 16), num_resolutions=3),
    "signed": dict(signed=True),
    "signed_97": dict(signed=True, irreversible=True),
    "plt": dict(plt=True),
    "comment": dict(comment="JPEG 2000 test"),
    "no_jp2": dict(no_jp2=True),
    "no_jp2_97": dict(no_jp2=True, irreversible=True, mct=1),
}


# each option at 37x23 (both tier-1 twins) and 130x70; OpenJPEG writes
# at most 5 resolutions for 23 rows
OPTION_CASES = [(case, size) for case in sorted(OPTIONS)
                for size in ("37x23", "130x70")
                if size == "130x70" or OPTIONS[case].get(
                    "num_resolutions", 0) <= 5]


@pytest.mark.parametrize("case,size", OPTION_CASES)
def test_coding_options_match_pil(tmp_path, case, size):
    _check(tmp_path, _save(_image("RGB", *SIZES[size]), **OPTIONS[case]))


def test_j2k_extension_writes_a_codestream(tmp_path):
    path = tmp_path / "t.j2k"
    _image("RGBA", 37, 23).save(path)
    data = path.read_bytes()
    assert data[:4] == j2k.J2K_MAGIC
    _check(tmp_path, data)


# ---------------------------------------------------------------------------
# codestreams PIL cannot write, made by patching its files
# ---------------------------------------------------------------------------

def _markers(cs):
    """[(marker, start, end)] of the main header's segments after SIZ,
    and the position of the first SOT."""
    out, p = [], 4 + struct.unpack_from(">H", cs, 4)[0]
    while struct.unpack_from(">H", cs, p)[0] != 0xFF90:
        m, n = struct.unpack_from(">HH", cs, p)
        out.append((m, p, p + 2 + n))
        p += 2 + n
    return out, p


def _segment(marker, body):
    return struct.pack(">HH", marker, len(body) + 2) + body


def _body(cs, marker):
    for m, s, e in _markers(cs)[0]:
        if m == marker:
            return cs[s + 4:e]
    raise KeyError(marker)


def _insert_main(cs, *segs):
    p = _markers(cs)[1]
    return cs[:p] + b"".join(segs) + cs[p:]


def _replace_main(cs, marker, body):
    for m, s, e in _markers(cs)[0]:
        if m == marker:
            return cs[:s] + _segment(marker, body) + cs[e:]
    raise KeyError(marker)


def _tile_parts(cs):
    """[(start, sod, end)] of every tile-part."""
    out, p = [], _markers(cs)[1]
    while struct.unpack_from(">H", cs, p)[0] == 0xFF90:
        psot = struct.unpack_from(">I", cs, p + 6)[0]
        q = p + 12
        while struct.unpack_from(">H", cs, q)[0] != 0xFF93:
            q += 2 + struct.unpack_from(">H", cs, q + 2)[0]
        out.append((p, q, p + psot))
        p += psot
    return out


def _sot(tile, length, part, nparts):
    return struct.pack(">HHHIBB", 0xFF90, 10, tile, length, part, nparts)


def _add_to_tile_headers(cs, *segs):
    """The codestream with segs added to every tile-part header."""
    out = bytearray(cs[:_markers(cs)[1]])
    extra = b"".join(segs)
    for s, sod, e in _tile_parts(cs):
        tile, psot, part, nparts = struct.unpack_from(">HIBB", cs, s + 4)
        out += _sot(tile, psot + len(extra), part, nparts)
        out += cs[s + 12:sod] + extra + cs[sod:e]
    return bytes(out) + cs[_tile_parts(cs)[-1][2]:]


def _plt_lengths(cs, s, sod):
    """The packet lengths of a tile-part's PLT segments."""
    out, q = [], s + 12
    while q < sod:
        m, n = struct.unpack_from(">HH", cs, q)
        if m == 0xFF58:
            v = 0
            for b in cs[q + 5:q + 2 + n]:
                v = (v << 7) | (b & 0x7F)
                if not b & 0x80:
                    out.append(v)
                    v = 0
        q += 2 + n
    return out


def _split_tile_parts(cs):
    """Each tile's packets in two tile-parts (cut after half its packets),
    from a file written with plt=True; PLT segments dropped."""
    out = bytearray(cs[:_markers(cs)[1]])
    for s, sod, e in _tile_parts(cs):
        tile = struct.unpack_from(">H", cs, s + 4)[0]
        lens = _plt_lengths(cs, s, sod)
        cut = sod + 2 + sum(lens[:len(lens) // 2])
        out += _sot(tile, 14 + cut - sod - 2, 0, 2) + b"\xff\x93"
        out += cs[sod + 2:cut]
        out += _sot(tile, 14 + e - cut, 1, 2) + b"\xff\x93" + cs[cut:e]
    return bytes(out) + b"\xff\xd9"


def _truncated(cs):
    """Each tile-part cut after the first third of its packets (a
    transmission stopped early; Psot shortened to match), PLT dropped."""
    out = bytearray(cs[:_markers(cs)[1]])
    for s, sod, e in _tile_parts(cs):
        tile = struct.unpack_from(">H", cs, s + 4)[0]
        lens = _plt_lengths(cs, s, sod)
        cut = sod + 2 + sum(lens[:len(lens) // 3])
        out += _sot(tile, 14 + cut - sod - 2, 0, 1) + b"\xff\x93"
        out += cs[sod + 2:cut]
    return bytes(out) + b"\xff\xd9"


def _derived(cs):
    body = _body(cs, 0xFF5C)
    return _replace_main(cs, 0xFF5C, bytes([(body[0] & 0xE0) | 1])
                         + body[1:3])


def _coc_qcc(cs):
    cod, qcd = _body(cs, 0xFF52), _body(cs, 0xFF5C)
    return _insert_main(cs, _segment(0xFF53, bytes([1, cod[0] & 1]) + cod[5:]),
                        _segment(0xFF5D, bytes([2]) + qcd))


def _tile_cod_qcd(cs):
    cod, qcd = _body(cs, 0xFF52), _body(cs, 0xFF5C)
    return _add_to_tile_headers(
        cs, _segment(0xFF52, cod), _segment(0xFF5C, qcd),
        _segment(0xFF53, bytes([0, cod[0] & 1]) + cod[5:]),
        _segment(0xFF5D, bytes([1]) + qcd))


def _tlm_plm_crg(cs):
    parts = _tile_parts(cs)
    tlm = bytes([0, 0x60]) + b"".join(
        struct.pack(">HI", struct.unpack_from(">H", cs, s + 4)[0], e - s)
        for s, _, e in parts)
    plm = bytes([0])
    for s, sod, _ in parts:
        raw = cs[s + 12:sod]
        iplt = raw[raw.index(b"\xff\x58") + 5:
                   raw.index(b"\xff\x58") + 2 + struct.unpack_from(
                       ">H", raw, raw.index(b"\xff\x58") + 2)[0]]
        plm += bytes([len(iplt)]) + iplt
    crg = b"\0\0\0\0" * 3
    return _insert_main(cs, _segment(0xFF55, tlm), _segment(0xFF57, plm),
                        _segment(0xFF63, crg))


def _precision(cs, prec, signed=False, comp=None):
    """Ssiz of every component (or one) set to prec bits."""
    cs = bytearray(cs)
    n = struct.unpack_from(">H", cs, 40)[0]
    for c in range(n) if comp is None else [comp]:
        cs[42 + 3 * c] = (prec - 1) | (0x80 if signed else 0)
    return bytes(cs)


def _twelve_bit():
    """16-bit samples in [-2048, 2047] coded signed, then read as 12-bit
    unsigned: the decoded values cover all of 0..4095."""
    rng = np.random.default_rng(3)
    v = (_scene(37, 23, 1)[..., 0].astype(np.int32) * 16 - 2048
         + rng.integers(0, 16, (23, 37))).astype(np.int16)
    cs = _save(Image.fromarray(v.view(np.uint16)), no_jp2=True, signed=True)
    return _precision(cs, 12)


PATCHED = {
    "qcd_derived_97": lambda: _derived(_save(_image("RGB", 37, 23),
                                             no_jp2=True, irreversible=True)),
    "coc_qcc": lambda: _coc_qcc(_save(_image("RGB", 37, 23), no_jp2=True,
                                      precinct_size=(16, 16))),
    "coc_qcc_97": lambda: _coc_qcc(_save(_image("RGB", 37, 23),
                                         no_jp2=True, irreversible=True)),
    "tile_cod_qcd": lambda: _tile_cod_qcd(_save(
        _image("RGB", 37, 23), no_jp2=True, tile_size=(16, 16))),
    "two_tile_parts": lambda: _split_tile_parts(_save(
        _image("RGB", 37, 23), no_jp2=True, plt=True, tile_size=(24, 16),
        quality_layers=[30, 10, 4])),
    "truncated_packets": lambda: _truncated(_save(
        _image("RGB", 37, 23), no_jp2=True, plt=True, tile_size=(24, 16),
        quality_layers=[30, 10, 4])),
    "tlm_plm_crg": lambda: _tlm_plm_crg(_save(
        _image("RGB", 37, 23), no_jp2=True, plt=True, tile_size=(32, 16))),
    "4bit_gray": lambda: _precision(_save(_image("L", 37, 23),
                                          no_jp2=True), 4),
    "12bit_gray": _twelve_bit,
    "signed_4bit_gray": lambda: _precision(_save(_image("L", 37, 23),
                                                 no_jp2=True), 4, True),
}


@pytest.mark.parametrize("case", sorted(PATCHED))
def test_patched_codestreams_match_pil(tmp_path, case):
    _check(tmp_path, PATCHED[case]())


def test_twelve_bit_fills_its_range():
    got = j2k.decode_j2k(_twelve_bit())
    assert got.dtype == np.uint16
    assert set(np.unique(got & 15)) == {0}
    assert got.min() < 2048 * 16 < got.max()


# ---------------------------------------------------------------------------
# JP2 boxes
# ---------------------------------------------------------------------------

def _box(kind, payload):
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def _patch_jp2h(data, extra=b"", replace=None):
    """The file with boxes added to the end of jp2h, or replaced (payload
    None: removed)."""
    i = data.index(b"jp2h") - 4
    n = struct.unpack_from(">I", data, i)[0]
    inner, out, p = data[i + 8:i + n], b"", 0
    while p < len(inner):
        ln, kind = struct.unpack_from(">I4s", inner, p)
        if replace and kind in replace:
            if replace[kind] is not None:
                out += _box(kind, replace[kind])
        else:
            out += inner[p:p + ln]
        p += ln
    return data[:i] + _box(b"jp2h", out + extra) + data[i + n:]


def _colr(enum):
    return bytes([1, 0, 0]) + struct.pack(">I", enum)


def _palette_file(colours, index_range=None, depth=7):
    npc = len(colours[0])
    idx = _scene(37, 23, 1)[..., 0] % (index_range or len(colours))
    data = _save(Image.fromarray(idx.astype(np.uint8)))
    pclr = struct.pack(">HB", len(colours), npc) + bytes([depth] * npc)
    fmt = ">" + ("B" if depth < 8 else "H") * npc
    pclr += b"".join(struct.pack(fmt, *c) for c in colours)
    cmap = b"".join(struct.pack(">HBB", 0, 1, k) for k in range(npc))
    # PIL reads a palette of deeper entries as gray (L), which it then
    # reads only under a greyscale colr
    return _patch_jp2h(data, _box(b"pclr", pclr) + _box(b"cmap", cmap),
                       {b"colr": _colr(16 if depth < 8 else 17)})


def _cdef_res():
    data = _save(_image("RGB", 37, 23))
    cdef = struct.pack(">H", 3) + b"".join(
        struct.pack(">HHH", cn, 0, asoc) for cn, asoc in ((0, 3), (1, 2),
                                                           (2, 1)))
    resc = struct.pack(">HHHHbb", 72, 1, 72, 1, 0, 0)
    return _patch_jp2h(data, _box(b"cdef", cdef)
                       + _box(b"res ", _box(b"resc", resc)))


def _jpx_brand():
    data = _save(_image("RGB", 37, 23))
    i = data.index(b"ftyp")
    return data[:i + 4] + b"jpx " + data[i + 8:]


BOXES = {
    # a palette with a repeated colour: PIL's indices follow its palette of
    # distinct colours, and so do the port's colours (held to convert)
    "palette_rgb": lambda: _palette_file([(10, 20, 30), (40, 50, 60),
                                          (10, 20, 30), (200, 100, 0)]),
    "palette_rgba": lambda: _palette_file([(10, 20, 30, 40),
                                           (90, 50, 60, 255),
                                           (1, 2, 3, 4)]),
    "palette_beyond": lambda: _palette_file([(7, 8, 9), (60, 70, 80)], 5),
    "palette_16bit_ignored": lambda: _palette_file([(1, 2, 3), (4, 5, 6)],
                                                   depth=15),
    "cdef_res_ignored": _cdef_res,
    "jpx_brand": _jpx_brand,
    "sycc": lambda: _patch_jp2h(_save(_image("RGB", 37, 23)),
                                replace={b"colr": _colr(18)}),
    "sycc_alpha": lambda: _patch_jp2h(_save(_image("RGBA", 37, 23)),
                                      replace={b"colr": _colr(18)}),
    "cmyk": lambda: _patch_jp2h(_save(_image("RGBA", 37, 23)),
                                replace={b"colr": _colr(12)}),
}


@pytest.mark.parametrize("case", sorted(BOXES))
def test_jp2_boxes_match_pil(tmp_path, case):
    data = BOXES[case]()
    im = Image.open(io.BytesIO(data))
    if case.startswith("palette") and "16bit" not in case:
        assert im.mode == "P"
    _check(tmp_path, data)


def test_ycbcr_tables_match_pil_on_every_input():
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 77, 255):
        px = np.stack([np.full_like(cb, y), cb, cr], -1).astype(np.uint8)
        want = np.asarray(Image.fromarray(px, "YCbCr").convert("RGB"))
        assert np.array_equal(j2k._ycbcr_to_rgb(px), want)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def _rgb_j2k(**kw):
    return _save(_image("RGB", 37, 23), no_jp2=True, **kw)


def _cod_byte(cs, offset, value, mask=None):
    body = bytearray(_body(cs, 0xFF52))
    body[offset] = value if mask is None else body[offset] | mask
    return _replace_main(cs, 0xFF52, bytes(body))


def _subsampled():
    cs = bytearray(_rgb_j2k())
    cs[43 + 3] = 2
    return bytes(cs)


def _icc():
    return _patch_jp2h(_save(_image("RGB", 37, 23)),
                       replace={b"colr": bytes([2, 0, 0]) + bytes(16)})


def _header_disagrees():
    data = bytearray(_save(_image("RGB", 37, 23)))
    i = data.index(b"ihdr") + 12
    data[i:i + 2] = struct.pack(">H", 4)
    return bytes(data)


def _pa():
    data = _save(Image.fromarray(_scene(37, 23, 2) % 4))
    pclr = struct.pack(">HB", 4, 3) + bytes([7] * 3) + bytes(range(12))
    return _patch_jp2h(data, _box(b"pclr", pclr), {b"colr": _colr(16)})


def _later_part_cod():
    """A COD segment in the second tile-part of a tile."""
    cs = _split_tile_parts(_rgb_j2k(plt=True))
    s, sod, e = _tile_parts(cs)[1]
    seg = _segment(0xFF52, _body(cs, 0xFF52))
    tile, psot, part, nparts = struct.unpack_from(">HIBB", cs, s + 4)
    return (cs[:s] + _sot(tile, psot + len(seg), part, nparts)
            + cs[s + 12:sod] + seg + cs[sod:])


def _qcd(cs, style=None, entries=None):
    body = _body(cs, 0xFF5C)
    head = body[0] if style is None else (body[0] & 0xE0) | style
    rest = body[1:] if entries is None else body[1:1 + 2 * entries]
    return _replace_main(cs, 0xFF5C, bytes([head]) + rest)


REFUSED = {
    "later_tile_part_cod": (_later_part_cod, "later tile-part"),
    "custom_wavelet": (lambda: _cod_byte(_rgb_j2k(), 9, 2),
                       "custom wavelets"),
    "unknown_marker": (lambda: _insert_main(_rgb_j2k(), _segment(
        0xFF70, bytes(2))), "unknown marker"),
    "quantization_style": (lambda: _qcd(_rgb_j2k(irreversible=True), 3),
                           "quantization style 3"),
    "too_few_step_sizes": (lambda: _qcd(_rgb_j2k(irreversible=True),
                                        entries=1), "too few sub-bands"),
    **{f"mode_switch_{name}": (lambda bit=bit: _cod_byte(
        _rgb_j2k(), 8, 0, 1 << bit), name)
       for bit, name in enumerate(j2k._MODE_SWITCHES)},
    "htj2k_blocks": (lambda: _cod_byte(_rgb_j2k(), 8, 0, 0x40), "HTJ2K"),
    "htj2k_cap": (lambda: _insert_main(_rgb_j2k(), _segment(
        0xFF50, bytes(6))), "HTJ2K"),
    "htj2k_rsiz": (lambda: _rgb_j2k()[:6] + b"\x40\x00" + _rgb_j2k()[8:],
                   "HTJ2K"),
    "rgn": (lambda: _insert_main(_rgb_j2k(), _segment(0xFF5E, bytes(
        [0, 0, 3]))), "ROI"),
    "poc": (lambda: _insert_main(_rgb_j2k(), _segment(0xFF5F, bytes(
        [0, 0, 0, 1, 2, 3, 1]))), "POC"),
    "ppm": (lambda: _insert_main(_rgb_j2k(), _segment(0xFF60, bytes(3))),
            "packed headers"),
    "ppt": (lambda: _add_to_tile_headers(_rgb_j2k(), _segment(
        0xFF61, bytes(3))), "packed headers"),
    "sop": (lambda: _cod_byte(_rgb_j2k(), 0, 0, 2), "SOP / EPH"),
    "eph": (lambda: _cod_byte(_rgb_j2k(), 0, 0, 4), "SOP / EPH"),
    "subsampled": (_subsampled, "sub-sampled components"),
    "colour_over_8_bits": (lambda: _precision(_rgb_j2k(), 10),
                           "colour samples over 8 bits"),
    "samples_over_16_bits": (lambda: _precision(_save(
        _image("L", 37, 23), no_jp2=True), 20), "samples over 16 bits"),
    "icc": (_icc, "ICC colour"),
    "header_disagrees": (_header_disagrees, "disagree"),
    "palette_with_alpha": (_pa, "palette with alpha"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_name_the_feature(tmp_path, case):
    make, words = REFUSED[case]
    data = make()
    with pytest.raises(ValueError, match=words):
        _decode(data)
    path = tmp_path / ("t.jp2" if data[:12] == j2k.JP2_MAGIC else "t.j2k")
    path.write_bytes(data)
    with pytest.raises(ValueError, match=words):
        timage.read_image(str(path))


@pytest.mark.parametrize("cut", [20, 60, 150])
@pytest.mark.parametrize("kind", ["jp2", "j2k"])
def test_files_cut_short_raise_value_error(kind, cut):
    """A file cut inside its boxes or headers raises ValueError, as PIL
    raises on it."""
    data = _save(_image("RGB", 37, 23), no_jp2=kind == "j2k")[:cut]
    with pytest.raises((OSError, SyntaxError, ValueError)):
        np.asarray(Image.open(io.BytesIO(data)))
    with pytest.raises(ValueError, match="JPEG 2000"):
        _decode(data)


PIL_REFUSES = {
    "gray_colour_space_on_rgb": lambda: _patch_jp2h(
        _save(_image("RGB", 37, 23)), replace={b"colr": _colr(17)}),
    "srgb_colour_space_on_gray": lambda: _patch_jp2h(
        _save(_image("L", 37, 23)), replace={b"colr": _colr(16)}),
    "eycc_colour_space": lambda: _patch_jp2h(
        _save(_image("RGB", 37, 23)), replace={b"colr": _colr(24)}),
    "five_components": lambda: _five_components(),
}


def _five_components():
    """SIZ naming five components (two more than are coded)."""
    cs = bytearray(_rgb_j2k())
    cs[4:6] = struct.pack(">H", struct.unpack_from(">H", cs, 4)[0] + 6)
    cs[40:42] = struct.pack(">H", 5)
    return bytes(cs[:51]) + bytes(cs[42:45]) * 2 + bytes(cs[51:])


@pytest.mark.parametrize("case", sorted(PIL_REFUSES))
def test_what_pil_refuses_is_refused(case):
    data = PIL_REFUSES[case]()
    with pytest.raises((OSError, SyntaxError, ValueError)):
        np.asarray(Image.open(io.BytesIO(data)))
    with pytest.raises(ValueError, match="not read"):
        _decode(data)


def test_arithmetic_lossless_jpeg_refused_as_pil_refuses(tmp_path):
    """SOF11 (arithmetic-coded lossless): PIL 12.1.0 refuses it, and so
    does the port, naming it."""
    data = tiw.encode_jpeg_lossless(_scene(37, 23))
    i = data.index(b"\xff\xc3")
    data = data[:i + 1] + b"\xcb" + data[i + 2:]
    with pytest.raises(OSError, match="broken data stream"):
        np.asarray(Image.open(io.BytesIO(data)))
    path = tmp_path / "t.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="arithmetic-coded lossless"):
        timage.read_image(str(path))


# ---------------------------------------------------------------------------
# fixtures and imgtool
# ---------------------------------------------------------------------------

J2K_FIXTURES = ("sky_2048x1024_97.jp2", "ground_1024x512_53.j2k",
                "sky_512x256_lossless.jp2")


@pytest.mark.parametrize("name", J2K_FIXTURES)
def test_committed_fixtures_hashes(name):
    """chip_smoke.py phase 35 holds the port's decodes to these hashes on
    the card's host, which has no PIL."""
    rec = json.loads((FIXTURES / "images.json").read_text())[name]
    data = (FIXTURES / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == rec["sha256_of_bytes"]
    want = np.ascontiguousarray(np.asarray(Image.open(FIXTURES / name)))
    assert hashlib.sha256(want.tobytes()).hexdigest() == rec[
        "sha256_of_pil_samples"]
    got = _decode(data)
    assert list(got.shape) == rec["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec[
        "sha256_of_pil_samples"]


@pytest.mark.parametrize("ext", [".jp2", ".j2k"])
def test_imgtool_convert_and_info_match_reference(tmp_path, capsys, ext):
    src = tmp_path / f"in{ext}"
    _image("RGB", 37, 23).save(src, irreversible=ext == ".j2k")
    outs = {}
    for tag, main in (("t", timgtool.main), ("j", jimgtool.main)):
        (tmp_path / tag).mkdir()
        for out_ext in (".exr", ".png"):
            out = tmp_path / tag / f"out{out_ext}"
            assert main(["convert", str(src), str(out)]) == 0
            outs[tag, out_ext] = out
        capsys.readouterr()
        assert main(["info", str(src)]) == 0
        outs[tag, "info"] = capsys.readouterr().out
    assert outs["t", "info"] == outs["j", "info"]
    assert np.array_equal(timage.decode_png(outs["t", ".png"].read_bytes()),
                          timage.decode_png(outs["j", ".png"].read_bytes()))
    assert np.array_equal(read_exr(str(outs["t", ".exr"]))[0],
                          read_exr(str(outs["j", ".exr"]))[0])
    np.testing.assert_array_equal(timgtool._load(str(src))[0],
                                  jimgtool._load(str(src))[0])


def test_decode_timer_times_both_tier_ones(tmp_path):
    """scripts/time_image_decode.py's JPEG 2000 records (chip_smoke phase
    35 (a) calls its time_jpeg2000 on the fixtures): the C++ and numpy
    tier 1 on a small file, equal."""
    import time_image_decode as tid

    path = tmp_path / "t.jp2"
    path.write_bytes(_save(_image("RGB", 37, 23), irreversible=True))
    records = tid.time_formats(8, 8, reps=1, j2k=[path], twin=True)
    j2k_records = [r for r in records if r[0].startswith("JPEG 2000")]
    assert [r[0].split("(")[-1] for r in j2k_records] == [
        "C++ tier 1)", "numpy tier 1)"]
    assert all(ok for *_, ok in records)


def test_native_build_lands_in_build_dir():
    """The C++ tier 1 is built into build/native/ (ignored by git), and
    nothing else is built beside its source."""
    from acceleratedvolrenderer_tpu_torch import native

    assert native.j2k_library(required=True) is not None
    assert native.J2K_LIB_PATH.exists()
    root = Path(native.__file__).resolve().parents[1].parent
    assert native.J2K_LIB_PATH.parent == root / "build" / "native"
    assert "build/" in (root / ".gitignore").read_text().split()
    assert not list(Path(native.__file__).parent.glob("*.so"))
