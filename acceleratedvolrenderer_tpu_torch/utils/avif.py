"""AVIF read as PIL 12.1.0 reads it (libavif 1.3.0 over dav1d 1.5.1, colour
conversion by libyuv 1909): the HEIF container and the AV1 headers here,
the AV1 intra decode in native/av1_dec.cpp, the YUV -> RGB conversion in
numpy.

decode_avif(data) returns np.asarray(PIL.Image.open(file)): uint8 (H, W, 3),
or (H, W, 4) where the file has an alpha item.  It reads the still images
that PIL's own writer makes through its parameters (quality, speed,
subsampling 4:2:0 / 4:2:2 / 4:4:4 / 4:0:0, range, tiles, alpha
premultiplied or not, ICC profile, EXIF orientation), the screen content
tools libaom turns on by itself for few-colour images (palette, intra
block copy), film grain (applied as dav1d applies it, also on an alpha
item), the AV1 tools common encoders leave on (CDEF, quantizer matrices,
block-level delta q), the BT.601, BT.709 and BT.2020 NCL matrices, `grid`
items and frame 0 of an image sequence.  What it does not read raises a
ValueError that names it (segmentation, block-level delta lf, superres,
more than 8 bits, non-uniform tile spacing, item construction method 2,
other matrices).
"""
from __future__ import annotations

import struct

import numpy as np

BRANDS = (b"avif", b"avis", b"mif1", b"msf1")       # PIL's _accept
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")


def is_avif(data: bytes) -> bool:
    """PIL's AvifImagePlugin._accept: an ftyp box whose major brand is
    avif, avis, mif1 or msf1."""
    return data[4:8] == b"ftyp" and data[8:12] in BRANDS


def _refuse(tool: str):
    raise ValueError(f"avif: {tool} is not read")


def _decline(why: str):
    """libavif cannot parse the container: PIL's plugin raises SyntaxError
    and PIL tries the next plugin (image_read_pil.Declined)."""
    from .image_read_pil import Declined

    raise Declined(f"avif: {why}")


# ---------------------------------------------------------------------------
# HEIF container (ISO/IEC 23008-12 over ISOBMFF)
# ---------------------------------------------------------------------------

def _boxes(data: bytes, pos: int, end: int):
    """(type, payload start, payload end) of each box in data[pos:end]."""
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            _decline("truncated box")
        yield kind, pos + hdr, pos + size
        pos += size


class _Reader:
    def __init__(self, data, pos, end):
        self.d, self.p, self.end = data, pos, end

    def u(self, n):
        if self.p + n > self.end:
            _decline("truncated box")
        v = int.from_bytes(self.d[self.p:self.p + n], "big")
        self.p += n
        return v

    def full(self):
        v = self.u(4)
        return v >> 24, v & 0xFFFFFF


def _parse_meta(data, pos, end):
    m = {"items": {}, "iloc": {}, "props": [], "assoc": {}, "iref": [],
         "idat": None, "pitm": None}
    r = _Reader(data, pos, end)
    r.full()
    for kind, s, e in _boxes(data, r.p, end):
        b = _Reader(data, s, e)
        if kind == b"pitm":
            ver, _ = b.full()
            m["pitm"] = b.u(2 if ver == 0 else 4)
        elif kind == b"iinf":
            ver, _ = b.full()
            b.u(2 if ver == 0 else 4)
            for k2, s2, e2 in _boxes(data, b.p, e):
                if k2 != b"infe":
                    continue
                ib = _Reader(data, s2, e2)
                iver, _ = ib.full()
                if iver < 2:
                    continue
                iid = ib.u(2 if iver == 2 else 4)
                ib.u(2)
                m["items"][iid] = data[ib.p:ib.p + 4]
        elif kind == b"iloc":
            ver, _ = b.full()
            v = b.u(2)
            osz, lsz, bsz = v >> 12, (v >> 8) & 15, (v >> 4) & 15
            isz = v & 15 if ver in (1, 2) else 0
            for _ in range(b.u(2 if ver < 2 else 4)):
                iid = b.u(2 if ver < 2 else 4)
                method = b.u(2) & 15 if ver in (1, 2) else 0
                b.u(2)
                base = b.u(bsz)
                ext = []
                for _ in range(b.u(2)):
                    if isz:
                        b.u(isz)
                    ext.append((base + b.u(osz), b.u(lsz)))
                m["iloc"][iid] = (method, ext)
        elif kind == b"idat":
            m["idat"] = (s, e)
        elif kind == b"iref":
            ver, _ = b.full()
            n = 2 if ver == 0 else 4
            for k2, s2, e2 in _boxes(data, b.p, e):
                rb = _Reader(data, s2, e2)
                frm = rb.u(n)
                m["iref"] += [(k2, frm, rb.u(n)) for _ in range(rb.u(2))]
        elif kind == b"iprp":
            for k2, s2, e2 in _boxes(data, s, e):
                if k2 == b"ipco":
                    m["props"] = list(_boxes(data, s2, e2))
                elif k2 == b"ipma":
                    pb = _Reader(data, s2, e2)
                    ver, flags = pb.full()
                    for _ in range(pb.u(4)):
                        iid = pb.u(2 if ver < 1 else 4)
                        idx = []
                        for _ in range(pb.u(1)):
                            v = pb.u(2) if flags & 1 else pb.u(1)
                            idx.append(v & (0x7FFF if flags & 1 else 0x7F))
                        m["assoc"].setdefault(iid, []).extend(idx)
    return m


def _item_props(data, m, iid):
    out = {}
    for i in m["assoc"].get(iid, []):
        if i == 0 or i > len(m["props"]):
            continue
        kind, s, e = m["props"][i - 1]
        out.setdefault(kind, (s, e))
    return out


def _item_data(data, m, iid):
    if iid not in m["iloc"]:
        _decline(f"item {iid} has no location")
    method, ext = m["iloc"][iid]
    if method == 1:
        if m["idat"] is None:
            _decline("idat item without an idat box")
        base = m["idat"][0]
        parts = [data[base + o:base + o + n] for o, n in ext]
    elif method == 0:
        parts = [data[o:o + n] if n else data[o:] for o, n in ext]
    else:
        _refuse("AVIF item construction method 2")
    return b"".join(parts)


def _nclx(data, props):
    """(matrix, full_range) of the item's colr nclx box, libavif's default
    (BT.601, full range) without one."""
    if b"colr" in props:
        s, e = props[b"colr"]
        if data[s:s + 4] == b"nclx" and e - s >= 11:
            _cp, _tc, mc = struct.unpack(">HHH", data[s + 4:s + 10])
            return mc, data[s + 10] >> 7
    return None


def _parse_trak(data, s, e):
    """One track of a moov box: its id, references, first sample entry
    (its kind and its property boxes) and the offset and size of its
    first sample."""
    t = {"id": 0, "tref": {}, "entry": None, "props": {}, "sample0": None}
    for kind, a, b in _boxes(data, s, e):
        r = _Reader(data, a, b)
        if kind == b"tkhd":
            ver, _ = r.full()
            r.u(16 if ver == 1 else 8)
            t["id"] = r.u(4)
        elif kind == b"tref":
            for k2, a2, b2 in _boxes(data, a, b):
                t["tref"][k2] = [int.from_bytes(data[i:i + 4], "big")
                                 for i in range(a2, b2 - 3, 4)]
        elif kind == b"mdia":
            _parse_mdia(data, a, b, t)
    return t


def _parse_mdia(data, s, e, t):
    size0 = chunk0 = None
    for kind, a, b in _boxes(data, s, e):
        if kind == b"minf":
            for k2, a2, b2 in _boxes(data, a, b):
                if k2 != b"stbl":
                    continue
                for k3, a3, b3 in _boxes(data, a2, b2):
                    r = _Reader(data, a3, b3)
                    if k3 == b"stsd":
                        r.full()
                        for k4, a4, b4 in list(_boxes(data, a3 + 8, b3))[:1]:
                            t["entry"] = k4
                            if k4 == b"av01":   # VisualSampleEntry: 78 bytes
                                for k5, a5, b5 in _boxes(data, a4 + 78, b4):
                                    t["props"].setdefault(k5, (a5, b5))
                    elif k3 == b"stsz":
                        r.full()
                        size, count = r.u(4), r.u(4)
                        if count:
                            size0 = size or r.u(4)
                    elif k3 in (b"stco", b"co64"):
                        r.full()
                        if r.u(4):
                            chunk0 = r.u(4 if k3 == b"stco" else 8)
    if size0 is not None and chunk0 is not None:  # sample 0 opens chunk 1
        t["sample0"] = (chunk0, size0)


def _parse_moov(data, s, e):
    return [_parse_trak(data, a, b) for kind, a, b in _boxes(data, s, e)
            if kind == b"trak"]


# ---------------------------------------------------------------------------
# AV1 OBUs and headers (AV1 specification sections 5.3, 5.5, 5.9, 5.11.1)
# ---------------------------------------------------------------------------

class _Bits:
    def __init__(self, data: bytes, pos: int = 0):
        self.d = data
        self.bit = pos * 8

    def f(self, n):
        v = 0
        for _ in range(n):
            byte = self.d[self.bit >> 3] if (self.bit >> 3) < len(self.d) else 0
            v = (v << 1) | ((byte >> (7 - (self.bit & 7))) & 1)
            self.bit += 1
        return v

    def su(self, n):
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def uvlc(self):
        lz = 0
        while not self.f(1):
            lz += 1
            if lz >= 32:
                return (1 << 32) - 1
        return self.f(lz) + (1 << lz) - 1

    def align(self):
        self.bit = (self.bit + 7) & ~7


def _leb128(d, p):
    v = 0
    for i in range(8):
        b = d[p + i]
        v |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return v, p + i + 1
    return v, p + 8


def _obus(d: bytes):
    p = 0
    while p < len(d):
        h = d[p]
        kind, ext, has_size = (h >> 3) & 15, (h >> 2) & 1, (h >> 1) & 1
        p += 1 + ext
        if has_size:
            n, p = _leb128(d, p)
        else:
            n = len(d) - p
        yield kind, p, p + n
        p += n


def _sequence_header(b: _Bits) -> dict:
    # bit positions of the fields tests flip to make refused streams
    s = {"bit_of": {"seq_profile": b.bit}}
    s["profile"] = b.f(3)
    b.f(1)                                  # still_picture
    s["reduced"] = b.f(1)
    s["decoder_model"] = 0
    s["equal_picture_interval"] = 0
    if s["reduced"]:
        b.f(5)
    else:
        timing = b.f(1)
        if timing:
            b.f(32), b.f(32)
            s["equal_picture_interval"] = b.f(1)
            if s["equal_picture_interval"]:
                b.uvlc()
            s["decoder_model"] = b.f(1)
            if s["decoder_model"]:
                s["buffer_delay_len"] = b.f(5) + 1
                b.f(32)
                s["removal_len"] = b.f(5) + 1
                s["presentation_len"] = b.f(5) + 1
        initial_display = b.f(1)
        s["op_decoder_model"] = []
        for _ in range(b.f(5) + 1):
            b.f(12)
            lvl = b.f(5)
            if lvl > 7:
                b.f(1)
            present = 0
            if s["decoder_model"]:
                present = b.f(1)
                if present:
                    n = s["buffer_delay_len"]
                    b.f(n), b.f(n), b.f(1)
            s["op_decoder_model"].append(present)
            if initial_display and b.f(1):
                b.f(4)
    wb, hb = b.f(4) + 1, b.f(4) + 1
    s["max_w"], s["max_h"] = b.f(wb) + 1, b.f(hb) + 1
    s["w_bits"], s["h_bits"] = wb, hb
    s["frame_id"] = 0 if s["reduced"] else b.f(1)
    if s["frame_id"]:
        s["delta_id_len"] = b.f(4) + 2
        s["id_len"] = b.f(3) + 1 + s["delta_id_len"]
    s["use128"], s["filter_intra"], s["edge_filter"] = b.f(1), b.f(1), b.f(1)
    s["order_hint_bits"] = 0
    s["screen_content"], s["integer_mv"] = 2, 2
    if not s["reduced"]:
        b.f(4)            # interintra, masked, warped, dual filter
        order_hint = b.f(1)
        if order_hint:
            b.f(2)        # jnt_comp, ref_frame_mvs
        s["screen_content"] = 2 if b.f(1) else b.f(1)
        s["integer_mv"] = (2 if b.f(1) else b.f(1)) \
            if s["screen_content"] > 0 else 2
        if order_hint:
            s["order_hint_bits"] = b.f(3) + 1
    s["bit_of"]["enable_superres"] = b.bit
    s["superres"], s["cdef"], s["restoration"] = b.f(1), b.f(1), b.f(1)
    s["bit_of"]["high_bitdepth"] = b.bit
    high = b.f(1)
    bitdepth = 8
    if s["profile"] == 2 and high:
        bitdepth = 12 if b.f(1) else 10
    elif high:
        bitdepth = 10
    if bitdepth != 8:
        _refuse(f"{bitdepth}-bit AV1 (more than 8 bits)")
    mono = 0 if s["profile"] == 1 else b.f(1)
    cp, tc, mc = 2, 2, 2
    if b.f(1):
        cp, tc, mc = b.f(8), b.f(8), b.f(8)
    s["cicp"] = (cp, tc, mc)
    if mono:
        s["full_range"] = b.f(1)
        s["ss"] = (1, 1)
        s["separate_uv_dq"] = 0
    elif cp == 1 and tc == 13 and mc == 0:
        s["full_range"] = 1
        s["ss"] = (0, 0)
        s["separate_uv_dq"] = b.f(1)
    else:
        s["full_range"] = b.f(1)
        if s["profile"] == 0:
            s["ss"] = (1, 1)
        elif s["profile"] == 1:
            s["ss"] = (0, 0)
        else:
            s["ss"] = (1, 0)
        if s["ss"] == (1, 1):
            b.f(2)
        s["separate_uv_dq"] = b.f(1)
    s["mono"] = mono
    s["film_grain_present"] = b.f(1)
    return s


def _tile_log2(blk, target):
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _delta_q(b):
    return b.su(7) if b.f(1) else 0


def _frame_header(b: _Bits, s: dict) -> dict:
    f = {"bit_of": {}}
    resilient = 1
    showable = 0
    if s["reduced"]:
        frame_type, show = 0, 1
    else:
        if b.f(1):
            _refuse("an AV1 show_existing_frame")
        frame_type = b.f(2)
        show = b.f(1)
        if show and s["decoder_model"] and not s["equal_picture_interval"]:
            _refuse("AV1 temporal point info")
        if not show:
            showable = b.f(1)
        if frame_type not in (0, 2):
            _refuse("an AV1 inter frame")
        if not (frame_type == 0 and show):
            resilient = b.f(1)
    f["disable_cdf_update"] = b.f(1)
    screen = b.f(1) if s["screen_content"] == 2 else s["screen_content"]
    f["screen"] = screen
    if screen and s["integer_mv"] == 2:
        b.f(1)                              # force_integer_mv (1 if intra)
    if s["frame_id"]:
        b.f(s["id_len"])
    override = 0 if s["reduced"] else b.f(1)
    b.f(s["order_hint_bits"])
    if s["decoder_model"]:
        if b.f(1):
            for present in s["op_decoder_model"]:
                if present:
                    b.f(s["removal_len"])
    if not (frame_type == 0 and show) and b.f(8) != 0xFF and resilient:
        b.f(8 * s["order_hint_bits"])       # ref_order_hint[8]
    if override:
        w, h = b.f(s["w_bits"]) + 1, b.f(s["h_bits"]) + 1
    else:
        w, h = s["max_w"], s["max_h"]
    if s["superres"] and b.f(1):
        _refuse("AV1 superres")
    f["bit_of"]["render_and_frame_size_different"] = b.bit
    if b.f(1):
        b.f(16), b.f(16)
    f["intrabc"] = b.f(1) if screen else 0
    f["w"], f["h"] = w, h
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((h + 7) >> 3)
    f["mi_cols"], f["mi_rows"] = mi_cols, mi_rows
    if not s["reduced"] and not f["disable_cdf_update"]:
        b.f(1)                              # disable_frame_end_update_cdf
    # tile_info (5.9.15)
    use128 = s["use128"]
    sb_shift = 5 if use128 else 4
    sb_cols = (mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_w_sb = 4096 >> sb_size
    max_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_w_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2 = max(min_log2_cols, _tile_log2(max_area_sb, sb_rows * sb_cols))
    f["bit_of"]["uniform_tile_spacing_flag"] = b.bit
    if not b.f(1):
        _refuse("AV1 non-uniform tile spacing")
    cols_log2 = min_log2_cols
    while cols_log2 < max_log2_cols and b.f(1):
        cols_log2 += 1
    wsb = (sb_cols + (1 << cols_log2) - 1) >> cols_log2
    col_starts = [x << sb_shift for x in range(0, sb_cols, wsb)] + [mi_cols]
    rows_log2 = max(min_log2 - cols_log2, 0)
    while rows_log2 < max_log2_rows and b.f(1):
        rows_log2 += 1
    hsb = (sb_rows + (1 << rows_log2) - 1) >> rows_log2
    row_starts = [y << sb_shift for y in range(0, sb_rows, hsb)] + [mi_rows]
    f["col_starts"], f["row_starts"] = col_starts, row_starts
    f["tile_bits"] = cols_log2 + rows_log2
    f["tile_size_bytes"] = 0
    if f["tile_bits"]:
        b.f(f["tile_bits"])                 # context_update_tile_id
        f["tile_size_bytes"] = b.f(2) + 1
    # quantization_params (5.9.12)
    f["base_q"] = b.f(8)
    dq = [_delta_q(b), 0, 0, 0, 0]          # Y dc, U dc, U ac, V dc, V ac
    if not s["mono"]:
        diff = b.f(1) if s["separate_uv_dq"] else 0
        dq[1], dq[2] = _delta_q(b), _delta_q(b)
        dq[3], dq[4] = (_delta_q(b), _delta_q(b)) if diff else (dq[1], dq[2])
    f["dq"] = dq
    f["qm_level"] = [15, 15, 15]            # 15: flat, no matrix
    if b.f(1):                              # using_qmatrix
        qy, qu = b.f(4), b.f(4)
        f["qm_level"] = [qy, qu, b.f(4) if s["separate_uv_dq"] else qu]
    f["bit_of"]["segmentation_enabled"] = b.bit
    if b.f(1):
        _refuse("AV1 segmentation")
    # delta_q_params, delta_lf_params (5.9.17, 5.9.18)
    f["delta_q_present"] = b.f(1) if f["base_q"] > 0 else 0
    f["delta_q_res"] = b.f(2) if f["delta_q_present"] else 0
    if f["delta_q_present"] and not f["intrabc"]:
        f["bit_of"]["delta_lf_present"] = b.bit
        if b.f(1):
            _refuse("AV1 block-level delta lf")
    lossless = f["base_q"] == 0 and not any(dq)
    f["lossless"] = int(lossless)
    # intra block copy reads the frame before any filter: no deblocking,
    # CDEF or restoration syntax either
    unfiltered = lossless or f["intrabc"]
    # loop_filter_params (5.9.11)
    lf = [0, 0, 0, 0]
    f["lf_sharpness"], f["lf_delta_enabled"] = 0, 1
    f["lf_ref_deltas"] = [1, 0, 0, 0, -1, 0, -1, -1]
    if not unfiltered:
        lf[0], lf[1] = b.f(6), b.f(6)
        if not s["mono"] and (lf[0] or lf[1]):
            lf[2], lf[3] = b.f(6), b.f(6)
        f["lf_sharpness"] = b.f(3)
        f["lf_delta_enabled"] = b.f(1)
        if f["lf_delta_enabled"] and b.f(1):
            for i in range(8):
                if b.f(1):
                    f["lf_ref_deltas"][i] = b.su(7)
            for i in range(2):
                if b.f(1):
                    b.su(7)
    f["lf"] = lf
    # cdef_params (5.9.19)
    f["cdef"] = int(not unfiltered and s["cdef"])
    f["cdef_damping"], f["cdef_bits"] = 3, 0
    for k in ("y_pri", "y_sec", "uv_pri", "uv_sec"):
        f["cdef_" + k] = [0] * 8
    if f["cdef"]:
        f["cdef_damping"] = b.f(2) + 3
        f["cdef_bits"] = b.f(2)
        for i in range(1 << f["cdef_bits"]):
            for k in ("y", "uv") if not s["mono"] else ("y",):
                f[f"cdef_{k}_pri"][i] = b.f(4)
                sec = b.f(2)
                f[f"cdef_{k}_sec"][i] = 4 if sec == 3 else sec
    # lr_params (5.9.20)
    f["lr_type"] = [0, 0, 0]
    f["lr_size"] = [64, 64, 64]
    if not unfiltered and s["restoration"]:
        remap = (0, 3, 1, 2)
        planes = 1 if s["mono"] else 3
        for i in range(planes):
            f["lr_type"][i] = remap[b.f(2)]
        if any(f["lr_type"]):
            if use128:
                shift = b.f(1) + 1
            else:
                shift = b.f(1)
                if shift:
                    shift += b.f(1)
            size = 256 >> (2 - shift)
            uv_shift = 0
            if s["ss"] == (1, 1) and any(f["lr_type"][1:]):
                uv_shift = b.f(1)
            f["lr_size"] = [size, size >> uv_shift, size >> uv_shift]
    # read_tx_mode, reduced_tx_set, film grain
    f["tx_mode"] = 0 if lossless else (2 if b.f(1) else 1)
    f["reduced_tx_set"] = b.f(1)
    f["grain"] = None
    if s["film_grain_present"] and (show or showable) and b.f(1):
        f["grain"] = _film_grain(b, s, f["bit_of"])
    return f


def _grain_points(b, n_max, what):
    n = b.f(4)
    if n > n_max:
        raise ValueError(f"avif: AV1 film grain with {n} {what} points "
                         f"(at most {n_max})")
    pts = [(b.f(8), b.f(8)) for _ in range(n)]
    if any(p[0] >= q[0] for p, q in zip(pts, pts[1:])):
        raise ValueError(f"avif: AV1 film grain {what} points that do not "
                         "increase")
    return pts


def _film_grain(b: _Bits, s: dict, bit_of: dict) -> dict:
    """film_grain_params (5.9.30) of a frame that applies grain, with
    dav1d's checks (a file that breaks them is not decoded)."""
    g = {"seed": b.f(16)}
    bit_of["num_y_points"] = b.bit
    g["y"] = _grain_points(b, 14, "luma")
    g["from_luma"] = 0 if s["mono"] else b.f(1)
    g["cb"], g["cr"] = [], []
    if not (s["mono"] or g["from_luma"] or (s["ss"] == (1, 1)
                                            and not g["y"])):
        g["cb"] = _grain_points(b, 10, "Cb")
        g["cr"] = _grain_points(b, 10, "Cr")
        if s["ss"] == (1, 1) and bool(g["cb"]) != bool(g["cr"]):
            raise ValueError("avif: AV1 film grain on one 4:2:0 chroma "
                             "plane")
    g["scaling_shift"] = b.f(2) + 8
    g["lag"] = b.f(2)
    npos = 2 * g["lag"] * (g["lag"] + 1)
    g["ar_y"] = [b.f(8) - 128 for _ in range(npos)] if g["y"] else []
    for k in ("cb", "cr"):
        n = npos + 1 if g["y"] else npos
        g["ar_" + k] = ([b.f(8) - 128 for _ in range(n)]
                        if g["from_luma"] or g[k] else [])
    g["ar_shift"] = b.f(2) + 6
    g["grain_scale_shift"] = b.f(2)
    for k in ("cb", "cr"):
        g[k + "_mult"] = g[k + "_luma_mult"] = g[k + "_offset"] = 0
        if g[k]:
            g[k + "_mult"] = b.f(8) - 128
            g[k + "_luma_mult"] = b.f(8) - 128
            g[k + "_offset"] = b.f(9) - 256
    g["overlap"] = b.f(1)
    bit_of["clip_to_restricted_range"] = b.bit
    g["clip"] = b.f(1)
    return g


def _tiles(d: bytes, start: int, end: int, f: dict):
    """(offset, size) of each tile of a tile group OBU (5.11.1)."""
    ntiles = (len(f["col_starts"]) - 1) * (len(f["row_starts"]) - 1)
    b = _Bits(d, start)
    first, last = 0, ntiles - 1
    if ntiles > 1 and b.f(1):
        first, last = b.f(f["tile_bits"]), b.f(f["tile_bits"])
    b.align()
    p = b.bit >> 3
    out = []
    for t in range(first, last + 1):
        if t == last:
            out.append((t, p, end - p))
            break
        n = f["tile_size_bytes"]
        size = int.from_bytes(d[p:p + n], "little") + 1
        p += n
        out.append((t, p, size))
        p += size
    return out


def parse_av1(d: bytes):
    """(sequence header, frame header, [(tile number, offset, size)]) of
    the one frame of an AV1 image item.  Each header's `bit_of` holds the
    bit positions (in the item) of a few fields."""
    seq, frame, tiles = None, None, []
    for kind, s, e in _obus(d):
        if kind == 1:
            seq = _sequence_header(_Bits(d, s))
        elif kind in (3, 6):
            if seq is None:
                raise ValueError("avif: frame header before a sequence header")
            b = _Bits(d, s)
            frame = _frame_header(b, seq)
            if kind == 6:
                b.align()
                tiles += _tiles(d, b.bit >> 3, e, frame)
        elif kind == 4:
            tiles += _tiles(d, s, e, frame)
    if frame is None or not tiles:
        raise ValueError("avif: no AV1 frame in the image item")
    return seq, frame, tiles


def decode_av1(d: bytes):
    """The Y, U, V planes (uint8; U and V None for 4:0:0) of an AV1 still
    image, and its sequence header."""
    from ..native import av1_decode

    seq, frame, tiles = parse_av1(d)
    planes = av1_decode(d, seq, frame, tiles)
    return planes, seq


# ---------------------------------------------------------------------------
# YUV -> RGB (libavif 1.3.0 through libyuv 1909)
# ---------------------------------------------------------------------------

# libyuv's YuvConstants, (YG, YB, UB, UG, VG, VR), by the
# matrix_coefficients that libavif hands to libyuv and by full range (1) or
# limited (0): kYuvJPEG / kYuvI601 (BT.601: 2 unspecified, 5, 6),
# kYuvF709 / kYuvH709 (BT.709: 1), kYuvF2020 / kYuvV2020 (BT.2020 NCL: 9)
_BT601 = {1: (16320, 32, 113, 22, 46, 90),
          0: (18997, -1160, 128, 25, 52, 102)}
_BT709 = {1: (16320, 32, 119, 12, 30, 101),
          0: (18997, -1160, 128, 14, 34, 115)}
_BT2020 = {1: (16320, 32, 120, 11, 37, 94),
           0: (19003, -1160, 128, 12, 42, 107)}
_LIBYUV = {2: _BT601, 5: _BT601, 6: _BT601, 1: _BT709, 9: _BT2020}


def _upsample_taps(n: int, vertical: bool):
    """libyuv's 2x bilinear chroma upsampling along one axis of n samples
    (I420ToRGB24MatrixFilter, kFilterBilinear): each output's two source
    indices and their weights in quarters, and whether it is interpolated
    (3:1) rather than copied.  The first sample copies, and so does the
    last, save the last row of an odd height, which the row-pair loop
    interpolates."""
    i = np.arange(n)
    k = np.maximum(i - 1, 0) // 2
    m = (n + 1) // 2
    a, b = k, np.minimum(k + 1, m - 1)
    wa = np.where(i % 2 == 1, 3, 1)
    mixed = i >= 1
    last = n - 1
    if n > 1 and not (vertical and n % 2):
        mixed[last] = False
    a = np.where(mixed, a, np.where(i == 0, 0, (n - 1) // 2))
    wa = np.where(mixed, wa, 4)
    return a, b, wa, 4 - wa, mixed


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """A 4:2:0 chroma plane at (h, w): libyuv's bilinear 2x2 filter."""
    ya, yb, wya, wyb, my = _upsample_taps(h, True)
    xa, xb, wxa, wxb, mx = _upsample_taps(w, False)
    c = c.astype(np.int32)
    v = wya[:, None] * c[ya] + wyb[:, None] * c[yb]            # quarters
    full = wxa * v[:, xa] + wxb * v[:, xb]                     # sixteenths
    out = (full + 8) >> 4
    # copied rows and columns round once, along the other axis only
    rows, cols = np.flatnonzero(~my), np.flatnonzero(~mx)
    out[rows] = ((full[rows] >> 2) + 2) >> 2
    out[:, cols] = ((full[:, cols] >> 2) + 2) >> 2
    out[np.ix_(rows, cols)] = full[np.ix_(rows, cols)] >> 4
    return out


def _upsample_h(c: np.ndarray, w: int) -> np.ndarray:
    """A 4:2:2 chroma plane at width w: libyuv's linear 2x filter along
    rows only (I422ToRGB24MatrixFilter, ScaleRowUp2_Linear)."""
    xa, xb, wxa, wxb, _ = _upsample_taps(w, False)
    c = c.astype(np.int32)
    return (wxa * c[:, xa] + wxb * c[:, xb] + 2) >> 2


def _yuv_pixels(y, u, v, constants) -> np.ndarray:
    """libyuv's YuvPixel with one set of YuvConstants: uint8 (..., 3)."""
    yg, yb, ub, ug, vg, vr = constants
    y = y.astype(np.int32)       # y * 0x0101 * yg < 2**31
    u = u.astype(np.int32)
    v = v.astype(np.int32)
    y1 = (y * 0x0101 * yg) >> 16
    b = (y1 + u * ub - (ub * 128 - yb)) >> 6
    g = (y1 - (u * ug + v * vg) + (ug * 128 + vg * 128 + yb)) >> 6
    r = (y1 + v * vr - (vr * 128 - yb)) >> 6
    out = np.empty(y.shape + (3,), np.uint8)
    for i, c in enumerate((r, g, b)):
        out[..., i] = np.clip(c, 0, 255)
    return out


def _limited_to_full(a: np.ndarray) -> np.ndarray:
    """libavif's avifLimitedToFullY (8-bit): the range of an alpha item."""
    a = a.astype(np.int64)
    q = ((a - 16) * 255 + 109)
    return np.clip(np.where(q < 0, -((-q) // 219), q // 219), 0,
                   255).astype(np.uint8)


def yuv_to_rgb(y, u, v, seq: dict, nclx, alpha, premultiplied: bool):
    """The RGB(A) samples PIL gets from libavif's avifImageYUVToRGB."""
    matrix, full = nclx if nclx is not None else (seq["cicp"][2],
                                                  seq["full_range"])
    if matrix not in _LIBYUV:
        _refuse(f"AVIF matrix_coefficients {matrix} (only BT.601, BT.709 "
                "and BT.2020 NCL)")
    constants = _LIBYUV[matrix][full]
    h, w = y.shape
    if u is None:
        if full:
            rgb = _yuv_pixels(y, np.full_like(y, 128), np.full_like(y, 128),
                              constants)
        else:   # libavif's own float path for limited-range 4:0:0
            g = np.floor((y.astype(np.float64) - 16) * 255 / 219 + 0.5)
            rgb = np.repeat(np.clip(g, 0, 255).astype(np.uint8)[..., None],
                            3, -1)
    else:
        if u.shape[0] != h:
            u, v = _upsample(u, h, w), _upsample(v, h, w)
        elif u.shape[1] != w:
            u, v = _upsample_h(u, w), _upsample_h(v, w)
        rgb = _yuv_pixels(y, u, v, constants)
    if alpha is None:
        return rgb
    a, a_full = alpha
    if a.shape != (h, w):
        raise ValueError("avif: the alpha item's size differs from the image's")
    if not a_full:
        a = _limited_to_full(a)
    if premultiplied:       # libyuv's ARGBUnattenuate, alpha 255 left alone
        ai = a.astype(np.int64)[..., None]
        inv = np.where(ai == 0, 0, np.where(ai == 1, 0xFFFF,
                                            0x10000 // np.maximum(ai, 1)))
        c = rgb.astype(np.int64)
        un = np.minimum(((c | (c << 8)) * inv) >> 16, 255)
        rgb = np.where(ai == 255, c, un).astype(np.uint8)
    return np.concatenate([rgb, a[..., None]], -1)


def _tile_planes(data, meta, iid):
    """The Y, U, V planes and the sequence header of one av01 item."""
    if meta["items"].get(iid) != b"av01":
        _decline(f"item {iid} is {meta['items'].get(iid)!r}, not av01")
    return decode_av1(_item_data(data, meta, iid))


def _grid_planes(data, meta, iid):
    """The planes of a `grid` item (ISO/IEC 23008-12 6.6.2.3): its dimg
    tiles, in the order iref lists them, decoded, stitched row by row and
    cropped to the output size, with libavif's checks."""
    payload = _item_data(data, meta, iid)
    r = _Reader(payload, 0, len(payload))
    if r.u(1) != 0:
        _decline("grid version is not 0")
    n = 4 if r.u(1) & 1 else 2
    rows, cols = r.u(1) + 1, r.u(1) + 1
    out_w, out_h = r.u(n), r.u(n)
    ids = [to for k, frm, to in meta["iref"] if k == b"dimg" and frm == iid]
    if len(ids) != rows * cols:
        _decline(f"grid of {rows}x{cols} with {len(ids)} tiles")
    tiles = [_tile_planes(data, meta, t) for t in ids]
    (y0, u0, _), seq = tiles[0]
    th, tw = y0.shape
    key = (seq["ss"], seq["mono"], seq["full_range"])
    if any(t[0][0].shape != (th, tw) or (t[1]["ss"], t[1]["mono"],
                                          t[1]["full_range"]) != key
           for t in tiles):
        _decline("grid tiles differ in size or format")
    ssx, ssy = seq["ss"]
    if (tw * cols < out_w or th * rows < out_h or tw * (cols - 1) >= out_w
            or th * (rows - 1) >= out_h or tw < 64 or th < 64
            or (not seq["mono"] and ssx and (out_w % 2 or tw % 2))
            or (not seq["mono"] and ssy and (out_h % 2 or th % 2))):
        raise ValueError(f"avif: grid of {rows}x{cols} {tw}x{th} tiles "
                         f"for {out_w}x{out_h} breaks MIAF's rules "
                         "(libavif refuses the grid)")
    planes = []
    for k in range(1 if seq["mono"] else 3):
        sx, sy = (ssx, ssy) if k else (0, 0)
        full = np.concatenate([np.concatenate(
            [tiles[r * cols + c][0][k] for c in range(cols)], 1)
            for r in range(rows)], 0)
        planes.append(np.ascontiguousarray(
            full[:(out_h + sy) >> sy, :(out_w + sx) >> sx]))
    planes += [None] * (3 - len(planes))
    return planes, seq


def _image_planes(data, meta, iid):
    if meta["items"].get(iid) == b"grid":
        return _grid_planes(data, meta, iid)
    return _tile_planes(data, meta, iid)


def _decode_item(data, meta):
    """The primary item (av01 or grid) and its alpha item, as libavif's
    AVIF_DECODER_SOURCE_PRIMARY_ITEM reads them."""
    prim = meta["pitm"]
    kind = meta["items"].get(prim)
    if kind not in (b"av01", b"grid"):
        _decline(f"the primary item is {kind!r}, not av01 or grid")
    props = _item_props(data, meta, prim)
    (y, u, v), seq = _image_planes(data, meta, prim)
    nclx = _nclx(data, props)
    alpha = None
    alpha_id = None
    for k, frm, to in meta["iref"]:
        if (k == b"auxl" and to == prim
                and meta["items"].get(frm) in (b"av01", b"grid")):
            aprops = _item_props(data, meta, frm)
            if b"auxC" in aprops:
                s, e = aprops[b"auxC"]
                urn = data[s + 4:e].split(b"\0")[0]
                if urn in ALPHA_URNS:
                    alpha_id = frm
    premultiplied = False
    if alpha_id is not None:
        (alpha, _, _), aseq = _image_planes(data, meta, alpha_id)
        alpha = (alpha, aseq["full_range"])
        premultiplied = any(k == b"prem" and frm == prim and to == alpha_id
                            for k, frm, to in meta["iref"])
    return yuv_to_rgb(y, u, v, seq, nclx, alpha, premultiplied)


def _decode_track(data, tracks):
    """Frame 0 of the colour track (the first av01 track that is not an
    auxiliary one) and of its alpha track, as libavif's
    AVIF_DECODER_SOURCE_TRACKS reads them."""
    def sample0(t):
        if t["sample0"] is None:
            _decline(f"track {t['id']} has no samples")
        off, n = t["sample0"]
        return decode_av1(data[off:off + n])

    av01 = [t for t in tracks if t["id"] and t["entry"] == b"av01"]
    colour = [t for t in av01 if b"auxl" not in t["tref"]]
    if not colour:
        _decline("no av01 track")
    col = colour[0]
    (y, u, v), seq = sample0(col)
    nclx = _nclx(data, col["props"])
    alpha, premultiplied = None, False
    for t in av01:
        if col["id"] in t["tref"].get(b"auxl", []):
            (a, _, _), aseq = sample0(t)
            alpha = (a, aseq["full_range"])
            premultiplied = t["id"] in col["tref"].get(b"prem", [])
            break
    return yuv_to_rgb(y, u, v, seq, nclx, alpha, premultiplied)


def decode_avif(data: bytes) -> np.ndarray:
    """np.asarray(PIL.Image.open(...)) of an AVIF file; raises
    image_read_pil.Declined where libavif cannot parse the container (PIL
    then tries its next plugin), ValueError naming the tool where the
    file uses one this port does not read.  Like libavif's
    AVIF_DECODER_SOURCE_AUTO it reads frame 0 of the tracks of an `avis`
    file (or of a file of another major brand than `avif` that has
    tracks), and the primary item otherwise."""
    if not is_avif(data):
        _decline("not an AVIF file")
    meta, tracks = None, []
    for kind, s, e in _boxes(data, 0, len(data)):
        if kind == b"meta":
            meta = _parse_meta(data, s, e)
        elif kind == b"moov":
            tracks = _parse_moov(data, s, e)
    major = data[8:12]
    if major == b"avis" or (major != b"avif" and tracks):
        return _decode_track(data, tracks)
    if meta is None or meta["pitm"] is None:
        _decline("no primary item")
    return _decode_item(data, meta)
