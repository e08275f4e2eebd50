"""The committed AVIF fixtures (tests/data/images/*.avif): which samples
PIL's writer encoded with which parameters, and their decode by the port
held to images.json's hashes of PIL's decode.

  - sky_2048x1024_q75.avif: PIL 12.1.0's defaults (quality 75, speed 6,
    4:2:0, autotiling: 4x2 tiles of 128x128 superblocks, TX_MODE_SELECT)
    on sky_2048x1024_q90.webp's samples: chip_smoke.py phase 39's sky map;
  - ground_1024x512_s4.avif: speed 4 on ground_1024x512_q90.webp's
    samples (self-guided restoration for luma, Wiener for chroma): phase
    39's ground texture;
  - six 128x96 crops of the ground (AVIF_SMALL): RGBA with premultiplied
    alpha, 4:4:4, 4:0:0, limited range, lossless (quality 100) and speed
    10, decoded by chip_smoke.py's side process (phase 37);
  - TOOL_FILES, the tools common encoders use: phase 40's grid sky of
    two 1024x1024 tiles with CDEF, quantizer matrices and delta q
    (TOOLS_SKY) and 4:2:2 BT.709 ground with CDEF (TOOLS_GROUND), and
    eight 128x96 crops of one tool each (TOOL_SMALL, phase 37);
  - SCREEN_FILES, film grain and the screen content tools PIL's default
    save turns on for few-colour images: phase 41's sky (the WebP sky's
    samples with denoise-noise-level, whose noise model libaom solves
    into film grain: GRAIN_SKY) and ground (a flat-colour checker with
    labels, palette and intra block copy: SCREEN_GROUND), and four crops
    (SCREEN_SMALL, phase 37): a palette, intra block copy (384x96: in a
    frame 128 wide no block has a valid DV, as libaom keeps a DV 256
    pixels behind in 64x64 superblock order), a binary cut-out alpha and
    a film grain test vector.

scripts/make_image_fixtures.py --avif writes them (make_files) and their
records; tests/test_torch_image_formats_avif.py and
tests/test_torch_image_formats_avif_tools.py hold them to PIL.

    python3 scripts/avif_maps.py      # decode each fixture, print seconds
                                      # and the AV1 stage's
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import io
import json
import struct
import time
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parents[1] / "tests" / "data" / "images"
READ_BY = "utils/avif.py"
AVIF_SKY = "sky_2048x1024_q75.avif"
AVIF_GROUND = "ground_1024x512_s4.avif"
CROP = (128, 96)
# name: (source, PIL's save parameters); "sky" and "ground" are the WebP
# fixtures' decoded samples, "crop" the ground's first 128x96, "rgba" the
# crop with ALPHA as its fourth channel
AVIF_FILES = {
    AVIF_SKY: ("sky", {}),
    AVIF_GROUND: ("ground", {"speed": 4}),
    "ground_128x96_rgba.avif": ("rgba", {"alpha_premultiplied": True}),
    "ground_128x96_444.avif": ("crop", {"subsampling": "4:4:4"}),
    "ground_128x96_400.avif": ("crop", {"subsampling": "4:0:0"}),
    "ground_128x96_limited.avif": ("crop", {"range": "limited"}),
    "ground_128x96_lossless.avif": ("crop", {"quality": 100}),
    "ground_128x96_s10.avif": ("crop", {"speed": 10}),
}
AVIF_SMALL = tuple(n for n in AVIF_FILES if n not in (AVIF_SKY, AVIF_GROUND))

# The AV1 and HEIF tools common encoders use (chip_smoke.py phase 40 and
# its crops): name: (source, recipe).  A recipe is PIL's save parameters
# ("pil_save") and what the script does to PIL's file: "grid" (rows,
# columns, width, height: PIL saves each tile, compose_grid joins them),
# "nclx_matrix" (the colr box's matrix_coefficients set to it) or
# "frames" (PIL's save_all of that many crops side by side in the
# ground).  "crop128" is the ground's first 128x128.
TOOLS = {"enable-cdef": "1", "enable-qm": "1", "deltaq-mode": "2"}
TOOLS_SKY = "sky_2048x1024_grid_cdef.avif"
TOOLS_GROUND = "ground_1024x512_422_bt709.avif"
TOOL_FILES = {
    TOOLS_SKY: ("sky", {"pil_save": {"quality": 75, "speed": 6,
                                     "advanced": TOOLS},
                        "grid": [1, 2, 2048, 1024]}),
    TOOLS_GROUND: ("ground", {"pil_save": {"subsampling": "4:2:2",
                                           "advanced": {"enable-cdef": "1"}},
                              "nclx_matrix": 1}),
    "ground_128x96_cdef.avif": ("crop", {"pil_save": {
        "quality": 60, "speed": 4, "advanced": {"enable-cdef": "1"}}}),
    "ground_128x96_qm.avif": ("crop", {"pil_save": {
        "advanced": {"enable-qm": "1"}}}),
    "ground_128x96_deltaq.avif": ("crop", {"pil_save": {
        "advanced": {"deltaq-mode": "2"}}}),
    "ground_128x96_422.avif": ("crop", {"pil_save": {
        "subsampling": "4:2:2"}}),
    "ground_128x96_bt709.avif": ("crop", {"pil_save": {},
                                          "nclx_matrix": 1}),
    "ground_128x96_bt2020_limited.avif": ("crop", {
        "pil_save": {"range": "limited"}, "nclx_matrix": 9}),
    "ground_128x96_grid.avif": ("crop128", {"pil_save": {},
                                            "grid": [2, 2, 128, 96]}),
    "ground_128x96_sequence.avif": ("ground", {"pil_save": {},
                                               "frames": 2}),
}
TOOL_SMALL = tuple(n for n in TOOL_FILES if n not in (TOOLS_SKY,
                                                       TOOLS_GROUND))

# Film grain and screen content (chip_smoke.py phase 41 and its crops):
# name: (source, recipe) as TOOL_FILES'.  "labels" is labels(512, 1024),
# "labels_crop" its first 128x96, "labels_strip" labels(96, 384, 16),
# "cutout" the ground's crop with cutout()'s binary alpha.
GRAIN_SKY = "sky_2048x1024_grain.avif"
SCREEN_GROUND = "ground_1024x512_screen.avif"
SCREEN_FILES = {
    GRAIN_SKY: ("sky", {"pil_save": {"advanced": {
        "denoise-noise-level": "20"}}}),
    SCREEN_GROUND: ("labels", {"pil_save": {}}),
    "ground_128x96_palette.avif": ("labels_crop", {"pil_save": {}}),
    "ground_384x96_intrabc.avif": ("labels_strip", {"pil_save": {}}),
    "ground_128x96_cutout.avif": ("cutout", {"pil_save": {}}),
    "ground_128x96_grain.avif": ("crop", {"pil_save": {"advanced": {
        "film-grain-test": "1"}}}),
}
SCREEN_SMALL = tuple(n for n in SCREEN_FILES if n not in (GRAIN_SKY,
                                                           SCREEN_GROUND))

# a 3x5 pixel font of the digits, row by row
FONT = {"0": "111101101101111", "1": "010110010010111",
        "2": "111001111100111", "3": "111001111001111",
        "4": "101101111001001", "5": "111100111001111",
        "6": "111100111101111", "7": "111001010010010",
        "8": "111101111101111", "9": "111101111001111"}
LABEL_COLOURS = ((178, 152, 112), (120, 140, 84), (150, 96, 70),
                 (196, 188, 160))
LABEL_INK = (40, 36, 30)


def labels(h, w, tile=48):
    """A ground texture of flat colours: tiles of four colours, each
    labelled in dark ink with its row and column (digits of the 3x5
    font drawn at twice its size), uint8 (h, w, 3)."""
    colours = np.array(LABEL_COLOURS, np.uint8)
    yy, xx = np.mgrid[:h, :w]
    px = colours[(yy // tile + 2 * (xx // tile)) % 4]
    for r in range((h + tile - 1) // tile):
        for c in range((w + tile - 1) // tile):
            for k, ch in enumerate(f"{r}{c:02d}"):
                glyph = np.kron(np.array([int(b) for b in FONT[ch]], bool)
                                .reshape(5, 3), np.ones((2, 2), bool))
                ys, xs = np.nonzero(glyph)
                ys, xs = ys + r * tile + 6, xs + c * tile + 6 + 8 * k
                ok = (ys < h) & (xs < w)
                px[ys[ok], xs[ok]] = LABEL_INK
    return px


def cutout(h, w):
    """A binary cut-out alpha, as a foliage texture has: an ellipse
    opaque (255) in a transparent (0) field."""
    y, x = np.mgrid[:h, :w]
    inside = ((y - h / 2) / (0.42 * h)) ** 2 + ((x - w / 2) / (0.43 * w)) ** 2
    return np.where(inside < 1, 255, 0).astype(np.uint8)


def alpha(h, w):
    """The RGBA fixture's alpha: a ramp with a transparent and an opaque
    band."""
    y, x = np.mgrid[:h, :w]
    a = (x * 255 // max(w - 1, 1) + y) % 256
    a[:, : w // 8] = 0
    a[:, -w // 8:] = 255
    return a.astype(np.uint8)


def sources(sky_px, ground_px):
    w, h = CROP
    crop = np.ascontiguousarray(ground_px[:h, :w, :3])
    ground_labels = labels(512, 1024)
    return {"sky": sky_px[..., :3], "ground": ground_px[..., :3],
            "crop": crop,
            "crop128": np.ascontiguousarray(ground_px[:w, :w, :3]),
            "rgba": np.concatenate([crop, alpha(h, w)[..., None]], -1),
            "labels": ground_labels,
            "labels_crop": np.ascontiguousarray(ground_labels[:h, :w]),
            "labels_strip": labels(h, 3 * w, 16),
            "cutout": np.concatenate([crop, cutout(h, w)[..., None]], -1)}


def pil_file(px, **kw):
    """PIL's AVIF file of uint8 (h, w, 3 or 4) samples (needs PIL)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(px, "RGBA" if px.shape[-1] == 4 else "RGB").save(
        buf, "AVIF", **kw)
    return buf.getvalue()


def set_nclx_matrix(data, matrix):
    """data with its (first) colr nclx box's matrix_coefficients set."""
    i = data.index(b"colrnclx") + 12
    return data[:i] + struct.pack(">H", matrix) + data[i + 2:]


def pil_sequence(frames, **kw):
    """PIL's save_all AVIF file of the frames (needs PIL)."""
    from PIL import Image

    ims = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, "AVIF", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


def grid_file(px, rows, cols, width, height, **kw):
    """px cut into rows x cols tiles, each saved by PIL with kw, composed
    into a grid cropped to width x height."""
    th, tw = px.shape[0] // rows, px.shape[1] // cols
    return compose_grid([pil_file(np.ascontiguousarray(
        px[r * th:(r + 1) * th, c * tw:(c + 1) * tw]), **kw)
        for r in range(rows) for c in range(cols)], rows, cols, width,
        height, premultiplied=kw.get("alpha_premultiplied", False))


def tool_file(px, recipe):
    """The file of one TOOL_FILES recipe from its source samples."""
    kw = recipe["pil_save"]
    if "grid" in recipe:
        return grid_file(px, *recipe["grid"], **kw)
    if "frames" in recipe:
        w, h = CROP
        return pil_sequence([np.ascontiguousarray(px[:h, k * w:(k + 1) * w])
                             for k in range(recipe["frames"])], **kw)
    data = pil_file(px, **kw)
    if "nclx_matrix" in recipe:
        data = set_nclx_matrix(data, recipe["nclx_matrix"])
    return data


def recipe(name):
    """A fixture's record of how it was made: PIL's save parameters, and
    for TOOL_FILES what the script did to PIL's file."""
    if name in AVIF_FILES:
        return {"pil_save": AVIF_FILES[name][1]}
    if name in SCREEN_FILES:
        return SCREEN_FILES[name][1]
    return TOOL_FILES[name][1]


def make_files(sky_px, ground_px):
    """{name: bytes} of every AVIF fixture (needs PIL)."""
    src = sources(sky_px, ground_px)
    out = {}
    for name, (which, kw) in AVIF_FILES.items():
        out[name] = pil_file(src[which], **kw)
    for name, (which, rec) in {**TOOL_FILES, **SCREEN_FILES}.items():
        out[name] = tool_file(src[which], rec)
    return out


# ---------------------------------------------------------------- grids

def _box(kind, payload):
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def _full(kind, version, flags, payload):
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big") + payload)


def _items(data):
    """The colour and alpha AV1 streams of one of PIL's still AVIF files,
    each with its property boxes (whole, header included)."""
    from acceleratedvolrenderer_tpu_torch.utils import avif

    meta = next(avif._parse_meta(data, s, e)
                for kind, s, e in avif._boxes(data, 0, len(data))
                if kind == b"meta")
    out = {}
    alpha = {frm for k, frm, to in meta["iref"] if k == b"auxl"}
    for iid in meta["items"]:
        props = [data[s - 8:e] for kind, (s, e)
                 in avif._item_props(data, meta, iid).items()
                 if kind != b"ispe"]
        out["alpha" if iid in alpha else "colour"] = (
            avif._item_data(data, meta, iid), props)
    return out


def compose_grid(files, rows, cols, width, height, premultiplied=False):
    """An AVIF file whose primary item is a `grid` of rows x cols tiles
    cropped to width x height, as libavif writes a grid: the ImageGrid
    payload in `idat` (construction method 1), the tiles hidden av01
    items in `mdat` named by `dimg` in raster order, ispe on every item,
    the colour properties on the grid, av1C on the tiles.  files: PIL's
    still AVIF files of the tiles, row by row, all of one size; where they
    have alpha, the alpha tiles make a second grid (auxl, and prem where
    premultiplied)."""
    from acceleratedvolrenderer_tpu_torch.utils import avif

    tiles = [_items(f) for f in files]
    first = avif.decode_avif(files[0])
    th, tw = first.shape[:2]
    planes = ["colour"] + (["alpha"] if "alpha" in tiles[0] else [])
    n = rows * cols
    # item ids: grids 1 (colour), 2 (alpha); tiles from 3 on
    grid_ids = {pl: 1 + i for i, pl in enumerate(planes)}
    tile_ids = {pl: [3 + i * n + k for k in range(n)]
                for i, pl in enumerate(planes)}
    big = width > 0xFFFF or height > 0xFFFF
    payload = bytes([0, int(big), rows - 1, cols - 1]) + (
        struct.pack(">II" if big else ">HH", width, height))
    props, assoc = [], {}

    def prop(raw, essential=False):
        if raw not in props:
            props.append(raw)
        return (0x80 if essential else 0) | (props.index(raw) + 1)

    def ispe(w, h):
        return _full(b"ispe", 0, 0, struct.pack(">II", w, h))

    for pl in planes:
        tprops = tiles[0][pl][1]
        grid_props = [p for p in tprops if p[4:8] != b"av1C"]
        assoc[grid_ids[pl]] = [prop(ispe(width, height))] + [
            prop(p, p[4:8] == b"auxC") for p in grid_props]
        for k, t in enumerate(tiles):
            assoc[tile_ids[pl][k]] = [prop(ispe(tw, th))] + [
                prop(p, p[4:8] == b"av1C") for p in t[pl][1]
                if p[4:8] in (b"av1C", b"pixi")]
    order = [grid_ids[pl] for pl in planes] + [i for pl in planes
                                               for i in tile_ids[pl]]
    streams = {tile_ids[pl][k]: t[pl][0] for pl in planes
               for k, t in enumerate(tiles)}

    def meta(mdat_at):
        infe = b"".join(_full(b"infe", 2, 0 if i in grid_ids.values() else 1,
                              struct.pack(">HH", i, 0)
                              + (b"grid" if i in grid_ids.values()
                                 else b"av01") + b"\0") for i in order)
        iloc, at, idat_at = [], mdat_at, 0
        for i in order:
            if i in grid_ids.values():
                iloc.append(struct.pack(">HHHHII", i, 1, 0, 1, idat_at,
                                        len(payload)))
                idat_at += len(payload)
            else:
                iloc.append(struct.pack(">HHHHII", i, 0, 0, 1, at,
                                        len(streams[i])))
                at += len(streams[i])
        refs = [_box(b"dimg", struct.pack(">HH", grid_ids[pl], n) + b"".join(
            struct.pack(">H", i) for i in tile_ids[pl])) for pl in planes]
        if "alpha" in grid_ids:
            refs.append(_box(b"auxl", struct.pack(">HHH", 2, 1, 1)))
            if premultiplied:
                refs.append(_box(b"prem", struct.pack(">HHH", 1, 1, 2)))
        ipma = struct.pack(">I", len(order)) + b"".join(
            struct.pack(">HB", i, len(assoc[i])) + bytes(assoc[i])
            for i in order)
        return _full(b"meta", 0, 0, b"".join([
            _full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13),
            _full(b"pitm", 0, 0, struct.pack(">H", 1)),
            _full(b"iloc", 1, 0, bytes([0x44, 0x00])
                  + struct.pack(">H", len(order)) + b"".join(iloc)),
            _full(b"iinf", 0, 0, struct.pack(">H", len(order)) + infe),
            _full(b"iref", 0, 0, b"".join(refs)),
            _box(b"iprp", _box(b"ipco", b"".join(props))
                 + _full(b"ipma", 0, 0, ipma)),
            _box(b"idat", payload * len(planes))]))

    ftyp = _box(b"ftyp", b"avif" + b"\0" * 4 + b"avifmif1miaf")
    head = len(ftyp) + len(meta(0)) + 8
    mdat = b"".join(streams[i] for i in order if i in streams)
    return ftyp + meta(head) + _box(b"mdat", mdat)


def fixture_records():
    record = json.loads((FIXTURES / "images.json").read_text())
    return {k: v for k, v in record.items() if v.get("read_by") == READ_BY}


def decode(name):
    """(bytes, samples, seconds) of one fixture through image.py's
    _decode_image."""
    from acceleratedvolrenderer_tpu_torch.utils import image

    data = (FIXTURES / name).read_bytes()
    t = time.perf_counter()
    px = image._decode_image(name, data)
    return data, px, time.perf_counter() - t


def held(name, data, px, rec):
    """Whether a fixture's bytes, shape and decoded samples are at its
    record's hashes (PIL's decode)."""
    return (hashlib.sha256(data).hexdigest() == rec["sha256_of_bytes"]
            and list(px.shape) == rec["shape"]
            and hashlib.sha256(np.ascontiguousarray(px).tobytes())
            .hexdigest() == rec["sha256_of_pil_samples"])


def decode_fixtures(names=AVIF_SMALL):
    """[(name, seconds, samples' shape, at the record)], one decode each."""
    recs = fixture_records()
    out = []
    for name in names:
        data, px, secs = decode(name)
        out.append((name, secs, px.shape, held(name, data, px, recs[name])))
    return out


def av1_seconds(name):
    """Seconds of one fixture's AV1 stage alone: its primary item's planes
    (each tile's C++ decode and, for a grid, the stitch); the rest of
    decode()'s seconds are the container and the colour stage."""
    from acceleratedvolrenderer_tpu_torch.utils import avif

    data = (FIXTURES / name).read_bytes()
    meta = next(avif._parse_meta(data, s, e)
                for kind, s, e in avif._boxes(data, 0, len(data))
                if kind == b"meta")
    t = time.perf_counter()
    avif._image_planes(data, meta, meta["pitm"])
    return time.perf_counter() - t


# what phase 41's maps must decode with: the av1_counts() totals that
# must not be 0
TOOLS_ON = {GRAIN_SKY: ("grain",),
            SCREEN_GROUND: ("screen", "intrabc", "palette_blocks",
                            "intrabc_blocks")}


@contextlib.contextmanager
def av1_counts():
    """Totals over the AV1 frames decoded inside the with block:
    native.av1_decode's stats, and the number of frames whose header
    allows the screen content tools (screen) or intra block copy
    (intrabc) or applies film grain (grain)."""
    from acceleratedvolrenderer_tpu_torch import native

    plain, totals = native.av1_decode, collections.Counter()

    def counted(data, seq, frame, tiles, stats=None):
        stats = {} if stats is None else stats
        planes = plain(data, seq, frame, tiles, stats)
        totals.update(stats, screen=frame["screen"],
                      intrabc=frame["intrabc"],
                      grain=int(frame["grain"] is not None))
        return planes

    native.av1_decode = counted
    try:
        yield totals
    finally:
        native.av1_decode = plain


def main():
    import time_image_decode as tid

    print(f"host CPU: {tid.cpu_line()}")
    names = tuple(AVIF_FILES) + tuple(TOOL_FILES) + tuple(SCREEN_FILES)
    for name, secs, shape, ok in decode_fixtures(names):
        print(f"{name}: {tuple(shape)} decoded in {secs:.4f} s (the AV1 "
              f"stage {av1_seconds(name):.4f} s), "
              f"{'equal to PIL' if ok else 'WRONG'}")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main()
