"""AVIF files made with the tools common encoders use, read by the port
(utils/avif.py, native/av1_dec.cpp) and held sample for sample to
np.asarray(PIL.Image.open(...)) (PIL 12.1.0: libavif 1.3.0, dav1d,
libyuv): 4:2:2, CDEF, quantizer matrices, block-level delta q, the BT.709
and BT.2020 matrices at both ranges, grid items (with alpha) and frame 0
of an image sequence.  Each case also shows that its tool is on in its
file; the tolerance is none.  The committed fixtures of chip_smoke.py
phase 40 (scripts/avif_maps.py's TOOL_FILES) are held to images.json.
"""
import hashlib
import io
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from test_torch_image_formats_avif import _image, _meta, _pil, _same_as_pil

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch import native
from acceleratedvolrenderer_tpu_torch.utils import avif
from acceleratedvolrenderer_tpu_torch.utils import image as timage

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "images"
sys.path.insert(0, str(ROOT / "scripts"))

import avif_maps  # noqa: E402

# name: (h, w, seed, smooth); 23x37 puts blocks across the frame's edge
IMAGES = {"96x128": (96, 128, 0, False), "23x37": (23, 37, 1, False),
          "72x136": (72, 136, 2, False), "64x80_smooth": (64, 80, 3, True)}


def _px(name, c=3):
    h, w, seed, smooth = IMAGES[name]
    return _image(h, w, c, seed=seed, smooth=smooth)


def _primary_stream(data):
    """The AV1 stream of the primary item, or of a grid's first tile."""
    meta = _meta(data)
    iid = meta["pitm"]
    if meta["items"][iid] == b"grid":
        iid = next(to for k, frm, to in meta["iref"]
                   if k == b"dimg" and frm == iid)
    return avif._item_data(data, meta, iid)


def _decoded(data):
    """(sequence header, frame header, the decoder's counts) of the
    primary item's AV1 stream."""
    d = _primary_stream(data)
    seq, frame, tiles = avif.parse_av1(d)
    stats = {}
    native.av1_decode(d, seq, frame, tiles, stats)
    return seq, frame, stats


def _cdef_on(frame, stats):
    """Some strength of the frame's CDEF sets is not 0 and some 64x64
    block is filtered."""
    n = 1 << frame["cdef_bits"]
    strengths = [frame[f"cdef_{k}"][i] for k in ("y_pri", "y_sec", "uv_pri",
                                                  "uv_sec") for i in range(n)]
    return frame["cdef"] and any(strengths) and stats["cdef_blocks"] > 0


def _nclx_matrix(data):
    i = data.index(b"colrnclx") + 12
    return struct.unpack(">H", data[i:i + 2])[0]


# ---------------------------------------------------------------- 4:2:2

SETTINGS_422 = {"q75_s6": {}, "q90_s4": {"quality": 90, "speed": 4},
                "q40_s8_limited": {"quality": 40, "speed": 8,
                                   "range": "limited"}}


@pytest.mark.parametrize("setting", sorted(SETTINGS_422))
@pytest.mark.parametrize("img", ["96x128", "23x37", "72x136"])
def test_422_as_pil(img, setting):
    data = avif_maps.pil_file(_px(img), subsampling="4:2:2",
                              **SETTINGS_422[setting])
    seq, _, _ = _decoded(data)
    assert seq["profile"] == 2 and seq["ss"] == (1, 0)
    _same_as_pil(data)


@pytest.mark.parametrize("prem", [False, True])
def test_422_with_alpha_as_pil(prem):
    px = _px("72x136", 4)
    px[..., 3] = avif_maps.alpha(*px.shape[:2])
    data = avif_maps.pil_file(px, subsampling="4:2:2",
                              alpha_premultiplied=prem)
    assert _decoded(data)[0]["ss"] == (1, 0)
    _same_as_pil(data)


# ---------------------------------------------------------------- CDEF, QM, delta q

# (aom leaves CDEF's strengths at 0 on some images at its defaults and at
# quality 90: these settings make it use them on every image here)
SETTINGS_CDEF = {"q60_s4": {"quality": 60, "speed": 4},
                 "q40_s2": {"quality": 40, "speed": 2},
                 "q50_s6_422": {"quality": 50, "subsampling": "4:2:2"}}


@pytest.mark.parametrize("setting", sorted(SETTINGS_CDEF))
@pytest.mark.parametrize("img", sorted(IMAGES))
def test_cdef_as_pil(img, setting):
    data = avif_maps.pil_file(_px(img), advanced={"enable-cdef": "1"},
                              **SETTINGS_CDEF[setting])
    _, frame, stats = _decoded(data)
    assert _cdef_on(frame, stats)
    _same_as_pil(data)


# 4:2:2 and 4:4:4 code rectangular and square chroma transforms
SETTINGS_QM = {"q75_s6": {}, "q40_s2": {"quality": 40, "speed": 2},
               "q50_s6_422": {"quality": 50, "subsampling": "4:2:2"},
               "q90_s5_444": {"quality": 90, "speed": 5,
                              "subsampling": "4:4:4"}}


@pytest.mark.parametrize("setting", sorted(SETTINGS_QM))
@pytest.mark.parametrize("img", ["96x128", "23x37", "72x136"])
def test_quantizer_matrices_as_pil(img, setting):
    data = avif_maps.pil_file(_px(img), advanced={"enable-qm": "1"},
                              **SETTINGS_QM[setting])
    _, frame, _ = _decoded(data)
    assert max(frame["qm_level"]) < 15
    _same_as_pil(data)


SETTINGS_DQ = {"q75_s6": {}, "q40_s2": {"quality": 40, "speed": 2},
               "q90_s5_422": {"quality": 90, "speed": 5,
                              "subsampling": "4:2:2"}}


@pytest.mark.parametrize("setting", sorted(SETTINGS_DQ))
@pytest.mark.parametrize("img", ["96x128", "23x37", "72x136"])
def test_block_delta_q_as_pil(img, setting):
    data = avif_maps.pil_file(_px(img), advanced={"deltaq-mode": "2"},
                              **SETTINGS_DQ[setting])
    _, frame, stats = _decoded(data)
    assert frame["delta_q_present"] and stats["delta_q_blocks"] > 0
    _same_as_pil(data)


@pytest.mark.parametrize("setting", ["q40_s2", "q50_s6_422"])
@pytest.mark.parametrize("img", ["96x128", "23x37", "72x136"])
def test_cdef_qm_and_delta_q_together_as_pil(img, setting):
    data = avif_maps.pil_file(_px(img), advanced=avif_maps.TOOLS,
                              **SETTINGS_CDEF[setting])
    _, frame, stats = _decoded(data)
    assert _cdef_on(frame, stats) and max(frame["qm_level"]) < 15
    assert stats["delta_q_blocks"] > 0
    _same_as_pil(data)


# ---------------------------------------------------------------- matrices

SETTINGS_MATRIX = {"420_q75": {}, "422_q90": {"subsampling": "4:2:2",
                                              "quality": 90},
                   "444_s8": {"subsampling": "4:4:4", "speed": 8}}


@pytest.mark.parametrize("setting", sorted(SETTINGS_MATRIX))
@pytest.mark.parametrize("img", ["96x128", "23x37", "72x136"])
@pytest.mark.parametrize("rng", ["full", "limited"])
@pytest.mark.parametrize("matrix", [1, 9])       # BT.709, BT.2020 NCL
def test_matrix_as_pil(matrix, rng, img, setting):
    data = avif_maps.set_nclx_matrix(avif_maps.pil_file(
        _px(img), range=rng, **SETTINGS_MATRIX[setting]), matrix)
    assert _nclx_matrix(data) == matrix
    _same_as_pil(data)


@pytest.mark.parametrize("matrix", [1, 9])
def test_matrix_of_a_monochrome_file_as_pil(matrix):
    for rng in ("full", "limited"):
        _same_as_pil(avif_maps.set_nclx_matrix(avif_maps.pil_file(
            _px("72x136"), subsampling="4:0:0", range=rng), matrix))


# ---------------------------------------------------------------- grids

# name: (source (h, w, seed), rows, columns, output width, height)
GRIDS = {"2x2_of_64_cropped": ((128, 128, 4), 2, 2, 128, 96),
         "1x3_of_64": ((64, 192, 5), 1, 3, 180, 64),
         "2x1_of_72x64": ((128, 72, 6), 2, 1, 70, 120)}
SETTINGS_GRID = {"q75_s6": {}, "q50_s4_422": {"quality": 50, "speed": 4,
                                               "subsampling": "4:2:2"}}


def _grid_source(h, w, seed, c=3):
    return _image(h, w, c, seed=seed)


@pytest.mark.parametrize("setting", sorted(SETTINGS_GRID))
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_grid_as_pil(grid, setting):
    (h, w, seed), rows, cols, ow, oh = GRIDS[grid]
    data = avif_maps.grid_file(_grid_source(h, w, seed), rows, cols, ow, oh,
                               **SETTINGS_GRID[setting])
    meta = _meta(data)
    assert meta["items"][meta["pitm"]] == b"grid"
    assert sum(k == b"dimg" for k, *_ in meta["iref"]) == rows * cols
    assert _pil(data).shape == (oh, ow, 3)
    _same_as_pil(data)


@pytest.mark.parametrize("prem", [False, True])
def test_grid_with_alpha_as_pil(prem):
    px = _grid_source(128, 128, 7, 4)
    px[..., 3] = avif_maps.alpha(128, 128)
    data = avif_maps.grid_file(px, 2, 2, 126, 90, alpha_premultiplied=prem)
    meta = _meta(data)
    kinds = {k for k, *_ in meta["iref"]}
    assert {b"dimg", b"auxl"} <= kinds and (b"prem" in kinds) == prem
    assert _pil(data).shape == (90, 126, 4)
    _same_as_pil(data)


def test_grid_of_tiles_with_cdef_qm_and_delta_q_as_pil():
    data = avif_maps.grid_file(_grid_source(128, 128, 8), 2, 2, 128, 128,
                               quality=60, speed=4, advanced=avif_maps.TOOLS)
    _, frame, stats = _decoded(data)
    assert max(frame["qm_level"]) < 15 and frame["delta_q_present"]
    _same_as_pil(data)


def _mixed_grid():
    px = _grid_source(128, 128, 9)
    tiles = [avif_maps.pil_file(np.ascontiguousarray(
        px[r * 64:(r + 1) * 64, c * 64:(c + 1) * 64]),
        subsampling="4:4:4" if r + c == 2 else "4:2:0")
        for r in range(2) for c in range(2)]
    return avif_maps.compose_grid(tiles, 2, 2, 128, 128)


# grids libavif refuses: name: (the file, the words of the port's error)
BAD_GRIDS = {
    "tiles_under_64": (lambda: avif_maps.grid_file(
        _grid_source(64, 64, 1), 2, 2, 64, 64), "MIAF's rules"),
    "output_wider_than_the_tiles": (lambda: avif_maps.grid_file(
        _grid_source(128, 128, 2), 2, 2, 130, 96), "MIAF's rules"),
    "last_column_outside_the_output": (lambda: avif_maps.grid_file(
        _grid_source(128, 128, 3), 2, 2, 64, 96), "MIAF's rules"),
    "odd_width_of_a_420_grid": (lambda: avif_maps.grid_file(
        _grid_source(128, 128, 4), 2, 2, 127, 96), "MIAF's rules"),
    "tiles_of_two_formats": (_mixed_grid, "not an EXR.*AVIF"),
}


@pytest.mark.parametrize("case", sorted(BAD_GRIDS))
def test_grid_libavif_refuses_is_refused(case, tmp_path):
    make, words = BAD_GRIDS[case]
    data = make()
    with pytest.raises(Exception):
        _pil(data)
    path = tmp_path / "t.avif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=words):
        timage.read_image(str(path))


def test_odd_grid_sizes_where_chroma_is_not_subsampled_as_pil():
    """MIAF asks even sizes only along subsampled axes: 4:2:2 may have an
    odd height, 4:4:4 an odd width and height."""
    src = _grid_source(128, 128, 5)
    _same_as_pil(avif_maps.grid_file(src, 2, 2, 128, 95,
                                     subsampling="4:2:2"))
    _same_as_pil(avif_maps.grid_file(src, 2, 2, 127, 95,
                                     subsampling="4:4:4"))


# ---------------------------------------------------------------- sequences

SETTINGS_SEQ = {"q75_s6": {}, "q90_s4": {"quality": 90, "speed": 4}}


def _frames(img, n, c=3):
    return [_image(*IMAGES[img][:2], c, seed=IMAGES[img][2] + k)
            for k in range(n)]


@pytest.mark.parametrize("setting", sorted(SETTINGS_SEQ))
@pytest.mark.parametrize("img", ["96x128", "23x37", "72x136"])
def test_sequence_frame_0_as_pil(img, setting):
    data = avif_maps.pil_sequence(_frames(img, 3), **SETTINGS_SEQ[setting])
    assert data[8:12] == b"avis"
    tracks = next(avif._parse_moov(data, s, e) for k, s, e in
                  avif._boxes(data, 0, len(data)) if k == b"moov")
    assert len(tracks) == 1 and tracks[0]["entry"] == b"av01"
    _same_as_pil(data)


@pytest.mark.parametrize("prem", [False, True])
def test_sequence_with_alpha_as_pil(prem):
    frames = _frames("72x136", 2, 4)
    for f in frames:
        f[..., 3] = avif_maps.alpha(*f.shape[:2])
    data = avif_maps.pil_sequence(frames, alpha_premultiplied=prem)
    tracks = next(avif._parse_moov(data, s, e) for k, s, e in
                  avif._boxes(data, 0, len(data)) if k == b"moov")
    assert len(tracks) == 2
    _same_as_pil(data)


@pytest.mark.parametrize("brand", [b"avif", b"mif1", b"msf1"])
def test_sequence_source_follows_the_major_brand(brand):
    """libavif reads the tracks of an `avis` file or of one whose major
    brand is neither avif nor avis, and the primary item of an `avif`
    one.  The track's colr box is set to BT.709 here, so PIL's samples
    show which source it read; the port's equal them."""
    data = avif_maps.pil_sequence(_frames("96x128", 2))
    track_colr = data.rindex(b"colrnclx") + 12
    data = (data[:8] + brand + data[12:track_colr] + struct.pack(">H", 1)
            + data[track_colr + 2:])
    from_tracks = brand != b"avif"
    base = _pil(avif_maps.pil_sequence(_frames("96x128", 2)))
    assert np.array_equal(_pil(data), base) != from_tracks
    _same_as_pil(data)


# ---------------------------------------------------------------- fixtures

def _tool_on(name, data):
    """Each committed tool fixture uses what its name says."""
    meta = _meta(data)
    rec = avif_maps.TOOL_FILES[name][1]
    if "grid" in rec:
        assert meta["items"][meta["pitm"]] == b"grid"
    if "nclx_matrix" in rec:
        assert _nclx_matrix(data) == rec["nclx_matrix"]
    if "frames" in rec:
        assert data[8:12] == b"avis" and b"moov" in data
    seq, frame, stats = _decoded(data)
    adv = rec["pil_save"].get("advanced", {})
    if adv.get("enable-cdef") == "1" or name.endswith("_cdef.avif"):
        assert _cdef_on(frame, stats)
    if adv.get("enable-qm") == "1":
        assert max(frame["qm_level"]) < 15
    if adv.get("deltaq-mode") == "2":
        assert stats["delta_q_blocks"] > 0
    if rec["pil_save"].get("subsampling") == "4:2:2":
        assert seq["ss"] == (1, 0)


@pytest.mark.parametrize("name", sorted(avif_maps.TOOL_FILES))
def test_committed_tool_fixture(name):
    """The fixture's bytes and PIL's samples at images.json's record, its
    tool on, and the port's decode equal to PIL's."""
    rec = avif_maps.fixture_records()[name]
    data = (FIXTURES / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == rec["sha256_of_bytes"]
    want = _pil(data)
    assert list(want.shape) == rec["shape"]
    assert hashlib.sha256(want.tobytes()).hexdigest() == rec[
        "sha256_of_pil_samples"]
    assert {k: rec[k] for k in avif_maps.recipe(name)} == \
        avif_maps.recipe(name)
    _tool_on(name, data)
    _same_as_pil(data, name)


def _without_times(data):
    """data with the creation and modification times of its mvhd, tkhd
    and mdhd boxes (libavif writes the clock's) set to 0."""
    out = bytearray(data)

    def walk(s, e):
        for kind, a, b in avif._boxes(data, s, e):
            if kind in (b"moov", b"trak", b"mdia"):
                walk(a, b)
            elif kind in (b"mvhd", b"tkhd", b"mdhd"):
                n = 16 if data[a] == 1 else 8
                out[a + 4:a + 4 + n] = bytes(n)
    walk(0, len(data))
    return bytes(out)


def test_small_tool_fixtures_are_the_script_s():
    """scripts/avif_maps.py's tool_file rewrites the 128x96 tool
    fixtures byte for byte from the WebP ground's samples (the sequence's
    clock times aside)."""
    ground = np.asarray(Image.open(FIXTURES / "ground_1024x512_q90.webp")
                        .convert("RGB"))
    src = avif_maps.sources(ground, ground)
    for name in avif_maps.TOOL_SMALL:
        which, rec = avif_maps.TOOL_FILES[name]
        data = avif_maps.tool_file(src[which], rec)
        want = (FIXTURES / name).read_bytes()
        assert _without_times(data) == _without_times(want), name


def test_tool_fixture_decode_timer():
    """decode_fixtures over the tool crops, as chip_smoke.py's phase 37
    runs it on the card's host: every crop at its record."""
    rows = avif_maps.decode_fixtures(avif_maps.TOOL_SMALL)
    assert len(rows) == len(avif_maps.TOOL_SMALL)
    assert all(ok for *_, ok in rows)


@pytest.mark.parametrize("name", sorted(avif_maps.TOOL_FILES))
def test_tool_fixture_read_image_like_jax(name):
    lin, attrs = timage.read_image(str(FIXTURES / name))
    assert attrs == {} and lin.shape[2] == 3
    assert np.array_equal(lin, jimage.read_image(str(FIXTURES / name))[0])


def test_pil_file_is_pil_s_save():
    """avif_maps.pil_file is a plain PIL save (the fixtures' recipes name
    PIL's parameters)."""
    px = _px("23x37")
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "AVIF", quality=60)
    assert avif_maps.pil_file(px, quality=60) == buf.getvalue()


# ---------------------------------------------------------------- the slice

def test_tool_maps_render_like_jax(tmp_path):
    """The slice: a 32x24 frame under a grid sky of tiles with CDEF,
    quantizer matrices and delta q over a 4:2:2 BT.709 ground with CDEF,
    parsed and rendered by the port on the CPU and by the JAX package
    under jax.disable_jit, equal (test_torch_image_formats_avif_scene.py's
    check)."""
    import test_torch_image_formats_avif_scene as scene_test
    from test_torch_image_formats_scene import _scene_text

    sky = avif_maps.grid_file(_image(64, 128, seed=3), 1, 2, 128, 64,
                              quality=60, speed=4, advanced=avif_maps.TOOLS)
    ground = avif_maps.set_nclx_matrix(avif_maps.pil_file(
        _image(32, 48, seed=4), subsampling="4:2:2",
        advanced={"enable-cdef": "1"}), 1)
    (tmp_path / "sky.avif").write_bytes(sky)
    (tmp_path / "ground.avif").write_bytes(ground)
    _same_as_pil(sky)
    _same_as_pil(ground)
    path = tmp_path / "scene.pbrt"
    path.write_text(_scene_text(tmp_path / "sky.avif", "ground.avif"))
    scene_test.test_avif_sky_and_ground_render_like_jax(path)
