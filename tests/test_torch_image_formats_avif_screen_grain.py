"""AVIF files with the screen content tools and with film grain, read by
the port (utils/avif.py, native/av1_dec.cpp) and held sample for sample to
np.asarray(PIL.Image.open(...)) (PIL 12.1.0: libavif 1.3.0, dav1d 1.5.1,
libyuv).

PIL's default save (libaom) turns on allow_screen_content_tools for
images of few colours, and allow_intrabc where blocks copy well: palettes
(luma, chroma, the 4:0:0 alpha item of a binary cut-out, an L mask) and
intra block copy (its DVs, the inter transform tree and types, the frame
without loop filters).  Film grain: the 16 film-grain-test vectors,
denoise-noise-level, each subsampling at sizes that are not multiples of
32, chroma_scaling_from_luma, clip_to_restricted_range and grain on an
alpha item, which libavif lets dav1d apply.  Each case shows its tool on
(a header bit or the decoder's counts); the tolerance is none.  The
committed fixtures of chip_smoke.py phase 41 (scripts/avif_maps.py's
SCREEN_FILES) are held to images.json and read_image equals the JAX
package's.
"""
import hashlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from test_torch_image_formats_avif import _meta, _pil, _same_as_pil

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch import native
from acceleratedvolrenderer_tpu_torch.utils import avif
from acceleratedvolrenderer_tpu_torch.utils import image as timage

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "images"
sys.path.insert(0, str(ROOT / "scripts"))

import avif_maps  # noqa: E402


def _save(px, **kw):
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(px)).save(buf, "AVIF", **kw)
    return buf.getvalue()


def _items(data):
    """{"colour" / "alpha": the item's AV1 stream, its headers and tiles,
    the decoder's counts and its planes} of a still AVIF file."""
    meta = _meta(data)
    alpha = {frm for k, frm, to in meta["iref"] if k == b"auxl"}
    out = {}
    for iid, kind in meta["items"].items():
        if kind != b"av01":
            continue
        d = avif._item_data(data, meta, iid)
        seq, frame, tiles = avif.parse_av1(d)
        stats = {}
        planes = native.av1_decode(d, seq, frame, tiles, stats)
        out["alpha" if iid in alpha else "colour"] = dict(
            stream=d, seq=seq, frame=frame, tiles=tiles, stats=stats,
            planes=planes)
    return out


# ---------------------------------------------------------------- images

def _flat_tiles(h, w, seed=0):
    """Four flat colours in 10x12 tiles: blocks of two to four colours."""
    colours = np.random.default_rng(seed).integers(0, 256, (4, 3))
    y, x = np.mgrid[:h, :w]
    return colours[(y // 12 + (x // 10) * 3) % 4].astype(np.uint8)


def _logo(h, w):
    """A white image with one red rectangle."""
    px = np.full((h, w, 3), 255, np.uint8)
    px[h * 5 // 32:h * 19 // 32, w // 5:w * 25 // 32] = (200, 20, 30)
    return px


def _text(h, w, seed=1, colour=False):
    """Rows of glyphs drawn from eight 5x5 shapes: blocks that repeat.
    colour: inks of four colours over three bands of background, so that
    chroma is copied too (with half-sample DVs under subsampling)."""
    rng = np.random.default_rng(seed)
    px = np.full((h, w, 3), 250, np.uint8)
    inks = np.array([(20, 20, 20)], np.uint8)
    step = 12
    if colour:
        px[:h // 3] = (230, 220, 120)
        px[h // 3:2 * h // 3] = (60, 90, 200)
        inks = np.array([(200, 20, 30), (20, 120, 40), (20, 20, 20),
                         (240, 200, 0)], np.uint8)
        step = 11
    glyphs = rng.integers(0, 2, (8, 5, 5)).astype(bool)
    for row in range(step - 8, h - 12, step):
        for col in range(step - 8, w - 8, 7):
            cell = px[row:row + 10:2, col:col + 10:2]
            cell[glyphs[rng.integers(0, 8)]] = inks[
                rng.integers(0, len(inks))] if colour else inks[0]
    return px


def _natural(h, w, c=3, seed=0):
    """Smooth sinusoids with a little noise, as a photograph has."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([np.sin(x / (7.0 + 3 * k) + y / (13.0 - 2 * k)) * 70
                     + 128 for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 3, base.shape), 0, 255).astype(
        np.uint8)


def _gradient_cutout(h, w):
    """An RGBA gradient whose alpha is avif_maps.cutout's binary ellipse."""
    y, x = np.mgrid[:h, :w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)],
                   -1)
    return np.concatenate([rgb, avif_maps.cutout(h, w)[..., None]],
                          -1).astype(np.uint8)


# ---------------------------------------------------------------- palette

@pytest.mark.parametrize("size", [(128, 128), (77, 101)])
@pytest.mark.parametrize("ss", ["4:2:0", "4:4:4", "4:2:2", "4:0:0"])
def test_palette_as_pil(ss, size):
    """PIL's defaults on flat colours: palettes in luma and, but for 4:0:0,
    in chroma."""
    data = _save(_flat_tiles(*size), subsampling=ss)
    it = _items(data)["colour"]
    assert it["frame"]["screen"] == 1 and it["stats"]["palette_blocks"] > 0
    assert (it["stats"]["palette_uv_blocks"] > 0) == (ss != "4:0:0")
    _same_as_pil(data)


def test_logo_palette_as_pil():
    data = _save(_logo(128, 128))
    it = _items(data)["colour"]
    assert it["frame"]["screen"] == 1 and it["stats"]["palette_blocks"] > 0
    _same_as_pil(data)


@pytest.mark.parametrize("prem", [False, True])
def test_cutout_alpha_palette_as_pil(prem):
    """A gradient under a binary cut-out alpha: the colour item has no
    screen content, the 4:0:0 alpha item palettes."""
    data = _save(_gradient_cutout(128, 128), alpha_premultiplied=prem)
    its = _items(data)
    assert its["colour"]["frame"]["screen"] == 0
    assert its["alpha"]["frame"]["screen"] == 1
    assert its["alpha"]["stats"]["palette_blocks"] > 0
    _same_as_pil(data)


def test_l_mask_palette_as_pil():
    """The cut-out as an L image (PIL saves it as 4:2:0 of grey)."""
    data = _save(avif_maps.cutout(96, 128))
    it = _items(data)["colour"]
    assert it["frame"]["screen"] == 1 and it["stats"]["palette_blocks"] > 0
    _same_as_pil(data)


# ---------------------------------------------------------- intra block copy

# name: (image (h, w, seed, colour), save parameters); the colour text
# copies chroma: at 4:2:0 with half-sample DVs, at 4:4:4 with the luma's
# inter transform types, FLIPADST among them
INTRABC = {"speed0_128sb": ((192, 256, 1, False), {"speed": 0}),
           "speed4": ((256, 256, 1, False), {"speed": 4}),
           "speed6": ((256, 256, 1, False), {"speed": 6}),
           "q100_lossless": ((256, 256, 1, False), {"quality": 100}),
           "two_tiles": ((192, 320, 1, False), {"tile_cols": 1,
                                                "autotiling": False}),
           "colour_420": ((256, 256, 0, True), {}),
           "colour_444": ((256, 256, 2, True), {"subsampling": "4:4:4"}),
           "colour_speed4": ((256, 256, 0, True), {"speed": 4})}


@pytest.mark.parametrize("case", sorted(INTRABC))
def test_intra_block_copy_as_pil(case):
    (h, w, seed, colour), kw = INTRABC[case]
    data = _save(_text(h, w, seed, colour), **kw)
    it = _items(data)["colour"]
    frame = it["frame"]
    assert frame["screen"] == frame["intrabc"] == 1
    assert it["stats"]["intrabc_blocks"] > 0
    # intra block copy reads the frame before filtering: none is coded
    assert not any(frame["lf"]) and not frame["cdef"] and \
        not any(frame["lr_type"])
    if case == "speed0_128sb":
        assert it["seq"]["use128"] == 1
    if case == "q100_lossless":
        assert frame["lossless"] == 1
    if case == "two_tiles":
        assert len(it["tiles"]) == 2
    _same_as_pil(data)


# ---------------------------------------------------------------- film grain

def _grain_on(data, item="colour"):
    """The item applies film grain, and its decode differs from the
    grain-free one: the grain was applied."""
    it = _items(data)[item]
    assert it["frame"]["grain"] is not None
    plain = native.av1_decode(it["stream"], it["seq"],
                              dict(it["frame"], grain=None), it["tiles"])
    assert any(not np.array_equal(a, b) for a, b in zip(it["planes"], plain)
               if a is not None)
    return it["frame"]["grain"]


@pytest.mark.parametrize("vector", range(1, 17))
def test_film_grain_test_vector_as_pil(vector):
    data = _save(_natural(96, 128), advanced={
        "film-grain-test": str(vector)})
    grain = _grain_on(data)
    if vector == 15:
        assert grain["from_luma"] == 1
    _same_as_pil(data)


@pytest.mark.parametrize("level", [10, 40])
def test_denoise_noise_level_as_pil(level):
    """libaom's noise model, solved on the image, as film grain."""
    data = _save(_natural(96, 128), advanced={
        "denoise-noise-level": str(level)})
    _grain_on(data)
    _same_as_pil(data)


@pytest.mark.parametrize("vector", [1, 15])
@pytest.mark.parametrize("ss", ["4:2:0", "4:4:4", "4:2:2", "4:0:0"])
def test_film_grain_subsampling_as_pil(ss, vector):
    """77x101: stripes and blocks cut by the frame's edges, odd chroma
    widths; vector 15 scales chroma from luma."""
    data = _save(_natural(77, 101), subsampling=ss, advanced={
        "film-grain-test": str(vector)})
    grain = _grain_on(data)
    assert grain["from_luma"] == (vector == 15 and ss != "4:0:0")
    _same_as_pil(data)


def test_film_grain_on_the_alpha_item_as_pil():
    """libavif hands the grain parameters to the alpha item too, and dav1d
    applies them there: PIL's alpha has grain."""
    px = np.concatenate([_natural(96, 128), _natural(96, 128, 1, 3)], -1)
    data = _save(px, advanced={"film-grain-test": "1"})
    _grain_on(data, "alpha")
    _same_as_pil(data)


def _flip(data, bit):
    out = bytearray(data)
    stream = _items(data)["colour"]["stream"]
    base = data.index(stream) * 8 + bit
    out[base >> 3] ^= 0x80 >> (base & 7)
    return bytes(out)


def test_film_grain_clipped_to_restricted_range_as_pil():
    """clip_to_restricted_range set in a grain file (no encoder option
    sets it): PIL clips to 16-235 (luma) and 16-240 (chroma), so does the
    port.  Saturated blue and red bands reach past both chroma limits."""
    px = _natural(96, 128)
    px[:, :40] = (20, 40, 250)
    px[:, 40:64] = (250, 30, 20)
    data = _save(px, advanced={"film-grain-test": "2"})
    bit = _items(data)["colour"]["frame"]["bit_of"][
        "clip_to_restricted_range"]
    data = _flip(data, bit)
    assert _grain_on(data)["clip"] == 1
    _same_as_pil(data)


def test_film_grain_with_15_luma_points_is_refused(tmp_path):
    """num_y_points 15 (vector 1's 14 with its last bit set): dav1d
    refuses the frame, so PIL cannot open it; the port names it."""
    data = _save(_natural(96, 128), advanced={"film-grain-test": "1"})
    frame = _items(data)["colour"]["frame"]
    assert len(frame["grain"]["y"]) == 14
    data = _flip(data, frame["bit_of"]["num_y_points"] + 3)
    with pytest.raises(Exception):
        _pil(data)
    path = tmp_path / "t.avif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="film grain with 15 luma points"):
        timage.read_image(str(path))


# ---------------------------------------------------------------- fixtures

def _screen_tool_on(name, data):
    """Each committed phase 41 fixture uses what its name says."""
    its = _items(data)
    colour = its["colour"]
    if name == avif_maps.GRAIN_SKY or name.endswith("_grain.avif"):
        _grain_on(data)
    if name in (avif_maps.SCREEN_GROUND, "ground_384x96_intrabc.avif"):
        assert colour["frame"]["screen"] == colour["frame"]["intrabc"] == 1
        assert colour["stats"]["intrabc_blocks"] > 0
        assert colour["stats"]["palette_blocks"] > 0
    if name.endswith("_palette.avif"):
        assert colour["frame"]["screen"] == 1
        assert colour["stats"]["palette_blocks"] > 0
    if name.endswith("_cutout.avif"):
        assert its["alpha"]["frame"]["screen"] == 1
        assert its["alpha"]["stats"]["palette_blocks"] > 0


@pytest.mark.parametrize("name", sorted(avif_maps.SCREEN_FILES))
def test_committed_screen_fixture(name):
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
    _screen_tool_on(name, data)
    _same_as_pil(data, name)


@pytest.mark.parametrize("name", sorted(avif_maps.SCREEN_FILES))
def test_screen_fixture_read_image_like_jax(name):
    lin, attrs = timage.read_image(str(FIXTURES / name))
    assert attrs == {} and lin.shape[2] == 3
    assert np.array_equal(lin, jimage.read_image(str(FIXTURES / name))[0])


def test_screen_fixtures_are_the_script_s():
    """scripts/avif_maps.py rewrites the phase 41 fixtures byte for byte
    from the WebP sky's and ground's samples and its labels texture."""
    sky = np.asarray(Image.open(FIXTURES / "sky_2048x1024_q90.webp")
                     .convert("RGB"))
    ground = np.asarray(Image.open(FIXTURES / "ground_1024x512_q90.webp")
                        .convert("RGB"))
    src = avif_maps.sources(sky, ground)
    for name, (which, rec) in avif_maps.SCREEN_FILES.items():
        data = avif_maps.tool_file(src[which], rec)
        assert data == (FIXTURES / name).read_bytes(), name


def test_screen_fixture_decode_timer():
    """decode_fixtures over the phase 41 crops, as chip_smoke.py's phase 37
    runs it on the card's host: every crop at its record."""
    rows = avif_maps.decode_fixtures(avif_maps.SCREEN_SMALL)
    assert len(rows) == len(avif_maps.SCREEN_SMALL) == 4
    assert all(ok for *_, ok in rows)
