"""AVIF read by the port (utils/avif.py, native/av1_dec.cpp) held sample for
sample to np.asarray(PIL.Image.open(...)), which is what the reference's
read_image takes (PIL 12.1.0: libavif 1.3.0, dav1d, libyuv).

Every committed AVIF fixture, and files PIL's writer makes here from
seeded numpy images across its parameters (quality, speed 0-10 and so
both loop-restoration filters, subsampling, range, tiles, modes, alpha
premultiplied or not, ICC profile, EXIF orientation, sizes whose blocks
cross the frame's edge), decode with max |diff| 0.  Files that use a tool
the port does not read (segmentation, superres, more than 8 bits,
non-uniform tiles, block-level delta lf, construction method 2, matrices
other than BT.601, BT.709 and BT.2020) raise a ValueError naming it;
read_image equals the JAX package's; and no module of the port imports
PIL or reads Pillow's bundled libraries.  The tools common encoders use
(4:2:2, CDEF, quantizer matrices, delta q, BT.709 / BT.2020, grids,
sequences) are test_torch_image_formats_avif_tools.py; palette, intra
block copy and film grain test_torch_image_formats_avif_screen_grain.py;
the 32x24 frame under an AVIF sky over an AVIF ground is
test_torch_image_formats_avif_scene.py.
"""
import hashlib
import io
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch import native
from acceleratedvolrenderer_tpu_torch.utils import avif
from acceleratedvolrenderer_tpu_torch.utils import image as timage

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "data" / "images"
sys.path.insert(0, str(ROOT / "scripts"))

import avif_maps  # noqa: E402


def _image(h, w, c=3, seed=0, smooth=False):
    """Seeded content that makes the encoder use many tools: sinusoids,
    sharp tiles and noise, uint8 (h, w, c); smooth: box-filtered, which
    the encoder restores with Wiener filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / (7.0 + 3 * k) + yy / (13.0 - 2 * k)) * 70
                     + 128 for k in range(c)], -1)
    base[((xx // 9 + yy // 7) % 3 == 0)] *= 0.4
    base += rng.normal(0, 9, base.shape)
    px = np.clip(base, 0, 255).astype(np.uint8)
    if smooth:
        px = ((px.astype(int) + np.roll(px, 1, 0) + np.roll(px, 1, 1)
               + np.roll(px, 2, 1)) // 4).astype(np.uint8)
    return px


def _save(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "AVIF", **kw)
    return buf.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _same_as_pil(data, name="t.avif"):
    want = _pil(data)
    got = timage._decode_image(name, data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int(np.abs(got.astype(int) - want).max()) == 0


# ---------------------------------------------------------------- PIL's saves

# (size (h, w), mode, save parameters): each decoded equal to PIL
SAVES = {
    "q0": ((64, 80), "RGB", {"quality": 0}),
    "q30": ((64, 80), "RGB", {"quality": 30}),
    "q75": ((64, 80), "RGB", {}),
    "q95": ((64, 80), "RGB", {"quality": 95}),
    "q100_lossless": ((48, 64), "RGB", {"quality": 100}),
    "speed0_128sb": ((72, 136), "RGB", {"speed": 0}),
    "speed2": ((72, 136), "RGB", {"speed": 2}),
    "speed4_restoration": ((72, 136), "RGB", {"speed": 4}),
    "speed5": ((64, 80), "RGB", {"speed": 5}),
    "speed10": ((64, 80), "RGB", {"speed": 10}),
    "444": ((64, 80), "RGB", {"subsampling": "4:4:4"}),
    "444_speed3": ((64, 80), "RGB", {"subsampling": "4:4:4", "speed": 3}),
    "400": ((64, 80), "RGB", {"subsampling": "4:0:0"}),
    "400_limited": ((64, 80), "RGB", {"subsampling": "4:0:0",
                                      "range": "limited"}),
    "limited": ((64, 80), "RGB", {"range": "limited"}),
    "444_limited_q100": ((40, 56), "RGB", {"subsampling": "4:4:4",
                                           "range": "limited",
                                           "quality": 100}),
    "tiles_2x4": ((200, 512), "RGB", {"tile_rows": 1, "tile_cols": 2,
                                      "autotiling": False}),
    "rgba": ((64, 80), "RGBA", {}),
    "rgba_premultiplied": ((64, 80), "RGBA", {"alpha_premultiplied": True}),
    "rgba_premultiplied_444": ((40, 48), "RGBA", {
        "alpha_premultiplied": True, "subsampling": "4:4:4"}),
    "L": ((64, 80), "L", {}),
    "P": ((64, 80), "P", {}),
    "icc_profile": ((48, 64), "RGB", {"icc_profile": b"\0" * 128}),
    "1x1": ((1, 1), "RGB", {}),
    "3x2": ((2, 3), "RGB", {}),
    "37x23": ((23, 37), "RGB", {}),
    "37x23_speed1": ((23, 37), "RGB", {"speed": 1}),
    "129x65": ((65, 129), "RGB", {}),
    "129x65_444_speed4": ((65, 129), "RGB", {"subsampling": "4:4:4",
                                             "speed": 4}),
    "chroma_deltaq": ((64, 80), "RGB", {"advanced": {
        "enable-chroma-deltaq": "1"}}),
    "speed1_wiener": ((72, 136), "RGB", {"speed": 1}),
    "speed4_wiener": ((96, 128), "RGB", {"speed": 4}),
}
# cases of smooth content, by their seed
SMOOTH = {"speed1_wiener": 0, "speed4_wiener": 1}


def _make(case):
    (h, w), mode, kw = SAVES[case]
    px = _image(h, w, 4 if mode == "RGBA" else 3,
                seed=SMOOTH.get(case, len(case)), smooth=case in SMOOTH)
    if mode == "RGBA":
        px[..., 3] = avif_maps.alpha(h, w)
    im = Image.fromarray(px, "RGBA" if mode == "RGBA" else "RGB")
    if mode in ("L", "P"):
        im = im.convert(mode)
    return _save(im, **kw)


@pytest.mark.parametrize("case", sorted(SAVES))
def test_pil_saves_decode_as_pil(case):
    _same_as_pil(_make(case))


def test_speeds_make_both_restoration_filters_and_128_superblocks():
    """The saves above do exercise what they are named for: speeds 0-4
    turn loop restoration on (Wiener and self-guided both occur), speed 0
    here picks 128x128 superblocks, quality 100 is lossless, and the
    tiled save has 4x2 tiles."""
    kinds = set()
    for case in ("speed0_128sb", "speed2", "speed4_restoration",
                 "speed1_wiener", "speed4_wiener"):
        seq, frame, _ = _parse(_make(case))
        kinds.update(t for t in frame["lr_type"] if t)
    assert kinds == {1, 2}      # RESTORE_WIENER, RESTORE_SGRPROJ
    assert _parse(_make("speed0_128sb"))[0]["use128"] == 1
    assert _parse(_make("q100_lossless"))[1]["lossless"] == 1
    frame = _parse(_make("tiles_2x4"))[1]
    assert (len(frame["col_starts"]) - 1, len(frame["row_starts"]) - 1) == (
        4, 2)


def _parse(data):
    meta = _meta(data)
    return avif.parse_av1(avif._item_data(data, meta, meta["pitm"]))


def _meta(data):
    for kind, s, e in avif._boxes(data, 0, len(data)):
        if kind == b"meta":
            return avif._parse_meta(data, s, e)
    raise AssertionError("no meta box")


def test_exif_orientation_is_not_applied_to_the_pixels():
    """PIL writes an EXIF orientation as irot / imir and reports it in
    the EXIF data; it does not turn the pixels, and neither does the
    port."""
    ex = Image.Exif()
    ex[0x0112] = 6
    data = _save(Image.fromarray(_image(23, 37)), exif=ex)
    props = avif._item_props(data, _meta(data), _meta(data)["pitm"])
    assert b"irot" in props
    assert _pil(data).shape == (23, 37, 3)
    _same_as_pil(data)


def test_alpha_is_an_av1_item_of_its_own():
    """An RGBA save's alpha is a second, monochrome AV1 item that names
    the colour item by `auxl` (and `prem` where premultiplied)."""
    for prem in (False, True):
        rgba = _make("rgba_premultiplied" if prem else "rgba")
        meta = _meta(rgba)
        alpha = [frm for k, frm, to in meta["iref"] if k == b"auxl"]
        assert len(alpha) == 1
        aseq = avif.parse_av1(avif._item_data(rgba, meta, alpha[0]))[0]
        assert aseq["mono"] == 1
        assert any(k == b"prem" for k, *_ in meta["iref"]) == prem


# ---------------------------------------------------------------- refusals

def _flip(data, item_bit, value=1):
    """data with one bit of the primary item's AV1 stream set to value."""
    meta = _meta(data)
    method, ext = meta["iloc"][meta["pitm"]]
    assert method == 0 and len(ext) == 1
    pos = ext[0][0] + item_bit // 8
    mask = 0x80 >> (item_bit % 8)
    out = bytearray(data)
    out[pos] = (out[pos] | mask) if value else (out[pos] & ~mask)
    return bytes(out)


def _bits(data):
    seq, frame, _ = _parse(data)
    return seq["bit_of"], frame["bit_of"]


def _superres(data):
    sbits, fbits = _bits(data)
    out = _flip(data, sbits["enable_superres"])
    return _flip(out, fbits["render_and_frame_size_different"])


def _base():
    return _save(Image.fromarray(_image(64, 80)))


def _delta_lf():
    """A delta q file with delta_lf_present set."""
    data = _save(Image.fromarray(_image(64, 80)),
                 advanced={"deltaq-mode": "2"})
    return _flip(data, _bits(data)[1]["delta_lf_present"])


def _twelve_bit():
    """The base file's sequence header made profile 2 at 12 bits: the
    profile's bits, high_bitdepth and the bit after it (twelve_bit)."""
    sbits = _bits(_base())[0]
    data = _flip(_base(), sbits["seq_profile"] + 1)     # seq_profile 2
    data = _flip(data, sbits["high_bitdepth"])
    return _flip(data, sbits["high_bitdepth"] + 1)


def _grid_method_2():
    """A grid whose ImageGrid item says construction method 2."""
    px = _image(128, 128, seed=3)
    data = avif_maps.grid_file(px, 2, 2, 128, 128)
    i = data.index(struct.pack(">HHHH", 1, 1, 0, 1), data.index(b"iloc"))
    return data[:i] + struct.pack(">HH", 1, 2) + data[i + 4:]


# case: (the file, the words of the ValueError)
REFUSED = {
    "block_delta_lf": (_delta_lf, "block-level delta lf"),
    "segmentation": (lambda: _flip(_base(), _bits(_base())[1][
        "segmentation_enabled"]), "segmentation"),
    "superres": (lambda: _superres(_base()), "superres"),
    "more_than_8_bits": (lambda: _flip(_base(), _bits(_base())[0][
        "high_bitdepth"]), "more than 8 bits"),
    "non_uniform_tiles": (lambda: _flip(_base(), _bits(_base())[1][
        "uniform_tile_spacing_flag"], 0), "non-uniform tile spacing"),
    "twelve_bit": (_twelve_bit, "12-bit AV1"),
    "matrix_4": (lambda: avif_maps.set_nclx_matrix(_base(), 4),
                 "matrix_coefficients 4"),
    "grid_construction_method_2": (_grid_method_2, "construction method 2"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_tools_are_named(case, tmp_path):
    make, words = REFUSED[case]
    path = tmp_path / "t.avif"
    path.write_bytes(make())
    with pytest.raises(ValueError, match=words):
        timage.read_image(str(path))


def test_pil_reads_the_advanced_files_the_port_refuses():
    """The refusals are of files PIL reads: the port leaves them, it does
    not misread them."""
    for case in ("matrix_4",):
        assert _pil(REFUSED[case][0]()).shape == (64, 80, 3)


def test_avif_brand_without_an_av1_image_is_declined_as_pil_declines_it(
        tmp_path):
    """PIL's plugin takes the brand, libavif cannot parse the file, and
    PIL goes on to its other plugins: so does the port, ending in its
    "not an ..." error."""
    for data in (b"\0\0\0\x18ftypavif\0\0\0\0avifmif1" + bytes(64),
                 b"\0\0\0\x18ftypmif1\0\0\0\0mif1heic" + bytes(64)):
        with pytest.raises(Exception):
            Image.open(io.BytesIO(data))
        path = tmp_path / "t.avif"
        path.write_bytes(data)
        with pytest.raises(ValueError, match="not an EXR.*AVIF"):
            timage.read_image(str(path))


# ---------------------------------------------------------------- fixtures

def _records():
    return avif_maps.fixture_records()


def test_committed_fixtures_hashes():
    """Every committed AVIF fixture: its bytes and PIL's samples at
    images.json's records, and the port's decode equal to PIL's."""
    recs = _records()
    assert sorted(recs) == sorted({**avif_maps.AVIF_FILES,
                                   **avif_maps.TOOL_FILES,
                                   **avif_maps.SCREEN_FILES})
    for name, rec in recs.items():
        data = (FIXTURES / name).read_bytes()
        assert hashlib.sha256(data).hexdigest() == rec["sha256_of_bytes"]
        want = _pil(data)
        assert list(want.shape) == rec["shape"]
        assert hashlib.sha256(want.tobytes()).hexdigest() == rec[
            "sha256_of_pil_samples"]
        assert rec["pil_save"] == avif_maps.recipe(name)["pil_save"]
        _same_as_pil(data, name)


def test_fixtures_are_pil_files_of_the_webp_fixtures():
    """scripts/avif_maps.py's make_files rewrites the small fixtures byte
    for byte from the WebP ground's samples."""
    ground = np.asarray(Image.open(FIXTURES / "ground_1024x512_q90.webp")
                        .convert("RGB"))
    w, h = avif_maps.CROP
    src = avif_maps.sources(ground, ground)
    for name in avif_maps.AVIF_SMALL:
        which, kw = avif_maps.AVIF_FILES[name]
        px = src[which]
        data = _save(Image.fromarray(
            px, "RGBA" if px.shape[-1] == 4 else "RGB"), **kw)
        assert data == (FIXTURES / name).read_bytes(), name


def test_maps_are_the_issue_s_streams():
    """The sky is 128x128 superblocks in 4x2 tiles under TX_MODE_SELECT;
    the ground uses self-guided restoration for luma and Wiener for
    chroma."""
    seq, frame, tiles = _parse((FIXTURES / avif_maps.AVIF_SKY).read_bytes())
    assert seq["use128"] == 1 and frame["tx_mode"] == 2 and len(tiles) == 8
    seq, frame, _ = _parse((FIXTURES / avif_maps.AVIF_GROUND).read_bytes())
    assert frame["lr_type"] == [2, 1, 1]


def test_fixture_decode_timer(capsys):
    """scripts/avif_maps.py's decode_fixtures, which chip_smoke.py's phase
    37 runs on the card's host: every small fixture at its record."""
    rows = avif_maps.decode_fixtures()
    assert len(rows) == len(avif_maps.AVIF_SMALL)
    assert all(ok for *_, ok in rows)


@pytest.mark.parametrize("name", sorted(avif_maps.AVIF_FILES))
def test_read_image_like_jax(name):
    lin, attrs = timage.read_image(str(FIXTURES / name))
    assert attrs == {} and lin.shape[2] == 3
    assert np.array_equal(lin, jimage.read_image(str(FIXTURES / name))[0])


# ---------------------------------------------------------------- isolation

def test_port_reads_avif_without_pil_or_its_libraries():
    """The decode runs with PIL made unimportable, and no file of the AVIF
    path names PIL or Pillow's bundled libraries (the tables come from
    the committed native/av1_tables.h)."""
    code = (
        "import sys; sys.modules['PIL'] = None\n"
        "from acceleratedvolrenderer_tpu_torch.utils import image\n"
        f"p = {str(FIXTURES / 'ground_128x96_rgba.avif')!r}\n"
        "px = image._decode_image(p, open(p, 'rb').read())\n"
        "assert 'PIL' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print(px.shape)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(96, 128, 4)"
    port = ROOT / "acceleratedvolrenderer_tpu_torch"
    for f in (port / "utils" / "avif.py", port / "native" / "__init__.py",
              port / "native" / "av1_dec.cpp", port / "native" /
              "av1_tables.h"):
        text = f.read_text()
        assert "pillow.libs" not in text and "libavif-" not in text, f
        assert "import PIL" not in text and "from PIL" not in text, f


def test_tables_header_is_the_script_s():
    """native/av1_tables.h is what scripts/av1_tables.py writes from the
    bundled library (held to the specification's values there)."""
    out = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                              "av1_tables.py"), "--check"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_build_failure_names_gpp(monkeypatch, tmp_path):
    """No fallback: when g++ cannot build av1_dec.cpp the decode raises,
    naming g++."""
    monkeypatch.setattr(native, "_av1_lib", None)
    monkeypatch.setattr(native, "AV1_LIB_PATH", tmp_path / "libx.so")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        timage._decode_image("t.avif", (FIXTURES / avif_maps.AVIF_SMALL[0])
                             .read_bytes())
