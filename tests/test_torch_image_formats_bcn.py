"""The port's block-compressed DDS reader (utils/bcn.py through
utils/image_read.py::decode_dds and utils/image.py's read_image) against
PIL 12.1.0, which the reference's read_image uses, on the same bytes.

Files: PIL's own DDS writer (DXT1, DXT3, DXT5; BC2, BC3 and BC5 under DX10
headers), and blocks of random bytes under a header (scripts/block_maps.py's
dds_blocks) for every FourCC and DXGI format PIL decodes: any 8 or 16
bytes form a block, so every BC1 colour mode, BC4 / BC5 interpolation
mode, BC6H mode (with the reserved ones), partition and transform, and
every BC7 mode, rotation, index selection and a mode byte of 0 appear.
Sizes 37x23 and 6x5 (not multiples of 4) and 8x8.  The samples equal PIL's
and read_image and imgtool's loader equal the reference's (PIL gives
colours: RGBA, RGB or L; for L, the reference's loader fails on PIL's 2-D
array and the port's repeats the gray, the rule of the other gray
readers).  The formats PIL does not decode raise ValueError naming them.
The departures of PIL's decoder from the Direct3D specification that the
port keeps (ROADMAP Queue 3, "Hazards of the reference, kept") are held
each by a crafted block, and the block-compressed files chip_smoke.py
phase 34 rebuilds are held to images.json's hashes of their bytes and of
PIL's decodes.
"""
import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu.cli import imgtool as jimgtool
from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.cli import imgtool as timgtool
from acceleratedvolrenderer_tpu_torch.utils import image as timage
from acceleratedvolrenderer_tpu_torch.utils import image_read

import torch_image_writers as tiw

SIZES = {"37x23": (37, 23), "6x5": (6, 5), "8x8": (8, 8)}
FIXTURES = Path(__file__).resolve().parent / "data" / "images"


def _pil(data):
    a = np.asarray(Image.open(io.BytesIO(data)))
    return a[..., None] if a.ndim == 2 else a


def _random_dds(kind, w, h, fourcc=None, dxgi=None, seed=0):
    """Random blocks of kind (BC1 / BC4: 8 bytes, else 16) at w x h, under
    the FourCC `fourcc` or a DX10 header naming `dxgi`."""
    size = 8 if kind in ("BC1", "BC4") else 16
    n = -(-w // 4) * -(-h // 4)
    raw = np.random.default_rng(seed).integers(0, 256, (n, size), np.uint8)
    if kind == "BC7":
        raw[::7, 0] = 0                         # no mode bit
    return tiw.dds_blocks(kind, raw.tobytes(), w, h, dx10=dxgi,
                          fourcc=fourcc)


def _pil_written(fmt, w, h):
    px = np.random.default_rng(1).integers(0, 256, (h, w, 4), np.uint8)
    px[:, : w // 2] = px[0, 0]
    mode = "RGB" if fmt == "BC5" else "RGBA"
    b = io.BytesIO()
    Image.fromarray(px[..., :len(mode)], mode).save(b, "DDS",
                                                    pixel_format=fmt)
    return b.getvalue()


CASES = {
    # PIL's writer
    "pil_DXT1": lambda w, h: _pil_written("DXT1", w, h),
    "pil_DXT3": lambda w, h: _pil_written("DXT3", w, h),
    "pil_DXT5": lambda w, h: _pil_written("DXT5", w, h),
    "pil_BC2": lambda w, h: _pil_written("BC2", w, h),
    "pil_BC3": lambda w, h: _pil_written("BC3", w, h),
    "pil_BC5": lambda w, h: _pil_written("BC5", w, h),
    # random blocks, by FourCC
    "DXT1": lambda w, h: _random_dds("BC1", w, h, b"DXT1"),
    "DXT3": lambda w, h: _random_dds("BC2", w, h, b"DXT3"),
    "DXT5": lambda w, h: _random_dds("BC3", w, h, b"DXT5"),
    "BC4U": lambda w, h: _random_dds("BC4", w, h, b"BC4U"),
    "ATI1": lambda w, h: _random_dds("BC4", w, h, b"ATI1"),
    "BC5U": lambda w, h: _random_dds("BC5", w, h, b"BC5U"),
    "ATI2": lambda w, h: _random_dds("BC5", w, h, b"ATI2"),
    "BC5S": lambda w, h: _random_dds("BC5S", w, h, b"BC5S"),
    # random blocks, by DXGI format
    "BC1_TYPELESS": lambda w, h: _random_dds("BC1", w, h, dxgi=70),
    "BC1_UNORM": lambda w, h: _random_dds("BC1", w, h, dxgi=71),
    "BC2_UNORM": lambda w, h: _random_dds("BC2", w, h, dxgi=74),
    "BC3_UNORM": lambda w, h: _random_dds("BC3", w, h, dxgi=77),
    "BC4_UNORM": lambda w, h: _random_dds("BC4", w, h, dxgi=80),
    "BC5_UNORM": lambda w, h: _random_dds("BC5", w, h, dxgi=83),
    "BC5_SNORM": lambda w, h: _random_dds("BC5S", w, h, dxgi=84),
    "BC6H_UF16": lambda w, h: _random_dds("BC6H", w, h, dxgi=95),
    "BC6H_SF16": lambda w, h: _random_dds("BC6HS", w, h, dxgi=96),
    "BC7_TYPELESS": lambda w, h: _random_dds("BC7", w, h, dxgi=97),
    "BC7_UNORM": lambda w, h: _random_dds("BC7", w, h, dxgi=98),
    "BC7_UNORM_SRGB": lambda w, h: _random_dds("BC7", w, h, dxgi=99),
}


def _check_against_reference(path, data):
    """decode_dds equals PIL's samples; read_image and imgtool's loader
    equal the reference's (for a gray image, PIL's 2-D array: the loader's
    gray repeated)."""
    want = _pil(data)
    got = image_read.decode_dds(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    path.write_bytes(data)
    lin, attrs = timage.read_image(str(path))
    assert attrs == {} and lin.dtype == np.float32
    assert np.array_equal(lin, jimage.read_image(str(path))[0])
    loaded = timgtool._load(str(path))[0]
    if want.shape[2] == 1:
        with pytest.raises(IndexError):
            jimgtool._load(str(path))
        assert np.array_equal(loaded, np.repeat(
            want.astype(np.float32) / 255.0, 3, 2))
    else:
        assert np.array_equal(loaded, jimgtool._load(str(path))[0])


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_block_compressed_dds_match_reference(tmp_path, case, size):
    _check_against_reference(tmp_path / "t.dds", CASES[case](*SIZES[size]))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("kind,dxgi", [("BC6H", 95), ("BC6HS", 96),
                                       ("BC7", 98)])
def test_many_random_blocks(tmp_path, kind, dxgi, seed):
    """4,000 random blocks more of the formats with the most modes."""
    data = _random_dds(kind, 160, 100, dxgi=dxgi, seed=seed)
    assert np.array_equal(image_read.decode_dds(data), _pil(data))


def _fourcc_dds(name):
    return tiw.dds_blocks("BC3", bytes(64), 8, 8, fourcc=name)


UNREAD = {
    "DXT2": (lambda: _fourcc_dds(b"DXT2"), "'DXT2'"),
    "DXT4": (lambda: _fourcc_dds(b"DXT4"), "'DXT4'"),
    "BC4S": (lambda: _fourcc_dds(b"BC4S"), "'BC4S'"),
    "BC1_UNORM_SRGB": (lambda: tiw.dds_blocks("BC1", bytes(32), 8, 8, 72),
                       "BC1_UNORM_SRGB"),
    "BC4_SNORM": (lambda: tiw.dds_blocks("BC4", bytes(32), 8, 8, 81),
                  "BC4_SNORM"),
    "BC6H_TYPELESS": (lambda: tiw.dds_blocks("BC6H", bytes(64), 8, 8, 94),
                      "BC6H_TYPELESS"),
}


@pytest.mark.parametrize("case", sorted(UNREAD))
def test_formats_pil_does_not_decode_raise(tmp_path, case):
    """PIL raises NotImplementedError; the port ValueError, naming the
    format."""
    make, words = UNREAD[case]
    data = make()
    with pytest.raises(NotImplementedError):
        Image.open(io.BytesIO(data))
    path = tmp_path / "t.dds"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=words):
        timage.read_image(str(path))


def _bits_block(fields):
    """A 16-byte block of (value, bits) fields, lowest bit first."""
    v, pos = 0, 0
    for value, nb in fields:
        v |= (value & ((1 << nb) - 1)) << pos
        pos += nb
    return v.to_bytes(16, "little")


# PIL's departures from the Direct3D specification, each a block, one of
# its pixels and what PIL (and so the port) gives there
HAZARDS = {
    # BC1 thirds truncated: red 16 and 0 (5-bit 2 and 0), index 2 gives
    # (2 * 16 + 0) // 3 = 10 where rounding gives 11
    "bc1_thirds_truncated": (
        "BC1", struct.pack("<HHI", 2 << 11, 0, 2), 0, (10, 0, 0, 255)),
    # BC7 with no mode bit: opaque black (the specification: transparent)
    "bc7_mode_byte_0": ("BC7", bytes(16), 0, (0, 0, 0, 255)),
    # signed BC5: blue 128 (unsigned BC5's is 0)
    "bc5s_blue_128": ("BC5S", bytes(16), 0, (128, 128, 128)),
    # BC6H mode 11, endpoints 0 and 413 (unquantized 26464), pixel 1's
    # index 13 (weight 55): (26464 * 55) >> 6 = 22742 without the
    # specification's + 32 (22743 with it), half bits (22742 * 31) >> 6,
    # 8-bit 13 (14 with the rounding)
    "bc6h_interpolation_truncated": (
        "BC6H", _bits_block([(3, 5), (0, 30)] + [(413, 10)] * 3
                            + [(0, 3), (13, 4)]), 1, (13, 13, 13)),
    # signed BC6H mode 1 (two regions, transformed): red w = 511, the
    # largest positive 10-bit value, plus the delta 15 wraps to 526, which
    # PIL keeps positive (unquantized to 0x7FFF, a half of 65504: 255) and
    # the specification sign-extends to -498 (0); pixel 1 (region 0 of
    # partition 0) takes the delta's endpoint by index 7
    "bc6hs_sum_not_sign_extended": (
        "BC6HS", _bits_block([(0, 2), (0, 3), (511, 10), (0, 20), (15, 5),
                              (0, 42), (0, 2), (7, 3)]), 1, (255, 0, 0)),
}


@pytest.mark.parametrize("case", sorted(HAZARDS))
def test_pil_departures_kept(tmp_path, case):
    kind, block, pixel, value = HAZARDS[case]
    data = tiw.dds_blocks(kind, block, 4, 4, dx10={
        "BC1": 71, "BC7": 98, "BC5S": 84, "BC6H": 95, "BC6HS": 96}[kind])
    want = _pil(data)
    assert tuple(want.reshape(16, -1)[pixel]) == value
    _check_against_reference(tmp_path / "t.dds", data)


def test_rebuilt_block_maps_hashes():
    """The block-compressed files scripts/block_maps.py rebuilds for
    chip_smoke.py phase 34 (the 2048x1024 sky in six formats, the ground
    in BC7): their bytes and PIL's samples at images.json's hashes, and
    the port's samples PIL's."""
    record = json.loads((FIXTURES / "images.json").read_text())
    rebuilt = {k: v for k, v in record.items()
               if v.get("rebuilt_by") == "scripts/block_maps.py"}
    files = tiw.block_files()
    ground = np.asarray(Image.open(FIXTURES / "ground_1024x512_q90.webp"))
    files["ground_1024x512_bc7.dds"] = tiw.encode_dds("BC7", ground)
    assert sorted(files) == sorted(rebuilt)
    for name, data in files.items():
        rec = rebuilt[name]
        assert hashlib.sha256(data).hexdigest() == rec["sha256_of_bytes"]
        assert len(data) == rec["bytes"]
        pil = np.ascontiguousarray(_pil(data))
        assert list(pil.shape[:2]) == rec["shape"][:2]
        assert hashlib.sha256(pil.tobytes()).hexdigest() == \
            rec["sha256_of_pil_samples"]
        assert np.array_equal(image_read.decode_dds(data), pil)


def test_scripts_import_no_image_library():
    """scripts/block_maps.py, which phase 34 runs, writes its files without
    PIL (the card's host has none)."""
    import re

    src = (Path(__file__).resolve().parents[1] / "scripts"
           / "block_maps.py").read_text()
    assert not re.search(r"^\s*(?:import|from)\s+PIL\b", src, re.M)


def test_phase34_decodes_run_small():
    """chip_smoke.py phase 34 (c)'s files and decode loop at 64x32 (the
    card runs them at 2048x1024): every file decodes, the lossless ones to
    their samples."""
    import block_maps

    blocks = block_maps.block_files(64, 32)
    out = block_maps.decode_all(blocks, block_maps.lossless_files(64, 32))
    assert len(out) == 10 and all(rec[-1] for rec in out)
    assert [rec[3][:2] for rec in out[:6]] == [(32, 64)] * 6
