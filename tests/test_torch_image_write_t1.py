"""The JPEG 2000 tier-1 encoder in C++ (native/j2k_t1.cpp,
avrt_j2k_encode_blocks) against its plain-Python twin (utils/j2k_t1.py,
encode_block), on every code-block the 5/3 sub-bands of the test images
give at 37x23 and 64x48 (from 1x2 up, every orientation), and
on blocks of random signs and magnitudes of 1 to 11 bit-planes: the same
bit-plane counts and bytes; the bytes decode (numpy tier 1) back to the
coefficients; and whole files with either tier 1 are PIL's bytes (the
writer always runs the C++ encoder: the twin's files are made by putting
it in the writer's place)."""
import io

import numpy as np
import pytest
from PIL import Image

from acceleratedvolrenderer_tpu_torch import native
from acceleratedvolrenderer_tpu_torch.utils import (
    image, image_write, j2k_t1, jpeg2000_write)

from torch_write_util import KINDS, linear_image


def _band_blocks(px):
    """(coefficients, orientation) of every code-block of px's planes."""
    out = []
    levels = jpeg2000_write.resolutions(px.shape[1], px.shape[0]) - 1
    for c in range(3):
        for res in jpeg2000_write.subbands(px[..., c].astype(np.int64) - 128,
                                           levels):
            for orient, band in res:
                out += [(b, orient) for b in jpeg2000_write._blocks(band)[0]]
    return out


def _check(blocks):
    got = native.j2k_encode_blocks(blocks)
    want = j2k_t1.encode_blocks(blocks)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [g[1] for g in got] == [w[1] for w in want]
    coded = [(data, 3 * nb - 2, nb, o, *c.shape)
             for (nb, data), (c, o) in zip(got, blocks) if nb]
    dec = j2k_t1.decode_blocks(coded)
    for d, (c, _) in zip(dec, [b for b, g in zip(blocks, got) if g[0]]):
        # decoded values are twice the magnitude plus half a step
        assert np.array_equal(np.sign(d) * (np.abs(d) >> 1), c)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("size", [(37, 23), (64, 48)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cpp_encoder_matches_twin_on_image_blocks(size, kind):
    px = image.to_8bit(linear_image(kind, *size))
    blocks = _band_blocks(px)
    assert len({b.shape for b, _ in blocks}) >= 6
    _check(blocks)


@pytest.mark.parametrize("planes", [1, 2, 5, 8, 11])
def test_cpp_encoder_matches_twin_on_random_blocks(planes):
    rng = np.random.default_rng(planes)
    blocks = []
    for orient in range(4):
        for h, w in ((1, 1), (3, 7), (4, 4), (5, 64), (64, 5), (17, 33)):
            mag = rng.integers(0, 1 << planes, (h, w))
            sparse = rng.random((h, w)) < 0.3
            c = np.where(sparse, mag, mag >> planes // 2) * rng.choice(
                [-1, 1], (h, w))
            blocks.append((c.astype(np.int32), orient))
    blocks.append((np.zeros((8, 8), np.int32), 3))
    _check(blocks)


@pytest.mark.parametrize("native_t1", [True, False], ids=["cpp", "python"])
def test_files_with_either_tier1_are_pils(native_t1, monkeypatch):
    if not native_t1:
        monkeypatch.setattr(jpeg2000_write, "_tier1", j2k_t1.encode_blocks)
    px = image.to_8bit(linear_image("noise", 37, 23))
    for ext in (".jp2", ".j2k"):
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "JPEG2000", no_jp2=ext == ".j2k")
        assert jpeg2000_write.encode_jpeg2000(px, f"x{ext}") == \
            buf.getvalue()


def test_writer_raises_without_cpp_encoder(monkeypatch, tmp_path):
    """No silent fallback to the twin: where g++ is missing, the writer
    raises the build's error, which names g++."""
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError(2, "No such file or directory", "g++")

    monkeypatch.setattr(native, "_j2k_lib", None)
    monkeypatch.setattr(native, "_j2k_tried", False)
    monkeypatch.setattr(native, "J2K_LIB_PATH", tmp_path / "libj2k.so")
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    px = image.to_8bit(linear_image("noise", 8, 8))
    for ext in (".jp2", ".j2k"):
        with pytest.raises(RuntimeError, match="g\\+\\+.*no fallback"):
            image_write.encode(f"x{ext}", px)
