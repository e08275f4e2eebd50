"""The port's WebP reader (acceleratedvolrenderer_tpu_torch/utils/webp.py and
utils/vp8.py, through utils/image.py's read_image) against the
reference's read_image, which opens the file with PIL (libwebp's decoder),
bit for bit: lossy (VP8: the boolean decoder, intra prediction, the
dequantizer, the inverse WHT / DCT and loop filters, then libwebp's fancy
upsampling and 14-bit YUV -> RGB), lossless (VP8L: the four transforms,
colour cache, meta prefix codes, LZ77), alpha (ALPH, raw or VP8L-coded,
its filters) and the first frame of an animation; sizes that are not
multiples of 16.  decode_webp's RGBA equals PIL's samples too.  The
committed fixtures under tests/data/images/ (scripts/make_image_fixtures.py)
are held to the hashes of PIL's decode that images.json records; that
test skips without PIL, so a machine without it does not fail on it.
"""
import hashlib
import io
import json
from pathlib import Path

import numpy as np
import pytest

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.utils import image as timage
from acceleratedvolrenderer_tpu_torch.utils import webp as twebp

Image = pytest.importorskip("PIL.Image")

FIXTURES = Path(__file__).resolve().parent / "data" / "images"


def _scene(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 7.0),
                    128 + 90 * np.cos(yy / 5.0 + xx / 11.0),
                    (xx * 3 + yy * 5) % 256], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def _webp(im, **kw):
    b = io.BytesIO()
    im.save(b, "WEBP", **kw)
    return b.getvalue()


def _check(tmp_path, data):
    """decode_webp equals PIL's samples; read_image the reference's."""
    ref = np.asarray(Image.open(io.BytesIO(data)))
    got = twebp.decode_webp(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)
    path = tmp_path / "t.webp"
    path.write_bytes(data)
    lin, attrs = timage.read_image(str(path))
    assert attrs == {} and np.array_equal(lin,
                                          jimage.read_image(str(path))[0])


LOSSY = {"q90": dict(quality=90), "q10": dict(quality=10),
         "q50_method0": dict(quality=50, method=0),
         "q75_method6": dict(quality=75, method=6),
         "q100": dict(quality=100)}


@pytest.mark.parametrize("size", [(37, 23), (300, 200), (17, 33), (1, 1)])
@pytest.mark.parametrize("case", sorted(LOSSY))
def test_lossy_matches_reference(tmp_path, case, size):
    _check(tmp_path, _webp(Image.fromarray(_scene(*size)), **LOSSY[case]))


def _image(kind, w, h):
    base = _scene(w, h)
    if kind == "rgb":
        return Image.fromarray(base)
    if kind == "gray":
        return Image.fromarray(base[..., 0]).convert("RGB")
    if kind == "flat":
        return Image.fromarray(np.full((h, w, 3), 77, np.uint8))
    colors = {"palette2": 2, "palette12": 12, "palette200": 200}[kind]
    return Image.fromarray(base).convert(
        "P", palette=Image.ADAPTIVE, colors=colors).convert("RGB")


LOSSLESS = {"default": dict(lossless=True),
            "fast": dict(lossless=True, quality=0, method=0),
            "best": dict(lossless=True, quality=100, method=6)}


@pytest.mark.parametrize("kind", ["rgb", "gray", "flat", "palette2",
                                  "palette12", "palette200"])
@pytest.mark.parametrize("case", sorted(LOSSLESS))
def test_lossless_matches_reference(tmp_path, case, kind):
    _check(tmp_path, _webp(_image(kind, 37, 23), **LOSSLESS[case]))


def test_lossless_larger_image_matches_reference(tmp_path):
    """300x200: meta prefix codes, cache and distance codes all in use."""
    _check(tmp_path, _webp(Image.fromarray(_scene(300, 200)),
                           lossless=True))


ALPHA = {"lossy": dict(quality=80), "lossy_alpha_q50": dict(
    quality=80, alpha_quality=50), "lossy_raw_alpha": dict(
    quality=60, alpha_method=0), "lossy_filtered": dict(
    quality=70, alpha_filter="best"), "lossless": dict(lossless=True),
    "lossless_exact": dict(lossless=True, exact=True)}


@pytest.mark.parametrize("size", [(37, 23), (300, 200)])
@pytest.mark.parametrize("case", sorted(ALPHA))
def test_alpha_matches_reference(tmp_path, case, size):
    base = _scene(*size)
    yy, xx = np.mgrid[0:size[1], 0:size[0]]
    alpha = ((xx * 7 + yy * 3) % 256).astype(np.uint8)[..., None]
    data = _webp(Image.fromarray(np.concatenate([base, alpha], -1)),
                 **ALPHA[case])
    _check(tmp_path, data)
    assert twebp.decode_webp(data).shape[2] == 4


@pytest.mark.parametrize("kw", [dict(lossless=True), dict(quality=70)],
                         ids=["lossless", "lossy"])
def test_animation_gives_first_frame(tmp_path, kw):
    frames = [Image.fromarray(_scene(40, 30, seed=s)) for s in range(3)]
    b = io.BytesIO()
    frames[0].save(b, "WEBP", save_all=True, append_images=frames[1:],
                   duration=100, **kw)
    _check(tmp_path, b.getvalue())


def test_truncated_and_foreign_chunks_raise():
    data = _webp(Image.fromarray(_scene(37, 23)), quality=80)
    with pytest.raises(ValueError, match="WebP"):
        twebp.decode_webp(data[:len(data) // 2])
    with pytest.raises(ValueError, match="WebP"):
        twebp.decode_webp(b"RIFF\x10\0\0\0WEBPVP8 " + b"\0" * 8)


@pytest.mark.parametrize("case", ["inter_frame", "profile", "partition"])
def test_vp8_frames_libwebp_refuses_raise(case):
    """An inter frame, a profile above 3 and a first partition longer
    than the chunk: refused, as libwebp refuses them."""
    data = bytearray(_webp(Image.fromarray(_scene(37, 23)), quality=80))
    at = data.index(b"VP8 ") + 8                    # the frame tag
    tag = int.from_bytes(data[at:at + 3], "little")
    tag = {"inter_frame": tag | 1, "profile": tag | 7 << 1,
           "partition": tag | 0x7FFFF << 5}[case]
    data[at:at + 3] = tag.to_bytes(3, "little")
    words = {"inter_frame": "not a key frame", "profile": "profile",
             "partition": "truncated"}[case]
    with pytest.raises(ValueError, match=words):
        twebp.decode_webp(bytes(data))


def test_committed_fixtures_hashes():
    """Each committed WebP fixture: PIL's decode has the recorded SHA-256,
    and the port's decode is those samples (the entries with `rebuilt_by`
    are files scripts/block_maps.py rebuilds, held in
    test_torch_image_formats_bcn.py; the JPEG 2000 ones are held in
    test_torch_image_formats_j2k.py)."""
    record = json.loads((FIXTURES / "images.json").read_text())
    committed = {k: v for k, v in record.items()
                 if "rebuilt_by" not in v and k.endswith(".webp")}
    assert len(committed) == 2
    for name, rec in committed.items():
        data = (FIXTURES / name).read_bytes()
        assert len(data) == rec["bytes"] < 512 * 1024
        pil = np.ascontiguousarray(np.asarray(Image.open(io.BytesIO(data))))
        assert list(pil.shape) == rec["shape"]
        assert hashlib.sha256(pil.tobytes()).hexdigest() == \
            rec["sha256_of_pil_samples"]
        assert np.array_equal(twebp.decode_webp(data), pil)
