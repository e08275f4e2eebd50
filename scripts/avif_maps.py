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
    10, decoded by chip_smoke.py's side process (phase 37).

scripts/make_image_fixtures.py --avif writes them (make_files) and their
records; tests/test_torch_image_formats_avif.py holds them to PIL.

    python3 scripts/avif_maps.py      # decode each fixture, print seconds
"""
from __future__ import annotations

import hashlib
import io
import json
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
    return {"sky": sky_px[..., :3], "ground": ground_px[..., :3],
            "crop": crop,
            "rgba": np.concatenate([crop, alpha(h, w)[..., None]], -1)}


def make_files(sky_px, ground_px):
    """{name: bytes} of PIL's AVIF files (needs PIL)."""
    from PIL import Image

    src = sources(sky_px, ground_px)
    out = {}
    for name, (which, kw) in AVIF_FILES.items():
        buf = io.BytesIO()
        px = src[which]
        Image.fromarray(px, "RGBA" if px.shape[-1] == 4 else "RGB").save(
            buf, "AVIF", **kw)
        out[name] = buf.getvalue()
    return out


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


def main():
    import time_image_decode as tid

    print(f"host CPU: {tid.cpu_line()}")
    for name, secs, shape, ok in decode_fixtures(tuple(AVIF_FILES)):
        print(f"{name}: {tuple(shape)} decoded in {secs:.4f} s, "
              f"{'equal to PIL' if ok else 'WRONG'}")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main()
