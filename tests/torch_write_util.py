"""Images and helpers for tests/test_torch_image_write_*.py: numpy-seeded
linear float images (gradient, noise, constant, a few colours), written by
the port's and the JAX package's write_png (PIL) into two folders, and a
fixed clock for PDF files (both write time.gmtime() at the call:
chip_smoke.pdf_clock, the clock images.json's PDF hash was written under)."""
import numpy as np

from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.utils import image as timage

from chip_smoke import pdf_clock

KINDS = ("gradient", "noise", "constant", "few")
SIZES = ((8, 8), (37, 23), (64, 48))


def linear_image(kind, w, h, seed=0):
    """A linear float image (h, w, 3)."""
    if kind == "gradient":
        yy, xx = np.mgrid[0:h, 0:w]
        return np.stack([xx / max(w - 1, 1) * 1.3 - 0.1, yy / max(h - 1, 1),
                         (xx + yy) / max(w + h - 2, 1) * 0.5],
                        -1).astype(np.float32)
    rng = np.random.default_rng(seed + w * h)
    if kind == "noise":
        return rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    if kind == "few":
        colours = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                            [0.6, 0.02, 0.04], [0.01, 0.1, 0.9],
                            [0.3, 0.3, 0.05]], np.float32)
        return colours[rng.integers(0, len(colours), (h, w))]
    return np.full((h, w, 3), [0.7, 0.05, 0.3], np.float32)


def write_both(tmp_path, name, img, tonemap=True):
    """The port's and the JAX package's files of img, both named `name`,
    under a fixed clock."""
    paths = []
    for tag, mod in (("t", timage), ("j", jimage)):
        (tmp_path / tag).mkdir(exist_ok=True)
        p = tmp_path / tag / name
        with pdf_clock():
            mod.write_png(str(p), img, tonemap=tonemap)
        paths.append(p)
    return paths
