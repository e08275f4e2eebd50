"""The port's EXR writer (utils/image.py, through models/film.py::write_film)
against the JAX package's (acceleratedvolrenderer_tpu/utils/image.py): the
same image and metadata give byte-identical files, which the JAX package's
reader reads back exactly.  And no file of the port, chip_smoke.py or the
port's gather-design script imports jax or the JAX package."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import film as jfilm
from acceleratedvolrenderer_tpu.utils import image as jimage
from acceleratedvolrenderer_tpu_torch.models import film as tfilm
from acceleratedvolrenderer_tpu_torch.utils import image as timage

ROOT = Path(__file__).resolve().parents[1]


def _image(shape, seed=0):
    img = np.random.default_rng(seed).uniform(0.0, 3.0, shape)
    return img.astype(np.float32)


@pytest.mark.parametrize("shape", [(37, 21, 3), (5, 4, 3), (40, 33, 3)])
def test_write_film_byte_identical(tmp_path, shape):
    img = _image(shape)
    img[0, 0] = 0.0                     # a run that compresses
    w2c = np.arange(16, dtype=np.float32).reshape(4, 4)
    kw = dict(render_time=12.5, spp=16, mse=0.001, w2c=w2c)
    jfilm.write_film(str(tmp_path / "j.exr"), img, **kw)
    tfilm.write_film(str(tmp_path / "t.exr"), torch.as_tensor(img), **kw)
    raw = (tmp_path / "t.exr").read_bytes()
    assert raw == (tmp_path / "j.exr").read_bytes()
    back, names, attrs = jimage.read_exr(str(tmp_path / "t.exr"))
    assert np.array_equal(back, img)
    assert int(attrs["samplesPerPixel"]) == 16


def test_write_exr_options_byte_identical(tmp_path):
    """Half floats, other channel names, string and NDC metadata."""
    img = _image((18, 9, 2), seed=1)
    names = ("Z", "A")
    for mod, tag in ((jimage, "j"), (timage, "t")):
        md = mod.ImageMetadata(render_time_seconds=1.0,
                               world_to_ndc=np.eye(4),
                               strings={"renderer": "volpath"})
        mod.write_exr(str(tmp_path / f"{tag}.exr"), img, md,
                      channel_names=names, half=True)
    assert ((tmp_path / "t.exr").read_bytes()
            == (tmp_path / "j.exr").read_bytes())
    back, got_names, _ = jimage.read_exr(str(tmp_path / "t.exr"))
    order = [names.index(n) for n in got_names]
    assert sorted(order) == [0, 1]
    want = img.astype(np.float16).astype(np.float32)[..., order]
    assert np.array_equal(np.asarray(back, np.float32), want)


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax\b|"
                     r"acceleratedvolrenderer_tpu(?:\.|\s|$))", re.M)


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "acceleratedvolrenderer_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py",
              ROOT / "scripts" / "measure_gather_designs_torch.py",
              ROOT / "scripts" / "phase31_alone.py",
              ROOT / "scripts" / "time_image_decode.py",
              ROOT / "tests" / "torch_shard_worker.py"]
    assert len(files) > 20
    bad = [str(f.relative_to(ROOT)) for f in files
           if _IMPORT.search(f.read_text())]
    assert bad == []
    # the pattern does catch such imports
    assert _IMPORT.search("import jax.numpy as jnp")
    assert _IMPORT.search("    from acceleratedvolrenderer_tpu.utils import x")
    assert not _IMPORT.search("from acceleratedvolrenderer_tpu_torch import y")
