"""The new image readers where users meet them: a .pbrt file whose infinite
light reads a TIFF map and whose ground's imagemap texture is a WebP,
parsed by both packages into equal scenes and rendered at 32x24 by the
port on the CPU, equal to the JAX package's frame under jax.disable_jit
(the reference's own ops, unfused; see tests/test_torch_fused_surfaces.py);
an environment map in each newly read format no longer falls back to a
uniform sky with a warning; and imgtool's loader (cli/imgtool.py::_load)
on JPEG, BMP, TGA, TIFF, WebP and QOI files equals the reference's bit
for bit, and reads GIF, where the reference's crashes on the 2-D index
array PIL returns (ROADMAP Queue 3).
"""
import io
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from acceleratedvolrenderer_tpu.cli import imgtool as jimgtool
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import parser as jparser
from acceleratedvolrenderer_tpu_torch.cli import imgtool as timgtool
from acceleratedvolrenderer_tpu_torch.models import lights as tlights
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import parser as tparser
from acceleratedvolrenderer_tpu_torch.utils import image as timage
from acceleratedvolrenderer_tpu_torch.utils.image import read_exr

from test_torch_scene_parser import _scenes_equal

import torch_image_writers as tiw

torch.set_num_threads(2)


def _scene_text(sky, ground, w=32, h=24):
    """A textured ground quad seen from above under a sky map and a sun,
    the path integrator at depth 1 (the sky and the sun on the textured
    ground), spp 1."""
    return f"""
LookAt 0 3 -6  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [{w}] "integer yresolution" [{h}]
Sampler "independent" "integer pixelsamples" [1]
Integrator "path" "integer maxdepth" [1]
WorldBegin
LightSource "distant" "rgb L" [1 1 1] "float scale" [2]
    "point3 from" [0 0 0] "point3 to" [0.3 -1 0.4]
LightSource "infinite" "string filename" "{sky}" "float scale" [0.6]
Texture "ground" "spectrum" "imagemap" "string filename" "{ground}"
Material "diffuse" "texture reflectance" "ground"
Shape "trianglemesh" "point3 P" [-4 0 -4  4 0 -4  -4 0 4  4 0 4]
    "point2 uv" [0 0 1 0 0 1 1 1] "integer indices" [0 1 2 2 1 3]
"""


@pytest.fixture
def scene_file(tmp_path):
    sky = tiw.sky(64, 32, 255)
    (tmp_path / "sky.tif").write_bytes(tiw.encode_tiff(sky, "lzw",
                                                       predictor=2))
    b = io.BytesIO()
    Image.fromarray(tiw.scene(48, 32)).save(b, "WEBP", quality=85)
    (tmp_path / "ground.webp").write_bytes(b.getvalue())
    path = tmp_path / "scene.pbrt"
    # the infinite light's filename is not joined with the file's
    # directory (in both packages): an absolute path
    path.write_text(_scene_text(tmp_path / "sky.tif", "ground.webp"))
    return path


def test_tiff_sky_and_webp_ground_parse_like_jax(scene_file):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ts = tparser.load_scene(str(scene_file), device="cpu")
    js = jparser.load_scene(str(scene_file))
    assert isinstance(ts.lights[1], tlights.ImageInfiniteLight)
    _scenes_equal(js, ts)


def test_tiff_sky_and_webp_ground_render_like_jax(scene_file):
    import jax

    js = jparser.load_scene(str(scene_file))
    ts = tparser.load_scene(str(scene_file), device="cpu")
    with jax.disable_jit():
        ref, _ = jrender.render(js)
    img, _ = trender.render(ts, device="cpu")
    assert img.shape == ref.shape == (24, 32, 3) and img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-5
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-6)


def _env_file(kind, tmp_path):
    sky8 = tiw.sky(16, 8, 255)
    if kind == "tif":
        return tiw.encode_tiff(sky8, "deflate")
    if kind == "webp":
        b = io.BytesIO()
        Image.fromarray(sky8).save(b, "WEBP", lossless=True)
        return b.getvalue()
    if kind == "gif":
        pal = np.unique(sky8.reshape(-1, 3), axis=0)[:256]
        idx = np.array([[np.flatnonzero((pal == p).all(1))[0] if (
            pal == p).all(1).any() else 0 for p in row] for row in sky8])
        full = np.zeros((256, 3), np.uint8)
        full[:len(pal)] = pal
        return tiw.encode_gif(idx.astype(np.uint8), full)
    if kind == "qoi":
        return tiw.encode_qoi(sky8)
    return tiw.encode_netpbm(sky8)


@pytest.mark.parametrize("kind", ["tif", "webp", "gif", "qoi", "ppm"])
def test_environment_map_not_dropped(tmp_path, kind):
    """The parser used to warn and light the scene by a uniform sky for
    these formats; now the map is the image read_image reads."""
    env = tmp_path / f"sky.{kind}"
    env.write_bytes(_env_file(kind, tmp_path))
    path = tmp_path / "env.pbrt"
    path.write_text(f'WorldBegin\nLightSource "infinite" "string filename" '
                    f'"{env}"\nShape "sphere" "float radius" [1]\n')
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sc = tparser.load_scene(str(path), device="cpu")
    light = sc.lights[0]
    assert isinstance(light, tlights.ImageInfiniteLight)
    np.testing.assert_array_equal(light.image,
                                  timage.read_image(str(env))[0])


def _load_file(kind, tmp_path):
    px = tiw.scene(37, 23)
    if kind == "qoi":
        data = tiw.encode_qoi(px)
    else:
        b = io.BytesIO()
        fmt = {"jpg": "JPEG", "bmp": "BMP", "tga": "TGA", "tif": "TIFF",
               "webp": "WEBP", "gif": "GIF"}[kind]
        Image.fromarray(px).save(b, fmt)
        data = b.getvalue()
    path = tmp_path / f"t.{kind}"
    path.write_bytes(data)
    return str(path)


@pytest.mark.parametrize("kind", ["jpg", "bmp", "tga", "tif", "webp", "qoi"])
def test_imgtool_load_matches_reference(tmp_path, kind):
    path = _load_file(kind, tmp_path)
    got, attrs = timgtool._load(path)
    want, jattrs = jimgtool._load(path)
    assert attrs == jattrs == {}
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_imgtool_load_reads_gif(tmp_path):
    path = _load_file("gif", tmp_path)
    with pytest.raises(IndexError):
        jimgtool._load(path)            # PIL's 2-D palette indices
    rgb = np.asarray(Image.open(path).convert("RGB"))
    got, _ = timgtool._load(path)
    assert np.array_equal(got, rgb.astype(np.float32) / 255.0)


@pytest.mark.parametrize("kind", ["jpg", "bmp", "tga", "tif", "webp", "gif",
                                  "qoi"])
def test_imgtool_diff_and_convert_read_the_formats(tmp_path, capsys, kind):
    """`imgtool convert` writes _load's image; `imgtool diff` of a file
    against its EXR conversion is 0, and against the reference's printout
    for the formats the reference reads."""
    path = _load_file(kind, tmp_path)
    out = str(tmp_path / "out.exr")
    assert timgtool.main(["convert", path, out]) == 0
    img = read_exr(out)[0]
    np.testing.assert_array_equal(img[..., :3], timgtool._load(path)[0])
    capsys.readouterr()
    assert timgtool.main(["diff", path, out]) == 0
    got = capsys.readouterr().out
    assert '"MSE": 0.0' in got.replace(" ", "").replace('"MSE":0.0',
                                                         '"MSE": 0.0')
    if kind != "gif":
        assert jimgtool.main(["diff", path, out]) == 0
        assert capsys.readouterr().out == got


def test_readers_import_no_image_library():
    """The port, chip_smoke.py and the scripts phase 32 runs read images
    without PIL, libtiff or libwebp (the card's host has none)."""
    import re

    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "acceleratedvolrenderer_tpu_torch").rglob("*.py"))
    files += [root / "chip_smoke.py", root / "scripts/time_image_decode.py",
              root / "scripts/phase32_alone.py",
              root / "scripts/pil_only_formats.py"]
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:PIL|tifffile|libtiff|"
                         r"webp|imageio|cv2)\b", re.M)
    hits = [str(f) for f in files if pattern.search(f.read_text())]
    assert not hits, hits
    assert pattern.search("    from PIL import Image")
