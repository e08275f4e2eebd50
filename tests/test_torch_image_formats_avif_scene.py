"""The slice of AVIF read: a 32x24 frame under an AVIF sky (PIL's
defaults) over an AVIF ground (speed 4, loop restoration), parsed and
rendered by the port on the CPU and by the JAX package under
jax.disable_jit, equal (as test_torch_image_formats_pil_only.py's
PhotoCD / FTEX frame).  The decode itself is held to PIL in
test_torch_image_formats_avif.py.
"""

import numpy as np
import pytest
from PIL import Image

from test_torch_image_formats_avif import _image, _save


@pytest.fixture
def avif_scene(tmp_path):
    """test_torch_image_formats_scene's ground quad under an AVIF sky (PIL's
    defaults) over an AVIF ground (speed 4: loop restoration)."""
    from test_torch_image_formats_scene import _scene_text

    (tmp_path / "sky.avif").write_bytes(_save(Image.fromarray(
        _image(32, 64, seed=3))))
    (tmp_path / "ground.avif").write_bytes(_save(Image.fromarray(
        _image(32, 48, seed=4)), speed=4))
    path = tmp_path / "scene.pbrt"
    path.write_text(_scene_text(tmp_path / "sky.avif", "ground.avif"))
    return path


def test_avif_sky_and_ground_render_like_jax(avif_scene):
    """Both packages parse the file into equal scenes (the port with its
    warnings made errors: no uniform-sky fallback) and the port's 32x24
    frame on the CPU equals the JAX package's under jax.disable_jit."""
    import warnings

    import jax

    from acceleratedvolrenderer_tpu.parallel import render as jrender
    from acceleratedvolrenderer_tpu.scene import parser as jparser
    from acceleratedvolrenderer_tpu_torch.models import lights as tlights
    from acceleratedvolrenderer_tpu_torch.parallel import render as trender
    from acceleratedvolrenderer_tpu_torch.scene import parser as tparser
    from test_torch_scene_parser import _scenes_equal

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ts = tparser.load_scene(str(avif_scene), device="cpu")
    js = jparser.load_scene(str(avif_scene))
    assert isinstance(ts.lights[1], tlights.ImageInfiniteLight)
    _scenes_equal(js, ts)
    with jax.disable_jit():
        ref, _ = jrender.render(js)
    img, _ = trender.render(ts, device="cpu")
    assert img.shape == ref.shape == (24, 32, 3) and img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-5
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-6)
