"""The port's scene parser (scene/parser.py) against the JAX package's: the
tokenizer gives the same tokens on every scene the JAX tests write and on a
32^3 uniformgrid block (whose numbers it parses in bulk, to the same
float32 values); the parsed Scene equals the JAX one field by field
(camera matrices, density and majorant bitwise, light directions, spectra
at 64 wavelengths to rtol 2e-6 (exp differs by an ulp between XLA and
torch), filter, sampler, spp, integrator, primitives); a parsed medium scene and a parsed surface scene render
through both packages on the CPU to the earlier slices' frame tolerances
(means to 1e-3, 99% of pixels to rtol 1e-3 / atol 1e-5; the surface frame
against the JAX li outside jit, as tests/test_torch_fused_surfaces.py
renders it); and the parser's own cases of tests/test_parser.py."""
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.cli import nanovdb2pbrt as jconv
from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import parser as jparser
from acceleratedvolrenderer_tpu_torch.cli import nanovdb2pbrt as tconv
from acceleratedvolrenderer_tpu_torch.models import cameras as tcam
from acceleratedvolrenderer_tpu_torch.models import textures as ttex
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import parser as tparser

from test_cli import SCENE_TXT
from test_parser import MINI_SCENE

torch.set_num_threads(2)

CLI_SCENE = (
    'LookAt 0.5 0.5 -3  0.5 0.5 0.5  0 1 0\n'
    'Camera "perspective" "float fov" [30]\n'
    'Film "rgb" "integer xresolution" [8] "integer yresolution" [8]\n'
    'Sampler "halton" "integer pixelsamples" [2]\n'
    'Integrator "volpath" "integer maxdepth" [3]\n'
    'WorldBegin\n'
    'LightSource "infinite" "rgb L" [0.5 0.5 0.5]\n')

SURFACE_SCENE = '''
Camera "perspective" "float fov" [45]
Film "rgb" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
LightSource "point" "rgb I" [10 10 10]
MakeNamedMaterial "red" "string type" "diffuse" "rgb reflectance" [.8 .1 .1]
AttributeBegin
Translate 0 0 5
Material "coateddiffuse" "float roughness" [0.1]
Shape "sphere" "float radius" [1.5]
AttributeEnd
AttributeBegin
NamedMaterial "red"
Translate 0 -2 5
Shape "trianglemesh"
  "point3 P" [-3 0 -3  3 0 -3  3 0 3  -3 0 3]
  "integer indices" [0 1 2 0 2 3]
AttributeEnd
AttributeBegin
AreaLightSource "diffuse" "rgb L" [4 4 4]
Translate 0 3 5
Shape "disk" "float radius" [0.7]
AttributeEnd
'''

RENDER_SURFACE_SCENE = '''
Camera "perspective" "float fov" [50]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
Sampler "independent" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "point" "point3 from" [0 2 3] "rgb I" [20 20 20]
AttributeBegin
Translate 0 0 4
Shape "sphere" "float radius" [1]
AttributeEnd
'''

TRANSFORM_SCENE = '''
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
AttributeBegin
Transform [ 1 0 0 0  0 1 0 0  0 0 1 0  0.5 0 4 1 ]
ConcatTransform [ 2 0 0 0  0 2 0 0  0 0 2 0  0 0 0 1 ]
Shape "sphere" "float radius" [1]
AttributeEnd
'''

UNBRACKETED_SCENE = '''
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Transform 1 0 0 0  0 1 0 0  0 0 1 0  0 0 4 1
Shape "sphere" "float radius" [1]
'''

TEXTURE_SCENE = '''
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
Texture "half" "float" "constant" "float value" [0.5]
Texture "chk" "spectrum" "checkerboard"
    "texture tex1" "half" "rgb tex2" [0.9 0.1 0.1]
    "float uscale" [4] "float vscale" [4]
Texture "sph" "float" "fbm" "integer octaves" [4]
Material "diffuse" "texture reflectance" "chk"
Shape "sphere" "float radius" [1]
'''

TEXTURE_MIX_SCENE = '''
WorldBegin
Texture "a" "float" "constant" "float value" [0.25]
Texture "b" "float" "scale" "texture tex" "a" "float scale" [2]
Texture "c" "float" "mix" "texture tex1" "a" "texture tex2" "b"
    "float amount" [1.0]
Texture "d" "spectrum" "directionmix" "texture tex1" "a"
    "texture tex2" "b" "vector dir" [0 0 1]
'''

# cameras, lights, materials, shapes and media beyond the JAX tests' scenes
BREADTH_SCENE = '''
Scale -1 1 1
LookAt 1 2 -6  0 0.5 0  0 1 0
Rotate 5 0 0 1
Camera "orthographic"
Film "rgb" "integer xresolution" [20] "integer yresolution" [12]
PixelFilter "box" "float xradius" [0.5]
Sampler "zsobol" "integer pixelsamples" [4]
Integrator "simplepath" "integer maxdepth" [4]
WorldBegin
LightSource "spot" "point3 from" [0 4 0] "point3 to" [0 0 0]
    "blackbody I" [3000] "float coneangle" [40]
LightSource "distant" "spectrum L" [400 1 500 2 600 0.5 700 1]
    "point3 from" [1 1 1] "point3 to" [0 0 0] "float scale" [1.5]
MakeNamedMaterial "gold" "string type" "conductor"
    "spectrum eta" "metal-Au-eta" "spectrum k" "metal-Au-k"
    "float roughness" [0.2]
MakeNamedMaterial "glass" "string type" "dielectric" "float eta" [1.33]
AttributeBegin
  NamedMaterial "gold"
  Translate 1 0 0
  Shape "cylinder" "float radius" [0.3] "float zmin" [-0.5] "float zmax" [0.5]
AttributeEnd
AttributeBegin
  Material "mix" "string materials" ["gold" "glass"] "float amount" [0.3]
  Shape "bilinearmesh" "point3 P" [0 0 0  1 0 0  0 1 0  1 1 0.2]
AttributeEnd
AttributeBegin
  Material "diffusetransmission" "rgb reflectance" [0.3 0.4 0.5]
  Scale 2 2 2
  Shape "curve" "point3 P" [0 0 0  0.1 0.5 0  0.2 1 0  0.3 1.5 0]
      "float width" [0.05]
AttributeEnd
AttributeBegin
  Material "thindielectric"
  Shape "disk" "float radius" [2] "float innerradius" [0.5] "float height" [1]
AttributeEnd
AttributeBegin
  Translate 0 1 0
  MakeNamedMedium "smoke" "string type" "rgbgrid"
      "integer nx" [2] "integer ny" [1] "integer nz" [1]
      "rgb sigma_a" [0.1 0.2 0.3  0.4 0.5 0.6]
      "rgb sigma_s" [1 1 1  2 2 2] "float scale" [3]
      "point3 p0" [-1 -1 -1] "point3 p1" [1 1 1]
  MediumInterface "smoke" ""
  Shape "sphere" "float radius" [1.8]
AttributeEnd
'''


def grid_scene(n=32, seed=0):
    """MINI_SCENE with a n^3 uniformgrid block printed by nanovdb2pbrt."""
    dens = np.random.default_rng(seed).random((n, n, n)).astype(np.float32)
    dens[dens < 0.2] = 0.0
    buf = io.StringIO()
    tconv.emit_pbrt(dens, [0, 0, 0], [1, 1, 1], "density", buf)
    return MINI_SCENE.replace(
        '''"integer nx" [2] "integer ny" [2] "integer nz" [2]
      "point3 p0" [0 0 0] "point3 p1" [1 1 1]
      "float density" [1 1 1 1 2 2 2 2]''', buf.getvalue())


SCENES = {"mini": MINI_SCENE, "cli": CLI_SCENE, "cli_mesh": SCENE_TXT,
          "surface": SURFACE_SCENE, "render_surface": RENDER_SURFACE_SCENE,
          "transform": TRANSFORM_SCENE, "unbracketed": UNBRACKETED_SCENE,
          "textures": TEXTURE_SCENE, "texture_mix": TEXTURE_MIX_SCENE,
          "breadth": BREADTH_SCENE,
          "tokenizer": 'Foo "bar baz" [1 2 3] # comment\nQux',
          "string_brackets": '"float x[2]" [0.5]',
          "nested": 'A [ 1 2 [ 3 ] ] "s t" [ "u" 4 ]#c\n\tB\r\n[1e-3 -2E+2 .5]',
          "grid32": None}


def scene_text(name):
    return grid_scene() if name == "grid32" else SCENES[name]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tokens_match_jax(name):
    text = scene_text(name)
    assert tparser.tokenize(text) == jparser.tokenize(text)


def test_grid_block_is_one_bulk_token():
    """The 32^3 block comes as one _Numbers, whose tokens are the reference
    tokens and whose float32 values are the reference parser's."""
    text = grid_scene()
    scanned = tparser._scan(text)
    blocks = [t for t in scanned if isinstance(t, tparser._Numbers)]
    assert len(blocks) == 1 and len(blocks[0]) == 32 ** 3
    ref = jparser.tokenize(text)
    flat = []
    for t in scanned:
        flat.extend(t.tokens() if isinstance(t, tparser._Numbers) else [t])
    assert flat == ref
    want = np.asarray(jparser._floats(blocks[0].tokens()), np.float32)
    np.testing.assert_array_equal(tparser._f32(blocks[0]), want)


def test_bulk_parse_of_unusual_numbers():
    toks = ["1e-3", "-2.5E+2", "+3", ".5", "5.", "-0", "1e400",
            "0.1000000000000000055511151231257827", "4.9406564584124654e-324",
            "123456789012345678901234567890"] * 500
    block = tparser._Numbers(" \n".join(toks))
    np.testing.assert_array_equal(block.array, [float(t) for t in toks])
    with pytest.raises(ValueError):
        tparser._Numbers("1 2 3e " * 1000).array


def test_unterminated_string_raises():
    for mod in (tparser, jparser):
        with pytest.raises(ValueError, match="unterminated"):
            mod.tokenize('Camera "persp')


LAM = torch.linspace(360.0, 830.0, 64).reshape(16, 4)


def _spectra_equal(jf, tf):
    if jf is None or tf is None:
        assert jf is None and tf is None
        return
    a = np.asarray(jf(jnp.asarray(LAM.numpy())), np.float32)
    b = tf(LAM).numpy()
    np.testing.assert_allclose(b, np.broadcast_to(a, b.shape), rtol=2e-6,
                               atol=1e-7)


def _camera_equal(jc, tc):
    assert type(jc).__name__ == type(tc).__name__
    np.testing.assert_array_equal(tc.c2w.m.numpy(), np.asarray(jc.c2w.m))
    np.testing.assert_array_equal(tc.c2w.m_inv.numpy(),
                                  np.asarray(jc.c2w.m_inv))
    assert (tc.width, tc.height) == (jc.width, jc.height)
    for f in ("fov_deg", "screen_scale", "rear_offset"):
        assert getattr(tc, f, None) == getattr(jc, f, None)


def _value_equal(a, b, path):
    """A JAX scene object's field against the port's: spectra at 64
    wavelengths, arrays and numbers exactly, dataclasses field by field."""
    import dataclasses

    if b is None or isinstance(b, (bool, int, float, str)):
        assert a == b, path
    elif isinstance(b, torch.Tensor):
        np.testing.assert_array_equal(b.cpu().numpy(), np.asarray(a),
                                      err_msg=path)
    elif isinstance(b, (np.ndarray, tuple, list)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=path)
    elif dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(b):
            _value_equal(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif callable(b) and not hasattr(b, "eval"):
        _spectra_equal(a, b)
    else:
        assert type(a).__name__ == type(b).__name__, path


def _scenes_equal(js, ts):
    _camera_equal(js.camera, ts.camera)
    for f in ("max_depth", "spp", "sampler", "integrator", "seed",
              "scene_radius", "light_sampler"):
        assert getattr(ts, f) == getattr(js, f), f
    assert type(ts.filter).__name__ == type(js.filter).__name__
    assert tuple(ts.filter) == tuple(js.filter)
    assert len(ts.lights) == len(js.lights)
    for jl, tl in zip(js.lights, ts.lights):
        _value_equal(jl, tl, type(tl).__name__)
    assert len(ts.primitives) == len(js.primitives)
    for jp, tp in zip(js.primitives, ts.primitives):
        _value_equal(jp, tp, type(tp).__name__)
    if js.medium is None:
        assert ts.medium is None
        return
    jm, tm = js.medium, ts.medium
    for f in ("density", "sigma_a_rgb", "sigma_s_rgb", "Le_rgb"):
        a, b = getattr(jm, f), getattr(tm, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tm.build_majorant().numpy(),
                                  np.asarray(jm.build_majorant()))
    np.testing.assert_array_equal(tm.world_to_unit(), jm.world_to_unit())
    for f in ("g", "scale", "Le_scale", "majorant_res"):
        assert getattr(tm, f) == getattr(jm, f), f
    for f in ("sigma_a_spec", "sigma_s_spec", "Le_spec"):
        _spectra_equal(getattr(jm, f), getattr(tm, f))


PARSED = ["mini", "grid32", "cli", "cli_mesh", "surface", "render_surface",
          "transform", "unbracketed", "textures", "breadth"]


@pytest.mark.parametrize("name", PARSED)
def test_parsed_scene_matches_jax(name):
    text = scene_text(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = jparser.PbrtParser().parse_string(text)
        ts = tparser.PbrtParser(device="cpu").parse_string(text)
    _scenes_equal(js, ts)


def test_breadth_scene_kinds():
    ts = tparser.PbrtParser(device="cpu").parse_string(BREADTH_SCENE)
    assert isinstance(ts.camera, tcam.OrthographicCamera)
    assert [type(p).__name__ for p in ts.primitives] == [
        "Cylinder", "BilinearPatch", "Curve", "Disk"]
    assert ts.medium.rgb and ts.medium.sigma_a_rgb.shape == (1, 1, 2, 3)
    assert ts.medium.m2w is not None
    assert ts.sampler == "zsobol" and ts.integrator == "simplepath"


@pytest.mark.parametrize("kind", ["spherical", "realistic"])
def test_other_camera_kinds_match_jax(tmp_path, kind):
    lens = ""
    if kind == "realistic":
        (tmp_path / "lens.dat").write_text(
            "35.0 2.0 1.52 26.0\n0 4.0 1 18.0\n-35.0 30.0 1.0 26.0\n")
        lens = ' "string lensfile" "lens.dat"'
    path = tmp_path / "c.pbrt"
    path.write_text(f'LookAt 0 0 -3 0 0 0 0 1 0\nCamera "{kind}"{lens}\n'
                    'Film "rgb" "integer xresolution" [16] '
                    '"integer yresolution" [8]\nWorldBegin\n')
    js = jparser.load_scene(str(path))
    ts = tparser.load_scene(str(path), device="cpu")
    _camera_equal(js.camera, ts.camera)
    pxy = np.stack(np.meshgrid(np.arange(16), np.arange(8)), -1).reshape(
        -1, 2).astype(np.int32)
    u = np.full(pxy.shape, 0.5, np.float32)
    oj, dj = js.camera.generate_rays(jnp.asarray(pxy), jnp.asarray(u))
    ot, dt = ts.camera.generate_rays(torch.as_tensor(pxy),
                                     torch.as_tensor(u))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6,
                               atol=1e-6)


def _frames_close(img, ref):
    assert img.shape == ref.shape
    assert np.isfinite(img).all() and img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


def test_parsed_medium_scene_renders_like_jax():
    """test_parser.py:76's frame: MINI_SCENE at 8x8, spp 2."""
    js = jparser.PbrtParser().parse_string(MINI_SCENE)
    ts = tparser.PbrtParser(device="cpu").parse_string(MINI_SCENE)
    from acceleratedvolrenderer_tpu.models.cameras import PerspectiveCamera

    js.spp = ts.spp = 2
    js.camera = PerspectiveCamera(c2w=js.camera.c2w, fov_deg=30.0, width=8,
                                  height=8)
    ts.camera = ts.camera._replace(width=8, height=8)
    ref, _ = jrender.render(js)
    img, st = trender.render(ts, device="cpu")
    _frames_close(img, ref)
    assert st["iterations"] > 0


def test_parsed_surface_scene_renders_like_jax():
    """test_parser.py:163's frame: the path integrator over a sphere and a
    point light, 8x8, spp 4 (the JAX side outside jit)."""
    js = jparser.PbrtParser().parse_string(RENDER_SURFACE_SCENE)
    ts = tparser.PbrtParser(device="cpu").parse_string(RENDER_SURFACE_SCENE)
    assert js.integrator == ts.integrator == "path"
    with jax.disable_jit():
        ref, _ = jrender.render(js)
    img, _ = trender.render(ts, device="cpu")
    assert img.max() > 0
    _frames_close(img, ref)


def test_parsed_grid_scene_renders_like_jax():
    """The 32^3 uniformgrid scene at 8x6, spp 1."""
    text = grid_scene().replace("[64]", "[8]").replace("[48]", "[6]")
    js = jparser.PbrtParser().parse_string(text)
    ts = tparser.PbrtParser(device="cpu").parse_string(text)
    ref, _ = jrender.render(js, spp=1)
    img, _ = trender.render(ts, spp=1, device="cpu")
    _frames_close(img, ref)


# tests/test_parser.py's own cases, on the port

def test_camera_transform_matches_lookat():
    scene = tparser.PbrtParser(device="cpu").parse_string(MINI_SCENE)
    o, d = scene.camera.generate_rays(torch.tensor([[32, 24]]),
                                      torch.zeros((1, 2)))
    np.testing.assert_allclose(o[0].numpy(), [0.5, 0.5, -3.0], atol=1e-5)
    np.testing.assert_allclose(d[0].numpy(), [0, 0, 1], atol=1e-3)


def test_unknown_directive_warns():
    with pytest.warns(UserWarning):
        tparser.PbrtParser(device="cpu").parse_string(
            'Camera "perspective"\nWorldBegin\n'
            'Shape "heightfield" "integer nu" [2]\nCoordSysTransform "x"\n'
            'Accelerator "bvh"\n')
    with pytest.raises(ValueError, match="unknown token"):
        tparser.PbrtParser(device="cpu").parse_string("NotADirective 1 2")


def test_include(tmp_path):
    (tmp_path / "inc.pbrt").write_text(
        'LightSource "infinite" "rgb L" [1 1 1]\n')
    main = tmp_path / "main.pbrt"
    main.write_text('Camera "perspective" "float fov" [45]\nWorldBegin\n'
                    'Include "inc.pbrt"\nImport "inc.pbrt"\n')
    scene = tparser.load_scene(str(main), device="cpu")
    assert len(scene.lights) == 2


def test_named_textures_and_material_reference():
    ps = tparser.PbrtParser(device="cpu")
    sc = ps.parse_string(TEXTURE_SCENE)
    assert set(ps.named_textures) == {"half", "chk", "sph"}
    refl = sc.primitives[0].material.reflectance
    assert isinstance(refl, ttex.MappedTexture)
    v = ttex.eval_texture(refl, torch.zeros((1, 2)))
    assert v.shape[-1] == 3 or v.dim() == 1


def test_texture_scale_mix_directionmix():
    ps = tparser.PbrtParser(device="cpu")
    ps.parse_string(TEXTURE_MIX_SCENE)
    uv = torch.zeros((2, 2))
    assert torch.allclose(ps.named_textures["b"].eval(uv), torch.tensor(0.5))
    assert torch.allclose(ps.named_textures["c"].eval(uv), torch.tensor(0.5))
    n = torch.tensor([[0, 0, 1.0], [1.0, 0, 0]])
    v = ttex.eval_texture(ps.named_textures["d"], uv, n=n)
    np.testing.assert_allclose(v.numpy(), [0.25, 0.5], atol=1e-6)


def test_unknown_texture_class_warns():
    ps = tparser.PbrtParser(device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ps.parse_string('WorldBegin\nTexture "p" "spectrum" "ptex" '
                        '"string filename" ["x.ptx"]\n')
    assert any("ptex" in str(r.message) for r in rec)
    assert "p" in ps.named_textures


def test_measured_material_raises(tmp_path):
    """A measured material whose .bsdf file is missing raises, as the
    reference's does (the port no longer refuses measured materials); one
    whose file exists is built from it."""
    text = 'WorldBegin\nMaterial "measured" "string filename" "{}"\n'
    missing = str(tmp_path / "x.bsdf")
    for ps in (tparser.PbrtParser(device="cpu"), jparser.PbrtParser()):
        with pytest.raises(FileNotFoundError):
            ps.parse_string(text.format(missing))
    from acceleratedvolrenderer_tpu_torch.models import materials, measured

    measured.write_tensor_file(missing, measured.tensors_of(
        measured.synthesize_ggx(res=8, n_theta=2)))
    ps = tparser.PbrtParser(device="cpu")
    ps.parse_string(text.format(missing) + 'Shape "sphere"\n')
    mat = ps.primitives[0].material
    assert isinstance(mat, materials.MeasuredMaterial)
    assert mat.filename == missing


def test_format_scene_matches_jax(tmp_path):
    for name in ("mini", "cli_mesh", "transform", "breadth"):
        f = tmp_path / f"{name}.pbrt"
        f.write_text(scene_text(name))
        text = tparser.format_scene(str(f))
        assert text == jparser.format_scene(str(f))
        f2 = tmp_path / f"{name}_formatted.pbrt"
        f2.write_text(text)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _scenes_equal(jparser.load_scene(str(f2)),
                          tparser.load_scene(str(f2), device="cpu"))


def test_load_scene_on_the_card_by_default(tmp_path, monkeypatch):
    """Without CUDA and without a device, load_scene and PbrtParser raise;
    with device="cpu" every tensor of the scene is on the CPU."""
    f = tmp_path / "g.pbrt"
    f.write_text(grid_scene(8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparser.load_scene(str(f))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tparser.PbrtParser()
    sc = tparser.load_scene(str(f), device="cpu")
    assert sc.medium.density.device.type == "cpu"
    assert sc.medium.majorant.device.type == "cpu"
    assert sc.camera.c2w.m.device.type == "cpu"
    assert sc.lights[0].direction.device.type == "cpu"
