"""The port's sharded renders (parallel/mesh.py) at world sizes 2 and 4
against the JAX package's (acceleratedvolrenderer_tpu/parallel/mesh.py) on
as many virtual CPU devices and against the port's single-device render:
every case of tests/test_multichip.py.

The port's ranks are processes (tests/torch_shard_worker.py, started with
sys.executable; they import only the port) in a gloo group on the CPU, one
thread each; every world size runs all its cases in one launch.

Tolerances, the reference's: regen films 3e-5 absolute (the same estimates
summed in another order over the ranks), the wave renderer rtol / atol
1e-5, the analytic centre 0.03 from exp(-1); the same seed twice gives the
same image bit for bit.  Against the JAX package: the same bounds, except
on the scene with a surface, where 98% of the pixels must be within 3e-5:
float32 ulps flip a bounce off the sphere on 3 of its 256 pixels (0.988
close), as they do between the JAX package's own jitted and unjitted li
(0.095 apart there).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import lights as jlm
from acceleratedvolrenderer_tpu.models import materials as jmats
from acceleratedvolrenderer_tpu.models import shapes as jshp
from acceleratedvolrenderer_tpu.models.cameras import PerspectiveCamera
from acceleratedvolrenderer_tpu.models.film import BoxFilter
from acceleratedvolrenderer_tpu.models.media import homogeneous_box
from acceleratedvolrenderer_tpu.parallel import mesh as jmesh
from acceleratedvolrenderer_tpu.scene import Scene
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu.utils import vecmath as jvm
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert

import torch_shard_worker
from torch_surface_util import surface_arrays_from_jax_scene

torch.set_num_threads(2)

WORLDS = (2, 4)
REGEN_TOL = 3e-5
SURFACE_SHARE = 0.98


def lum(img):
    return img @ np.array([0.2126, 0.7152, 0.0722])


def make_scene(spp=32):
    """tests/test_multichip.py's 8x8 absorbing box under a unit sky."""
    flat = jsp.constant_spectrum
    med = homogeneous_box(flat(1.0), flat(0.0), lo=(0, 0, 0), hi=(1, 1, 1))
    cam = PerspectiveCamera(
        c2w=jvm.look_at((0.5, 0.5, -3.0), (0.5, 0.5, 0.5), (0, 1, 0)),
        fov_deg=30.0, width=8, height=8)
    return Scene(camera=cam, medium=med,
                 lights=[jlm.UniformInfiniteLight(spectrum=flat(1.0))],
                 max_depth=5, filter=BoxFilter(), spp=spp)


def sphere_with_surface():
    """test_sharded_regen_heterogeneous_with_surfaces' scene."""
    sc = jpresets.sphere_medium(res=16, height=16, spp=4, max_depth=4)
    sphere = jshp.Sphere(
        center=np.array([0.5, -0.35, 0.5], np.float32), radius=0.3,
        material=jmats.DiffuseMaterial(
            reflectance=jsp.constant_spectrum(0.6)))
    return dataclasses.replace(sc, primitives=[sphere])


JAX_SCENES = {
    "box128": lambda: make_scene(spp=128),
    "box4": lambda: make_scene(spp=4),
    "fog": lambda: jpresets.fog_box(res=16, spp=4),
    "sphere": sphere_with_surface,
}
ACCUM = dict(accum_spp=True, retire_groups=2)
# (key, task, scene, kwargs) of each world's launch
TASKS = [
    ("analytic", "wave", "box128", {}),
    ("wave_a", "wave", "box4", {}),
    ("wave_b", "wave", "box4", {}),
    ("fog", "regen", "fog", dict(n_lanes=64)),
    ("sphere", "regen", "sphere", dict(n_lanes=64)),
    ("accum", "regen", "fog", dict(n_lanes=64, **ACCUM)),
]


@pytest.fixture(scope="module")
def jax_scenes():
    return {k: make() for k, make in JAX_SCENES.items()}


@pytest.fixture(scope="module")
def port_scenes(jax_scenes):
    return {k: convert.scene_from_arrays(surface_arrays_from_jax_scene(js),
                                         "cpu")
            for k, js in jax_scenes.items()}


@pytest.fixture(scope="module")
def ranks(jax_scenes, tmp_path_factory):
    """world -> each rank's results, one launch per world size."""
    arrays = {k: surface_arrays_from_jax_scene(js)
              for k, js in jax_scenes.items()}
    # every world size starts at once; the tests wait for their own
    launches = {w: torch_shard_worker.Launch(
        arrays, TASKS, w, tmp_path_factory.mktemp(f"world{w}"))
        for w in WORLDS}
    yield lambda world: launches[world].results()
    for launch in launches.values():
        launch.results()


@pytest.fixture(scope="module")
def single(port_scenes):
    """The port's single-device frames the sharded ones must equal."""
    out = {}
    out["wave"], _ = trender.render(port_scenes["box4"], device="cpu")
    out["fog"], _ = trender.render_regen(port_scenes["fog"], n_lanes=256,
                                         device="cpu")
    out["sphere"], _ = trender.render_regen(port_scenes["sphere"],
                                            n_lanes=256, device="cpu")
    out["accum"], _ = trender.render_regen(port_scenes["fog"], n_lanes=128,
                                           device="cpu", **ACCUM)
    return out


def _jax_mesh(world):
    return jmesh.make_mesh(jax.devices()[:world])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_analytic(ranks, world):
    res = ranks(world)[0]["analytic"]
    assert res["n_devices"] == world
    center = lum(res["img"])[3:5, 3:5].mean()
    assert abs(center - np.exp(-1.0)) < 0.03, center


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_deterministic(ranks, world):
    """The same seed twice, and every rank's copy of the frame, bit for
    bit."""
    results = ranks(world)
    np.testing.assert_array_equal(results[0]["wave_a"]["img"],
                                  results[0]["wave_b"]["img"])
    for r in results[1:]:
        np.testing.assert_array_equal(r["wave_a"]["img"],
                                      results[0]["wave_a"]["img"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_unsharded(ranks, single, jax_scenes, world):
    img = ranks(world)[0]["wave_a"]["img"]
    np.testing.assert_allclose(img, single["wave"], rtol=1e-5, atol=1e-5)
    ref, _ = jmesh.render_sharded(jax_scenes["box4"], _jax_mesh(world))
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key, knobs", [("fog", {}), ("sphere", {}),
                                        ("accum", ACCUM)],
                         ids=["homogeneous", "heterogeneous_with_surfaces",
                              "accum_spp"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_regen_matches_single(ranks, single, jax_scenes, world, key,
                                      knobs):
    """test_sharded_regen_matches_single,
    test_sharded_regen_heterogeneous_with_surfaces and
    test_sharded_regen_accum_spp_matches_single: the sharded regen frame at
    64 lanes per rank equals the port's single-device one and the JAX
    package's sharded one."""
    res = ranks(world)[0][key]
    assert res["n_devices"] == world
    img = res["img"]
    assert np.isfinite(img).all()
    assert np.abs(img - single[key]).max() < REGEN_TOL
    scene = jax_scenes["fog" if key == "accum" else key]
    ref, st = jmesh.render_sharded_regen(scene, _jax_mesh(world), n_lanes=64,
                                         **knobs)
    assert st["n_devices"] == world
    close = np.abs(img - ref).max(-1) < REGEN_TOL
    if key == "sphere":
        # ulps flip a surface bounce on 3 of the 256 pixels: the JAX
        # package's own li differs as much between jit and no jit there
        assert close.mean() >= SURFACE_SHARE, close.mean()
    else:
        assert close.all(), np.abs(img - ref).max()


def test_world_of_one_equals_single_device(port_scenes):
    """Without a process group the sharded entries are the single-device
    ones: the same films, torch.equal (the work offset defaults to 0)."""
    from acceleratedvolrenderer_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    for key, knobs in (("fog", {}), ("accum", ACCUM)):
        scene = port_scenes["fog"]
        run, density, majorant = tmesh.make_sharded_regen_renderer(
            scene, mesh, n_lanes=64, **knobs)
        film, res, secs = run(density, majorant)
        ref_run, d, m = trender.make_regen_renderer(scene, device="cpu",
                                                    n_lanes=64, **knobs)
        ref = ref_run(d, m, torch.zeros_like(film)).film_rgb
        assert secs == 0.0 and torch.equal(film, ref), key
    img, st = tmesh.render_sharded(port_scenes["box4"], mesh)
    ref, _ = trender.render(port_scenes["box4"], device="cpu")
    assert st["n_devices"] == 1 and np.array_equal(img, ref)
