"""The port's forward render against the JAX package's, end to end: the
32x24 cloud (spp 4, 32^3 grid, max_depth 8) through render_regen with the
bench knobs at a small lane count.

Tolerance: frame means to 1e-3 relative, and at least 99% of pixels to
rtol 1e-3 / atol 1e-5.  XLA:CPU and torch differ by ulps in exp, log1p and
erfinv, and one flipped `u < p` choice sends a single sample down another
path, so a few pixels may differ by Monte Carlo noise."""
import functools
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.parallel import render as jrender
from acceleratedvolrenderer_tpu.scene import presets as jpresets
from acceleratedvolrenderer_tpu_torch.parallel import render as trender
from acceleratedvolrenderer_tpu_torch.scene import convert
from acceleratedvolrenderer_tpu_torch.scene import presets as tpresets

from torch_port_util import arrays_from_jax_scene

torch.set_num_threads(2)

SMALL = dict(width=32, height=24, spp=4, max_depth=8, grid_res=32)
KNOBS = dict(n_lanes=256, k_substeps=8, stochastic_filter=True,
             accum_spp=True, retire_groups=4, work_stride="auto")


@pytest.fixture(scope="module")
def jax_scene():
    return jpresets.cloud(**SMALL)


def test_render_regen_matches_jax(jax_scene):
    ref, _ = jrender.render_regen(jax_scene, **KNOBS)
    scene = convert.scene_from_arrays(arrays_from_jax_scene(jax_scene), "cpu")
    img, stats = trender.render_regen(scene, device="cpu", record_alive=True,
                                      **KNOBS)
    assert img.shape == ref.shape == (24, 32, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert stats["iterations"] > 0 and 0 < stats["occupancy"] <= 1


def test_preset_cloud_matches_jax_scene(jax_scene):
    """presets.cloud of the port builds the same arrays as the JAX preset
    (what scene_from_arrays reads off it)."""
    ref = convert.scene_from_arrays(arrays_from_jax_scene(jax_scene), "cpu")
    sc = tpresets.cloud(**SMALL, device="cpu")
    assert torch.equal(sc.medium.density, ref.medium.density)
    assert torch.equal(sc.medium.build_majorant(), ref.medium.build_majorant())
    np.testing.assert_allclose(sc.medium.world_to_unit(),
                               ref.medium.world_to_unit(), rtol=1e-12)
    assert torch.equal(sc.camera.c2w.m, ref.camera.c2w.m)
    assert torch.equal(sc.lights[0].direction, ref.lights[0].direction)
    lam = torch.full((4,), 550.0)
    for a, b in ((sc.medium.sigma_s_spec, ref.medium.sigma_s_spec),
                 (sc.lights[0].spectrum, ref.lights[0].spectrum),
                 (sc.lights[1].spectrum, ref.lights[1].spectrum)):
        assert torch.equal(a(lam), b(lam))
    for f in ("max_depth", "spp", "seed", "max_march_steps", "scene_radius"):
        assert getattr(sc, f) == getattr(ref, f), f


@pytest.mark.parametrize("case", ["surfaces", "regen sigma override"])
def test_unported_options_raise(case):
    """Surfaces, which li refused before they were ported: a regen render
    of a medium scene with primitives (a glass sphere half in the cloud, a
    diffuse ground) matches the JAX regen frame, at the tolerances above;
    and sampling-side sigma overrides in regen mode, which li still refuses,
    as the reference does."""
    kw = dict(KNOBS, n_lanes=16, retire_groups=1)
    if case == "surfaces":
        from acceleratedvolrenderer_tpu.models import materials as jm
        from acceleratedvolrenderer_tpu.models import shapes as js
        from acceleratedvolrenderer_tpu.utils import spectrum as jsp

        from torch_surface_util import surface_arrays_from_jax_scene

        jsc = jpresets.cloud(16, 12, spp=2, max_depth=4, grid_res=8)
        jsc.primitives = [
            js.Sphere(center=np.array([100.0, 0.0, -40.0]), radius=50.0,
                      material=jm.DielectricMaterial(eta=1.5)),
            js.Quad(origin=np.array([-800.0, -100.0, -800.0]),
                    e1=np.array([0.0, 0.0, 1600.0]),
                    e2=np.array([1600.0, 60.0, 0.0]),
                    material=jm.DiffuseMaterial(
                        reflectance=jsp.constant_spectrum(0.4)))]
        ref, _ = jrender.render_regen(jsc, **kw)
        sc = convert.scene_from_arrays(surface_arrays_from_jax_scene(jsc),
                                       "cpu")
        img, _ = trender.render_regen(sc, device="cpu", **kw)
        assert np.isfinite(img).all() and img.mean() > 0
        assert abs(img.mean() - ref.mean()) / ref.mean() < 1e-3
        close = np.isclose(img, ref, rtol=1e-3, atol=1e-5).all(-1)
        assert close.mean() >= 0.99, close.mean()
        return
    sc = tpresets.cloud(8, 6, spp=1, max_depth=2, grid_res=8, device="cpu")
    run, density, majorant = trender.make_regen_renderer(sc, device="cpu",
                                                         **kw)
    override = torch.ones(4)
    with mock.patch.object(
            trender.dda, "MediumArrays",
            functools.partial(trender.dda.MediumArrays, sigma_a_s=override,
                              sigma_s_s=override)):
        with pytest.raises(ValueError, match="reference refuses"):
            run(density, majorant, torch.zeros(3 * (8 * 6 + 1)))


def test_import_leaves_jax_out(tmp_path):
    """Importing every module of the port, chip_smoke.py and
    scripts/measure_gather_designs_torch.py, and writing a film through the
    port's own EXR writer, loads neither jax nor any module of the JAX
    package."""
    root = Path(__file__).resolve().parents[1]
    pkg = root / "acceleratedvolrenderer_tpu_torch"
    mods = sorted(".".join(p.relative_to(root).with_suffix("").parts)
                  for p in pkg.rglob("*.py"))
    code = (f"import sys, importlib, numpy as np; sys.path[:0] = "
            f"[{str(root)!r}, {str(root / 'scripts')!r}]\n"
            f"for m in {mods + ['chip_smoke', 'measure_gather_designs_torch']!r}:"
            "\n    importlib.import_module(m)\n"
            "from acceleratedvolrenderer_tpu_torch.models import film as f\n"
            f"f.write_film({str(tmp_path / 'a.exr')!r}, "
            "np.ones((2, 3, 3), np.float32))\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'acceleratedvolrenderer_tpu' or m.startswith("
            "'acceleratedvolrenderer_tpu.')]\n"
            "print(len(sys.modules), bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=tmp_path)
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", out.stdout + out.stderr
    assert len(mods) > 20 and int(n) > len(mods)
    assert (tmp_path / "a.exr").stat().st_size > 0
