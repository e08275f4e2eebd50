"""The port's staged tracking (ops/dda.py::delta_track,
ops/transmittance.py::ratio_track) and the staged integrators that rest on
it (models/integrators/volpath.py, simple_volpath.py) against the JAX
package's, plus the statistical gates of tests/test_march.py and the twin
gates of tests/test_twin.py run over the port.

Inputs are made with numpy from a seed; both packages get the same arrays
and the same PCG streams.  Tolerances:
- delta_track: events equal for >= 99% of rays; where they agree,
  t_event / beta / r_u / r_l / L_emit to rtol 1e-5 / atol 1e-6 (exp and
  log1p differ by ulps between XLA:CPU and torch, and a flipped comparison
  reroutes a ray);
- ratio_track: T_ray to rtol 1e-5 / atol 1e-6 on >= 99% of rays, r_l / r_u
  the same where T_ray is nonzero (a ray whose transmittance reached 0
  carries no estimate; where density equals the majorant, sig_n cancels to
  a few ulps, which XLA and torch round differently, so such a ray may be
  retired one collision apart);
- the staged integrators against the JAX ones: >= 99% of rays to rtol 1e-3
  / atol 1e-5 and means to 1e-3 relative;
- the port's staged li against its fused li: test_twin.py's rtol 2e-4 /
  atol 2e-5; the march gates at test_march.py's own tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import lights as jlights
from acceleratedvolrenderer_tpu.models.integrators import (
    simple_volpath as jsimple)
from acceleratedvolrenderer_tpu.models.integrators import volpath as jstaged
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu.ops import grid as jgrid
from acceleratedvolrenderer_tpu.ops import transmittance as jtr
from acceleratedvolrenderer_tpu.utils import spectrum as jsp
from acceleratedvolrenderer_tpu_torch.models import lights as tlights
from acceleratedvolrenderer_tpu_torch.models.cameras import PerspectiveCamera
from acceleratedvolrenderer_tpu_torch.models.integrators import (
    simple_volpath as tsimple)
from acceleratedvolrenderer_tpu_torch.models.integrators import volpath as tstaged
from acceleratedvolrenderer_tpu_torch.models.integrators import (
    volpath_fused as tfused)
from acceleratedvolrenderer_tpu_torch.models.media import (MediumSpec,
                                                           homogeneous_box)
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda
from acceleratedvolrenderer_tpu_torch.ops import transmittance as ttr
from acceleratedvolrenderer_tpu_torch.utils import spectrum as tsp
from acceleratedvolrenderer_tpu_torch.utils.vecmath import look_at

torch.set_num_threads(2)

L = 4
TOL = dict(rtol=1e-5, atol=1e-6)


def t(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def sphere_grid(n=32, radius=0.45):
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r = np.linalg.norm(np.stack([xs, ys, zs], -1) - 0.5, axis=-1)
    return (r < radius).astype(np.float32)


def medium(kind, emission, n_rays, seed=0):
    """(JAX MediumArrays, port MediumArrays, maj_res, homogeneous) with
    per-ray spectra: kind 'homogeneous' (a unit cube), 'grid' (a random
    12^3 density over a 4^3 majorant) or 'sphere' (the 32^3 test sphere of
    tests/test_graph.py over an 8^3 majorant)."""
    rs = np.random.default_rng(seed)
    if kind == "homogeneous":
        dens = np.ones((1, 1, 1), np.float32)
        maj_res = (1, 1, 1)
    elif kind == "grid":
        dens = (rs.random((12, 12, 12)) * 2.0).astype(np.float32)
        maj_res = (4, 4, 4)
    else:
        dens = sphere_grid()
        maj_res = (8, 8, 8)
    maj = jgrid.build_majorant_grid(dens, maj_res)
    sa = (rs.random((n_rays, L)) * 0.5 + 0.2).astype(np.float32)
    ss = (rs.random((n_rays, L)) * 2.0 + 0.5).astype(np.float32)
    Le = (rs.random((n_rays, L)) if emission
          else np.zeros((n_rays, L))).astype(np.float32)
    w2m = np.eye(4, dtype=np.float32)
    j = jdda.MediumArrays(
        density=jnp.asarray(dens), majorant=jnp.asarray(maj),
        w2m=jnp.asarray(w2m), g=jnp.float32(0.3), sigma_a=jnp.asarray(sa),
        sigma_s=jnp.asarray(ss), Le=jnp.asarray(Le))
    p = tdda.MediumArrays(
        density=t(dens), majorant=t(maj), w2m=t(w2m),
        g=torch.tensor(0.3), sigma_a=t(sa), sigma_s=t(ss), Le=t(Le))
    return j, p, maj_res, kind == "homogeneous"


def rays(n, seed=1):
    """Rays from in front of the unit cube towards it (some miss), 90% of
    them active, and their streams."""
    rs = np.random.default_rng(seed)
    o = (rs.random((n, 3)) * 0.4 + np.array([0.3, 0.3, -1.0])
         ).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d[:, 2] = np.abs(d[:, 2]) * 4.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    active = rs.random(n) < 0.9
    rng = np.asarray(jdda.seed_stream(jnp.arange(n), jnp.zeros(n, jnp.uint32),
                                      salt=seed))
    return o, d, active, rng


N_PARITY = 2048


@pytest.mark.parametrize("kind,emission", [
    ("homogeneous", False), ("homogeneous", True), ("grid", False),
    ("grid", True), ("sphere", True)])
def test_delta_track_matches_jax(kind, emission):
    jm, tm, maj_res, hom = medium(kind, emission, N_PARITY)
    o, d, active, rng = rays(N_PARITY)
    rs = np.random.default_rng(2)
    beta = (rs.random((N_PARITY, L)) + 0.5).astype(np.float32)
    r_u = (rs.random((N_PARITY, L)) + 0.5).astype(np.float32)
    r_l = (rs.random((N_PARITY, L)) + 0.5).astype(np.float32)
    ref = jdda.delta_track(
        jm, jnp.asarray(o), jnp.asarray(d), jnp.full((N_PARITY,), jnp.inf),
        jnp.asarray(beta), jnp.asarray(r_u), jnp.asarray(r_l),
        jnp.asarray(rng), jnp.asarray(active), maj_res,
        collect_emission=emission, homogeneous=hom)
    before = tdda.delta_track_iterations
    got = tdda.delta_track(
        tm, t(o), t(d), torch.full((N_PARITY,), torch.inf), t(beta), t(r_u),
        t(r_l), t(rng), t(active), maj_res, collect_emission=emission,
        homogeneous=hom)
    assert tdda.delta_track_iterations > before
    ev = got.event.numpy() == np.asarray(ref.event)
    assert ev.mean() >= 0.99, ev.mean()
    counts = np.bincount(got.event.numpy(), minlength=4)
    assert counts[tdda.EVT_MARCHING] == 0
    assert counts[tdda.EVT_SCATTER] > 0 and counts[tdda.EVT_ESCAPED] > 0
    for k in ("t_event", "beta", "r_u", "r_l", "L_emit"):
        np.testing.assert_allclose(getattr(got, k).numpy()[ev],
                                   np.asarray(getattr(ref, k))[ev],
                                   err_msg=k, **TOL)
    if emission:
        assert float(got.L_emit.abs().max()) > 0
    same_rng = got.rng.numpy() == np.asarray(ref.rng).astype(np.int64)
    assert same_rng.mean() >= 0.99


@pytest.mark.parametrize("kind", ["homogeneous", "grid", "sphere"])
def test_ratio_track_matches_jax(kind):
    jm, tm, maj_res, hom = medium(kind, False, N_PARITY)
    o, d, active, rng = rays(N_PARITY)
    tmax = np.full((N_PARITY,), 2.5, np.float32)
    ref = jtr.ratio_track(jm, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(tmax), jnp.asarray(rng),
                          jnp.asarray(active), maj_res, homogeneous=hom)
    got = ttr.ratio_track(tm, t(o), t(d), t(tmax), t(rng), t(active),
                          maj_res, homogeneous=hom)
    T_ref, T_got = np.asarray(ref.T_ray), got.T_ray.numpy()
    assert np.isclose(T_got, T_ref, **TOL).all(-1).mean() >= 0.99
    live = (T_ref != 0).any(-1) | (T_got != 0).any(-1)
    assert 0.3 < live.mean() < 1.0, live.mean()
    for k in ("r_l", "r_u"):
        a, b = getattr(got, k).numpy()[live], np.asarray(getattr(ref, k))[live]
        assert np.isclose(a, b, **TOL).all(-1).mean() >= 0.99, k
    assert (T_got[~active] == 1.0).all()


# ---------------------------------------------------------------------------
# tests/test_march.py's statistical gates (l. 53-156), over the port
# ---------------------------------------------------------------------------

def unit_cube(sigma_a, sigma_s, density=None, maj_res=(1, 1, 1)):
    dens = np.ones((1, 1, 1), np.float32) if density is None else density
    maj = jgrid.build_majorant_grid(dens, maj_res)
    sa = np.full((1, L), sigma_a, np.float32) if np.isscalar(sigma_a) \
        else np.asarray(sigma_a, np.float32)
    return tdda.MediumArrays(
        density=t(dens), majorant=t(maj), w2m=torch.eye(4),
        g=torch.tensor(0.0), sigma_a=t(sa),
        sigma_s=torch.full((1, L), float(sigma_s)),
        Le=torch.zeros((1, L)))


def x_rays(n):
    return (torch.tensor([[-0.5, 0.5, 0.5]]).expand(n, 3),
            torch.tensor([[1.0, 0.0, 0.0]]).expand(n, 3))


def streams(n, salt):
    return tdda.seed_stream(torch.arange(n), torch.zeros(n, dtype=torch.int64),
                            salt=salt)


def march(med, n=100_000, t_max=10.0, seed=0, maj_res=(1, 1, 1),
          homogeneous=False):
    o, d = x_rays(n)
    ones = torch.ones((n, L))
    return tdda.delta_track(med, o, d, torch.full((n,), t_max), ones, ones,
                            ones, streams(n, seed),
                            torch.ones(n, dtype=torch.bool), maj_res,
                            homogeneous=homogeneous)


def frac(res, evt):
    return float((res.event == evt).double().mean())


def gate_pure_absorption():
    res = march(unit_cube(1.0, 0.0), homogeneous=True)
    assert abs(frac(res, tdda.EVT_ESCAPED) - np.exp(-1.0)) < 5e-3
    assert frac(res, tdda.EVT_SCATTER) == 0.0


def gate_pure_scattering():
    res = march(unit_cube(0.0, 2.0), homogeneous=True)
    assert abs(frac(res, tdda.EVT_SCATTER) - (1.0 - np.exp(-2.0))) < 5e-3
    assert frac(res, tdda.EVT_ABSORB) == 0.0


def gate_mixed_events():
    sa, ss = 0.5, 1.5
    res = march(unit_cube(sa, ss), homogeneous=True)
    p_int = 1.0 - np.exp(-(sa + ss))
    assert abs(frac(res, tdda.EVT_ABSORB) - p_int * sa / (sa + ss)) < 5e-3
    assert abs(frac(res, tdda.EVT_SCATTER) - p_int * ss / (sa + ss)) < 5e-3


def gate_scatter_distance():
    res = march(unit_cube(0.0, 3.0), homogeneous=True)
    sc = (res.event == tdda.EVT_SCATTER).numpy()
    t_in = res.t_event.numpy()[sc] - 0.5
    lam = 3.0
    expected = 1.0 / lam - np.exp(-lam) / (1.0 - np.exp(-lam))
    assert abs(t_in.mean() - expected) < 5e-3


def gate_heterogeneous_escape():
    dens = np.ones((1, 1, 2), np.float32)
    dens[0, 0, 1] = 3.0
    res = march(unit_cube(1.0, 0.0, dens, (2, 1, 1)), maj_res=(2, 1, 1))
    tau = 0.25 * 0.75 + 0.5 * 2.0 + 0.25 * 2.25
    assert abs(frac(res, tdda.EVT_ESCAPED) - np.exp(-tau)) < 5e-3


def gate_spectral_residual():
    med = unit_cube([[1.0, 2.0, 0.5, 1.0]], 0.0)
    res = march(med, n=20_000, homogeneous=True)
    beta = res.beta.numpy()[(res.event == tdda.EVT_ESCAPED).numpy()]
    np.testing.assert_allclose(beta[:, 0], 1.0, atol=1e-5)
    assert np.all(beta[:, 1] <= 1.0 + 1e-5)
    assert np.all(beta[:, 2] >= 1.0 - 1e-5)


def ratio_estimate(med, n, salt, maj_res, homogeneous):
    o, d = x_rays(n)
    res = ttr.ratio_track(med, o, d, torch.full((n,), 10.0), streams(n, salt),
                          torch.ones(n, dtype=torch.bool), maj_res,
                          homogeneous=homogeneous)
    return float((res.T_ray[:, 0] / torch.mean(res.r_l, -1)).double().mean())


def gate_ratio_homogeneous():
    est = ratio_estimate(unit_cube(0.7, 0.8), 200_000, 7, (1, 1, 1), True)
    assert abs(est - np.exp(-1.5)) < 5e-3, est


def gate_ratio_heterogeneous():
    dens = np.zeros((1, 1, 4), np.float32)
    dens[0, 0, 1] = 2.0
    dens[0, 0, 2] = 1.0
    est = ratio_estimate(unit_cube(1.0, 0.0, dens, (4, 1, 1)), 300_000, 9,
                         (4, 1, 1), False)
    xs = np.linspace(0, 1, 20001)
    prof = np.interp(xs, [0, 1 / 8, 3 / 8, 5 / 8, 7 / 8, 1.0],
                     [0, 0, 2.0, 1.0, 0, 0])
    tau = np.trapezoid(prof, xs)
    assert abs(est - np.exp(-tau)) < 1e-2, (est, np.exp(-tau))


def gate_no_medium_hit():
    n = 16
    o = torch.tensor([[-0.5, 5.0, 0.5]]).expand(n, 3)
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(n, 3)
    ones = torch.ones((n, L))
    res = tdda.delta_track(unit_cube(1.0, 1.0), o, d, torch.full((n,), 10.0),
                           ones, ones, ones, streams(n, 0),
                           torch.ones(n, dtype=torch.bool), (1, 1, 1))
    assert (res.event == tdda.EVT_ESCAPED).all()
    np.testing.assert_allclose(res.beta.numpy(), 1.0)


GATES = [gate_pure_absorption, gate_pure_scattering, gate_mixed_events,
         gate_scatter_distance, gate_heterogeneous_escape,
         gate_spectral_residual, gate_ratio_homogeneous,
         gate_ratio_heterogeneous, gate_no_medium_hit]


@pytest.mark.parametrize("gate", GATES, ids=lambda g: g.__name__[5:])
def test_march_gates(gate):
    gate()


# ---------------------------------------------------------------------------
# the staged integrators: tests/test_twin.py's gates, and against the JAX ones
# ---------------------------------------------------------------------------

def twin_rays(res=8, eye=(0.5, 0.5, -2.0)):
    """tests/test_twin.py's rays: pixel centres of a res x res camera and
    streams 2654435761 * i + 12345, advanced once for the wavelengths."""
    cam = PerspectiveCamera(c2w=look_at(eye, (0.5, 0.5, 0.5), (0, 1, 0),
                                        "cpu"),
                            fov_deg=30.0, width=res, height=res)
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    pix = torch.as_tensor(np.stack([xs.reshape(-1), ys.reshape(-1)], -1))
    n = res * res
    o, d = cam.generate_rays(pix, torch.full((n, 2), 0.5))
    rng = (torch.arange(n, dtype=torch.int64) * 2654435761 + 12345) \
        & 0xFFFFFFFF
    rng, ul = tdda.pcg_uniform(rng)
    return o, d, tsp.sample_wavelengths_visible(ul).lam, rng


def flat(c):
    return tsp.constant_spectrum(c)


def fog_box():
    return (homogeneous_box(flat(0.3), flat(0.8), lo=(0, 0, 0),
                            hi=(1, 1, 1), g=0.4, Le_spec=flat(0.2)),
            [tlights.UniformInfiniteLight(spectrum=flat(1.0))])


def density_grid():
    dens = np.random.RandomState(7).rand(12, 12, 12).astype(np.float32) * 2.0
    direction = torch.tensor([0.3, -1.0, 0.2], dtype=torch.float32)
    return (MediumSpec(sigma_a_spec=flat(0.4), sigma_s_spec=flat(1.2),
                       density=torch.as_tensor(dens), g=-0.2),
            [tlights.DistantLight(direction=direction, spectrum=flat(3.0))])


TWINS = {"fog_box": (fog_box, 0.1), "density_grid": (density_grid, 1e-3)}


def jax_twin(name):
    """The same scene as the JAX package's test_twin.py builds it."""
    jflat = jsp.constant_spectrum
    from acceleratedvolrenderer_tpu.models.media import MediumSpec as JSpec
    from acceleratedvolrenderer_tpu.models.media import homogeneous_box as jbox
    if name == "fog_box":
        return (jbox(jflat(0.3), jflat(0.8), lo=(0, 0, 0), hi=(1, 1, 1),
                     g=0.4, Le_spec=jflat(0.2)),
                [jlights.UniformInfiniteLight(spectrum=jflat(1.0))])
    dens = np.random.RandomState(7).rand(12, 12, 12).astype(np.float32) * 2.0
    return (JSpec(sigma_a_spec=jflat(0.4), sigma_s_spec=jflat(1.2),
                  density=dens, g=-0.2),
            [jlights.DistantLight(direction=(0.3, -1.0, 0.2),
                                  spectrum=jflat(3.0))])


def jax_li(module, name, o, d, lam, rng, max_depth):
    spec, lights = jax_twin(name)
    med = spec.build_arrays(jnp.asarray(lam.numpy()))
    return np.asarray(module.li(
        med, lights, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(lam.numpy()), jnp.asarray(rng.numpy().astype(np.uint32)),
        maj_res=spec.maj_res(), homogeneous=spec.homogeneous,
        max_depth=max_depth).L)


def assert_rays_close(got, ref):
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) / ref.mean() < 1e-3
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-5).all(-1)
    assert close.mean() >= 0.99, close.mean()


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_staged_matches_fused_and_jax(name):
    """test_twin.py's fog-box and density-grid gates over the port (the
    staged li against the fused li at rtol 2e-4 / atol 2e-5), and the
    port's staged li against the JAX package's."""
    make, min_mean = TWINS[name]
    spec, lights = make()
    o, d, lam, rng = twin_rays()
    med = spec.build_arrays(lam)
    kw = dict(maj_res=spec.maj_res(), homogeneous=spec.homogeneous,
              max_depth=6)
    staged = tstaged.li(med, lights, o, d, lam, rng, **kw).L.numpy()
    fused = tfused.li(med, lights, o, d, lam, rng, **kw).L.numpy()
    assert np.isfinite(staged).all() and np.isfinite(fused).all()
    assert staged.mean() > min_mean
    np.testing.assert_allclose(staged, fused, rtol=2e-4, atol=2e-5)
    assert_rays_close(staged, jax_li(jstaged, name, o, d, lam, rng, 6))


def test_twin_rgb_mode_statistical():
    """test_twin.py's RGB gate over the port: a grey RGB grid is the scalar
    grid with constant spectra, so the fused li's means agree to 5%."""
    rs = np.random.RandomState(3)
    dens = rs.rand(8, 8, 8).astype(np.float32) + 0.2
    sa_c, ss_c = 0.3, 1.0
    grey = lambda c: torch.as_tensor(np.repeat(dens[..., None] * c, 3, -1))
    specs = (MediumSpec(sigma_a_spec=flat(sa_c), sigma_s_spec=flat(ss_c),
                        density=torch.as_tensor(dens), g=0.0),
             MediumSpec(sigma_a_spec=flat(sa_c), sigma_s_spec=flat(ss_c),
                        g=0.0, sigma_a_rgb=grey(sa_c),
                        sigma_s_rgb=grey(ss_c)))
    lights = [tlights.UniformInfiniteLight(spectrum=flat(1.0))]
    o, d, _, _ = twin_rays(8)
    means = []
    for spec in specs:
        tot = 0.0
        for rep in range(24):
            rng = (torch.arange(64, dtype=torch.int64) * 2654435761
                   + 1000 + rep) & 0xFFFFFFFF
            rng, ul = tdda.pcg_uniform(rng)
            lam = tsp.sample_wavelengths_visible(ul).lam
            r = tfused.li(spec.build_arrays(lam), lights, o, d, lam, rng,
                          maj_res=spec.maj_res(), homogeneous=False,
                          max_depth=8, rgb_mode=spec.rgb)
            tot += float(r.L.mean())
        means.append(tot / 24)
    assert abs(means[0] - means[1]) / means[0] < 0.05, means


def test_simple_volpath_matches_jax():
    """The teaching integrator on the fog box, against the JAX one."""
    spec, lights = fog_box()
    o, d, lam, rng = twin_rays()
    got = tsimple.li(spec.build_arrays(lam), lights, o, d, lam, rng,
                     maj_res=spec.maj_res(), homogeneous=True,
                     max_depth=6).L.numpy()
    assert got.mean() > 0.1
    assert_rays_close(got, jax_li(jsimple, "fog_box", o, d, lam, rng, 6))
