"""The port's BxDFs (models/bxdfs.py) against the JAX package's, on the same
directions, spectra and uniforms made from a numpy seed.

Every lobe's f, pdf and sample is compared elementwise: closed forms to
rtol 1e-4 / atol 1e-6 (float32 sqrt, division and the complex Fresnel of
the conductor differ by ulps between XLA:CPU and torch; a microfacet D near
grazing amplifies them), integer and boolean outputs exactly but for at
most 0.5% of lanes, where a comparison on the edge of a branch (TIR, the
hemisphere test, the lobe choice u < F) flips on an ulp.  The layered
walks (layered_sample, layered_f) draw from the same PCG streams on both
sides; their estimates are compared the same way.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acceleratedvolrenderer_tpu.models import bxdfs as jb
from acceleratedvolrenderer_tpu.ops import dda as jdda
from acceleratedvolrenderer_tpu_torch.models import bxdfs as tb
from acceleratedvolrenderer_tpu_torch.ops import dda as tdda

torch.set_num_threads(2)

N, L = 4096, 4
RTOL, ATOL = 1e-4, 1e-6


def _dirs(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    wo = _dirs(rng, N)
    wi = _dirs(rng, N)
    # half the lanes in the same hemisphere as wo
    wi[: N // 2, 2] = np.abs(wi[: N // 2, 2]) * np.sign(wo[: N // 2, 2])
    return dict(
        wo=wo, wi=wi,
        u_lobe=rng.random(N, dtype=np.float32),
        u2=rng.random((N, 2), dtype=np.float32),
        albedo=rng.uniform(0.05, 0.95, (N, L)).astype(np.float32),
        trans=rng.uniform(0.05, 0.95, (N, L)).astype(np.float32),
        eta_c=rng.uniform(0.1, 2.5, (N, L)).astype(np.float32),
        k_c=rng.uniform(0.5, 5.0, (N, L)).astype(np.float32),
        eta=rng.uniform(1.1, 2.0, N).astype(np.float32),
        # rough lanes, and every eighth lane smooth (a delta lobe)
        alpha=np.where(np.arange(N) % 8 == 0, 0.0,
                       rng.uniform(0.05, 0.8, N)).astype(np.float32),
    )


def _pair(x):
    return jnp.asarray(x), torch.as_tensor(x)


def _close(got, want, rtol=RTOL, atol=ATOL, flips=0.005):
    """Elementwise closeness; a lane may differ on at most `flips` of the
    lanes (a branch flipped on an ulp)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == bool or want.dtype.kind in "iu":
        ok = got == want
    else:
        ok = np.isclose(got, want, rtol=rtol, atol=atol, equal_nan=True)
    lanes = ok.reshape(ok.shape[0], -1).all(-1) if ok.ndim else ok
    assert lanes.mean() >= 1.0 - flips, (lanes.mean(), got[~lanes][:3],
                                         want[~lanes][:3])


def _close_sample(got, want, flips=0.005):
    for g, w in zip(got, want):
        _close(g, w, flips=flips)


def test_fresnel_and_refract(inputs):
    cos = np.linspace(-1.0, 1.0, N, dtype=np.float32)
    for eta in (1.5, inputs["eta"]):
        (jc, tc), (je, te) = _pair(cos), _pair(np.asarray(eta, np.float32))
        _close(tb.fresnel_dielectric(tc, te), jb.fresnel_dielectric(jc, je))
    (jc, tc) = _pair(np.abs(cos)[:, None] * np.ones((1, L), np.float32))
    (jeta, teta), (jk, tk) = _pair(inputs["eta_c"]), _pair(inputs["k_c"])
    _close(tb.fresnel_conductor(tc, teta, tk),
           jb.fresnel_conductor(jc, jeta, jk))
    (jw, tw), (jn, tn) = _pair(inputs["wo"]), _pair(_dirs(
        np.random.default_rng(3), N))
    (je, te) = _pair(inputs["eta"])
    for g, w in zip(tb.refract(tw, tn, te), jb.refract(jw, jn, je)):
        _close(g, w)
    _close(tb.reflect(tw, tn), jb.reflect(jw, jn))


def test_trowbridge_reitz(inputs):
    (jw, tw), (jm, tm) = _pair(inputs["wo"]), _pair(inputs["wi"])
    (ja, ta) = _pair(np.maximum(inputs["alpha"], 0.05))
    (ju, tu) = _pair(inputs["u2"])
    _close(tb.tr_lambda(tw, ta), jb.tr_lambda(jw, ja))
    _close(tb.tr_g(tw, tm, ta), jb.tr_g(jw, jm, ja))
    _close(tb.tr_d_visible(tw, tm, ta), jb.tr_d_visible(jw, jm, ja))
    wh = np.abs(inputs["wo"]) * [1, 1, 1]
    (jh, th) = _pair(wh.astype(np.float32))
    _close(tb.tr_sample_wm(th, tu, ta), jb.tr_sample_wm(jh, ju, ja))


def test_diffuse_and_transmission(inputs):
    (jo, to), (ji, ti) = _pair(inputs["wo"]), _pair(inputs["wi"])
    (ja, ta), (jt, tt) = _pair(inputs["albedo"]), _pair(inputs["trans"])
    (jl, tl), (ju, tu) = _pair(inputs["u_lobe"]), _pair(inputs["u2"])
    _close(tb.diffuse_f(to, ti, ta), jb.diffuse_f(jo, ji, ja))
    _close(tb.diffuse_pdf(to, ti), jb.diffuse_pdf(jo, ji))
    _close_sample(tb.diffuse_sample(to, tu, ta), jb.diffuse_sample(jo, ju, ja))
    _close(tb.diffuse_transmission_f(to, ti, ta, tt),
           jb.diffuse_transmission_f(jo, ji, ja, jt))
    pr, pt = inputs["albedo"].max(-1), inputs["trans"].max(-1)
    _close(tb.diffuse_transmission_pdf(to, ti, *map(torch.as_tensor, (pr, pt))),
           jb.diffuse_transmission_pdf(jo, ji, *map(jnp.asarray, (pr, pt))))
    _close_sample(tb.diffuse_transmission_sample(to, tl, tu, ta, tt),
                  jb.diffuse_transmission_sample(jo, jl, ju, ja, jt))


def test_conductor(inputs):
    (jo, to), (ji, ti) = _pair(inputs["wo"]), _pair(inputs["wi"])
    (je, te), (jk, tk) = _pair(inputs["eta_c"]), _pair(inputs["k_c"])
    (ja, ta), (ju, tu) = _pair(inputs["alpha"]), _pair(inputs["u2"])
    _close(tb.conductor_f(to, ti, te, tk, ta), jb.conductor_f(jo, ji, je, jk, ja))
    _close(tb.conductor_pdf(to, ti, ta), jb.conductor_pdf(jo, ji, ja))
    _close_sample(tb.conductor_sample(to, tu, te, tk, ta),
                  jb.conductor_sample(jo, ju, je, jk, ja))


def test_dielectric_and_thin(inputs):
    (jo, to), (ji, ti) = _pair(inputs["wo"]), _pair(inputs["wi"])
    (je, te), (ja, ta) = _pair(inputs["eta"]), _pair(inputs["alpha"])
    (jl, tl), (ju, tu) = _pair(inputs["u_lobe"]), _pair(inputs["u2"])
    _close(tb.dielectric_f(to, ti, te, ta), jb.dielectric_f(jo, ji, je, ja))
    _close(tb.dielectric_pdf(to, ti, te, ta), jb.dielectric_pdf(jo, ji, je, ja))
    _close_sample(tb.dielectric_sample(to, tl, tu, te, ta),
                  jb.dielectric_sample(jo, jl, ju, je, ja))
    _close_sample(tb.thin_dielectric_sample(to, tl, te),
                  jb.thin_dielectric_sample(jo, jl, je))


def test_coated_diffuse(inputs):
    (jo, to), (ji, ti) = _pair(inputs["wo"]), _pair(inputs["wi"])
    (jb_, tb_) = _pair(inputs["albedo"])
    (je, te), (ja, ta) = _pair(inputs["eta"]), _pair(inputs["alpha"])
    (jl, tl), (ju, tu) = _pair(inputs["u_lobe"]), _pair(inputs["u2"])
    _close(tb.coated_diffuse_f(to, ti, tb_, te, ta),
           jb.coated_diffuse_f(jo, ji, jb_, je, ja))
    _close(tb.coated_diffuse_pdf(to, ti, te, ta),
           jb.coated_diffuse_pdf(jo, ji, je, ja))
    _close_sample(tb.coated_diffuse_sample(to, tl, tu, tb_, te, ta),
                  jb.coated_diffuse_sample(jo, jl, ju, jb_, je, ja))


@pytest.mark.parametrize("medium", [False, True])
def test_layered_walks_on_the_same_streams(inputs, medium):
    """layered_sample and layered_f (with and without the slab's medium)
    from the same PCG streams: estimates and the advanced streams agree
    (a walk whose lobe choice flips on an ulp draws differently after;
    at most 1% of lanes)."""
    n = 1024
    (jo, to), (ji, ti) = _pair(inputs["wo"][:n]), _pair(inputs["wi"][:n])
    (jb_, tb_) = _pair(inputs["albedo"][:n])
    (je, te) = _pair(inputs["eta"][:n])
    (ja, ta) = _pair(np.maximum(inputs["alpha"][:n], 0.0))
    idx = np.arange(n)
    jr = jdda.seed_stream(jnp.asarray(idx), jnp.zeros(n, jnp.int32), salt=5)
    tr = tdda.seed_stream(torch.as_tensor(idx),
                          torch.zeros(n, dtype=torch.int64), salt=5)
    assert np.array_equal(np.asarray(jr).astype(np.int64), tr.numpy())
    med = dict(med_albedo=_pair(inputs["trans"][:n])) if medium else {}
    jkw = dict(thickness=0.05, g=0.3, **{k: v[0] for k, v in med.items()})
    tkw = dict(thickness=0.05, g=0.3, **{k: v[1] for k, v in med.items()})
    jbs, jr1 = jb.layered_sample(jo, jr, jb_, je, ja, **jkw)
    tbs, tr1 = tb.layered_sample(to, tr, tb_, te, ta, **tkw)
    _close_sample(tbs, jbs, flips=0.01)
    _close(tr1, np.asarray(jr1).astype(np.int64), flips=0.01)
    jf, jr2 = jb.layered_f(jo, ji, jr, jb_, je, ja, **jkw)
    tf, tr2 = tb.layered_f(to, ti, tr, tb_, te, ta, **tkw)
    _close(tf, jf, flips=0.01)
    _close(tr2, np.asarray(jr2).astype(np.int64), flips=0.01)
    assert (tf.numpy() > 0).mean() > 0.2
