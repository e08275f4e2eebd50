"""VolPath, the staged null-scattering spectral volumetric path tracer
(port of acceleratedvolrenderer_tpu/models/integrators/volpath.py).

The twin of volpath_fused.li's wave mode, kept as an independent
cross-check: the same estimator, the same per-ray draws in the same order,
written as one loop over bounces whose body runs three stages over the
whole batch:
  1. ops/dda.py::delta_track: march to the next real event (nulls inlined);
  2. ops/transmittance.py::ratio_track: the NEE shadow ray of scattered rays;
  3. the HG direction sample and the state update.
The bounce loop reads one flag from the device per bounce.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import dda, phase as phase_ops, transmittance
from ...ops.dda import EVT_ESCAPED, EVT_SCATTER, MediumArrays
from .. import lights as lights_mod


class LiResult(NamedTuple):
    L: torch.Tensor     # (N, LANES) spectral radiance (pre pdf-division)
    rng: torch.Tensor


def li(med: MediumArrays, lights: list, o, d, lam, rng, *, maj_res,
       homogeneous: bool, max_depth: int = 5, scene_radius: float = 1e4,
       max_march_steps: int = 100000, uniform_source=None) -> LiResult:
    """Radiance along the rays (o, d) (N, 3) at wavelengths lam (N, LANES),
    with the PCG streams rng (N,).

    `uniform_source` (path.VectorSource), the volumetric PSS-MLT hook,
    supplies the structural draws of each bounce (the NEE light pick and
    2D, then the phase 2D, in that order); the free-flight draws stay on
    rng.  With a source every one of the max_depth + 1 bounces runs, with
    the finished lanes masked, and the loop reads no flag: the source's
    cursor, and so the vector's dimension count, do not depend on the
    data."""
    N = o.shape[0]
    LANES = lam.shape[-1]
    f32 = torch.float32
    dev = o.device
    L = torch.zeros((N, LANES), dtype=f32, device=dev)
    beta = torch.ones((N, LANES), dtype=f32, device=dev)
    r_u = torch.ones((N, LANES), dtype=f32, device=dev)
    r_l = torch.ones((N, LANES), dtype=f32, device=dev)
    depth = torch.zeros((N,), dtype=torch.int32, device=dev)
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    t_inf = torch.full((N,), torch.inf, dtype=f32, device=dev)
    g = med.g

    def draw(mask):
        nonlocal rng
        if uniform_source is not None:
            return uniform_source.next()
        rng, u = dda.pcg_uniform_masked(rng, mask)
        return u

    bounce = 0
    while bounce <= max_depth and (uniform_source is not None
                                   or bool(torch.any(active))):
        # stage 1: march to the next real event
        res = dda.delta_track(med, o, d, t_inf, beta, r_u, r_l, rng, active,
                              maj_res, collect_emission=True,
                              homogeneous=homogeneous,
                              max_steps=max_march_steps)
        # volumetric emission only while depth < max_depth
        emit_ok = active & (depth < max_depth)
        L = L + torch.where(emit_ok[:, None], res.L_emit, 0.0)
        beta, r_u, r_l, rng = res.beta, res.r_u, res.r_l, res.rng

        # escaped rays: infinite lights, then terminate
        esc = active & (res.event == EVT_ESCAPED)
        Le_inf, pdf_inf = lights_mod.escaped_radiance(lights, d, lam)
        denom = torch.where(depth == 0, torch.mean(r_u, dim=-1), torch.mean(
            r_u + r_l * pdf_inf[:, None], dim=-1))
        contrib = beta * Le_inf / torch.clamp(denom, min=1e-24)[:, None]
        L = L + torch.where((esc & (denom > 0))[:, None], contrib, 0.0)

        beta_zero = (~torch.any(beta != 0.0, dim=-1)
                     | ~torch.any(r_u != 0.0, dim=-1))

        # scattered rays
        sc = active & (res.event == EVT_SCATTER) & ~beta_zero
        sc = sc & ~(depth >= max_depth)
        depth = depth + torch.where(sc, 1, 0).to(torch.int32)
        p = o + res.t_event[:, None] * d
        wo = -d

        # stage 2: next-event estimation
        u1, u2a, u2b = draw(sc), draw(sc), draw(sc)
        ls, is_delta = lights_mod.sample_one_light(
            lights, p, u1, torch.stack([u2a, u2b], -1), lam)
        f_hat = phase_ops.hg_phase(wo, ls.wi, g)
        nee_ok = sc & ls.valid & (ls.pdf > 0) & (f_hat > 0)
        tr = transmittance.ratio_track(med, p, ls.wi, ls.dist, rng, nee_ok,
                                       maj_res, homogeneous=homogeneous,
                                       max_steps=max_march_steps)
        rng = tr.rng
        r_l_nee = tr.r_l * r_u * ls.pdf[:, None]
        r_u_nee = tr.r_u * r_u * f_hat[:, None]
        denom_nee = torch.where(is_delta, torch.mean(r_l_nee, dim=-1),
                                torch.mean(r_l_nee + r_u_nee, dim=-1))
        nee = (beta * f_hat[:, None] * tr.T_ray * ls.L
               / torch.clamp(denom_nee, min=1e-24)[:, None])
        L = L + torch.where((nee_ok & (denom_nee > 0))[:, None], nee, 0.0)

        # stage 3: the phase-function direction sample
        u3a, u3b = draw(sc), draw(sc)
        wi, ps_pdf = phase_ops.sample_hg(wo, torch.stack([u3a, u3b], -1), g)
        # beta *= p / pdf == 1 for HG; r_l = r_u / ps_pdf
        r_l = torch.where(sc[:, None], r_u / torch.clamp(
            ps_pdf, min=1e-24)[:, None], r_l)
        o = torch.where(sc[:, None], p, o)
        d = torch.where(sc[:, None], wi, d)
        active = sc & (ps_pdf > 0)
        bounce += 1
    return LiResult(L=L, rng=rng)
