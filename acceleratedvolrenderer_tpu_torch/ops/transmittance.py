"""Ratio-tracking transmittance along shadow rays
(port of acceleratedvolrenderer_tpu/ops/transmittance.py).

Every tentative collision is a null interaction:
    pdf   = T_maj[0] * sigma_maj[0]
    T_ray *= T_maj * sigma_n / pdf
    r_l   *= T_maj * sigma_maj / pdf
    r_u   *= T_maj * sigma_n / pdf
with Russian roulette once max(T_ray / avg(r_l + r_u)) < 0.05 (q = 0.75),
and a final T_maj / T_maj[0] residual factor at the segment's end.  The
same staged march as ops/dda.py::delta_track: K voxel advances per loop
iteration, then the collisions, per-ray streams advanced only on use.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import grid as gridops
from .dda import (K_DDA_SUBSTEPS, MediumArrays, dda_advance, dda_init,
                  exp_target, grid_res, majorant_at, pcg_uniform_masked,
                  world_to_medium)


class TrResult(NamedTuple):
    T_ray: torch.Tensor  # (N, L)
    r_l: torch.Tensor    # (N, L)
    r_u: torch.Tensor    # (N, L)
    rng: torch.Tensor    # (N,)


class _Carry(NamedTuple):
    marching: torch.Tensor
    t_cur: torch.Tensor
    dl_target: torch.Tensor
    dl_since: torch.Tensor
    reached: torch.Tensor
    voxel: torch.Tensor
    next_t: torch.Tensor
    T_ray: torch.Tensor
    r_l: torch.Tensor
    r_u: torch.Tensor
    rng: torch.Tensor


def ratio_track(med: MediumArrays, o, d, t_max, rng_state, active, maj_res,
                rr_threshold: float = 0.05, rr_q: float = 0.75,
                homogeneous: bool = False,
                max_steps: int = 100000) -> TrResult:
    """Ratio-tracked transmittance of each active ray over [0, t_max].  The
    loop reads one flag from the device per iteration."""
    N = o.shape[0]
    L = med.sigma_a.shape[-1]
    f32 = torch.float32
    dev = o.device

    sigma_t = (med.sigma_a + med.sigma_s).expand(N, L)
    sigma_a_b = med.sigma_a.expand(N, L)
    sigma_s_b = med.sigma_s.expand(N, L)
    sigma_t0 = sigma_t[:, 0]

    dda, t0 = dda_init(o, d, t_max, med.w2m, maj_res)
    maj_res_i = grid_res(med.majorant)
    marching0 = active & dda.in_medium
    rng0, u0 = pcg_uniform_masked(rng_state, marching0)
    ones = torch.ones((N, L), dtype=f32, device=dev)
    c = _Carry(
        marching=marching0, t_cur=t0, dl_target=exp_target(u0, sigma_t0),
        dl_since=torch.zeros((N,), dtype=f32, device=dev),
        reached=torch.zeros((N,), dtype=torch.bool, device=dev),
        voxel=dda.voxel, next_t=dda.next_t, T_ray=ones, r_l=ones, r_u=ones,
        rng=rng0)

    def substep(c: _Carry) -> _Carry:
        t_cur, dl_target, dl_since, lands, escaped, voxel, next_t = \
            dda_advance(c.marching & ~c.reached, c.t_cur, c.dl_target,
                        c.dl_since, c.voxel, c.next_t, dda, med.majorant,
                        maj_res_i)
        return c._replace(marching=c.marching & ~escaped, t_cur=t_cur,
                          dl_target=dl_target, dl_since=dl_since,
                          reached=c.reached | lands, voxel=voxel,
                          next_t=next_t)

    def process(c: _Carry) -> _Carry:
        col = c.reached & c.marching
        if homogeneous:
            dens = torch.ones((N,), dtype=f32, device=dev)
        else:
            p_m = world_to_medium(med.w2m, o + c.t_cur[:, None] * d)
            dens = gridops.trilerp(med.density, p_m)
        maxd = majorant_at(med.majorant, c.voxel)

        sa = sigma_a_b * dens[:, None]
        ss = sigma_s_b * dens[:, None]
        sig_maj = sigma_t * maxd[:, None]
        T_maj = torch.exp(-sigma_t * c.dl_since[:, None])
        sig_n = torch.clamp(sig_maj - sa - ss, min=0.0)

        pdf = T_maj[:, 0] * sig_maj[:, 0]
        inv_pdf = (1.0 / torch.clamp(pdf, min=1e-30))[:, None]
        upd = col[:, None] & (pdf > 0)[:, None]
        T_new = torch.where(upd, c.T_ray * T_maj * sig_n * inv_pdf, c.T_ray)
        r_l_new = torch.where(upd, c.r_l * T_maj * sig_maj * inv_pdf, c.r_l)
        r_u_new = torch.where(upd, c.r_u * T_maj * sig_n * inv_pdf, c.r_u)

        # Russian roulette
        denom = torch.mean(r_l_new + r_u_new, dim=-1)
        Tr = T_new / torch.clamp(denom, min=1e-30)[:, None]
        rr = col & (torch.amax(Tr, dim=-1) < rr_threshold)
        rng, u_rr = pcg_uniform_masked(c.rng, rr)
        killed = rr & (u_rr < rr_q)
        T_new = torch.where(killed[:, None], 0.0, torch.where(
            rr[:, None], T_new / (1.0 - rr_q), T_new))
        dead = col & ~torch.any(T_new != 0.0, dim=-1)

        # a new collision target
        rng, u1 = pcg_uniform_masked(rng, col & ~dead)
        dl_target = torch.where(col, exp_target(u1, sigma_t0), c.dl_target)
        dl_since = torch.where(col, 0.0, c.dl_since)
        return c._replace(marching=c.marching & ~dead, dl_target=dl_target,
                          dl_since=dl_since, reached=c.reached & ~col,
                          T_ray=T_new, r_l=r_l_new, r_u=r_u_new, rng=rng)

    n_steps = 0
    while n_steps < max_steps and bool(torch.any(c.marching)):
        for _ in range(K_DDA_SUBSTEPS):
            c = substep(c)
        c = process(c)
        n_steps += 1

    # the residual T_maj / T_maj[0] at the segment's end
    T_res = torch.exp(-sigma_t * c.dl_since[:, None])
    f_res = T_res / torch.clamp(T_res[:, 0:1], min=1e-30)
    app = active[:, None]
    return TrResult(T_ray=torch.where(app, c.T_ray * f_res, c.T_ray),
                    r_l=torch.where(app, c.r_l * f_res, c.r_l),
                    r_u=torch.where(app, c.r_u * f_res, c.r_u), rng=c.rng)
