"""SimpleVolPath, the teaching-version volumetric path tracer
(port of acceleratedvolrenderer_tpu/models/integrators/simple_volpath.py).

Pure delta tracking with no NEE, no MIS and no spectral rescaling: lights
are found only by escaping to them.  A ground-truth cross-check of the MIS
machinery.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import dda, phase as phase_ops
from ...ops.dda import EVT_ESCAPED, EVT_SCATTER, MediumArrays
from .. import lights as lights_mod


class LiResult(NamedTuple):
    L: torch.Tensor
    rng: torch.Tensor


def li(med: MediumArrays, lights: list, o, d, lam, rng, *, maj_res,
       homogeneous: bool, max_depth: int = 5, scene_radius: float = 1e4,
       max_march_steps: int = 100000) -> LiResult:
    N = o.shape[0]
    LANES = lam.shape[-1]
    f32 = torch.float32
    dev = o.device
    L = torch.zeros((N, LANES), dtype=f32, device=dev)
    beta = torch.ones((N, LANES), dtype=f32, device=dev)
    depth = torch.zeros((N,), dtype=torch.int32, device=dev)
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    t_inf = torch.full((N,), torch.inf, dtype=f32, device=dev)

    bounce = 0
    while bounce <= max_depth and bool(torch.any(active)):
        res = dda.delta_track(med, o, d, t_inf, beta, beta, beta, rng, active,
                              maj_res, collect_emission=True,
                              homogeneous=homogeneous,
                              max_steps=max_march_steps)
        rng = res.rng
        L = L + torch.where(active[:, None], res.L_emit * beta, 0.0)

        esc = active & (res.event == EVT_ESCAPED)
        Le_inf, _ = lights_mod.escaped_radiance(lights, d, lam)
        L = L + torch.where(esc[:, None], beta * Le_inf, 0.0)

        sc = active & (res.event == EVT_SCATTER) & ~(depth >= max_depth)
        depth = depth + torch.where(sc, 1, 0).to(torch.int32)
        p = o + res.t_event[:, None] * d

        rng, ua = dda.pcg_uniform_masked(rng, sc)
        rng, ub = dda.pcg_uniform_masked(rng, sc)
        wi, _ = phase_ops.sample_hg(-d, torch.stack([ua, ub], -1), med.g)
        o = torch.where(sc[:, None], p, o)
        d = torch.where(sc[:, None], wi, d)
        active = sc
        bounce += 1
    return LiResult(L=L, rng=rng)
