"""LightPath, particle tracing from the lights with camera splats (port of
acceleratedvolrenderer_tpu/models/integrators/light_path.py).

Sample a light, sample an emission ray (pbrt's Light::SampleLe), walk it
through the surfaces, and at the emitter vertex and every surface vertex
connect to the camera and splat into the projected pixel.  A pixel is the
mean radiance over its raster footprint, so the pixel-j importance of a
direction through the pinhole is W_j = W·H / (A·cos³θ), A the film area on
the z=1 plane (PerspectiveCamera.film_area_z1).  A vertex with throughput
β (every sampling pdf divided out) splats

    β · f(p → cam) · |cosθ_surface| / d²  ·  W·H / (A · cos²θ_cam)

and the image is the splat sum over the number of traced light paths.
Surface vertices only, as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops import warps
from ...utils import vecmath as vmu
from .. import lights as lights_mod
from .. import shapes as shapes_mod
from .path import (PCGSource, _bsdf_f_pdf, _bsdf_sample, _gather_mat_params,
                   _take, scene_lights_with_area)

_SURF_EPS = 1e-4


def _light_pmfs(lights_all, light_strategy):
    """The light selection pmf: by power, or uniform."""
    if light_strategy == "power":
        pw = np.asarray([lights_mod.light_power(lt) for lt in lights_all])
        return pw / pw.sum()
    return np.full((len(lights_all),), 1.0 / len(lights_all))


def sample_le(lights_all, pmfs, u1, u_pos, u_dir, lam):
    """Batched light emission sampling over the light list: returns
    (p, n_l, d, beta0, from_area, valid).  beta0 carries Le (or the
    intensity) with every pdf and the selection pmf divided out; point and
    distant lights return n_l = d.  Other light kinds contribute 0."""
    n = u1.shape[0]
    dev = u1.device
    k = len(lights_all)
    cdf = torch.as_tensor(np.cumsum(pmfs), dtype=torch.float32, device=dev)
    # jnp.searchsorted's default side is 'left'
    idx = torch.clamp(torch.searchsorted(cdf, u1), 0, k - 1)
    p_o = torch.zeros((n, 3), device=dev)
    n_o = torch.zeros((n, 3), device=dev)
    d_o = torch.zeros((n, 3), device=dev)
    b_o = torch.zeros(lam.shape, device=dev)
    area_o = torch.zeros((n,), dtype=torch.bool, device=dev)
    ok_o = torch.zeros((n,), dtype=torch.bool, device=dev)
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    for i, lt in enumerate(lights_all):
        sel = idx == i
        pmf = float(pmfs[i])
        from_area = ~ones
        if isinstance(lt, lights_mod.DiffuseAreaLight):
            p, nl, pdf_a = lt.shape.sample(u_pos)
            local = warps.sample_cosine_hemisphere(u_dir)
            bx, by, bz = vmu.frame_from_z(nl)
            d = vmu.from_local(bx, by, bz, local)
            # beta0 = Le cos / (pdf_A (cos / pi) pmf) = Le pi / (pdf_A pmf)
            beta = (lt.spectrum(lam) * lt.scale * np.pi
                    / torch.clamp(pdf_a, min=1e-12)[:, None] / pmf)
            ok, from_area = ones, ones
        elif isinstance(lt, lights_mod.PointLight):
            p = torch.as_tensor(np.asarray(lt.position, np.float32),
                                device=dev).expand(n, 3)
            d = warps.sample_uniform_sphere(u_dir)
            nl = d
            beta = (lt.spectrum(lam) * lt.scale / warps.UNIFORM_SPHERE_PDF
                    / pmf) * torch.ones(lam.shape, device=dev)
            ok = ones
        elif isinstance(lt, lights_mod.DistantLight):
            # a disk of the scene radius across the light direction
            dirn = lt.direction.to(dev)
            r = lt.scene_radius
            disk = warps.sample_uniform_disk_concentric(u_pos) * r
            bx, by, bz = vmu.frame_from_z(dirn.expand(n, 3))
            p = -2.0 * r * dirn + disk[..., 0:1] * bx + disk[..., 1:2] * by
            d = dirn.expand(n, 3)
            nl = d
            pdf_pos = 1.0 / (np.pi * r * r)
            beta = (lt.spectrum(lam) * lt.scale / pdf_pos
                    / pmf) * torch.ones(lam.shape, device=dev)
            ok = ones
        else:
            # an emitter family light tracing does not sample
            p = torch.zeros((n, 3), device=dev)
            d = torch.tensor([[0.0, 0.0, 1.0]], device=dev).expand(n, 3)
            nl = d
            beta = torch.zeros(lam.shape, device=dev)
            ok = ~ones
        p_o = torch.where(sel[:, None], p, p_o)
        n_o = torch.where(sel[:, None], nl, n_o)
        d_o = torch.where(sel[:, None], d, d_o)
        b_o = torch.where(sel[:, None], beta, b_o)
        area_o = torch.where(sel, from_area, area_o)
        ok_o = torch.where(sel, ok, ok_o)
    return p_o, n_o, d_o, b_o, area_o, ok_o


def trace_light_paths(prims: tuple, lights: list, camera, n_paths: int, lam,
                      rng, *, max_depth: int = 5,
                      light_strategy: str = "uniform"):
    """Trace `n_paths` light subpaths; returns (pix (M, 2) int64, -1 where
    a splat is invalid; weights (M, L); the advanced streams), M =
    n_paths * (max_depth + 1) or n_paths * max_depth without an area light,
    splats grouped by vertex.  The caller divides the splat film by the
    number of traced paths."""
    N = n_paths
    dev = lam.device
    opaque = tuple(p for p in prims if p.material is not None)
    src = PCGSource(rng)
    lights_all = [lt for lt in scene_lights_with_area(lights, opaque)
                  if not lt.is_infinite]
    assert lights_all, "lightpath needs at least one finite light"
    pmfs = _light_pmfs(lights_all, light_strategy)

    u1 = src.next()
    u_pos = torch.stack([src.next(), src.next()], -1)
    u_dir = torch.stack([src.next(), src.next()], -1)
    p, n_l, d, beta, from_area, ok = sample_le(lights_all, pmfs, u1, u_pos,
                                               u_dir, lam)

    W, H = camera.width, camera.height
    A = camera.film_area_z1()
    cam_p = camera.position
    hi = torch.tensor([W - 1, H - 1], device=dev)
    splat_pix, splat_val = [], []

    def splat_from(p_v, f_times_cos, mask):
        """f_times_cos (N, L): f(p -> cam) |cos(n_s, wi_cam)| at the vertex,
        or the emitted term at the emitter vertex."""
        to_cam = cam_p - p_v
        d2 = torch.clamp(vmu.length_squared(to_cam), min=1e-12)
        dist = torch.sqrt(d2)
        wi_cam = to_cam / dist[:, None]
        raster, cos_cam, inside = camera.project(p_v)
        occ = shapes_mod.occluded(opaque, p_v + wi_cam * _SURF_EPS, wi_cam,
                                  dist * (1 - 1e-4))
        w = f_times_cos * (W * H / (A * torch.clamp(cos_cam, min=1e-6) ** 2)
                           / d2)[:, None]
        valid = mask & inside & ~occ & (cos_cam > 1e-6)
        # float -> int truncates toward zero, as the reference's astype
        pix = torch.minimum(torch.clamp(raster.long(), min=0), hi)
        splat_pix.append(torch.where(valid[:, None], pix, -1))
        splat_val.append(torch.where(valid[:, None], w, 0.0))

    # the emitter vertex (area lights only; one-sided emission): the
    # emitted term toward the camera is (beta0 / pi) |cos(n_l, wi_cam)|
    if any(isinstance(lt, lights_mod.DiffuseAreaLight) for lt in lights_all):
        to_cam = vmu.normalize(cam_p - p)
        front = vmu.dot(n_l, to_cam) > 0
        le_term = beta / np.pi * torch.abs(vmu.dot(n_l, to_cam))[:, None]
        splat_from(p, le_term, ok & from_area & front)

    alive = ok
    o_cur = p + n_l * _SURF_EPS * from_area[:, None].float()
    d_cur = d
    for depth in range(max_depth):
        hit = shapes_mod.intersect_all(opaque, o_cur, d_cur, torch.inf)
        surf = alive & torch.isfinite(hit.t)
        mid = torch.clamp(hit.prim_id, 0, len(opaque) - 1)
        p_hit = o_cur + hit.t[:, None] * d_cur
        wo = -d_cur
        stacks = _gather_mat_params(opaque, lam, hit.uv, N)
        kind_ids = _take(stacks["kind"], mid)
        prm = {k: _take(v, mid) for k, v in stacks.items()
               if k not in ("kind", "emissive") and not k.startswith("_")}
        emissive_mask = torch.tensor(stacks["emissive"], device=dev)[mid]
        shade = surf & ~emissive_mask

        # connect this vertex to the camera
        bx, by, bz = vmu.frame_from_z(hit.n)
        wo_l = vmu.to_local(bx, by, bz, wo)
        to_cam = vmu.normalize(cam_p - p_hit)
        wi_l = vmu.to_local(bx, by, bz, to_cam)
        f_cam, _ = _bsdf_f_pdf(kind_ids, prm, wo_l, wi_l, lam,
                               stacks["_measured_tables"])
        cos_cam_s = torch.abs(wi_l[..., 2])
        p_off = p_hit + hit.n * torch.where(
            vmu.dot(hit.n, to_cam) > 0, _SURF_EPS, -_SURF_EPS)[:, None]
        splat_from(p_off, beta * f_cam * cos_cam_s[:, None], shade)

        # continue the walk
        u_lobe = src.next(shade)
        u2 = torch.stack([src.next(shade), src.next(shade)], -1)
        bs = _bsdf_sample(kind_ids, prm, wo_l, u_lobe, u2, lam,
                          stacks["_measured_tables"])
        cos_b = torch.abs(bs.wi[..., 2])
        ok_b = shade & (bs.pdf > 0) & (bs.f > 0).any(-1)
        beta = torch.where(ok_b[:, None], beta * bs.f * (
            cos_b / torch.clamp(bs.pdf, min=1e-20))[:, None], beta)
        wi_w = vmu.from_local(bx, by, bz, bs.wi)
        side = torch.where(vmu.dot(hit.n, wi_w) > 0, _SURF_EPS, -_SURF_EPS)
        o_cur = torch.where(ok_b[:, None], p_hit + hit.n * side[:, None],
                            o_cur)
        d_cur = torch.where(ok_b[:, None], wi_w, d_cur)
        # Russian roulette
        rr_beta = torch.amax(beta, -1)
        do_rr = ok_b & (depth > 2) & (rr_beta < 1.0)
        q = torch.clamp(1.0 - rr_beta, 0.0, 0.95)
        killed = do_rr & (src.next(do_rr) < q)
        beta = torch.where((do_rr & ~killed)[:, None],
                           beta / torch.clamp(1.0 - q, min=1e-6)[:, None],
                           beta)
        alive = ok_b & ~killed

    return torch.cat(splat_pix, 0), torch.cat(splat_val, 0), src.rng
