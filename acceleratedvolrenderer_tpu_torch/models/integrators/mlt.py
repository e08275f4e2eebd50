"""MLT, primary-sample-space Metropolis light transport, Kelemen style (port
of acceleratedvolrenderer_tpu/models/integrators/mlt.py).

A bootstrap estimates the normalization b and seeds the chains; the chains
then take large and small mutations over the primary sample space with
luminance-ratio acceptance, splatting both the current and the proposed
state.  The target function is the forward estimator run from an explicit
primary-sample vector (path.VectorSource): surface scenes run path.li_path,
volumetric scenes the staged volpath.li, whose free-flight draws come from
a counter-RNG seed carried as one more chain coordinate (drawn anew on a
large step, kept on a small one).  Every chain is a lane of one batch.

With u uniform over [0,1]^D, pixel_j = W H b E_pi[(F / I) 1{p(u) in j}],
I = luminance(F), b = E_uniform[I]; the splat sum is divided by the number
of mutations and multiplied by W H b, b folding in every large-step
proposal (each is an independent uniform sample).

The chain's random numbers come from one torch.Generator seeded with
`seed`, on the CPU, and are moved to the render device: the same seed runs
the same chain on the card and on the CPU (the reference draws with
jax.random, whose streams the port does not reproduce).  The chains are
picked from the bootstrap by numpy's default_rng(seed).choice, as the
reference picks them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ...ops import dda
from ...utils import colorspace as cspace
from ...utils import spectrum as sp
from ...utils.device import resolve
from .path import VectorSource, li_path

SIGMA_SMALL = 0.01
P_LARGE = 0.3


def _dims_for_depth(max_depth: int) -> int:
    # film (2) + lambda (1) + per bounce: NEE (3) + lobe and direction (3)
    # + roulette (1)
    return 3 + 7 * (max_depth + 1)


def _film_and_rays(u_vec, cam):
    """The film position, wavelengths and camera rays of each vector."""
    W, H = cam.width, cam.height
    px = torch.clamp((u_vec[:, 0] * W).to(torch.int64), 0, W - 1)
    py = torch.clamp((u_vec[:, 1] * H).to(torch.int64), 0, H - 1)
    off = torch.stack([u_vec[:, 0] * W - px, u_vec[:, 1] * H - py], -1)
    pix = torch.stack([px, py], -1)
    swl = sp.sample_wavelengths_visible(u_vec[:, 2])
    o, d = cam.generate_rays(pix, off)
    return pix, swl, o, d


def _rgb_lum(L, swl):
    rgb = torch.nan_to_num(cspace.xyz_to_rgb(sp.to_xyz(L, swl)), nan=0.0,
                           posinf=0.0, neginf=0.0)
    rgb = torch.clamp(rgb, min=0.0)
    lum = 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    return rgb, lum


def _eval_F(u_vec, scene, prims, lights):
    """Primary sample vectors (N, D) -> (pix (N, 2) int64, rgb (N, 3),
    luminance (N,)) of the surface path's contribution."""
    pix, swl, o, d = _film_and_rays(u_vec, scene.camera)
    zeros = torch.zeros((u_vec.shape[0],), dtype=torch.int64,
                        device=u_vec.device)
    L, _ = li_path(prims, lights, o, d, swl.lam, zeros,
                   max_depth=scene.max_depth,
                   light_strategy=scene.light_sampler,
                   uniform_source=VectorSource(u_vec[:, 3:]))
    return (pix,) + _rgb_lum(L, swl)


def _dims_for_depth_vol(max_depth: int) -> int:
    # film (2) + lambda (1) + per bounce: NEE (3) + phase (2)
    return 3 + 5 * (max_depth + 1)


def _eval_F_vol(u_vec, seed_u32, scene):
    """The volumetric target: primary vectors and free-flight seeds (N,)
    int64 holding uint32 -> (pix, rgb, luminance) of the staged volpath
    estimator."""
    from .volpath import li as volpath_li

    pix, swl, o, d = _film_and_rays(u_vec, scene.camera)
    med_spec = scene.medium
    rng = dda.seed_stream(seed_u32, torch.zeros_like(seed_u32),
                          salt=scene.seed + 77)
    res = volpath_li(med_spec.build_arrays(swl.lam), scene.lights, o, d,
                     swl.lam, rng, maj_res=med_spec.maj_res(),
                     homogeneous=med_spec.homogeneous,
                     max_depth=scene.max_depth,
                     scene_radius=scene.scene_radius,
                     uniform_source=VectorSource(u_vec[:, 3:]))
    return (pix,) + _rgb_lum(res.L, swl)


def _bits(gen, n):
    """n uint32 values in int64, from the generator."""
    return torch.randint(0, 1 << 32, (n,), dtype=torch.int64, generator=gen)


def _run_chains(eval_F, W, H, D, n_chains, n_mutations, n_bootstrap, seed,
                p_large, dev, with_seed):
    """The bootstrap and the chains over eval_F(u, s) (s the free-flight
    seeds, None for surface scenes); returns ((H, W, 3) image, stats)."""
    gen = torch.Generator().manual_seed(seed)
    on = lambda t: t.to(dev)
    u_boot = on(torch.rand((n_bootstrap, D), generator=gen))
    s_boot = on(_bits(gen, n_bootstrap)) if with_seed else None
    _, _, lum_boot = eval_F(u_boot, s_boot)
    lum_np = lum_boot.cpu().numpy().astype(np.float64)
    b = float(lum_np.mean())
    if b <= 0:
        return np.zeros((H, W, 3), np.float32), {"b": 0.0}
    sel = np.random.default_rng(seed).choice(n_bootstrap, size=n_chains,
                                             p=lum_np / lum_np.sum())
    sel = torch.as_tensor(sel, device=dev)
    u_cur = u_boot[sel]
    s_cur = s_boot[sel] if with_seed else None
    pix_cur, rgb_cur, lum_cur = eval_F(u_cur, s_cur)

    splat = torch.zeros((H * W, 3), device=dev)
    lsum = torch.zeros((), device=dev)
    lcnt = torch.zeros((), dtype=torch.int64, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    for _ in range(n_mutations):
        large = on(torch.rand((n_chains,), generator=gen)) < p_large
        u_fresh = on(torch.rand((n_chains, D), generator=gen))
        step = on(torch.randn((n_chains, D), generator=gen))
        u_prop = torch.where(large[:, None], u_fresh,
                             torch.remainder(u_cur + SIGMA_SMALL * step, 1.0))
        s_prop = None
        if with_seed:
            # the free-flight seed: drawn anew on large steps, kept on small
            s_prop = torch.where(large, on(_bits(gen, n_chains)), s_cur)
        u_acc = on(torch.rand((n_chains,), generator=gen))
        pix_p, rgb_p, lum_p = eval_F(u_prop, s_prop)
        # every large-step proposal is an independent uniform sample of the
        # integrand: it refines b whether or not it is accepted
        lsum = lsum + torch.where(large, lum_p, 0.0).sum()
        lcnt = lcnt + large.sum()
        a = torch.clamp(lum_p / torch.clamp(lum_cur, min=1e-12), max=1.0)
        w_cur = torch.where(lum_cur > 0, (1.0 - a)
                            / torch.clamp(lum_cur, min=1e-12), 0.0)
        w_prop = torch.where(lum_p > 0, a / torch.clamp(lum_p, min=1e-12),
                             0.0)
        splat.index_add_(0, pix_cur[:, 1] * W + pix_cur[:, 0],
                         rgb_cur * w_cur[:, None])
        splat.index_add_(0, pix_p[:, 1] * W + pix_p[:, 0],
                         rgb_p * w_prop[:, None])
        accept = u_acc < a
        u_cur = torch.where(accept[:, None], u_prop, u_cur)
        if with_seed:
            s_cur = torch.where(accept, s_prop, s_cur)
        pix_cur = torch.where(accept[:, None], pix_p, pix_cur)
        rgb_cur = torch.where(accept[:, None], rgb_p, rgb_cur)
        lum_cur = torch.where(accept, lum_p, lum_cur)
    img = splat.cpu().numpy().reshape(H, W, 3)
    dt = time.time() - t0
    total = n_chains * n_mutations
    b_ref = ((float(lum_np.sum()) + float(lsum))
             / (n_bootstrap + float(lcnt)))
    img = (img * (W * H * b_ref / total)).astype(np.float32)
    return img, {"b": b_ref, "b_bootstrap": b, "render_time": dt,
                 "mutations": total}


def render_mlt_vol(scene, *, n_chains: int = 4096, n_mutations: int = 64,
                   n_bootstrap: int = 8192, seed: int = 0,
                   p_large: float = P_LARGE, device=None):
    """PSS-MLT over the volumetric estimator; the chain state is (u_vec,
    free-flight seed).  Returns ((H, W, 3) numpy image, stats)."""
    dev = resolve(device)
    scene = scene.to(dev)
    W, H = scene.camera.width, scene.camera.height
    with torch.no_grad():
        return _run_chains(lambda u, s: _eval_F_vol(u, s, scene), W, H,
                           _dims_for_depth_vol(scene.max_depth), n_chains,
                           n_mutations, n_bootstrap, seed, p_large, dev,
                           with_seed=True)


def render_mlt(scene, *, n_chains: int = 4096, n_mutations: int = 64,
               n_bootstrap: int = 8192, seed: int = 0,
               p_large: float = P_LARGE, device=None):
    """Returns ((H, W, 3) numpy image, stats); the work is about
    n_chains * n_mutations paths.  A scene with a medium runs the
    volumetric chain."""
    if scene.medium is not None:
        return render_mlt_vol(scene, n_chains=n_chains,
                              n_mutations=n_mutations,
                              n_bootstrap=n_bootstrap, seed=seed,
                              p_large=p_large, device=device)
    dev = resolve(device)
    scene = scene.to(dev)
    prims = tuple(p for p in scene.primitives if p.material is not None)
    W, H = scene.camera.width, scene.camera.height
    with torch.no_grad():
        return _run_chains(lambda u, s: _eval_F(u, scene, prims,
                                                scene.lights), W, H,
                           _dims_for_depth(scene.max_depth), n_chains,
                           n_mutations, n_bootstrap, seed, p_large, dev,
                           with_seed=False)
