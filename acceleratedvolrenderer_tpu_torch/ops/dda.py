"""Per-ray PCG streams, medium arrays, DDA set-up and the staged
delta-tracking march (port of acceleratedvolrenderer_tpu/ops/dda.py).

uint32 arithmetic: CPU torch cannot add, shift or compare uint32 tensors,
so a PCG state is an int64 tensor holding a value in [0, 2^32), and every
step masks with 0xFFFFFFFF.  Products by constants >= 2^31 would reach
2^64 and wrap in int64; `_mul32` splits them into 16-bit halves so every
intermediate stays below 2^49 and the low 32 bits are exact.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.math import ONE_MINUS_EPSILON
from ..utils.vecmath import intersect_aabb
from . import grid as gridops

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64 and a constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pcg_step(state):
    """Advance PCG-RXS-M-XS-32; returns (new_state, output_bits)."""
    new = (state * 747796405 + 2891336453) & _M32
    # 277803737 < 2^29: the product stays below 2^61
    word = (((new >> ((new >> 28) + 4)) ^ new) * 277803737) & _M32
    out = (word >> 22) ^ word
    return new, out


def pcg_uniform(state):
    state, bits = pcg_step(state)
    return state, (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def pcg_uniform_masked(state, consume):
    """Draw a uniform; advance the stream only where `consume` is True."""
    new, u = pcg_uniform(state)
    return torch.where(consume, new, state), u


def seed_stream(pixel_index, sample_index, salt: int = 0):
    """Per-(pixel, sample, purpose) stream seed; indices are int64 tensors
    holding uint32 values (or python ints)."""
    x = torch.as_tensor(pixel_index, dtype=torch.int64) & _M32
    s = torch.as_tensor(sample_index, dtype=torch.int64,
                        device=x.device) & _M32
    h = (_mul32(x, 0x9E3779B9) + _mul32(s, 0x85EBCA6B) + (salt & _M32)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


class MediumArrays(NamedTuple):
    """Resolved per-render medium data, on the render device.

    density:  (nz, ny, nx) float32 density grid
    majorant: (rz, ry, rx) per-cell max density
    w2m:      (4, 4) world -> unit-cube medium transform
    g:        0-d float32 HG asymmetry
    density_s: optional frozen sampling-side density grid for the detached
              differentiable estimator (None => the density itself,
              detached); see volpath_fused
    sigma_a, sigma_s, Le: per-ray (N, L) or broadcastable spectra of the
              wave path (the regen path evaluates its own per lane)
    Le_grid:  optional per-voxel emission scale grid
    sigma_a_s, sigma_s_s: optional frozen sampling-side spectra
    g_s:      optional frozen sampling-side HG asymmetry
    minorant: optional (rz, ry, rx) per-cell min density, the control grid
              of residual ratio tracking on shadow segments
    sigma_a_rgb, sigma_s_rgb, Le_rgb: (nz, ny, nx, 3) per-voxel RGB
              coefficient grids of an RGB medium (Le_rgb optional)
    """
    density: torch.Tensor
    majorant: torch.Tensor
    w2m: torch.Tensor
    g: torch.Tensor
    density_s: Optional[torch.Tensor] = None
    sigma_a: Optional[torch.Tensor] = None
    sigma_s: Optional[torch.Tensor] = None
    Le: Optional[torch.Tensor] = None
    Le_grid: Optional[torch.Tensor] = None
    sigma_a_s: Optional[torch.Tensor] = None
    sigma_s_s: Optional[torch.Tensor] = None
    g_s: Optional[torch.Tensor] = None
    minorant: Optional[torch.Tensor] = None
    sigma_a_rgb: Optional[torch.Tensor] = None
    sigma_s_rgb: Optional[torch.Tensor] = None
    Le_rgb: Optional[torch.Tensor] = None


def world_to_medium(w2m, p):
    # elementwise multiply-add, as the reference writes it
    return (p[..., 0:1] * w2m[:3, 0] + p[..., 1:2] * w2m[:3, 1]
            + p[..., 2:3] * w2m[:3, 2] + w2m[:3, 3])


def world_dir_to_medium(w2m, d):
    return (d[..., 0:1] * w2m[:3, 0] + d[..., 1:2] * w2m[:3, 1]
            + d[..., 2:3] * w2m[:3, 2])


class DDAState(NamedTuple):
    voxel: torch.Tensor     # (N, 3) int32
    next_t: torch.Tensor    # (N, 3) world-t of the next axis crossing
    dt: torch.Tensor        # (N, 3) world-t per voxel (inf if axis-parallel)
    step: torch.Tensor      # (N, 3) int32 +-1
    t_exit: torch.Tensor    # (N,) world-t where the march stops
    in_medium: torch.Tensor  # (N,) bool


def dda_init(o, d, t_max, w2m, maj_res):
    """Amanatides-Woo set-up over the majorant grid; maj_res = (rx, ry, rz).
    Returns (DDAState, t0)."""
    om = world_to_medium(w2m, o)
    dm = world_dir_to_medium(w2m, d)
    hit, t0, t1 = intersect_aabb(om, dm, t_max, (0.0, 0.0, 0.0),
                                 (1.0, 1.0, 1.0))
    t0 = torch.where(hit, t0, 0.0)
    t1 = torch.where(hit, t1, 0.0)

    eps = 1e-6
    te = (t0 + eps)[..., None]
    p_entry = om + te * dm
    res = [float(r) for r in maj_res]
    pidx = torch.stack([p_entry[..., i] * res[i] for i in range(3)], dim=-1)
    voxel = torch.stack(
        [torch.clamp(torch.floor(pidx[..., i]).to(torch.int32), 0,
                     int(maj_res[i]) - 1) for i in range(3)], dim=-1)
    d_idx = torch.stack([dm[..., i] * res[i] for i in range(3)], dim=-1)
    pos = torch.where(d_idx > 0, 1.0, 0.0)
    nz = torch.abs(d_idx) > 1e-12
    inv = 1.0 / torch.where(nz, d_idx, 1.0)
    next_b = voxel.to(torch.float32) + pos
    next_t = torch.where(nz, te + (next_b - pidx) * inv, torch.inf)
    dt = torch.where(nz, torch.abs(inv), torch.inf)
    step = torch.where(d_idx > 0, 1, -1).to(torch.int32)
    return DDAState(voxel, next_t, dt, step, t1, hit), t0


# ---------------------------------------------------------------------------
# the staged delta-tracking march (reference ops/dda.py l. 196-451)
# ---------------------------------------------------------------------------

EVT_MARCHING = 0   # still walking (internal)
EVT_ESCAPED = 1    # reached t_max / left the medium without a real collision
EVT_SCATTER = 2    # real scatter event at t_event
EVT_ABSORB = 3     # absorbed (path terminates)

# DDA-only sub-steps per loop iteration
K_DDA_SUBSTEPS = 4

# loop iterations run by delta_track since the caller last set this to 0
delta_track_iterations = 0


class MarchResult(NamedTuple):
    event: torch.Tensor      # (N,) int32: EVT_ESCAPED / EVT_SCATTER / EVT_ABSORB
    t_event: torch.Tensor    # (N,)
    beta: torch.Tensor       # (N, L) updated throughput
    r_u: torch.Tensor        # (N, L) rescaled unidirectional pdf
    r_l: torch.Tensor        # (N, L) rescaled light-path pdf
    L_emit: torch.Tensor     # (N, L) volumetric emission picked up on the way
    rng: torch.Tensor        # (N,) advanced PCG states


class _Carry(NamedTuple):
    status: torch.Tensor         # (N,) int32 event codes; EVT_MARCHING = active
    t_cur: torch.Tensor          # (N,) voxel entry or collision position
    dl_target: torch.Tensor      # (N,) majorant density*length to the collision
    dl_since_event: torch.Tensor  # (N,) accumulated since the last real event
    reached: torch.Tensor        # (N,) bool: a collision candidate to classify
    voxel: torch.Tensor
    next_t: torch.Tensor
    beta: torch.Tensor
    r_u: torch.Tensor
    r_l: torch.Tensor
    L_emit: torch.Tensor
    rng: torch.Tensor


def majorant_at(majorant, voxel):
    """The majorant of each lane's (clamped) voxel; voxel (N, 3) = (x, y, z)."""
    rz, ry, rx = majorant.shape
    vx = torch.clamp(voxel[:, 0], 0, rx - 1).long()
    vy = torch.clamp(voxel[:, 1], 0, ry - 1).long()
    vz = torch.clamp(voxel[:, 2], 0, rz - 1).long()
    return majorant[vz, vy, vx]


def dda_advance(hunting, t_cur, dl_target, dl_since, voxel, next_t,
                dda: DDAState, majorant, maj_res_i):
    """One voxel-resolution advance of the lanes still hunting their
    collision target: one majorant lookup and the accumulator updates;
    maj_res_i is the (3,) int32 (rx, ry, rz) of the majorant grid.
    Returns (t_cur, dl_target, dl_since, lands, escaped, voxel, next_t)."""
    maxd = majorant_at(majorant, voxel)
    seg_end = torch.minimum(torch.amin(next_t, dim=-1), dda.t_exit)
    seg_len = torch.clamp(seg_end - t_cur, min=0.0)
    dl_seg = maxd * seg_len

    # does the target land inside this voxel?
    lands = hunting & (dl_seg >= dl_target) & (maxd > 0)
    t_col = t_cur + torch.where(maxd > 0, dl_target / torch.clamp(
        maxd, min=1e-30), torch.inf)

    # crossing lanes advance one voxel
    crossing = hunting & ~lands
    onehot = torch.nn.functional.one_hot(torch.argmin(next_t, dim=-1),
                                         3).to(torch.int32)
    hit_exit = seg_end >= dda.t_exit
    move = (crossing & ~hit_exit)[:, None]
    voxel = torch.where(move, voxel + onehot * dda.step, voxel)
    next_t = torch.where(move & (onehot != 0), next_t + dda.dt, next_t)
    out_of_grid = torch.any((voxel < 0) | (voxel >= maj_res_i), dim=-1)
    escaped = crossing & (hit_exit | out_of_grid)

    dl_target_new = torch.where(crossing, dl_target - dl_seg, dl_target)
    dl_since = dl_since + torch.where(
        lands, dl_target, torch.where(crossing, dl_seg, 0.0))
    t_cur = torch.where(lands, t_col, torch.where(crossing, seg_end, t_cur))
    return t_cur, dl_target_new, dl_since, lands, escaped, voxel, next_t


def grid_res(majorant) -> torch.Tensor:
    """The (3,) int32 (rx, ry, rz) of a (rz, ry, rx) majorant grid."""
    return torch.tensor(majorant.shape[::-1], dtype=torch.int32,
                        device=majorant.device)


def _dda_substep(c: _Carry, dda: DDAState, majorant, maj_res_i) -> _Carry:
    """One voxel-resolution advance for the lanes still hunting."""
    hunting = (c.status == EVT_MARCHING) & ~c.reached
    t_cur, dl_target, dl_since, lands, escaped, voxel, next_t = dda_advance(
        hunting, c.t_cur, c.dl_target, c.dl_since_event, c.voxel, c.next_t,
        dda, majorant, maj_res_i)
    status = torch.where(escaped, EVT_ESCAPED, c.status).to(torch.int32)
    return c._replace(status=status, t_cur=t_cur, dl_target=dl_target,
                      dl_since_event=dl_since, reached=c.reached | lands,
                      voxel=voxel, next_t=next_t)


def exp_target(u, sigma_t0):
    """Majorant density*length to the next collision: tau* ~ Exp(1) in
    lane-0 optical depth, tau* / sigma_t0."""
    u = torch.clamp(u, max=ONE_MINUS_EPSILON)
    return torch.where(sigma_t0 > 0, -torch.log1p(-u) / torch.clamp(
        sigma_t0, min=1e-30), torch.inf)


def delta_track(med: MediumArrays, o, d, t_max, beta, r_u, r_l, rng_state,
                active, maj_res, collect_emission: bool = True,
                homogeneous: bool = False,
                max_steps: int = 100000) -> MarchResult:
    """March every active ray to its next real event (absorb, scatter) or out
    of the medium, with the rescaled path-probability updates of the
    null-scattering collision callback:
      scatter: beta *= T_maj*sigma_s/pdf ; r_u *= same ; pdf = T_maj[0]*sigma_s[0]
      null:    beta *= T_maj*sigma_n/pdf ; r_u *= same ;
               r_l *= T_maj*sigma_maj/pdf ; pdf = T_maj[0]*sigma_n[0]
    plus emission at every collision and the final T_maj/T_maj[0] residual
    of escaped rays.  Each loop iteration runs K_DDA_SUBSTEPS voxel advances
    and then classifies the lanes that reached their target (masked, so a
    lane without a candidate keeps its state and its stream).  The loop
    reads one flag from the device per iteration: it ends when no lane
    marches or after max_steps iterations."""
    global delta_track_iterations
    N = o.shape[0]
    L = beta.shape[-1]
    f32 = torch.float32
    dev = o.device

    sigma_t = (med.sigma_a + med.sigma_s).expand(N, L)
    sigma_a_b = med.sigma_a.expand(N, L)
    sigma_s_b = med.sigma_s.expand(N, L)
    Le_b = med.Le.expand(N, L) if collect_emission else None
    sigma_t0 = sigma_t[:, 0]

    dda, t0 = dda_init(o, d, t_max, med.w2m, maj_res)
    maj_res_i = grid_res(med.majorant)
    status0 = torch.where(active & dda.in_medium, EVT_MARCHING,
                          EVT_ESCAPED).to(torch.int32)
    rng0, u0 = pcg_uniform_masked(rng_state, status0 == EVT_MARCHING)
    c = _Carry(
        status=status0, t_cur=t0, dl_target=exp_target(u0, sigma_t0),
        dl_since_event=torch.zeros((N,), dtype=f32, device=dev),
        reached=torch.zeros((N,), dtype=torch.bool, device=dev),
        voxel=dda.voxel, next_t=dda.next_t, beta=beta, r_u=r_u, r_l=r_l,
        L_emit=torch.zeros((N, L), dtype=f32, device=dev), rng=rng0)

    def classify(c: _Carry) -> _Carry:
        col = c.reached & (c.status == EVT_MARCHING)
        if homogeneous:
            dens = torch.ones((N,), dtype=f32, device=dev)
        else:
            p_m = world_to_medium(med.w2m, o + c.t_cur[:, None] * d)
            dens = gridops.trilerp(med.density, p_m)
        maxd = majorant_at(med.majorant, c.voxel)

        sa = sigma_a_b * dens[:, None]
        ss = sigma_s_b * dens[:, None]
        sig_maj = sigma_t * maxd[:, None]
        sig_maj0 = sig_maj[:, 0]
        T_maj = torch.exp(-sigma_t * c.dl_since_event[:, None])

        pos = sig_maj0 > 0
        maj0 = torch.clamp(sig_maj0, min=1e-30)
        p_absorb = torch.where(pos, sa[:, 0] / maj0, 0.0)
        p_scatter = torch.where(pos, ss[:, 0] / maj0, 0.0)
        rng, u2 = pcg_uniform_masked(c.rng, col)
        is_absorb = col & (u2 < p_absorb)
        is_scatter = col & ~is_absorb & (u2 < p_absorb + p_scatter)
        is_null = col & ~is_absorb & ~is_scatter

        L_emit = c.L_emit
        if collect_emission:
            pdf_e = sig_maj0 * T_maj[:, 0]
            pdf_e_c = torch.clamp(pdf_e, min=1e-30)[:, None]
            betap = c.beta * T_maj / pdf_e_c
            r_e = c.r_u * sig_maj * T_maj / pdf_e_c
            r_e_avg = torch.mean(r_e, dim=-1)
            contrib = betap * sa * Le_b / torch.clamp(r_e_avg,
                                                      min=1e-30)[:, None]
            ok = col & (pdf_e > 0) & (r_e_avg > 0)
            L_emit = L_emit + torch.where(ok[:, None], contrib, 0.0)

        sig_n = torch.clamp(sig_maj - sa - ss, min=0.0)
        pdf_null = T_maj[:, 0] * sig_n[:, 0]
        null_ok = (pdf_null > 0)[:, None]
        pdf_null_c = torch.clamp(pdf_null, min=1e-30)[:, None]
        f_null = torch.where(null_ok, T_maj * sig_n / pdf_null_c, 0.0)
        f_null_l = torch.where(null_ok, T_maj * sig_maj / pdf_null_c, 0.0)
        pdf_sc = T_maj[:, 0] * ss[:, 0]
        f_sc = torch.where((pdf_sc > 0)[:, None], T_maj * ss / torch.clamp(
            pdf_sc, min=1e-30)[:, None], 0.0)

        nul, sct = is_null[:, None], is_scatter[:, None]
        beta_new = torch.where(nul, c.beta * f_null,
                               torch.where(sct, c.beta * f_sc, c.beta))
        r_u_new = torch.where(nul, c.r_u * f_null,
                              torch.where(sct, c.r_u * f_sc, c.r_u))
        r_l_new = torch.where(nul, c.r_l * f_null_l, c.r_l)

        dead_null = is_null & (~torch.any(beta_new != 0.0, dim=-1)
                               | ~torch.any(r_u_new != 0.0, dim=-1))
        status = torch.where(
            is_absorb | dead_null, EVT_ABSORB,
            torch.where(is_scatter, EVT_SCATTER, c.status)).to(torch.int32)

        # nulls: a new collision target, the T_maj accumulator reset
        rng, u1 = pcg_uniform_masked(rng, is_null)
        dl_target = torch.where(is_null, exp_target(u1, sigma_t0),
                                c.dl_target)
        dl_since = torch.where(col, 0.0, c.dl_since_event)
        return c._replace(status=status, dl_target=dl_target,
                          dl_since_event=dl_since, reached=c.reached & ~col,
                          beta=beta_new, r_u=r_u_new, r_l=r_l_new,
                          L_emit=L_emit, rng=rng)

    n_steps = 0
    while n_steps < max_steps and bool(torch.any(c.status == EVT_MARCHING)):
        for _ in range(K_DDA_SUBSTEPS):
            c = _dda_substep(c, dda, med.majorant, maj_res_i)
        c = classify(c)
        n_steps += 1
    delta_track_iterations += n_steps

    # escaped rays multiply beta and the pdfs by T_maj / T_maj[0]
    T_res = torch.exp(-sigma_t * c.dl_since_event[:, None])
    esc = ((c.status == EVT_ESCAPED) & active)[:, None]
    f_res = torch.where(esc, T_res / torch.clamp(T_res[:, 0:1], min=1e-30),
                        1.0)
    return MarchResult(event=c.status, t_event=c.t_cur, beta=c.beta * f_res,
                       r_u=c.r_u * f_res, r_l=c.r_l * f_res,
                       L_emit=c.L_emit, rng=c.rng)
