"""The fused blocked-DDA march step
(counterpart of acceleratedvolrenderer_tpu/ops/pallas_march.py).

`march_block` is the wrapper of the hand-written CUDA kernel
`csrc/march.cu`; `march_block_plain` is the same computation in eager
PyTorch, the K-loop of the TPU kernel written over the lane dimension.
`march_window` is the integrator's other route, taken where `available`
says no: the K-voxel walk in eager PyTorch with one gather of the window's
majorants through the kernel of ops/gather.py.
The wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel once or raises: the kernel writes every
output, the landed / escaped flags as bool planes, into views of one new
buffer (`alloc_outputs`), and takes its arguments as one packed record.
`launches` counts kernel launches, so a run can show that its main path
went through the kernel; `residual_launches` counts those of them in
residual mode.

The outputs are sampling-side quantities and carry no gradient.
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct

import numpy as np
import torch

from .. import kernels
from . import gather

launches = 0
residual_launches = 0

_F_INF = 3.0e38


def march_block_plain(majorant, voxel, next_t, dt, step, t_exit, t_cur,
                      dl_target, dl_since, maxd_in, hunting, K, maj_res,
                      control=None, resid=None, ctrld_in=None, csince_in=None):
    """Eager version of the kernel.  Per-lane args are (N,) / (N, 3)
    tensors; majorant / control are flat (rz*ry*rx,) tables.  Returns a dict
    with voxel / next_t / t_cur / dl_target / dl_since / maxd and the landed
    / escaped masks (plus ctrld / ctrl_since in residual mode)."""
    rx, ry, rz = (int(r) for r in maj_res)
    use_ctrl = control is not None
    vx, vy, vz = voxel[:, 0], voxel[:, 1], voxel[:, 2]
    ntx, nty, ntz = next_t[:, 0], next_t[:, 1], next_t[:, 2]
    dtx, dty, dtz = dt[:, 0], dt[:, 1], dt[:, 2]
    sx, sy, sz = step[:, 0], step[:, 1], step[:, 2]
    s_k = t_cur
    live = hunting

    zf = torch.zeros_like(s_k)
    cum = zf
    landed = torch.zeros_like(hunting)
    t_col = zf
    t_end = s_k
    maj_snap = zf
    maxd_last = zf
    svx, svy, svz = vx, vy, vz
    sntx, snty, sntz = ntx, nty, ntz
    if use_ctrl:
        resid_f = resid.to(torch.float32)
        cumc = zf
        ctrl_snap = zf
        ctrl_last = zf
        c_land = zf

    for _ in range(int(K)):
        end_raw = torch.minimum(torch.minimum(ntx, nty), ntz)
        end_k = torch.minimum(end_raw, t_exit)
        len_k = torch.clamp(end_k - s_k, min=0.0)
        hit_exit = end_raw >= t_exit

        flat = ((torch.clamp(vz, 0, rz - 1) * ry + torch.clamp(vy, 0, ry - 1))
                * rx + torch.clamp(vx, 0, rx - 1)).long()
        maj_k = majorant[flat]
        if use_ctrl:
            ctrl_k = control[flat] * resid_f
            rate_k = torch.clamp(maj_k - ctrl_k, min=0.0)
        else:
            rate_k = maj_k

        len_c = torch.clamp(len_k, max=_F_INF)
        dl_k = torch.where(live & (rate_k > 0), rate_k * len_c, 0.0)
        prev_cum = cum
        cum = cum + dl_k
        ok = live & (dl_k > 0) & (cum >= dl_target)
        new_land = ok & ~landed
        t_col = torch.where(
            new_land,
            s_k + (dl_target - prev_cum) / torch.clamp(rate_k, min=1e-30),
            t_col)
        maj_snap = torch.where(new_land, maj_k, maj_snap)
        if use_ctrl:
            dc_k = torch.where(live, ctrl_k * len_c, 0.0)
            c_land = torch.where(new_land, cumc + ctrl_k * (t_col - s_k),
                                 c_land)
            cumc = cumc + dc_k
            ctrl_snap = torch.where(new_land, ctrl_k, ctrl_snap)
            ctrl_last = torch.where(live, ctrl_k, ctrl_last)
        svx = torch.where(new_land, vx, svx)
        svy = torch.where(new_land, vy, svy)
        svz = torch.where(new_land, vz, svz)
        sntx = torch.where(new_land, ntx, sntx)
        snty = torch.where(new_land, nty, snty)
        sntz = torch.where(new_land, ntz, sntz)
        landed = landed | ok
        maxd_last = torch.where(live, maj_k, maxd_last)
        t_end = torch.where(live, end_k, t_end)

        # advance one voxel; the first minimum wins ties
        is_x = (ntx <= nty) & (ntx <= ntz)
        is_y = ~is_x & (nty <= ntz)
        is_z = ~is_x & ~is_y
        vx = torch.where(is_x, vx + sx, vx)
        vy = torch.where(is_y, vy + sy, vy)
        vz = torch.where(is_z, vz + sz, vz)
        ntx = torch.where(is_x, ntx + dtx, ntx)
        nty = torch.where(is_y, nty + dty, nty)
        ntz = torch.where(is_z, ntz + dtz, ntz)
        out = ((vx < 0) | (vx >= rx) | (vy < 0) | (vy >= ry)
               | (vz < 0) | (vz >= rz))
        live = live & ~hit_exit & ~out
        s_k = end_k

    sel = landed
    adv = hunting & ~landed
    escaped = adv & ~live
    dl_tot = torch.where(hunting, cum, 0.0)
    pick = lambda s, a, old: torch.where(sel, s, torch.where(adv, a, old))
    out = dict(
        voxel=torch.stack([pick(svx, vx, voxel[:, 0]), pick(svy, vy, voxel[:, 1]),
                           pick(svz, vz, voxel[:, 2])], dim=-1),
        next_t=torch.stack([pick(sntx, ntx, next_t[:, 0]),
                            pick(snty, nty, next_t[:, 1]),
                            pick(sntz, ntz, next_t[:, 2])], dim=-1),
        t_cur=pick(t_col, t_end, t_cur),
        dl_target=torch.where(adv, dl_target - dl_tot, dl_target),
        dl_since=dl_since + torch.where(sel, dl_target,
                                        torch.where(adv, dl_tot, 0.0)),
        maxd=pick(maj_snap, maxd_last, maxd_in),
        landed=sel, escaped=escaped,
    )
    if use_ctrl:
        out["ctrld"] = pick(ctrl_snap, ctrl_last, ctrld_in)
        out["ctrl_since"] = csince_in + torch.where(
            sel, c_land, torch.where(adv, cumc, 0.0))
    return out


# The C entry's argument record (csrc/march.cu::MarchCall): 25 addresses
# (inputs, then outputs; 0 for an absent residual-mode tensor), n_table, n,
# K, rx, ry, rz, device and the stream, 8 bytes each.  One packed record
# crosses ctypes as one argument (31 separate arguments cost several us).
_CALL = struct.Struct("<25Q7qQ")
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = kernels.entry("avrt_march_block", [ctypes.c_char_p])
    return _fn


def output_layout(n, residual=False):
    """Where the outputs of one march_block call on n lanes lie in the one
    buffer the wrapper allocates for them: [(name, dtype, shape, byte
    offset)] in the C record's order (the 4-byte outputs, then landed and
    escaped, n bytes each) and the buffer's size in bytes.  Each output
    takes whole 4-byte words (the kernel's stores are 4-byte and 1-byte),
    so every output starts on a 4-byte boundary."""
    f32, i32 = torch.float32, torch.int32
    outs = [("voxel", i32, (n, 3)), ("next_t", f32, (n, 3))]
    outs += [(k, f32, (n,)) for k in ("t_cur", "dl_target", "dl_since",
                                      "maxd")]
    if residual:
        outs += [("ctrld", f32, (n,)), ("ctrl_since", f32, (n,))]
    outs += [("landed", torch.bool, (n,)), ("escaped", torch.bool, (n,))]
    layout, at = [], 0
    for name, dtype, shape in outs:
        layout.append((name, dtype, shape, at))
        at += -(-dtype.itemsize * math.prod(shape) // 4) * 4
    return layout, at


@functools.lru_cache(maxsize=64)
def _carve(n, residual):
    """output_layout as alloc_outputs uses it: the buffer's size and each
    output's size in float32 words, and the outputs' byte offsets in the C
    record's order."""
    layout, size = output_layout(n, residual)
    ends = [off for *_, off in layout[1:]] + [size]
    words = [(end - off) // 4 for (*_, off), end in zip(layout, ends)]
    offsets = {name: off for name, *_, off in layout}
    record = [offsets.get(k) for k in ("voxel", "next_t", "t_cur",
                                       "dl_target", "dl_since", "maxd",
                                       "landed", "escaped", "ctrld",
                                       "ctrl_since")]
    return size // 4, words, record


def alloc_outputs(n, residual, device):
    """The outputs of one march_block call, in the plain version's key
    order, as contiguous views of one new float32 buffer (output_layout),
    and their addresses in the C record's order (0 for an absent one)."""
    size, words, record = _carve(n, residual)
    buf = torch.empty(size, dtype=torch.float32, device=device)
    part = buf.split_with_sizes(words)
    landed, escaped = (p.view(torch.bool) for p in part[-2:])
    if n % 4:                  # the flags' last word is partly padding
        landed, escaped = landed[:n], escaped[:n]
    out = {"voxel": part[0].view(torch.int32).view(n, 3),
           "next_t": part[1].view(n, 3), "t_cur": part[2],
           "dl_target": part[3], "dl_since": part[4], "maxd": part[5],
           "landed": landed, "escaped": escaped}
    if residual:
        out["ctrld"], out["ctrl_since"] = part[6], part[7]
    base = buf.data_ptr()
    return out, [0 if off is None else base + off for off in record]


def march_block(majorant, voxel, next_t, dt, step, t_exit, t_cur,
                dl_target, dl_since, maxd_in, hunting, K, maj_res,
                control=None, resid=None, ctrld_in=None, csince_in=None):
    """Fused march (see march_block_plain for the arguments).  CPU tensors
    run the plain version; CUDA tensors launch csrc/march.cu once, or raise.
    The outputs are views of one new buffer (alloc_outputs)."""
    global launches, residual_launches
    dev = t_cur.device
    if dev.type == "cpu":
        return march_block_plain(majorant, voxel, next_t, dt, step, t_exit,
                                 t_cur, dl_target, dl_since, maxd_in, hunting,
                                 K, maj_res, control, resid, ctrld_in,
                                 csince_in)
    index, stream = kernels.launch_target("march_block", dev)
    rx, ry, rz = maj_res
    n, V = t_cur.shape[0], rx * ry * rz
    use_ctrl = control is not None
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    lane3, lane = (n, 3), (n,)
    args = ((majorant, f32, (V,)), (voxel, i32, lane3), (next_t, f32, lane3),
            (dt, f32, lane3), (step, i32, lane3), (t_exit, f32, lane),
            (t_cur, f32, lane), (dl_target, f32, lane), (dl_since, f32, lane),
            (maxd_in, f32, lane), (hunting, b8, lane))
    if use_ctrl:
        args += ((control, f32, (V,)), (resid, b8, lane),
                 (ctrld_in, f32, lane), (csince_in, f32, lane))
    _check_args(args, index, dev)
    out, o_ptrs = alloc_outputs(n, use_ctrl, dev)
    if n == 0:
        return out
    ctrl_ptrs = ((control.data_ptr(), resid.data_ptr(), ctrld_in.data_ptr(),
                  csince_in.data_ptr()) if use_ctrl else (0, 0, 0, 0))
    record = _CALL.pack(
        majorant.data_ptr(), ctrl_ptrs[0], voxel.data_ptr(),
        next_t.data_ptr(), dt.data_ptr(), step.data_ptr(), t_exit.data_ptr(),
        t_cur.data_ptr(), dl_target.data_ptr(), dl_since.data_ptr(),
        maxd_in.data_ptr(), hunting.data_ptr(), *ctrl_ptrs[1:], *o_ptrs,
        V, n, K, rx, ry, rz, index, stream)
    err = _kernel()(record)
    if err != 0:
        raise RuntimeError(f"march_block: CUDA kernel launch failed "
                           f"(cudaError {err})")
    launches += 1
    residual_launches += use_ctrl
    return out


_ARG_NAMES = ("majorant", "voxel", "next_t", "dt", "step", "t_exit", "t_cur",
              "dl_target", "dl_since", "maxd_in", "hunting", "control",
              "resid", "ctrld_in", "csince_in")


def _check_args(args, index, dev):
    """Raise unless every (tensor, dtype, shape) of march_block's `args`, in
    _ARG_NAMES's order, lies on CUDA device `index` with that dtype and
    shape and a contiguous layout; the message names the first that does
    not."""
    for t, dtype, shape in args:
        if (t.dtype is not dtype or t.shape != shape or not t.is_contiguous()
                or t.get_device() != index):
            for name, (u, want, shp) in zip(_ARG_NAMES, args):
                kernels.check_arg("march_block", name, u, want, shp, dev)


LANES = 128              # the TPU's lane width
MAX_TABLE_ROWS = 2048    # the fused route's table cap, in 128-wide rows
_ROW_SELECT_MAX = 32     # rows above which the TPU kernel gathers by MXU
_MXU_CHUNK = 8           # sublane rows per MXU gather dispatch


def available(majorant_size: int, n: int) -> bool:
    """Whether the integrator takes the fused route (march_block) for a
    majorant of `majorant_size` cells and `n` lanes: the rule of
    pallas_march.available without its backend test, so the port routes a
    (table, lane count) as the reference routes it on the TPU.  Otherwise
    the window route (march_window) runs."""
    lanes = LANES
    if not (majorant_size % lanes == 0
            and 0 < majorant_size <= MAX_TABLE_ROWS * lanes
            and n % lanes == 0):
        return False
    if majorant_size > _ROW_SELECT_MAX * lanes:
        return n % (lanes * _MXU_CHUNK) == 0
    return True


def march_window(majorant, voxel, next_t, dt, step, t_exit, t_cur,
                 dl_target, dl_since, maxd_in, hunting, K, maj_res,
                 control=None, resid=None, ctrld_in=None, csince_in=None):
    """The window route of the march step (port of
    volpath_fused.py::_block_substep_xla): the K-voxel geometric walk of
    every lane, then ONE (N, K) majorant gather through
    gather.table_gather, then the free-flight target resolved in closed
    form over the window.  Arguments and outputs are march_block's.

    Two choices hold it lane for lane to march_block_plain:
      * the running optical depth is summed column by column, in the
        fused kernel's order.  torch.cumsum accumulates float32 in double
        on the CPU and by a tree on CUDA, and either can move a landing
        test `cum >= dl_target` by one ulp;
      * a lane escapes when it is no longer live after the K-th step, as
        in the fused kernel.  The reference window route counts only the
        live steps (n_live < K), so a lane whose K-th step leaves the
        segment escapes one iteration later there, with the same estimate.
    Residual mode (`control`, the minorant table): a second gather over it;
    resid lanes march at the rate (majorant - minorant) and sum their
    control depth column by column, as the kernel does."""
    use_ctrl = control is not None
    rx, ry, rz = (int(r) for r in maj_res)
    res = torch.tensor([rx, ry, rz], dtype=torch.int32, device=voxel.device)
    vox, nt, s_k, live = voxel, next_t, t_cur, hunting
    v_list, nt_list, s_list, len_list, live_list = [], [], [], [], []
    for _ in range(int(K)):
        end_raw = torch.amin(nt, dim=-1)
        end_k = torch.minimum(end_raw, t_exit)
        len_list.append(torch.clamp(end_k - s_k, min=0.0))
        hit_exit = end_raw >= t_exit
        v_list.append(vox)
        nt_list.append(nt)
        s_list.append(s_k)
        live_list.append(live)
        # advance one voxel; argmin takes the first minimum, as the kernel
        onehot = torch.nn.functional.one_hot(torch.argmin(nt, dim=-1),
                                             3).bool()
        vox = torch.where(onehot, vox + step, vox)
        # where (not + onehot * dt): dt is inf on degenerate axes
        nt = torch.where(onehot, nt + dt, nt)
        out = ((vox < 0) | (vox >= res)).any(dim=-1)
        live = live & ~hit_exit & ~out
        s_k = end_k
    v_stack = torch.stack(v_list, 1)                # (N, K, 3)
    nt_stack = torch.stack(nt_list, 1)
    s_stack = torch.stack(s_list + [s_k], 1)        # (N, K+1) segment starts
    len_c = torch.clamp(torch.stack(len_list, 1), max=_F_INF)   # (N, K)
    live_stack = torch.stack(live_list, 1)

    # ---- ONE majorant gather over the window (and one of the minorant) ----
    vc = torch.minimum(torch.clamp(v_stack, min=0), res - 1)
    flat = ((vc[..., 2] * ry + vc[..., 1]) * rx + vc[..., 0]).contiguous()
    maj = gather.table_gather(majorant, flat)       # (N, K)
    if use_ctrl:
        ctrl = gather.table_gather(control, flat) * resid.to(
            torch.float32)[:, None]
        rate = torch.clamp(maj - ctrl, min=0.0)
    else:
        rate = maj

    # ---- closed-form free-flight resolution ----
    def running_sum(x):
        """Inclusive and exclusive sums along the window, column by column."""
        acc = torch.zeros_like(t_cur)
        cums = []
        for k in range(int(K)):
            acc = acc + x[:, k]
            cums.append(acc)
        cum = torch.stack(cums, 1)
        return cum, torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)

    dl = torch.where(live_stack & (rate > 0), rate * len_c, 0.0)
    cum, prev_cum = running_sum(dl)
    ok = live_stack & (dl > 0) & (cum >= dl_target[:, None])
    landed = hunting & ok.any(dim=1)
    k_star = torch.argmax(ok.to(torch.int8), dim=1, keepdim=True)  # first
    take = lambda a: torch.gather(a, 1, k_star)[:, 0]
    take3 = lambda a: torch.gather(
        a, 1, k_star[:, :, None].expand(-1, 1, 3))[:, 0]
    s_star = take(s_stack[:, :-1])
    t_col = s_star + (dl_target - take(prev_cum)) / torch.clamp(take(rate),
                                                                 min=1e-30)
    n_live = live_stack.sum(dim=1, keepdim=True)
    last = torch.clamp(n_live - 1, min=0)
    t_end = torch.gather(s_stack, 1, n_live)[:, 0]
    dl_tot = torch.where(hunting, cum[:, -1], 0.0)

    sel = landed
    adv = hunting & ~landed
    pick = lambda s, a, old: torch.where(sel, s, torch.where(adv, a, old))
    pick3 = lambda s, a, old: torch.where(
        sel[:, None], s, torch.where(adv[:, None], a, old))
    out = dict(
        voxel=pick3(take3(v_stack), vox, voxel),
        next_t=pick3(take3(nt_stack), nt, next_t),
        t_cur=pick(t_col, t_end, t_cur),
        dl_target=torch.where(adv, dl_target - dl_tot, dl_target),
        dl_since=dl_since + torch.where(sel, dl_target,
                                        torch.where(adv, dl_tot, 0.0)),
        maxd=pick(take(maj), torch.gather(maj, 1, last)[:, 0], maxd_in),
        landed=sel, escaped=adv & ~live,
    )
    if use_ctrl:
        # control depth: the whole segments before the collision plus the
        # landing segment's part
        cumc, prev_cumc = running_sum(torch.where(live_stack, ctrl * len_c,
                                                  0.0))
        c_land = take(prev_cumc) + take(ctrl) * (t_col - s_star)
        out["ctrld"] = pick(take(ctrl), torch.gather(ctrl, 1, last)[:, 0],
                            ctrld_in)
        out["ctrl_since"] = csince_in + torch.where(
            sel, c_land, torch.where(adv, cumc[:, -1], 0.0))
    return out


def random_lanes(n, maj_res, seed, residual=False):
    """Random march inputs as numpy arrays (shared by the tests and the
    chip smoke check): in-grid voxels, finite or axis-parallel steps, and
    optical-depth targets that land, escape or run on within a few voxels.
    Tables are float32 in [0, 2) with 20% empty cells; the minorant is a
    fraction of the majorant."""
    rng = np.random.default_rng(seed)
    rx, ry, rz = maj_res
    f = lambda a: np.asarray(a, np.float32)
    V = rx * ry * rz
    maj = f(rng.uniform(0.0, 2.0, V) * (rng.random(V) > 0.2))
    dt = f(rng.uniform(0.05, 2.0, (n, 3)))
    dt[rng.random((n, 3)) < 0.05] = np.inf
    t_cur = f(rng.uniform(0.0, 5.0, n))
    next_t = f(t_cur[:, None] + rng.uniform(0.0, 1.0, (n, 3)) * dt)
    next_t[~np.isfinite(dt)] = np.inf
    lanes = dict(
        majorant=maj,
        voxel=np.stack([rng.integers(0, r, n) for r in maj_res],
                       -1).astype(np.int32),
        next_t=next_t, dt=dt,
        step=np.where(rng.random((n, 3)) < 0.5, 1, -1).astype(np.int32),
        t_exit=f(t_cur + rng.uniform(0.0, 30.0, n)), t_cur=t_cur,
        dl_target=f(rng.exponential(2.0, n)),
        dl_since=f(rng.uniform(0.0, 3.0, n)),
        maxd_in=f(rng.uniform(0.0, 2.0, n)),
        hunting=rng.random(n) < 0.85,
    )
    if residual:
        lanes.update(
            control=f(maj * rng.uniform(0.0, 1.0, V)),
            resid=rng.random(n) < 0.5,
            ctrld_in=f(rng.uniform(0.0, 1.0, n)),
            csince_in=f(rng.uniform(0.0, 2.0, n)))
    return lanes
