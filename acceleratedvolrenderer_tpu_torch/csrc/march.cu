// Fused blocked-DDA march step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel acceleratedvolrenderer_tpu/ops/pallas_march.py
// (_march_kernel, entry march_block): for every hunting lane, up to K
// Amanatides-Woo voxel steps through the majorant grid, accumulating the
// majorant optical depth rate*len and resolving the delta-tracking
// free-flight target in closed form, t_col = s + (target - prev_cum) / rate.
// Axis ties go to the first minimum (x, then y, then z).  Opt-in residual
// mode reads a second (minorant) table: `resid` lanes hunt at
// max(maj - ctrl, 0) and accumulate the control depth ctrl*len.
//
// What bounds it: per lane per call 69 bytes are read (table lookups
// aside) and 42 written, 111 B.  At the wave chunk's N = 262,144 that is
// 29 MB, 8.7 us at 3.35 TB/s: bandwidth.  At the regen loop's N = 16,384 it
// is 1.8 MB, 0.55 us, below a launch's own latency: there the launch and
// the chain of round trips to memory (the lane's registers, then its K
// table lookups) bound the call.
//
// Design for the card, not a block-by-block copy of the TPU kernel:
//  * one thread per lane in 128-thread blocks: N = 16,384 is 128 blocks,
//    one per SM of the 132 (256-thread blocks left 68 SMs idle); the last
//    block of a lane count that is not a multiple of 128 is masked;
//  * every lane register is loaded at the start, all loads in flight
//    together; the (N, 3) planes are read three words per lane at a
//    12-byte stride (staging them through shared memory with 16-byte loads
//    and stores measured slower at N = 262,144, the L1 absorbs the stride);
//  * the majorant is float32 throughout, read in place through the
//    read-only data cache (__ldg): no copy into shared memory and no
//    barrier before the first step.  A bulk copy (TMA) of a 16^3 table into
//    each block's shared memory measured 5% slower at N = 16,384, 2x slower
//    with a 32^3 table and at N = 262,144 (a copy per block).  The TPU
//    kernel's bf16 round-up / round-down and one-hot MXU gather existed only
//    for the MXU;
//  * for K = 8, the render's k_substeps (a template argument; other K run
//    the same step in a loop), the K lookups are issued together: the voxel
//    walk does not depend on the table, so a first pass walks the K voxels
//    and loads their values, and the K steps then run on registers.  One
//    round trip to the table instead of K in a row;
//  * `landed` and `escaped` are written as two byte planes (0 or 1), the
//    torch.bool outputs themselves, so a call is one launch.
//
// Built with -fmad=false and IEEE division so every float32 operation rounds
// as the eager PyTorch version (ops/march.py::march_block_plain) rounds it;
// the hoisted walk and the unrolling keep every float operation and its
// order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFInf = 3.0e38f;
constexpr int kThreads = 128;
constexpr int kMainK = 8;                 // the render's k_substeps

// The wrapper's argument record (ops/march.py::_CALL), 8-byte fields in
// this order.  Absent residual-mode pointers are null.
struct MarchCall {
  const float* maj;
  const float* ctrl;
  const int32_t* voxel;
  const float* next_t;
  const float* dt;
  const int32_t* step;
  const float* t_exit;
  const float* t_cur;
  const float* dl_target;
  const float* dl_since;
  const float* maxd;
  const uint8_t* hunting;
  const uint8_t* resid;
  const float* ctrld;
  const float* csince;
  int32_t* o_voxel;
  float* o_next_t;
  float* o_t_cur;
  float* o_dl_target;
  float* o_dl_since;
  float* o_maxd;
  uint8_t* o_landed;
  uint8_t* o_escaped;
  float* o_ctrld;
  float* o_csince;
  int64_t n_table, n, K, rx, ry, rz, device;
  cudaStream_t stream;
};
static_assert(sizeof(MarchCall) == 33 * 8, "MarchCall layout");

// The kernel's parameters: the record's pointers and 32-bit counts (the
// record itself as the parameters, 64-bit counts, measured 4% slower at
// N = 262,144, in turns on one card).
struct MarchArgs {
  const float* maj;
  const float* ctrl;
  const int32_t* voxel;
  const float* next_t;
  const float* dt;
  const int32_t* step;
  const float* t_exit;
  const float* t_cur;
  const float* dl_target;
  const float* dl_since;
  const float* maxd;
  const uint8_t* hunting;
  const uint8_t* resid;
  const float* ctrld;
  const float* csince;
  int32_t* o_voxel;
  float* o_next_t;
  float* o_t_cur;
  float* o_dl_target;
  float* o_dl_since;
  float* o_maxd;
  uint8_t* o_landed;
  uint8_t* o_escaped;
  float* o_ctrld;
  float* o_csince;
  int n, K, rx, ry, rz;
};

// CTRL: residual mode.  KT: K as a template argument, with the lookups
// hoisted (0: the runtime a.K, one lookup per step).
template <bool CTRL, int KT>
__global__ void __launch_bounds__(kThreads) march_kernel(const MarchArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int vx0 = __ldg(a.voxel + 3 * i), vy0 = __ldg(a.voxel + 3 * i + 1),
            vz0 = __ldg(a.voxel + 3 * i + 2);
  const float ntx0 = __ldg(a.next_t + 3 * i),
              nty0 = __ldg(a.next_t + 3 * i + 1),
              ntz0 = __ldg(a.next_t + 3 * i + 2);
  const float dtx = __ldg(a.dt + 3 * i), dty = __ldg(a.dt + 3 * i + 1),
              dtz = __ldg(a.dt + 3 * i + 2);
  const int sx = __ldg(a.step + 3 * i), sy = __ldg(a.step + 3 * i + 1),
            sz = __ldg(a.step + 3 * i + 2);
  const float t_exit = __ldg(a.t_exit + i);
  const float t_cur0 = __ldg(a.t_cur + i);
  const float dlt = __ldg(a.dl_target + i);
  const bool hunting = __ldg(a.hunting + i) != 0;
  const float resid_f = (CTRL && __ldg(a.resid + i) != 0) ? 1.0f : 0.0f;
  const float dl_since = __ldg(a.dl_since + i);
  const float maxd_in = __ldg(a.maxd + i);
  const float ctrld_in = CTRL ? __ldg(a.ctrld + i) : 0.f;
  const float csince_in = CTRL ? __ldg(a.csince + i) : 0.f;

  const int rx = a.rx, ry = a.ry, rz = a.rz;
  int vx = vx0, vy = vy0, vz = vz0;
  float ntx = ntx0, nty = nty0, ntz = ntz0;
  float s_k = t_cur0;
  bool live = hunting;
  bool landed = false;
  float cum = 0.f, t_col = 0.f, t_end = t_cur0, maj_snap = 0.f,
        maxd_last = 0.f;
  int svx = vx, svy = vy, svz = vz;
  float sntx = ntx, snty = nty, sntz = ntz;
  float cumc = 0.f, ctrl_snap = 0.f, ctrl_last = 0.f, c_land = 0.f;

  // the table cell of voxel (x, y, z), clamped into the grid
  auto cell = [&](int x, int y, int z) {
    return (min(max(z, 0), rz - 1) * ry + min(max(y, 0), ry - 1)) * rx +
           min(max(x, 0), rx - 1);
  };
  // one voxel step on the cell's majorant (and control) value
  auto step = [&](float maj_k, float ctrl_k) {
    const float end_raw = fminf(fminf(ntx, nty), ntz);
    const float end_k = fminf(end_raw, t_exit);
    const float len_k = fmaxf(end_k - s_k, 0.f);
    const bool hit_exit = end_raw >= t_exit;

    float rate_k = maj_k;
    if (CTRL) {
      ctrl_k = ctrl_k * resid_f;
      rate_k = fmaxf(maj_k - ctrl_k, 0.f);
    }

    const float len_c = fminf(len_k, kFInf);
    const float dl_k = (live && rate_k > 0.f) ? rate_k * len_c : 0.f;
    const float prev_cum = cum;
    cum = cum + dl_k;
    const bool ok = live && (dl_k > 0.f) && (cum >= dlt);
    const bool new_land = ok && !landed;
    if (new_land) {
      t_col = s_k + (dlt - prev_cum) / fmaxf(rate_k, 1e-30f);
      maj_snap = maj_k;
      svx = vx; svy = vy; svz = vz;
      sntx = ntx; snty = nty; sntz = ntz;
    }
    if (CTRL) {
      const float dc_k = live ? ctrl_k * len_c : 0.f;
      if (new_land) {
        c_land = cumc + ctrl_k * (t_col - s_k);
        ctrl_snap = ctrl_k;
      }
      cumc = cumc + dc_k;
      if (live) ctrl_last = ctrl_k;
    }
    landed = landed || ok;
    if (live) {
      maxd_last = maj_k;
      t_end = end_k;
    }

    // advance one voxel; the first minimum wins ties
    const bool is_x = (ntx <= nty) && (ntx <= ntz);
    const bool is_y = !is_x && (nty <= ntz);
    if (is_x) {
      vx += sx; ntx = ntx + dtx;
    } else if (is_y) {
      vy += sy; nty = nty + dty;
    } else {
      vz += sz; ntz = ntz + dtz;
    }
    const bool out = vx < 0 || vx >= rx || vy < 0 || vy >= ry || vz < 0 ||
                     vz >= rz;
    live = live && !hit_exit && !out;
    s_k = end_k;
  };
  if constexpr (KT > 0) {
    // the walk does not depend on the table: walk the K voxels once to
    // issue every lookup, then take the K steps on the values
    float mk[KT], ck[KT];
    int wx = vx, wy = vy, wz = vz;
    float wtx = ntx, wty = nty, wtz = ntz;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int flat = cell(wx, wy, wz);
      mk[k] = __ldg(a.maj + flat);
      ck[k] = CTRL ? __ldg(a.ctrl + flat) : 0.f;
      const bool is_x = (wtx <= wty) && (wtx <= wtz);
      const bool is_y = !is_x && (wty <= wtz);
      if (is_x) {
        wx += sx; wtx = wtx + dtx;
      } else if (is_y) {
        wy += sy; wty = wty + dty;
      } else {
        wz += sz; wtz = wtz + dtz;
      }
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) step(mk[k], ck[k]);
  } else {
    for (int k = 0; k < a.K; ++k) {
      const int flat = cell(vx, vy, vz);
      step(__ldg(a.maj + flat), CTRL ? __ldg(a.ctrl + flat) : 0.f);
    }
  }

  const bool sel = landed;
  const bool adv = hunting && !landed;
  const bool escaped = adv && !live;
  const float dl_tot = hunting ? cum : 0.f;
  a.o_voxel[3 * i] = sel ? svx : (adv ? vx : vx0);
  a.o_voxel[3 * i + 1] = sel ? svy : (adv ? vy : vy0);
  a.o_voxel[3 * i + 2] = sel ? svz : (adv ? vz : vz0);
  a.o_next_t[3 * i] = sel ? sntx : (adv ? ntx : ntx0);
  a.o_next_t[3 * i + 1] = sel ? snty : (adv ? nty : nty0);
  a.o_next_t[3 * i + 2] = sel ? sntz : (adv ? ntz : ntz0);
  a.o_t_cur[i] = sel ? t_col : (adv ? t_end : t_cur0);
  a.o_dl_target[i] = adv ? dlt - dl_tot : dlt;
  a.o_dl_since[i] = dl_since + (sel ? dlt : (adv ? dl_tot : 0.f));
  a.o_maxd[i] = sel ? maj_snap : (adv ? maxd_last : maxd_in);
  a.o_landed[i] = sel ? 1 : 0;
  a.o_escaped[i] = escaped ? 1 : 0;
  if (CTRL) {
    a.o_ctrld[i] = sel ? ctrl_snap : (adv ? ctrl_last : ctrld_in);
    a.o_csince[i] = csince_in + (sel ? c_land : (adv ? cumc : 0.f));
  }
}

template <bool CTRL, int KT>
cudaError_t launch(const MarchArgs& a, cudaStream_t stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  march_kernel<CTRL, KT><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool CTRL>
cudaError_t launch_k(const MarchArgs& a, cudaStream_t s) {
  return a.K == kMainK ? launch<CTRL, kMainK>(a, s) : launch<CTRL, 0>(a, s);
}

}  // namespace

// C entry: one launch of the march kernel on the record's stream, for the
// MarchCall record at `record`; returns the cudaError_t of the launch (0 on
// success; n == 0 launches nothing).  `device` is the CUDA device of the
// tensors and of the stream, made current for the launch only if it is not
// already.
extern "C" int avrt_march_block(const void* record) {
  const MarchCall& c = *static_cast<const MarchCall*>(record);
  if (c.n == 0) return 0;
  if (c.n < 0 || c.n > 0x7fffffffLL / 3 || c.n_table <= 0 ||   // 3 * i fits
      c.n_table > 0x7fffffffLL || c.K < 0 || c.K > 0x7fffffffLL ||
      c.rx <= 0 || c.ry <= 0 || c.rz <= 0 ||
      c.rx * c.ry * c.rz != c.n_table || c.maj == nullptr)
    return int(cudaErrorInvalidValue);
  const MarchArgs a{c.maj, c.ctrl, c.voxel, c.next_t, c.dt, c.step,
                    c.t_exit, c.t_cur, c.dl_target, c.dl_since, c.maxd,
                    c.hunting, c.resid, c.ctrld, c.csince, c.o_voxel,
                    c.o_next_t, c.o_t_cur, c.o_dl_target, c.o_dl_since,
                    c.o_maxd, c.o_landed, c.o_escaped, c.o_ctrld, c.o_csince,
                    int(c.n), int(c.K), int(c.rx), int(c.ry), int(c.rz)};
  const int device = int(c.device);
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  e = c.ctrl != nullptr ? launch_k<true>(a, c.stream)
                        : launch_k<false>(a, c.stream);
  if (current != device) {
    const cudaError_t r = cudaSetDevice(current);
    if (e == cudaSuccess) e = r;
  }
  return int(e);
}
