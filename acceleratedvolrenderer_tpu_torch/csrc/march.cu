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
// Design for the card, not a block-by-block copy of the TPU kernel:
//  * one thread per lane, reading the integrator's registers in place:
//    voxel / next_t / dt / step as (N, 3), everything else as (N,);
//  * the majorant is float32 throughout.  The TPU kernel's bf16 round-up /
//    round-down and one-hot MXU gather existed only for the MXU;
//  * tables that fit (16^3 = 16 KB, 32^3 = 128 KB, both tables together at
//    most 227 KB) are staged once per block in dynamic shared memory;
//    larger ones (64^3 = 1 MB) are read through __ldg and sit in L2.
//
// What bounds it: per lane per call about 92 B are read and 52 B written,
// plus K table lookups in shared memory.  At the render's N = 16384 lanes
// that is 64 blocks of 256 threads on 132 SMs, so launch and latency bound
// the call, not bandwidth.
//
// Built with -fmad=false so every float32 operation rounds as the eager
// PyTorch version (ops/march.py::march_block_plain) rounds it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFInf = 3.0e38f;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;   // 227 KB usable by one block

struct MarchArgs {
  const float* maj;
  const float* ctrl;
  int n_table;
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
  int32_t* o_flags;
  float* o_ctrld;
  float* o_csince;
  int n;
  int K;
  int rx, ry, rz;
};

template <bool SMEM>
__device__ __forceinline__ float lookup(const float* t, int i) {
  if (SMEM) return t[i];
  return __ldg(t + i);
}

template <bool CTRL, bool SMEM>
__global__ void __launch_bounds__(kThreads) march_kernel(MarchArgs a) {
  extern __shared__ float smem[];
  const float* maj = a.maj;
  const float* ctl = a.ctrl;
  if (SMEM) {
    for (int j = threadIdx.x; j < a.n_table; j += blockDim.x) {
      smem[j] = a.maj[j];
      if (CTRL) smem[a.n_table + j] = a.ctrl[j];
    }
    __syncthreads();
    maj = smem;
    ctl = smem + a.n_table;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;

  const int rx = a.rx, ry = a.ry, rz = a.rz;
  const int vx0 = a.voxel[3 * i], vy0 = a.voxel[3 * i + 1],
            vz0 = a.voxel[3 * i + 2];
  const float ntx0 = a.next_t[3 * i], nty0 = a.next_t[3 * i + 1],
              ntz0 = a.next_t[3 * i + 2];
  const float dtx = a.dt[3 * i], dty = a.dt[3 * i + 1], dtz = a.dt[3 * i + 2];
  const int sx = a.step[3 * i], sy = a.step[3 * i + 1], sz = a.step[3 * i + 2];
  const float t_exit = a.t_exit[i];
  const float t_cur0 = a.t_cur[i];
  const float dlt = a.dl_target[i];
  const bool hunting = a.hunting[i] != 0;
  const float resid_f = (CTRL && a.resid[i] != 0) ? 1.0f : 0.0f;

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

  for (int k = 0; k < a.K; ++k) {
    const float end_raw = fminf(fminf(ntx, nty), ntz);
    const float end_k = fminf(end_raw, t_exit);
    const float len_k = fmaxf(end_k - s_k, 0.f);
    const bool hit_exit = end_raw >= t_exit;

    const int cx = min(max(vx, 0), rx - 1);
    const int cy = min(max(vy, 0), ry - 1);
    const int cz = min(max(vz, 0), rz - 1);
    const int flat = (cz * ry + cy) * rx + cx;
    const float maj_k = lookup<SMEM>(maj, flat);
    float ctrl_k = 0.f, rate_k = maj_k;
    if (CTRL) {
      ctrl_k = lookup<SMEM>(ctl, flat) * resid_f;
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
  a.o_dl_since[i] = a.dl_since[i] + (sel ? dlt : (adv ? dl_tot : 0.f));
  a.o_maxd[i] = sel ? maj_snap : (adv ? maxd_last : a.maxd[i]);
  a.o_flags[i] = (sel ? 1 : 0) + (escaped ? 2 : 0);
  if (CTRL) {
    a.o_ctrld[i] = sel ? ctrl_snap : (adv ? ctrl_last : a.ctrld[i]);
    a.o_csince[i] = a.csince[i] + (sel ? c_land : (adv ? cumc : 0.f));
  }
}

template <bool CTRL, bool SMEM>
cudaError_t launch(const MarchArgs& a, cudaStream_t stream) {
  const size_t smem =
      SMEM ? size_t(a.n_table) * sizeof(float) * (CTRL ? 2 : 1) : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        march_kernel<CTRL, SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (a.n + kThreads - 1) / kThreads;
  march_kernel<CTRL, SMEM><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry: returns the cudaError_t of the launch (0 on success).
extern "C" int avrt_march_block(
    const float* maj, const float* ctrl, int n_table,
    const int32_t* voxel, const float* next_t, const float* dt,
    const int32_t* step, const float* t_exit, const float* t_cur,
    const float* dl_target, const float* dl_since, const float* maxd,
    const uint8_t* hunting, const uint8_t* resid, const float* ctrld,
    const float* csince, int32_t* o_voxel, float* o_next_t, float* o_t_cur,
    float* o_dl_target, float* o_dl_since, float* o_maxd, int32_t* o_flags,
    float* o_ctrld, float* o_csince, int n, int K, int rx, int ry, int rz,
    int use_ctrl, void* stream) {
  if (n == 0) return 0;
  MarchArgs a{maj, ctrl, n_table, voxel, next_t, dt, step, t_exit, t_cur,
              dl_target, dl_since, maxd, hunting, resid, ctrld, csince,
              o_voxel, o_next_t, o_t_cur, o_dl_target, o_dl_since, o_maxd,
              o_flags, o_ctrld, o_csince, n, K, rx, ry, rz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t need = size_t(n_table) * sizeof(float) * (use_ctrl ? 2 : 1);
  const bool smem = need <= kMaxSmem;
  cudaError_t e;
  if (use_ctrl) {
    e = smem ? launch<true, true>(a, s) : launch<true, false>(a, s);
  } else {
    e = smem ? launch<false, true>(a, s) : launch<false, false>(a, s);
  }
  return int(e);
}
