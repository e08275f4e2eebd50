// Table gather for Hopper (sm_90a): out[i] = table[idx[i]].
//
// Replaces the Pallas TPU kernel
// acceleratedvolrenderer_tpu/ops/pallas_gather.py (_rowselect_kernel, entry
// table_gather): the (N, K) majorant window gather of the march step's
// window route (volpath_fused.py::_block_substep_xla).  Mosaic has one
// vectorized gather form, a per-row lane shuffle, so the TPU kernel loops
// over the table's 128-wide rows and masks each shuffled row in, and its
// entry serves only tables of V % 128 == 0, V <= 32^3 and index batches of
// a multiple of 128.  A thread on the card reads any address directly, so
// none of that carries over: this kernel serves every V and n.
//
// Design: one thread per output element, grid-striding over the n indices.
// Where the table fits in a block's shared memory (V * 4 bytes up to the
// opt-in limit, 227 KB on the H100, so every majorant up to 32^3 and a bit
// beyond), every block stages it first (the opt-in attribute above 48 KB)
// and the grid is at most two blocks per SM, so the table is staged at most
// 264 times per call.  A larger table is read in place through the
// read-only data cache (__ldg), as march.cu reads its large tables.  An
// index outside [0, V) reads 0, as in the row-select kernel, where no row
// matches and the accumulator stays zero.
//
// What bounds it: 8 bytes of device memory per element (the index in, the
// value out) plus, when staged, V * 4 bytes of L2 reads per block.  At the
// window route's sizes (n = N * K of a few thousand to 131072, V = 4096)
// that is well under a megabyte: launch latency bounds the call, not
// bandwidth.  A gather moves values without arithmetic, so the kernel
// equals its plain version (ops/gather.py::table_gather_plain) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxStagedBlocksPerSm = 2;
constexpr int kMaxDevices = 64;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ table, int n_table,
              const int32_t* __restrict__ idx, float* __restrict__ out,
              long long n) {
  extern __shared__ float s_table[];
  if (kStaged) {
    for (int j = threadIdx.x; j < n_table; j += blockDim.x)
      s_table[j] = table[j];
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int j = idx[i];
    float v = 0.f;
    if (j >= 0 && j < n_table) v = kStaged ? s_table[j] : __ldg(table + j);
    out[i] = v;
  }
}

struct DeviceInfo {
  int sms = 0;
  int smem_optin = 0;
};

// SM count and opt-in shared memory per block of a device, queried once.
cudaError_t device_info(int dev, DeviceInfo* info) {
  static DeviceInfo cache[kMaxDevices];
  if (dev < kMaxDevices && cache[dev].sms > 0) {
    *info = cache[dev];
    return cudaSuccess;
  }
  cudaError_t e = cudaDeviceGetAttribute(
      &info->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&info->smem_optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess && dev < kMaxDevices) cache[dev] = *info;
  return e;
}

template <bool kStaged>
cudaError_t launch(const float* table, int n_table, const int32_t* idx,
                   float* out, long long n, int sms, cudaStream_t stream) {
  const size_t smem = kStaged ? size_t(n_table) * sizeof(float) : 0;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(gather_kernel<kStaged>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_kernel<kStaged>, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) per_sm = 1;
  if (kStaged && per_sm > kMaxStagedBlocksPerSm) per_sm = kMaxStagedBlocksPerSm;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * per_sm;
  const int blocks = int(want < cap ? want : cap);
  gather_kernel<kStaged><<<blocks, kThreads, smem, stream>>>(
      table, n_table, idx, out, n);
  return cudaGetLastError();
}

}  // namespace

// C entry: returns the cudaError_t of the launch (0 on success).
extern "C" int avrt_table_gather(const float* table, int n_table,
                                 const int32_t* idx, float* out, long long n,
                                 void* stream) {
  if (n == 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  DeviceInfo info;
  e = device_info(dev, &info);
  if (e != cudaSuccess) return int(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = size_t(n_table) * sizeof(float) <= size_t(info.smem_optin);
  e = staged ? launch<true>(table, n_table, idx, out, n, info.sms, s)
             : launch<false>(table, n_table, idx, out, n, info.sms, s);
  return int(e);
}
