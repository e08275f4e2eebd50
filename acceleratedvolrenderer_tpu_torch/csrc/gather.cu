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
// Design: every thread takes four consecutive indices with one 16-byte
// load, reads their four values from the table in place through the
// read-only data cache (__ldg), and writes them with one 16-byte store.
// The table is not staged in shared memory: at the window route's size (a
// 16 KB majorant, n = 16384 * 8) staging it into each of ~264 blocks read
// four times the bytes the gather moves and put a barrier before the first
// load, while the table's lines stay in L1/L2 anyway.  The grid is
// ceil(n / 1024) blocks of 256 threads, one wave of the card at n = 131072,
// with no occupancy query.  `idx` may be a view at any 4-byte offset: the
// indices before its first 16-byte boundary (the head) and after the last
// whole vector (the tail) are done one by one by the thread after the last
// vector's, and the wrapper allocates `out` at the same offset modulo 16
// bytes as `idx`, so the body's loads and stores are aligned together.  An
// index outside [0, V) reads 0, as in the row-select kernel, where no row
// matches and the accumulator stays zero.
//
// What bounds it: 8 bytes of device memory per element (the index in, the
// value out) plus the table once, about 1 MB at the window route's sizes:
// 0.3 us at 3.35 TB/s, below a launch's own latency, so the launch bounds
// the call.  A gather moves values without arithmetic, so the kernel equals
// its plain version (ops/gather.py::table_gather_plain) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__device__ __forceinline__ float tap(const float* __restrict__ table,
                                     int n_table, int j) {
  return (unsigned)j < (unsigned)n_table ? __ldg(table + j) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ table, int n_table,
              const int32_t* __restrict__ idx, float* __restrict__ out,
              long long n, int head, long long n_vec) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n_vec) {
    const int4 j = __ldg(reinterpret_cast<const int4*>(idx + head) + i);
    const float4 v = make_float4(tap(table, n_table, j.x),
                                 tap(table, n_table, j.y),
                                 tap(table, n_table, j.z),
                                 tap(table, n_table, j.w));
    reinterpret_cast<float4*>(out + head)[i] = v;
  } else if (i == n_vec) {                 // the head and the tail
    for (int k = 0; k < head; ++k) out[k] = tap(table, n_table, idx[k]);
    for (long long k = head + kPerThread * n_vec; k < n; ++k)
      out[k] = tap(table, n_table, idx[k]);
  }
}

}  // namespace

// C entry: returns the cudaError_t of the launch (0 on success).  `idx` and
// `out` must lie at the same address modulo 16 bytes (4-byte aligned);
// `device` is the CUDA device of the tensors and of `stream`, made current
// for the launch only if it is not already.
extern "C" int avrt_table_gather(const float* table, int n_table,
                                 const int32_t* idx, float* out, long long n,
                                 int device, void* stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(idx);
  if ((a & 3) || ((a ^ reinterpret_cast<uintptr_t>(out)) & 15))
    return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long to_edge = (long long)((16 - (a & 15)) & 15) / 4;
  const int head = int(to_edge < n ? to_edge : n);
  const long long n_vec = (n - head) / kPerThread;
  const bool rest = head > 0 || (n - head) % kPerThread != 0;
  const long long threads = n_vec + (rest ? 1 : 0);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  gather_kernel<<<unsigned(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      table, n_table, idx, out, n, head, n_vec);
  e = cudaGetLastError();
  if (current != device) {
    const cudaError_t r = cudaSetDevice(current);
    if (e == cudaSuccess) e = r;
  }
  return int(e);
}
