// Per-lane tile-DMA gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/measure_gather_designs.py
// (_dma_kernel, entry dma_gather): one design of the density tap's gather
// that fetches, for every index j of a chunk, the 4 KB f32 tile
// table[tile_idx[j]] (the table viewed as (V / 1024, 8, 128)) from device
// memory into slot j % 16 of a ring of 16 tiles, 16 copies in flight, and
// returns slot 0 of the ring at the end: the tile of tile_idx[j*] with
// j* = 16 * floor((chunk - 1) / 16).  On the TPU each fetch is an
// HBM->VMEM async copy with a DMA semaphore per slot; the kernel waits on
// slot j - 16 before reusing it.
//
// Design, the direct Hopper counterpart: one block, as the TPU runs one
// program.  One elected thread issues each fetch as a 1-D bulk copy
// (cp.async.bulk, the Tensor Memory Accelerator's bulk form) of 4096
// bytes into a 16 x 4 KB ring in dynamic shared memory (64 KB, above the
// 48 KB default, so the launch sets the opt-in attribute), with one
// mbarrier per slot that counts the copy's bytes (expect_tx /
// complete_tx); before reusing slot s it waits on that slot's barrier, as
// the TPU kernel waits on the slot's semaphore.  The indices are read by
// the whole first warp, 32 at a time, and handed to the issuing lane by
// shuffles, so their loads do not serialise behind the copies.  An index
// outside the table issues no copy and marks the slot as zeros, so the
// kernel never reads outside the table.  At the end every thread waits on
// slot 0's last phase and the block writes the tile out.
//
// What bounds it: the copies.  One thread keeps 16 x 4 KB in flight, so
// the rate is 64 KB per round-trip latency of device memory (about a
// microsecond), tens of GB/s against the card's 3.35 TB/s: the design is
// latency bound, far from its byte bound (distinct tiles x 4 KB).
// Spreading the fetches over blocks on many SMs is the redesign that would
// approach it.  A copy moves bytes without arithmetic, so the output
// equals the plain version (ops/dma_gather.py::dma_gather_plain) bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 16;
constexpr int kTileFloats = 8 * 128;
constexpr unsigned kTileBytes = kTileFloats * sizeof(float);
constexpr int kThreads = 128;
constexpr size_t kSmemBytes = kSlots * kTileBytes + kSlots * sizeof(uint64_t);
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// 1-D bulk copy global -> shared that signals `bar` with its byte count.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
dma_gather_kernel(const float* __restrict__ table, long long n_tiles,
                  const int32_t* __restrict__ idx, int chunk,
                  float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kSlots * kTileBytes);
  __shared__ unsigned s_slot0;   // bit 0: slot 0 copied, bit 1: its parity,
                                 // bit 2: slot 0 holds zeros

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned pending = 0;   // bit s: a copy into slot s is in flight
    unsigned parity = 0;    // bit s: parity of slot s's next phase
    unsigned zero = 0;      // bit s: slot s holds zeros
    unsigned copied0 = 0;   // slot 0 received a copy at least once
    for (int j0 = 0; j0 < chunk; j0 += 32) {
      const int mine = (j0 + lane < chunk) ? idx[j0 + lane] : -1;
      const int n = chunk - j0 < 32 ? chunk - j0 : 32;
      for (int k = 0; k < n; ++k) {
        const long long t = __shfl_sync(0xffffffffu, mine, k);
        if (lane == 0) {
          const int s = (j0 + k) % kSlots;
          const unsigned bit = 1u << s;
          if (pending & bit) {               // reclaim the slot
            mbar_wait(&bars[s], (parity >> s) & 1u);
            parity ^= bit;
            pending &= ~bit;
          }
          if (t >= 0 && t < n_tiles) {
            mbar_expect_tx(&bars[s], kTileBytes);
            bulk_copy_g2s(ring + s * kTileFloats, table + t * kTileFloats,
                          kTileBytes, &bars[s]);
            pending |= bit;
            zero &= ~bit;
            if (s == 0) copied0 = 1;
          } else {
            zero |= bit;
          }
        }
      }
    }
    if (lane == 0) {
      for (int s = 0; s < kSlots; ++s) {     // drain
        if (pending & (1u << s)) {
          mbar_wait(&bars[s], (parity >> s) & 1u);
          parity ^= 1u << s;
        }
      }
      // slot 0's last completed phase has the parity before the last flip
      s_slot0 = copied0 | (((parity & 1u) ^ 1u) << 1) | ((zero & 1u) << 2);
    }
  }
  __syncthreads();

  const unsigned st = s_slot0;
  if (st & 1u) mbar_wait(&bars[0], (st >> 1) & 1u);   // observe the copy
  const bool zeros = (st >> 2) & 1u;
  const float4* src = reinterpret_cast<const float4*>(ring);
  float4* dst = reinterpret_cast<float4*>(out);
  for (int i = threadIdx.x; i < kTileFloats / 4; i += blockDim.x)
    dst[i] = zeros ? make_float4(0.f, 0.f, 0.f, 0.f) : src[i];
}

}  // namespace

// C entry: returns the cudaError_t of the launch (0 on success).
extern "C" int avrt_dma_gather(const float* table, long long n_tiles,
                               const int32_t* idx, int chunk, float* out,
                               void* stream) {
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    e = cudaFuncSetAttribute(dma_gather_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kSmemBytes));
    if (e != cudaSuccess) return int(e);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  dma_gather_kernel<<<1, kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      table, n_tiles, idx, chunk, out);
  return int(cudaGetLastError());
}
