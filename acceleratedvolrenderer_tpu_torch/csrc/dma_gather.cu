// Per-lane tile-DMA gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/measure_gather_designs.py
// (_dma_kernel, entry dma_gather): one design of the density tap's gather
// that fetches, for every index j of a chunk, the 4 KB f32 tile
// table[tile_idx[j]] (the table viewed as (V / 1024, 8, 128)) from device
// memory into slot j % 16 of a ring of 16 tiles, and returns slot 0 of the
// ring at the end: the tile of tile_idx[j*] with
// j* = 16 * floor((chunk - 1) / 16).  On the TPU one program issues every
// fetch as an HBM->VMEM async copy with a DMA semaphore per slot, 16 in
// flight, and waits on slot j - 16 before reusing it.
//
// What bounds it: the design's fetches, distinct tiles x 4 KB over the
// card's 3.35 TB/s (about 42 MB, 12.6 us, for the 16,384 ids of the gather
// designs' chunk over the 256^3 table).  By Little's law the card needs
// about 3.35 TB/s x ~1 us, some 3 MB, in flight to reach that rate; 16
// tiles from one program are 64 KB, so on one SM the design is latency
// bound at tens of GB/s.  Hence a ring per SM here, not one ring: the
// chunk is cut into `blocks` contiguous slices of `per` ids (the wrapper,
// ops/dma_gather.py::launch_geometry, sizes them to about one block per
// SM), and every block keeps its own 16-slot ring (64 KB of dynamic
// shared memory, above the 48 KB default, so the opt-in attribute is set
// once per device) with one mbarrier per slot, 16 x 4 KB in flight per
// block, 8 MB over the card.
//
// In a block: the whole block stages its slice's ids into shared memory.
// Then 16 warps issue the copies, one per slot (a lane spinning on its
// barrier holds its warp, so no slot waits behind another): the elected
// lane of warp w takes the ids j with j % 16 == w, whose slot w is its
// own, in order: before reusing the slot it waits on the slot's barrier
// for the previous copy (parity tracked by that lane), then issues a 1-D
// bulk copy (cp.async.bulk, the Tensor Memory Accelerator's bulk form) of
// 4096 bytes that completes on the slot's barrier (expect_tx /
// complete_tx).  An id outside the table issues no copy, so
// nothing outside the table is read.  Every block drains its copies
// before it ends.  j* is the chunk's last multiple of 16, so no later id
// reuses slot 0: the block whose slice holds j* waits, with every thread,
// on slot 0's last phase (which makes the copy's bytes visible to all) and
// writes that tile out, or zeros when j*'s id is out of range.  No other
// block writes, so no grid-wide synchronisation or atomics are needed.  A
// copy moves bytes without arithmetic, so the output equals the plain
// version (ops/dma_gather.py::dma_gather_plain) bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 16;
constexpr int kTileFloats = 8 * 128;
constexpr unsigned kTileBytes = kTileFloats * sizeof(float);
constexpr int kThreads = 32 * kSlots;      // a warp issuing into each slot
constexpr int kMaxPer = 1024;             // ids staged per block
constexpr size_t kRingBytes = kSlots * kTileBytes + kSlots * sizeof(uint64_t);
constexpr size_t kMaxSmemBytes = kRingBytes + kMaxPer * sizeof(int32_t);
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
                  const int32_t* __restrict__ idx, int chunk, int per,
                  float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kSlots * kTileBytes);
  int32_t* ids = reinterpret_cast<int32_t*>(smem + kRingBytes);
  __shared__ unsigned s_parity0;   // parity of slot 0's last phase

  const int start = blockIdx.x * per;
  const int n = min(per, chunk - start);
  const int j_star = kSlots * ((chunk - 1) / kSlots);
  const bool owner = j_star >= start && j_star < start + n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < n; i += kThreads) ids[i] = idx[start + i];
  __syncthreads();

  const int slot = threadIdx.x / 32;   // this warp's slot
  if (threadIdx.x % 32 == 0) {
    uint64_t* bar = &bars[slot];
    bool pending = false;   // a copy into the slot is in flight
    unsigned parity = 0;    // parity of the slot's next phase
    for (int i = (slot - start % kSlots + kSlots) % kSlots; i < n;
         i += kSlots) {                   // ids j = start + i, j % 16 == slot
      if (pending) {                      // reclaim the slot
        mbar_wait(bar, parity);
        parity ^= 1u;
        pending = false;
      }
      const long long t = ids[i];
      if (t >= 0 && t < n_tiles) {
        mbar_expect_tx(bar, kTileBytes);
        bulk_copy_g2s(ring + slot * kTileFloats, table + t * kTileFloats,
                      kTileBytes, bar);
        pending = true;
      }
    }
    if (pending) {                        // drain
      mbar_wait(bar, parity);
      parity ^= 1u;
    }
    // slot 0's last completed phase has the parity before the last flip
    if (slot == 0) s_parity0 = parity ^ 1u;
  }
  __syncthreads();

  if (!owner) return;
  const long long t = ids[j_star - start];
  const bool inside = t >= 0 && t < n_tiles;
  if (inside) mbar_wait(&bars[0], s_parity0);   // observe the copy
  const float4* src = reinterpret_cast<const float4*>(ring);
  float4* dst = reinterpret_cast<float4*>(out);
  for (int i = threadIdx.x; i < kTileFloats / 4; i += kThreads)
    dst[i] = inside ? src[i] : make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace

// C entry: returns the cudaError_t of the launch (0 on success).  The grid
// is `blocks` blocks of `per` ids each (per <= 1024, blocks * per >= chunk
// > (blocks - 1) * per).  `device` is the CUDA device of the tensors and
// of `stream`, made current for the launch only if it is not already.
extern "C" int avrt_dma_gather(const float* table, long long n_tiles,
                               const int32_t* idx, int chunk, int per,
                               int blocks, float* out, int device,
                               void* stream) {
  if (chunk < 1 || per < 1 || per > kMaxPer || blocks < 1 ||
      (long long)blocks * per < chunk || (long long)(blocks - 1) * per >= chunk)
    return int(cudaErrorInvalidValue);
  static bool attr_set[kMaxDevices] = {};
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return int(e);
  if (device >= kMaxDevices || !attr_set[device]) {
    e = cudaFuncSetAttribute(dma_gather_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(kMaxSmemBytes));
    if (e == cudaSuccess && device < kMaxDevices) attr_set[device] = true;
  }
  if (e == cudaSuccess) {
    const size_t smem = kRingBytes + size_t(per) * sizeof(int32_t);
    dma_gather_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        table, n_tiles, idx, chunk, per, out);
    e = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t r = cudaSetDevice(current);
    if (e == cudaSuccess) e = r;
  }
  return int(e);
}
