// The tile pipeline shared by the training encode's two kernels
// (encode_jacobian.cu, corner_backward.cu): Hopper's bulk asynchronous
// copies (the TMA's 1-D form, `cp.async.bulk`) between device memory and
// shared memory, completing on an `mbarrier` (loads) or a bulk group
// (stores), and the shared-memory layout of a tile.
//
// A tile is T consecutive samples (T a multiple of 32, from the wrappers'
// hash_corners.py:tile_plan). A stage of shared memory holds the tile's
// positions (T·3 floats) and four (T, L·F) blocks: the forward's four
// outputs, or the backward's four cotangents. Each block is T·L·F·4
// contiguous bytes of a row-major (N, L·F) tensor, so one bulk copy moves
// it. Two stages (or one, where two do not fit) follow kBarrierBytes of
// mbarriers. A bulk copy needs 16-byte aligned addresses and a size that
// is a multiple of 16: every full tile of 16-byte aligned tensors meets
// that; the ragged last tile, and every tile of a misaligned tensor, is
// moved by the block's threads with plain loads and stores instead.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kBarrierBytes = 128;  // two 8-byte mbarriers, padded
// dynamic shared memory a block may use on sm_90 (227 KB)
constexpr int kMaxSharedBytes = 232448;

// Bytes of one stage of T samples with L·F features per level.
__host__ __device__ __forceinline__ long long stage_bytes(int T, int LF) {
  return (long long)T * (3 + 4 * LF) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (the TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects `bytes` of bulk copies on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// L2 eviction policies: the streams a kernel reads or writes once leave
// L2 first, so that they do not push out the hash table that its gathers
// read again (the table is 42 MB at the default config, the L2 50 MB, a
// K = 1 step's four (N, L·F) tensors 117 MB). Both kernels measured
// faster with them than without on an NVIDIA H100 (PERF.md §6).
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// Bulk copy of `bytes` from device memory into shared memory, counted on
// `bar`'s transaction count; read once, so evicted from L2 first.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(l2_evict_first())
      : "memory");
}

// Bulk copy of `bytes` from shared memory into device memory, in the
// calling thread's open bulk group; evicted from L2 first.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes), "l"(l2_evict_first())
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N of the calling thread's bulk groups still read
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Wait until every bulk group of the calling thread has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Orders the calling thread's shared-memory writes before later bulk
// copies (the async proxy) read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
}

// The grid of a persistent kernel that walks `tiles` tiles: as many
// blocks of `threads` as the card holds at once with `smem` bytes of
// dynamic shared memory each (set here as the kernel's limit), at most
// one per tile.
template <typename Kernel>
__host__ cudaError_t persistent_grid(Kernel kernel, int threads, int smem,
                                     long long tiles, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  const long long most = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (unsigned)(tiles < most ? tiles : most);
  return e;
}
