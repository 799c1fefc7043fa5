// Scatter-add of (n, F) float rows into an (S, F) table with global
// atomics: the table gradient of every hash-grid level that the
// shared-memory kernel (hash_grad_small.cu) does not take.
//
// Replaces the five TPU scatter-add probes, which time the same function
// at the sizes of the hashed levels in TPU layouts:
//   tools/profiling/_bench_pallas.py:33       bench_scalar_loop   (F = 1)
//   tools/profiling/_bench_pallas.py:78       bench_onehot_mxu    (F = 2)
//   tools/profiling/_bench_pallas2.py:35      bench               (F = 1)
//   tools/profiling/_bench_primitives.py:168  bench_pallas_onehot (F = 2)
//   tools/profiling/_bench_primitives.py:241  bench_pallas_scalar (F = 1)
// and, on the training path, the width-1 `.at[idx].add` scatters of the
// JAX package's encode backward (rnb_neus2_tpu/ops/hash_encoding.py,
// modes "stoch" and "width1"):
//
//     out[S, F] = sum over elements e with 0 <= idx[e] < S of
//                 v[e, :] added into row idx[e];  other indices are dropped.
//
// On the training path at the default config F = 2 and S is 2^19 (the
// hashed levels 5-13) or a dense table of 39,304, 125,000 or 373,248 rows
// (levels 2-4): 314 KB to 4 MB, over one block's 227 KB of shared memory,
// which is why the table is not privatized per block as in
// hash_grad_small.cu. n is 2^18 per level with one stochastic corner per
// sample (stoch_corner_bwd = 1, the default) and 2^21 with the exact 8.
//
// Design. The simplest form: a grid-stride loop over the elements, one
// global atomicAdd per element and feature (its result is unused, so it
// compiles to a fire-and-forget reduction in L2). The caller zeroes `out`;
// an entry that no element touches stays exactly 0.0, which the sparse
// Adam of the optimizer relies on. Float atomics make the order of the
// sums, and so the last bits, vary from run to run.
//
// Zero values are skipped. Adding 0.0 leaves an entry bit for bit as it
// was (entries start at +0.0 and a sum never rounds to -0.0), so the result
// is the same; but on the training path the sample buffer is padded past
// its valid samples with slots that all sit at one position, and their
// zero cotangents would otherwise land on one row per level: tens of
// thousands of atomics on one address, which serialize (measured 0.22 ms
// per launch at n = 2^18 instead of 0.01 ms).
//
// Bound. Each input is read once and the output written once:
// n·(4 + 4F) + S·F·4 bytes. At n = 2^18, F = 2, S = 2^19 that is
// 2^18·12 + 2^19·8 B ≈ 7.3 MB, ≈ 2.2 µs at 3.35 TB/s; at n = 2^21 it is
// ≈ 29.4 MB, ≈ 8.8 µs. The n·F float adds take ≈ 0.01 µs at 67 TFLOP/s,
// so the kernel is bound by bytes. Atomics on random rows of a table larger
// than a cache line per element will sit well above that bound; warp
// aggregation of equal indices, float2 atomics on sm_90 or sorting are
// later work.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The launcher
// returns the cudaError_t of the launch; the caller raises if it is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_add_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ v,
                                   float* __restrict__ out,
                                   long long n, int S, int F) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n; e += stride) {
    const int row = idx[e];
    if ((unsigned)row < (unsigned)S) {   // drops negatives and rows >= S
      const float* src = v + e * F;
      float* dst = out + (long long)row * F;
      for (int f = 0; f < F; ++f) {
        const float x = src[f];
        if (x != 0.0f) atomicAdd(dst + f, x);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. idx: (n,) int32; v: (n, F) float32 row-major;
// out: (S, F) float32, zeroed by the caller. At most `max_blocks` blocks
// of 256 threads (the caller passes a few per SM). Returns
// cudaGetLastError() after the launch.
int scatter_add_launch(const void* idx, const void* v, void* out,
                       long long n, int S, int F, int max_blocks,
                       void* stream) {
  if (n <= 0) return 0;
  const long long need = (n + kThreads - 1) / kThreads;
  const unsigned blocks =
      (unsigned)(need < max_blocks ? need : (long long)max_blocks);
  scatter_add_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)v, (float*)out, n, S, F);
  return (int)cudaGetLastError();
}

const char* scatter_add_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
