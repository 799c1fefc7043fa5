// Scatter-add of (n, F) float rows into an (S, F) table with global
// atomics: the table gradient of every hash-grid level that the
// cluster-shared kernel (hash_grad_small.cu) does not take.
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
//     out[S, F] += sum over elements e with 0 <= idx[e] < S of
//                  v[e, :] added into row idx[e];  other indices are dropped.
//
// It adds in place into `out`, a contiguous (S, F) view that the caller
// owns: on the training path, one level's rows of the table gradient,
// which is zeroed once for all levels. An entry that no element touches
// keeps its bits (0.0 there, which the sparse Adam of the optimizer relies
// on). On that path F = 2 and S is 2^19 (the hashed levels 5-13) or a dense
// table of 39,304, 125,000 or 373,248 rows (levels 2-4): 314 KB to 4 MB,
// more than a cluster's shared memory holds. n is 2^18 per level with one
// stochastic corner per sample (stoch_corner_bwd = 1, the default) and
// 2^21 with the exact 8.
//
// Design.
// - The element walk of warp_scatter.cuh: each warp takes tiles of
//   4 x 32 consecutive elements with all their loads in flight before any
//   add; equal rows within a warp are summed first (warp aggregation) and
//   their lowest lane adds the sum with one atomic; zero values and indices
//   outside [0, S) add nothing. The grid is sized from n: one tile per
//   warp, up to the 8 blocks of 256 threads that one SM holds, and warps
//   loop over further tiles past that.
// - For even F, with `out` and `v` 8-byte aligned, each add is one 64-bit
//   vector reduction per pair of features (sm_90's float2 atomicAdd,
//   RED.E.ADD.F32x2 in L2) instead of two 32-bit ones into the same 8
//   bytes. F = 1, odd F and misaligned views take the scalar path of the
//   same kernel: one 32-bit atomicAdd per feature.
// - The zero skip matters on the training path: the sample buffer is
//   padded past its valid samples with slots that all sit at one position,
//   and their zero cotangents would otherwise land on one row per level:
//   tens of thousands of atomics on one address, which serialize.
// Float atomics make the order of the sums, and so the last bits, vary
// from run to run: warps reach a row in no fixed order.
//
// Bound. Each input is read once and the output written once:
// n·(4 + 4F) + S·F·4 bytes; in place, the S·F·4 term stands for the
// level's share of the one fill of the whole table gradient. At n = 2^18,
// F = 2, S = 2^19 that is 2^18·12 + 2^19·8 B ≈ 7.3 MB, ≈ 2.2 µs at
// 3.35 TB/s; at n = 2^21 it is ≈ 29.4 MB, ≈ 8.8 µs. The n·F float adds take
// ≈ 0.01 µs at 67 TFLOP/s, so the kernel is bound by bytes. Atomics on
// random rows of a table in L2 sit above that bound: each is a separate
// 8-byte (or 4-byte) transaction. What an in-place launch itself must
// move is less: the inputs, and a read and a write of each row it adds to
// (chip_smoke.py's `bound_into_ms`, against which `ms_into` is held).
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The launcher
// returns the cudaError_t of the launch; the caller raises if it is not 0.

#include <cuda_runtime.h>

#include "warp_scatter.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2048 / kThreads;

template <int Load>
__device__ __forceinline__ void scatter_warp(const int* __restrict__ idx,
                                             const float* __restrict__ v,
                                             float* __restrict__ out,
                                             long long n, int S, int F) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long base = warp * kTile; base < n; base += warps * kTile)
    scatter_tile<Load>(
        idx, v, n, S, F, base, lane,
        [&](int r, int f, float s) {
          atomicAdd(out + (long long)r * F + f, s);
        },
        [&](int r, int f, float a, float b) {
          red_add2(out + (long long)r * F + f, a, b);
        });
}

// `load`: value_load(F, v, out), the same for every warp.
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int* __restrict__ idx, const float* __restrict__ v,
                   float* __restrict__ out, long long n, int S, int F,
                   int load) {
  switch (load) {
    case kTwo: scatter_warp<kTwo>(idx, v, out, n, S, F); break;
    case kOne: scatter_warp<kOne>(idx, v, out, n, S, F); break;
    case kPairs: scatter_warp<kPairs>(idx, v, out, n, S, F); break;
    default: scatter_warp<kScalar>(idx, v, out, n, S, F);
  }
}

}  // namespace

extern "C" {

// Add into `out` on `stream`. idx: (n,) int32; v: (n, F) float32
// row-major; out: (S, F) float32, contiguous. `sms`: the device's SM
// count. Returns cudaGetLastError() after the launch.
int scatter_add_launch(const void* idx, const void* v, void* out,
                       long long n, int S, int F, int sms, void* stream) {
  if (n <= 0 || F <= 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long need = (tiles + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  scatter_add_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)v, (float*)out, n, S, F,
      value_load(F, v, out));
  return (int)cudaGetLastError();
}

const char* scatter_add_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
