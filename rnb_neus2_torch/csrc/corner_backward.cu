// The training encode's K-corner backward: per sample and level, K of the
// 8 corners drawn in proportion to the magnitude of their cotangent, each
// added into the table gradient scaled by 1/(K·p).
//
// Replaces the "stoch" branch of the JAX package's enc_bwd
// (rnb_neus2_tpu/ops/hash_encoding.py:689-740), which XLA compiles into
// selects and width-1 `.at[].add` scatters; the TPU ran no Pallas kernel
// there. Per sample n and level l < La, with unlock mask m and lattice
// scale s (the corner arithmetic is hash_corners.cuh's):
//
//   go = g_out[n, lF:lF+F]·m;   gj_d = g_jac_d[n, lF:lF+F]·float32(s·m)
//   src_c = ((w_c·go + dw_{c,0}·gj_0) + dw_{c,1}·gj_1) + dw_{c,2}·gj_2
//   mags_c = Σ_f |src_{c,f}| + float32(1e-20);  total = Σ_c mags_c
//   p_c = mags_c · (1/total);  cdf_c = p_0 + ... + p_c
//   for each of K draws u (the position hash, stream salt·La + l):
//     choice = #{c < 7 : u ≥ cdf_c}
//     g_table[offset_l + row_choice] += src_choice · (1/(K·p_choice))
//
// every float operation in the plain version's order and rounding (no
// fused multiply-adds), so that every pick is the plain version's. Its
// plain twin is kernels/corner_backward.py's `plain_into`
// (level_corner_cotangents + pick_corners + index_add_, level by level).
//
// Design. One launch per backward: one thread per (sample, level),
// grid.y = the level (La), 256 threads a block along the samples. A
// thread holds its 8 corners' cotangents, probabilities and rows in
// registers (F is a template parameter: 1, 2, 4 or 8) and draws its K
// picks one after another. Each pick is added as warp_scatter.cuh adds an
// element: lanes of a warp that picked the same row sum their values
// first and the lowest adds the sum, with one 64-bit float2 reduction per
// pair of features (F even) or one 32-bit atomic per feature (F = 1); a
// pick whose values are all zero (a locked level, a padded sample) adds
// nothing. Neighbouring samples lie along one ray, so coarse levels pick
// the same row within a warp: at level 0, 2^18 picks land on 4,096 rows.
// Float atomics make the order of the sums, and so the last bits, vary
// from run to run. An optional (La, K, N) int8 output records every
// choice (tests and chip_smoke.py).
//
// Bound. Bytes: the positions (12 B a sample) and the four cotangents
// (4·F B a sample and level, each) read once, and each table-gradient
// row that a pick touches written once (chip_smoke.py counts them on the
// main path's inputs); the zeroing of the whole gradient is the
// wrapper's. Operations: ~250 float32 operations per (sample, level) and
// K draws, far under 67 TFLOP/s. So the kernel is bound by bytes; atomics
// on random rows sit above that bound, each its own transaction in L2.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The launcher
// returns the cudaError_t of the launch, or cudaErrorInvalidValue for
// arguments it refuses (the wrapper checks them first); the caller raises
// if it is not 0.

#include <cuda_runtime.h>

#include <cstring>

#include "hash_corners.cuh"
#include "warp_scatter.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPicks = 16;
// float32(1e-20), as the plain version's `mags + 1e-20` rounds it
constexpr float kTiny = 0x1.79ca1p-67f;

template <int F>
__global__ void __launch_bounds__(kThreads)
corner_backward_kernel(const float* __restrict__ pos,
                       const float* __restrict__ g_out,
                       const float* __restrict__ gjx,
                       const float* __restrict__ gjy,
                       const float* __restrict__ gjz,
                       float* __restrict__ g_table,
                       signed char* __restrict__ choices, long long n, int L,
                       int K, const __grid_constant__ Levels lv) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int lvl = blockIdx.y;
  const bool live = i < n;
  const LevelConst& lc = lv.l[lvl];
  float src[8][F], ps[8], cdf[7];
  int row[8];
  uint32_t base = 0;
  if (live) {
    const float x[3] = {__ldg(pos + 3 * i), __ldg(pos + 3 * i + 1),
                        __ldg(pos + 3 * i + 2)};
    Corners c;
    level_corners(x, lc, c);
    const long long o = i * (long long)(L * F) + lvl * F;
    float go[F], gj[3][F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      go[f] = __fmul_rn(__ldg(g_out + o + f), lc.m);
      gj[0][f] = __fmul_rn(__ldg(gjx + o + f), lc.scale_m);
      gj[1][f] = __fmul_rn(__ldg(gjy + o + f), lc.scale_m);
      gj[2][f] = __fmul_rn(__ldg(gjz + o + f), lc.scale_m);
    }
    float mags[8], total = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float mag = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float s = __fmul_rn(c.w[k], go[f]);
#pragma unroll
        for (int d = 0; d < 3; ++d)
          s = __fadd_rn(s, __fmul_rn(c.dw[k][d], gj[d][f]));
        src[k][f] = s;
        mag = f ? __fadd_rn(mag, fabsf(s)) : fabsf(s);
      }
      mags[k] = __fadd_rn(mag, kTiny);
      total = k ? __fadd_rn(total, mags[k]) : mags[k];
      row[k] = lc.offset + c.idx[k];
    }
    const float inv_total = __fdiv_rn(1.0f, total);
#pragma unroll
    for (int k = 0; k < 8; ++k) ps[k] = __fmul_rn(mags[k], inv_total);
    cdf[0] = ps[0];
#pragma unroll
    for (int k = 1; k < 7; ++k) cdf[k] = __fadd_rn(cdf[k - 1], ps[k]);
    base = position_hash(x);
  }
  for (int j = 0; j < K; ++j) {
    float val[F];
    int key = -1;
#pragma unroll
    for (int f = 0; f < F; ++f) val[f] = 0.0f;
    if (live) {
      const float u = draw(base, lc.stream, K, j);
      int choice = 0;
#pragma unroll
      for (int k = 0; k < 7; ++k) choice += u >= cdf[k];
      if (choices)
        choices[((long long)lvl * K + j) * n + i] = (signed char)choice;
      float p = 0.0f;
      int r = -1;
      // a select per corner: a register array indexed by `choice` would
      // live in local memory
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k == choice) {
          p = ps[k];
          r = row[k];
#pragma unroll
          for (int f = 0; f < F; ++f) val[f] = src[k][f];
        }
      }
      const float inv = __fdiv_rn(1.0f, __fmul_rn((float)K, p));
      bool nonzero = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        val[f] = __fmul_rn(val[f], inv);
        nonzero |= val[f] != 0.0f;
      }
      key = nonzero ? r : -1;
    }
    const WarpGroup g = warp_group(key, lane);
    group_sum(val, g.rest, lane);
    if (g.leader) {
      float* dst = g_table + (long long)key * F;
      if constexpr (F % 2 == 0) {
#pragma unroll
        for (int f = 0; f < F; f += 2)
          if (val[f] != 0.0f || val[f + 1] != 0.0f)
            red_add2(dst + f, val[f], val[f + 1]);
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f)
          if (val[f] != 0.0f) atomicAdd(dst + f, val[f]);
      }
    }
  }
}

}  // namespace

extern "C" {

// pos: (n, 3) float32; g_out, gjx, gjy, gjz: (n, L·F) float32; g_table:
// (rows, F) float32, zeroed by the caller, 8-byte aligned; choices: null
// or (La, K, n) int8; all contiguous. levels: La LevelConst on the host.
// Launches on `stream` and returns cudaGetLastError().
int corner_backward_launch(const void* pos, const void* g_out,
                           const void* gjx, const void* gjy, const void* gjz,
                           void* g_table, void* choices, long long n, int L,
                           int La, int F, int K, const void* levels,
                           void* stream) {
  if (n <= 0 || La == 0) return 0;
  if (La < 0 || La > L || L > kMaxLevels || K < 1 || K > kMaxPicks)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  std::memset(&lv, 0, sizeof(lv));
  std::memcpy(lv.l, levels, sizeof(LevelConst) * La);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)La);
  cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* go = (const float*)g_out;
  const float *x = (const float*)gjx, *y = (const float*)gjy,
              *z = (const float*)gjz;
  float* t = (float*)g_table;
  signed char* ch = (signed char*)choices;
  switch (F) {
    case 1: corner_backward_kernel<1><<<grid, kThreads, 0, s>>>(
        p, go, x, y, z, t, ch, n, L, K, lv); break;
    case 2: corner_backward_kernel<2><<<grid, kThreads, 0, s>>>(
        p, go, x, y, z, t, ch, n, L, K, lv); break;
    case 4: corner_backward_kernel<4><<<grid, kThreads, 0, s>>>(
        p, go, x, y, z, t, ch, n, L, K, lv); break;
    case 8: corner_backward_kernel<8><<<grid, kThreads, 0, s>>>(
        p, go, x, y, z, t, ch, n, L, K, lv); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* corner_backward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
