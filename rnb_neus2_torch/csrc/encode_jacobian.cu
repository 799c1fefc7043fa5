// The training encode's forward: the hash-grid features of every sample
// at every level and their position-jacobian, from one gather of the 8
// corner rows.
//
// Replaces the JAX package's fwd_math (rnb_neus2_tpu/ops/
// hash_encoding.py:598-632, inside make_encode_with_jacobian_cv), which
// XLA compiles; the TPU ran no Pallas kernel there. Per sample n and level
// l < La with unlock mask m and lattice scale s:
//
//   out[n, lF + f]  = (Σ_c w_c · T[row_c, f]) · m
//   jac_d[n, lF + f] = (Σ_c dw_{c,d} · T[row_c, f]) · float32(s · m)
//
// summed corner by corner from c = 0 (the plain version's _corner_sum),
// and 0 at levels l ≥ La. Its plain twin is kernels/encode_jacobian.py's
// `plain`; the corner arithmetic is hash_corners.cuh's, so the outputs
// equal the twin's bit for bit.
//
// Design. One launch per encode call: one thread per (sample, level),
// grid.y = the level (all L levels: those from La on write their zeros),
// 256 threads a block along the samples. A thread computes its 8 corners,
// reads their F features (__ldg, the table is read-only here) and writes
// F values into each of the four (N, L·F) outputs. The level constants are
// a by-value kernel parameter (Levels, at most 32 levels), marked
// __grid_constant__ so that indexing it by level reads the parameter bank
// and copies nothing to local memory. F is a template parameter (1, 2, 4
// or 8), so the sums stay in registers.
//
// Bound. Bytes: the positions (12 B a sample) once, the four outputs
// (16·L·F B a sample) once, and the gathered corner rows. Neighbouring
// samples along a ray share the corners of coarse levels, so the distinct
// rows a batch reads are fewer than 8 a sample; what the gather must move
// at the least is each distinct 32-byte sector once (chip_smoke.py counts
// the sectors of the main path's inputs). Operations: ~130 float32
// operations per (sample, level), negligible at 67 TFLOP/s. So the kernel
// is bound by bytes. Each thread writes F·4 bytes into each output row of
// L·F·4 bytes, so a warp's stores touch 32 rows: the stores of the levels
// of one row merge in L2.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The launcher
// returns the cudaError_t of the launch, or cudaErrorInvalidValue for
// arguments it refuses (the wrapper checks them first); the caller raises
// if it is not 0.

#include <cuda_runtime.h>

#include <cstring>

#include "hash_corners.cuh"

namespace {

constexpr int kThreads = 256;

template <int F>
__global__ void __launch_bounds__(kThreads)
encode_jacobian_kernel(const float* __restrict__ table,
                       const float* __restrict__ pos,
                       float* __restrict__ out, float* __restrict__ jx,
                       float* __restrict__ jy, float* __restrict__ jz,
                       long long n, int L, int La,
                       const __grid_constant__ Levels lv) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int lvl = blockIdx.y;
  const long long o = i * (long long)(L * F) + lvl * F;
  if (lvl >= La) {
#pragma unroll
    for (int f = 0; f < F; ++f) {
      out[o + f] = 0.0f;
      jx[o + f] = 0.0f;
      jy[o + f] = 0.0f;
      jz[o + f] = 0.0f;
    }
    return;
  }
  const LevelConst& lc = lv.l[lvl];
  const float x[3] = {__ldg(pos + 3 * i), __ldg(pos + 3 * i + 1),
                      __ldg(pos + 3 * i + 2)};
  Corners c;
  level_corners(x, lc, c);
  const float* t = table + (long long)lc.offset * F;
  float acc[F], aj[3][F];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float* row = t + (long long)c.idx[k] * F;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float v = __ldg(row + f);
      const float a = __fmul_rn(c.w[k], v);
      acc[f] = k ? __fadd_rn(acc[f], a) : a;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float b = __fmul_rn(c.dw[k][d], v);
        aj[d][f] = k ? __fadd_rn(aj[d][f], b) : b;
      }
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    out[o + f] = __fmul_rn(acc[f], lc.m);
    jx[o + f] = __fmul_rn(aj[0][f], lc.scale_m);
    jy[o + f] = __fmul_rn(aj[1][f], lc.scale_m);
    jz[o + f] = __fmul_rn(aj[2][f], lc.scale_m);
  }
}

}  // namespace

extern "C" {

// table: (rows, F) float32; pos: (n, 3) float32; out, jx, jy, jz: (n, L·F)
// float32, all contiguous. levels: La LevelConst on the host. Launches on
// `stream` and returns cudaGetLastError().
int encode_jacobian_launch(const void* table, const void* pos, void* out,
                           void* jx, void* jy, void* jz, long long n, int L,
                           int La, int F, const void* levels, void* stream) {
  if (n <= 0) return 0;
  if (La < 0 || La > L || L > kMaxLevels || L <= 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  std::memset(&lv, 0, sizeof(lv));
  std::memcpy(lv.l, levels, sizeof(LevelConst) * La);
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)L);
  cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)table;
  const float* p = (const float*)pos;
  float *o = (float*)out, *x = (float*)jx, *y = (float*)jy, *z = (float*)jz;
  switch (F) {
    case 1: encode_jacobian_kernel<1><<<grid, kThreads, 0, s>>>(
        t, p, o, x, y, z, n, L, La, lv); break;
    case 2: encode_jacobian_kernel<2><<<grid, kThreads, 0, s>>>(
        t, p, o, x, y, z, n, L, La, lv); break;
    case 4: encode_jacobian_kernel<4><<<grid, kThreads, 0, s>>>(
        t, p, o, x, y, z, n, L, La, lv); break;
    case 8: encode_jacobian_kernel<8><<<grid, kThreads, 0, s>>>(
        t, p, o, x, y, z, n, L, La, lv); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* encode_jacobian_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
