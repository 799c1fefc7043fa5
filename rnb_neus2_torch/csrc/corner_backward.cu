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
// Bound. Bytes: the positions (12 B a sample) and the four cotangents
// (4·F B a sample and level, each) read once, and each table-gradient
// row that a pick touches written once (chip_smoke.py counts them on the
// main path's inputs); the zeroing of the whole gradient is the
// wrapper's. Operations: ~250 float32 operations per (sample, level) and
// K draws, far under 67 TFLOP/s, and no matrix product (no tensor cores).
// So the kernel is bound by bytes; atomics on random rows sit above that
// bound, each its own transaction in L2.
//
// Design (tile-major and staged, as encode_jacobian.cu; a first design
// ran one thread per (sample, level) on a level-major grid, so a warp's
// reads of each cotangent touched 32 rows 4·L·F bytes apart, and each
// sector was fetched again by later level passes: most of its time).
// Persistent blocks of 8 warps walk tiles of T consecutive samples
// (tile_copy.cuh; T from hash_corners.py:tile_plan, at most
// corner_backward.py's TILE = 64). A tile's positions and its four
// cotangent blocks (T·L·F·4 contiguous bytes each) arrive by five bulk
// asynchronous copies on one mbarrier (evict-first in L2); with two
// stages the next tile's arrive while this one is drawn. A cotangent that
// is not 16-byte aligned is read into the stage with plain loads instead,
// as is the ragged last tile. A warp takes 32 consecutive samples of one
// level: its level constants are uniform, and the samples follow each
// other along rays, so coarse levels repeat rows within the warp. A
// thread holds its 8 corners' cotangents, probabilities and rows in
// registers (F is a template parameter: 1, 2, 4 or 8) and draws its K
// picks one after another. Each pick is added as warp_scatter.cuh adds an
// element: lanes of a warp that picked the same row sum their values
// first and the lowest adds the sum, with one 64-bit float2 reduction per
// pair of features (F even) or one 32-bit atomic per feature (F = 1); a
// pick whose values are all zero (a locked level, a padded sample) adds
// nothing. At level 0, 2^18 picks land on 4,096 rows, yet a launch of
// level 0 alone costs about what reading the tiles' whole cotangent rows
// costs, and level 1 adds almost nothing (chip_smoke.py's
// `ms_into_first_levels`): the hot rows' atomics do not dominate, so
// there is no aggregation in shared memory. Float atomics make the order
// of the sums, and so the last bits, vary from run to run. An optional
// (La, K, N) int8 output records every choice (tests and chip_smoke.py).
// On an NVIDIA H100, on a K = 1 training step's inputs (n = 2^18, 14
// levels, F = 2): 0.112 ms in place, 2.3× the bound of 0.049 ms (PERF.md
// §6).
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The launcher
// returns the cudaError_t of the launch, or cudaErrorInvalidValue for
// arguments it refuses (the wrapper checks them first); the caller raises
// if it is not 0.

#include <cuda_runtime.h>

#include <cstring>

#include "hash_corners.cuh"
#include "tile_copy.cuh"
#include "warp_scatter.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPicks = 16;
// Blocks per SM that the registers must allow: at F = 8 a thread holds 64
// cotangent values and needs ~160 registers (one block), which ptxas's
// default cap of 128 would spill; below, three blocks (two at F = 4) as
// the default choice gives (80 registers at F = 2).
constexpr int min_blocks(int F) { return F == 8 ? 1 : (F == 4 ? 2 : 3); }
// float32(1e-20), as the plain version's `mags + 1e-20` rounds it
constexpr float kTiny = 0x1.79ca1p-67f;

// F floats from shared memory at p (aligned to 4·F bytes, 16 at F = 8).
template <int F>
__device__ __forceinline__ void load_shared(float (&v)[F], const float* p) {
  if constexpr (F == 1) {
    v[0] = p[0];
  } else if constexpr (F == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }
}

// One warp's 32 samples at one level: every lane calls it (lanes past the
// tile's rows with live false), since the picks merge across the warp.
// `c` points at the sample's row of the tile's g_out block (block stride
// `block`), i is its sample index in the batch.
template <int F>
__device__ __forceinline__ void pick_and_add(
    const float (&x)[3], const float* c, int block, bool live, long long i,
    long long n, int lvl, int K, const LevelConst& lc,
    float* __restrict__ g_table, signed char* __restrict__ choices,
    int lane) {
  float src[8][F], ps[8], cdf[7];
  int row[8];
  uint32_t base = 0;
  if (live) {
    Corners cr;
    level_corners(x, lc, cr);
    float go[F], gj[3][F];
    load_shared<F>(go, c);
#pragma unroll
    for (int d = 0; d < 3; ++d) load_shared<F>(gj[d], c + (d + 1) * block);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      go[f] = __fmul_rn(go[f], lc.m);
#pragma unroll
      for (int d = 0; d < 3; ++d) gj[d][f] = __fmul_rn(gj[d][f], lc.scale_m);
    }
    float mags[8], total = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float mag = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float s = __fmul_rn(cr.w[k], go[f]);
#pragma unroll
        for (int d = 0; d < 3; ++d)
          s = __fadd_rn(s, __fmul_rn(cr.dw[k][d], gj[d][f]));
        src[k][f] = s;
        mag = f ? __fadd_rn(mag, fabsf(s)) : fabsf(s);
      }
      mags[k] = __fadd_rn(mag, kTiny);
      total = k ? __fadd_rn(total, mags[k]) : mags[k];
      row[k] = lc.offset + cr.idx[k];
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

// The tile's positions and four cotangent blocks by bulk copies on `bar`.
__device__ __forceinline__ void load_tile(float* sp, const float* pos,
                                          const float* const (&cot)[4],
                                          long long tile, int T, int block,
                                          uint64_t* bar) {
  const uint32_t pos_bytes = T * 12, block_bytes = block * 4;
  mbar_expect_tx(bar, pos_bytes + 4 * block_bytes);
  bulk_load(sp, pos + tile * T * 3, pos_bytes, bar);
  float* sc = sp + T * 3;
#pragma unroll
  for (int d = 0; d < 4; ++d)
    bulk_load(sc + d * block, cot[d] + tile * block, block_bytes, bar);
}

template <int F>
__global__ void __launch_bounds__(kThreads, min_blocks(F))
corner_backward_kernel(const float* __restrict__ pos,
                       const float* __restrict__ g_out,
                       const float* __restrict__ gjx,
                       const float* __restrict__ gjy,
                       const float* __restrict__ gjz,
                       float* __restrict__ g_table,
                       signed char* __restrict__ choices, long long n, int L,
                       int La, int K, int T, int stages, int bulk,
                       const __grid_constant__ Levels lv) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* const stage0 = reinterpret_cast<float*>(smem + kBarrierBytes);
  const float* const cot[4] = {g_out, gjx, gjy, gjz};
  const int LF = L * F;
  const int block = T * LF;                  // floats of one cotangent block
  const int stage_floats = T * 3 + 4 * block;
  const long long tiles = (n + T - 1) / T;
  const long long bulk_tiles = bulk ? n / T : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    fence_mbar_init();
  }
  __syncthreads();
  long long tile = blockIdx.x;
  if (tid == 0 && tile < bulk_tiles)
    load_tile(stage0, pos, cot, tile, T, block, &bar[0]);
  uint32_t phase = 0;  // bit s: the parity that stage s waits for
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int s = stages == 2 ? it & 1 : 0;
    float* const sp = stage0 + s * stage_floats;
    const long long next = tile + gridDim.x;
    const int rows = (int)min((long long)T, n - tile * T);
    // the other stage was read by the last tile, done
    if (stages == 2 && tid == 0 && next < bulk_tiles)
      load_tile(stage0 + (s ^ 1) * stage_floats, pos, cot, next, T, block,
                &bar[s ^ 1]);
    if (tile < bulk_tiles) {
      mbar_wait(&bar[s], (phase >> s) & 1u);
      phase ^= 1u << s;
    } else {
      const float* p = pos + tile * T * 3;
      for (int i = tid; i < rows * 3; i += kThreads) sp[i] = p[i];
      const int m = rows * LF;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float* src = cot[d] + tile * block;
        float* dst = sp + T * 3 + d * block;
        for (int i = tid; i < m; i += kThreads) dst[i] = src[i];
      }
    }
    __syncthreads();
    const int groups = (rows + 31) >> 5;
    for (int task = warp; task < groups * La; task += kWarps) {
      const int lvl = task / groups;
      const int r = (task - lvl * groups) * 32 + lane;
      const bool live = r < rows;
      const int rr = live ? r : 0;
      const float x[3] = {sp[3 * rr], sp[3 * rr + 1], sp[3 * rr + 2]};
      pick_and_add<F>(x, sp + T * 3 + rr * LF + lvl * F, block, live,
                      tile * T + r, n, lvl, K, lv.l[lvl], g_table, choices,
                      lane);
    }
    __syncthreads();
    if (stages == 1 && tid == 0 && next < bulk_tiles)
      load_tile(sp, pos, cot, next, T, block, &bar[0]);
  }
}

template <int F>
int launch(const float* p, const float* go, const float* x, const float* y,
           const float* z, float* t, signed char* ch, long long n, int L,
           int La, int K, int T, int stages, const Levels& lv,
           cudaStream_t s) {
  const int smem = kBarrierBytes + (int)(stages * stage_bytes(T, L * F));
  unsigned grid = 0;
  const cudaError_t e = persistent_grid(corner_backward_kernel<F>, kThreads,
                                        smem, (n + T - 1) / T, &grid);
  if (e != cudaSuccess) return (int)e;
  const int bulk = aligned16(p) && aligned16(go) && aligned16(x) &&
                   aligned16(y) && aligned16(z);
  corner_backward_kernel<F><<<grid, kThreads, smem, s>>>(
      p, go, x, y, z, t, ch, n, L, La, K, T, stages, bulk, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pos: (n, 3) float32; g_out, gjx, gjy, gjz: (n, L·F) float32; g_table:
// (rows, F) float32, zeroed by the caller, 8-byte aligned; choices: null
// or (La, K, n) int8; all contiguous. levels: La LevelConst on the host.
// T (a multiple of 32) and stages (1 or 2): the tile plan, whose shared
// memory must fit a block. Launches on `stream` and returns
// cudaGetLastError().
int corner_backward_launch(const void* pos, const void* g_out,
                           const void* gjx, const void* gjy, const void* gjz,
                           void* g_table, void* choices, long long n, int L,
                           int La, int F, int K, int T, int stages,
                           const void* levels, void* stream) {
  if (n <= 0 || La == 0) return 0;
  if (La < 0 || La > L || L > kMaxLevels || K < 1 || K > kMaxPicks ||
      T < 32 || T % 32 || (stages != 1 && stages != 2) ||
      kBarrierBytes + stages * stage_bytes(T, L * F) > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  std::memset(&lv, 0, sizeof(lv));
  std::memcpy(lv.l, levels, sizeof(LevelConst) * La);
  cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* go = (const float*)g_out;
  const float *x = (const float*)gjx, *y = (const float*)gjy,
              *z = (const float*)gjz;
  float* t = (float*)g_table;
  signed char* ch = (signed char*)choices;
  switch (F) {
    case 1: return launch<1>(p, go, x, y, z, t, ch, n, L, La, K, T, stages,
                             lv, s);
    case 2: return launch<2>(p, go, x, y, z, t, ch, n, L, La, K, T, stages,
                             lv, s);
    case 4: return launch<4>(p, go, x, y, z, t, ch, n, L, La, K, T, stages,
                             lv, s);
    case 8: return launch<8>(p, go, x, y, z, t, ch, n, L, La, K, T, stages,
                             lv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* corner_backward_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
