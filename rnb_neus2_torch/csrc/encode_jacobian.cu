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
// Bound. Bytes: the positions (12 B a sample) once, the four outputs
// (16·L·F B a sample) once, and the gathered corner rows. Neighbouring
// samples along a ray share the corners of coarse levels, so the distinct
// rows a batch reads are fewer than 8 a sample; what the gather must move
// at the least is each distinct 32-byte sector once (chip_smoke.py counts
// the sectors of the main path's inputs). Operations: ~130 float32
// operations per (sample, level) and no matrix product, so no tensor
// cores: negligible at 67 TFLOP/s. The kernel is bound by bytes, and in
// practice by the gather's L2 sector requests (8 rows per sample and
// level, scattered at the hashed levels).
//
// Design (tile-major and staged; a first design ran one thread per
// (sample, level) on a level-major grid, so a warp's stores hit 32 rows
// 4·L·F bytes apart and each output sector was written by several passes
// over the batch: most of its time). Persistent blocks of 8 warps walk
// tiles of T consecutive samples (tile_copy.cuh; T from
// hash_corners.py:tile_plan, at most encode_jacobian.py's TILE = 32:
// small tiles leave room for more blocks on each SM, which hide the
// gathers' latency better than bigger tiles do). A tile's positions
// arrive by one bulk asynchronous copy on an mbarrier; with two stages,
// the next tile's positions load while this one gathers, and this tile's
// outputs drain while the next one gathers. A warp takes 32 consecutive
// samples of one level, so the level's constants and its dense-or-hashed
// branch are uniform across the warp; each lane reads a corner row as one
// vector (float2 at F = 2, float4 at F = 4, two float4 at F = 8) with an
// L2 evict-last hint, and writes its F values of each output into the
// tile in shared memory. Each of the four output blocks then leaves with
// one bulk copy from shared to device memory (evict-first): full 32-byte
// sectors, each row written once. The shared-memory row is L·F floats:
// at L·F = 28 lanes 8 apart meet in a bank pair, a 2-way conflict on the
// float2 stores (padding the row would break the block's contiguous
// layout for the bulk copy). The level constants stay a __grid_constant__
// parameter (indexed by a warp-uniform level: the parameter bank, no local
// copy). On an NVIDIA H100, on a K = 1 training step's inputs (n = 2^18,
// 14 levels, F = 2): 0.117 ms, 2.6× the bound of 0.046 ms (PERF.md §6).
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The launcher
// returns the cudaError_t of the launch, or cudaErrorInvalidValue for
// arguments it refuses (the wrapper checks them first); the caller raises
// if it is not 0.

#include <cuda_runtime.h>

#include <cstring>

#include "hash_corners.cuh"
#include "tile_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Row `row` of F floats into v through the read-only path, kept in L2
// by policy `keep`: one vector load where the table is aligned for it
// (`vec`; float2 at F = 2, float4 at F = 4, two at F = 8), else feature by
// feature.
template <int F>
__device__ __forceinline__ void load_row(float (&v)[F],
                                         const float* __restrict__ row,
                                         bool vec, uint64_t keep) {
  if constexpr (F == 2) {
    if (vec) {
      asm("ld.global.nc.L2::cache_hint.v2.f32 {%0, %1}, [%2], %3;"
          : "=f"(v[0]), "=f"(v[1])
          : "l"(row), "l"(keep));
      return;
    }
  } else if constexpr (F >= 4) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < F / 4; ++q)
        asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
            : "=f"(v[4 * q]), "=f"(v[4 * q + 1]), "=f"(v[4 * q + 2]),
              "=f"(v[4 * q + 3])
            : "l"(row + 4 * q), "l"(keep));
      return;
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f)
    asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(v[f])
        : "l"(row + f), "l"(keep));
}

// F floats into shared memory at p (aligned to 4·F bytes, 16 at F = 8).
template <int F>
__device__ __forceinline__ void store_shared(float* p, const float (&v)[F]) {
  if constexpr (F == 1) {
    p[0] = v[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// One sample's F features and jacobian columns at one level, into the
// tile's four output blocks at row offset o (block stride `block`).
template <int F>
__device__ __forceinline__ void encode_one(const float* __restrict__ table,
                                           const float (&x)[3], float* o,
                                           int block, const LevelConst& lc,
                                           bool vec, uint64_t keep) {
  Corners c;
  level_corners(x, lc, c);
  const float* t = table + (long long)lc.offset * F;
  float acc[F], aj[3][F];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float v[F];
    load_row<F>(v, t + (long long)c.idx[k] * F, vec, keep);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float a = __fmul_rn(c.w[k], v[f]);
      acc[f] = k ? __fadd_rn(acc[f], a) : a;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float b = __fmul_rn(c.dw[k][d], v[f]);
        aj[d][f] = k ? __fadd_rn(aj[d][f], b) : b;
      }
    }
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    acc[f] = __fmul_rn(acc[f], lc.m);
#pragma unroll
    for (int d = 0; d < 3; ++d) aj[d][f] = __fmul_rn(aj[d][f], lc.scale_m);
  }
  store_shared<F>(o, acc);
#pragma unroll
  for (int d = 0; d < 3; ++d) store_shared<F>(o + (d + 1) * block, aj[d]);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
encode_jacobian_kernel(const float* __restrict__ table,
                       const float* __restrict__ pos,
                       float* __restrict__ out, float* __restrict__ jx,
                       float* __restrict__ jy, float* __restrict__ jz,
                       long long n, int L, int La, int T, int stages,
                       int bulk, int vec,
                       const __grid_constant__ Levels lv) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* const stage0 = reinterpret_cast<float*>(smem + kBarrierBytes);
  const int LF = L * F;
  const int block = T * LF;                  // floats of one output block
  const int stage_floats = T * 3 + 4 * block;
  const long long tiles = (n + T - 1) / T;
  // full tiles of aligned tensors take the bulk copies
  const long long bulk_tiles = bulk ? n / T : 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint64_t keep = l2_evict_last();  // the table, gathered again
  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    fence_mbar_init();
  }
  __syncthreads();
  long long tile = blockIdx.x;
  if (tid == 0 && tile < bulk_tiles) {
    mbar_expect_tx(&bar[0], T * 12);
    bulk_load(stage0, pos + tile * T * 3, T * 12, &bar[0]);
  }
  uint32_t phase = 0;  // bit s: the parity that stage s waits for
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int s = stages == 2 ? it & 1 : 0;
    float* const sp = stage0 + s * stage_floats;
    float* const so = sp + T * 3;
    const long long next = tile + gridDim.x;
    const int rows = (int)min((long long)T, n - tile * T);
    const bool tma = tile < bulk_tiles;
    if (tid == 0) {
      if (stages == 2 && next < bulk_tiles) {
        // the other stage's positions were read by the last tile, done
        float* np = stage0 + (s ^ 1) * stage_floats;
        mbar_expect_tx(&bar[s ^ 1], T * 12);
        bulk_load(np, pos + next * T * 3, T * 12, &bar[s ^ 1]);
      }
      // this stage's output blocks were last read by the bulk stores of
      // tile it - stages: let only the younger group still read
      if (stages == 2)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
    }
    if (tma) {
      mbar_wait(&bar[s], (phase >> s) & 1u);
      phase ^= 1u << s;
    } else {
      const float* src = pos + tile * T * 3;
      for (int i = tid; i < rows * 3; i += kThreads) sp[i] = src[i];
    }
    __syncthreads();
    const int groups = (rows + 31) >> 5;
    for (int task = warp; task < groups * L; task += kWarps) {
      const int lvl = task / groups;
      const int r = (task - lvl * groups) * 32 + lane;
      if (r >= rows) continue;
      float* o = so + r * LF + lvl * F;
      if (lvl >= La) {
        float z[F];
#pragma unroll
        for (int f = 0; f < F; ++f) z[f] = 0.0f;
#pragma unroll
        for (int d = 0; d < 4; ++d) store_shared<F>(o + d * block, z);
        continue;
      }
      const float x[3] = {sp[3 * r], sp[3 * r + 1], sp[3 * r + 2]};
      encode_one<F>(table, x, o, block, lv.l[lvl], vec, keep);
    }
    if (tma) fence_proxy_async();
    __syncthreads();
    const long long g0 = tile * T * LF;
    if (tma) {
      if (tid == 0) {
        bulk_store(out + g0, so, block * 4);
        bulk_store(jx + g0, so + block, block * 4);
        bulk_store(jy + g0, so + 2 * block, block * 4);
        bulk_store(jz + g0, so + 3 * block, block * 4);
        bulk_commit();
      }
    } else {
      const int m = rows * LF;
      for (int i = tid; i < m; i += kThreads) {
        out[g0 + i] = so[i];
        jx[g0 + i] = so[block + i];
        jy[g0 + i] = so[2 * block + i];
        jz[g0 + i] = so[3 * block + i];
      }
    }
    if (stages == 1 && tid == 0 && next < bulk_tiles) {
      // one stage: the next positions load once this tile has read them
      mbar_expect_tx(&bar[0], T * 12);
      bulk_load(sp, pos + next * T * 3, T * 12, &bar[0]);
    }
  }
  if (tid == 0) bulk_wait_all();
}

template <int F>
int launch(const float* t, const float* p, float* o, float* x, float* y,
           float* z, long long n, int L, int La, int T, int stages,
           const Levels& lv, cudaStream_t s) {
  const int smem = kBarrierBytes + (int)(stages * stage_bytes(T, L * F));
  unsigned grid = 0;
  const cudaError_t e = persistent_grid(encode_jacobian_kernel<F>, kThreads,
                                        smem, (n + T - 1) / T, &grid);
  if (e != cudaSuccess) return (int)e;
  const int bulk = aligned16(p) && aligned16(o) && aligned16(x) &&
                   aligned16(y) && aligned16(z);
  const unsigned long long row_align = F == 1 ? 4 : (F == 2 ? 8 : 16);
  const int vec = (reinterpret_cast<unsigned long long>(t) % row_align) == 0;
  encode_jacobian_kernel<F><<<grid, kThreads, smem, s>>>(
      t, p, o, x, y, z, n, L, La, T, stages, bulk, vec, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: (rows, F) float32; pos: (n, 3) float32; out, jx, jy, jz: (n, L·F)
// float32, all contiguous. levels: La LevelConst on the host. T (a
// multiple of 32) and stages (1 or 2): the tile plan, whose shared memory
// must fit a block. Launches on `stream` and returns cudaGetLastError().
int encode_jacobian_launch(const void* table, const void* pos, void* out,
                           void* jx, void* jy, void* jz, long long n, int L,
                           int La, int F, int T, int stages,
                           const void* levels, void* stream) {
  if (n <= 0) return 0;
  if (La < 0 || La > L || L > kMaxLevels || L <= 0 || T < 32 || T % 32 ||
      (stages != 1 && stages != 2) ||
      kBarrierBytes + stages * stage_bytes(T, L * F) > kMaxSharedBytes)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  std::memset(&lv, 0, sizeof(lv));
  std::memcpy(lv.l, levels, sizeof(LevelConst) * La);
  cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)table;
  const float* p = (const float*)pos;
  float *o = (float*)out, *x = (float*)jx, *y = (float*)jy, *z = (float*)jz;
  switch (F) {
    case 1: return launch<1>(t, p, o, x, y, z, n, L, La, T, stages, lv, s);
    case 2: return launch<2>(t, p, o, x, y, z, n, L, La, T, stages, lv, s);
    case 4: return launch<4>(t, p, o, x, y, z, n, L, La, T, stages, lv, s);
    case 8: return launch<8>(t, p, o, x, y, z, n, L, La, T, stages, lv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* encode_jacobian_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
