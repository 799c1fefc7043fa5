// The training march and its two-pass compaction: each ray's samples on
// its ladder inside the occupied cells, packed ray after ray into one
// buffer of S slots, a ray that would overflow the buffer dropped whole.
//
// Replaces the JAX package's march_flat (rnb_neus2_tpu/ops/ray_march.py:
// 203) in both of its branches, the blocked two-phase march at cone 0
// (_march_flat_blocked, :286, with _coarse_dilated, :171) and the
// single-phase ladder (cone > 0, or blocked=False), which XLA compiles; the
// TPU ran no Pallas kernel there. The CUDA reference marches and compacts
// in its own two kernels (src/testbed_nerf.cu:1216-1387: a count pass, an
// atomicAdd of each ray's count, a write pass). The plain version is
// ops/ray_march.py's march_flat_plain, the port's CPU path, which equals
// the JAX package bit for bit; kernels/march.py's walk_twin is these
// kernels' loops in PyTorch.
//
// The function, per ray r with origin o, unit direction d and jitter u:
//
//   t0, t1  = (lo − o)·(1/d), (hi − o)·(1/d)         per axis (the slab test)
//   tmin    = max over axes of min(t0, t1), tmax = min over axes of max
//   alive   = tmax > tmin                    (false where any t is NaN)
//   startt  = max(tmin, 0) + clamp(max(tmin, 0)·cone, dt_min, dt_max)·u
//   t_k     = startt + k·dt_min              (cone 0; the geometric phase
//             t_sw·(1 + cone)^(k − n0) past the switch point n0 otherwise)
//   valid_k = alive ∧ o + t_k·d ∈ [lo, hi]³ ∧ bitfield[cell(o + t_k·d)]
//
// The blocked path (cone 0, 1-D bitfield) reads valid_k only in the ray's
// first NB flagged blocks of 8 ladder points, block b flagged when its
// midpoint t_{8b+3} lies within the cube grown by 8·dt_min and the
// dilated coarse grid (the bitfield any-pooled to ≤ 64³ and dilated by one
// coarse cell) is set there; blocks past the NB-th flagged one are never
// read. n_valid counts the ray's valid points; ray_kept = the inclusive
// prefix of n_valid ≤ S (monotone: every ray after the first one that
// overflows is dropped); seg_start = the exclusive prefix of the kept
// counts; slot seg_start[r] + i holds the ray's i-th valid point (t,
// clamp(t·cone, dt_min, dt_max), r, true); slots from the total on hold
// (0, dt_min, R, false).
//
// Four kernels, launched in order on the caller's stream:
//   march_coarse_kernel  one block per row of coarse cells along x: the
//                        dilated coarse grid (blocked path only);
//   march_count_kernel   one warp per ray: the ray's walk, counting; each
//                        block of 8 rays also writes their sum;
//   march_scan_kernel    one block per tile of 1,024 rays: the tile's
//                        offset (every block sums all earlier blocks'
//                        sums alike), the tile's inclusive scan, ray_kept,
//                        seg_start of the kept rays, and the total (by the
//                        one ray at the boundary);
//   march_write_kernel   one warp per ray: a dropped ray writes seg_start
//                        = total, a kept one walks again and writes its
//                        slots; every thread then fills its share of the
//                        unused slots [total, S).
// No atomics and no float reductions: every output is an integer, a bool
// or a ladder point, so runs repeat bit for bit. Nothing is read back to
// the host; the total stays in device memory.
//
// The walk. Lanes take 32 blocks at a time; a block's flag is one lane's
// probe, __ballot_sync gathers the 32 flags, and the popcount of the lower
// lanes' flags ranks each flagged block among the ray's flagged blocks so
// far, so the first NB are kept in order. Their indices go to a per-warp
// list in shared memory, and the warp then reads 4 blocks (32 points) at a
// time: a lane's point is valid or not, a second ballot counts them, and
// in the write pass each valid lane writes its slot at the ray's base plus
// its rank among the valid lanes, so a warp writes a ray's samples in
// ladder order, 32 at a time and coalesced. The single-phase ladder has
// one stage: lanes take 32 ladder points at a time. A warp stops once its
// ray has NB flagged blocks. The write pass repeats the count pass's walk
// (the same device function) for the kept rays only: with 2^16 rays and
// 2^18 slots most rays are dropped, and a kept ray carries hundreds of
// samples, which a warp writes in parallel.
//
// Bit for bit with the plain version on the same card:
// - No contraction: every product and sum is __fmul_rn / __fadd_rn /
//   __fsub_rn in the plain version's order (nvcc would fuse a·b + c), and
//   1/d is __fdiv_rn, IEEE division.
// - The constants are the plain version's float32 values, computed in
//   double and rounded once by the wrapper: dt_min, dt_max, lo − 8·dt_min,
//   hi + 8·dt_min, dt_min/cone, 1 + cone, and 1/dt_min as the float32
//   quotient of the float32 operands (ATen's CUDA division by a host
//   scalar multiplies by that reciprocal: the geometric phase's
//   (dt_min/cone − startt)/dt_min).
// - NaN: torch.minimum, amax and clamp propagate it, fminf and fmaxf drop
//   it. An axis-parallel ray whose origin lies on a slab plane has a NaN
//   t0 or t1, so the plain version's tmin and tmax are NaN and the ray has
//   no sample; the kernel tests each t for NaN and marks such a ray dead.
//   Every other t is ±inf or finite, where fminf/fmaxf agree with torch.
// - Cells truncate toward zero ((long long) of the float product, as
//   .to(torch.int64)) and are then clamped; a cell is read only for a
//   position inside the (grown) cube, never from an unclamped index.
// - The geometric phase calls powf, which ATen's CUDA pow calls for
//   float32.
//
// Bound. The function's bytes, each input read once and each output
// written once: o, d and u (28 B per ray), the fine bitfield (g³ bytes)
// and the coarse grid (≤ 64³ bytes) once, 17 B per slot (t, dt, ray_id,
// valid) and 17 B per ray (seg_start, n_valid, ray_kept): at 2^16 rays,
// 2^18 slots and a 128³ bitfield 9.8 MB, 2.9 µs at 3.35 TB/s. The walk's
// float work is a few tens of operations per point read, far under the
// bytes' time. What holds the kernels above it is latency: each warp's
// walk is a chain of dependent steps (a ballot, then the block list, then
// the point reads of scattered one-byte cells), and chip_smoke.py's
// phase 23 reports each kernel's time beside its share of the bound and
// the count of bitfield reads the walk makes.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). Each
// launcher returns the cudaError_t of its launch; the caller raises if it
// is not 0.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                    // rays per count/write block
constexpr int kThreads = 32 * kWarps;
constexpr int kScanThreads = 1024;           // rays per scan tile
constexpr int kCoarseThreads = 128;
constexpr int kMaxSide = 1024;               // the fine grid's side at most
constexpr int kBlock = 8;                    // ladder points per block
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

extern "C" {

// kernels/march.py's _Args: one field per line, in this order.
struct MarchArgs {
  const float* ray_o;
  const float* ray_d;
  const float* u_start;
  const unsigned char* bitfield;
  unsigned char* coarse;
  float* t;
  float* dt;
  long long* ray_id;
  unsigned char* valid;
  long long* seg_start;
  long long* n_valid;
  unsigned char* ray_kept;
  long long* work;
  long long S;
  int R;
  int K;
  int KB;
  int NB;
  int blocked;
  int geometric;
  int g;
  int f;
  int cg;
  float lo;
  float hi;
  float lo_m;
  float hi_m;
  float dt_min;
  float dt_max;
  float cone;
  float inv_dt_min;
  float t_switch;
  float growth;
};

}  // extern "C"

namespace {

struct Ray {
  float o[3];
  float d[3];
  float startt;
  bool alive;
};

// The slab test and the jittered start, in the plain version's order.
__device__ __forceinline__ Ray ray_start(const MarchArgs& a, int r) {
  Ray ray;
  float tmin = 0.f, tmax = 0.f;
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ray.o[i] = a.ray_o[3 * (long long)r + i];
    ray.d[i] = a.ray_d[3 * (long long)r + i];
    const float inv = __fdiv_rn(1.0f, ray.d[i]);
    const float t0 = __fmul_rn(__fsub_rn(a.lo, ray.o[i]), inv);
    const float t1 = __fmul_rn(__fsub_rn(a.hi, ray.o[i]), inv);
    nan |= isnan(t0) || isnan(t1);
    const float near = fminf(t0, t1), far = fmaxf(t0, t1);
    tmin = i == 0 ? near : fmaxf(tmin, near);
    tmax = i == 0 ? far : fminf(tmax, far);
  }
  ray.alive = !nan && tmax > tmin;
  tmin = fmaxf(tmin, 0.0f);
  const float dt0 = fminf(fmaxf(__fmul_rn(tmin, a.cone), a.dt_min),
                          a.dt_max);
  ray.startt = __fadd_rn(tmin, __fmul_rn(dt0, a.u_start[r]));
  return ray;
}

// Ladder point k (ladder_t_at).
__device__ __forceinline__ float ladder_t(const MarchArgs& a, float startt,
                                          int k) {
  const float kf = (float)k;
  const float t_const = __fadd_rn(startt, __fmul_rn(kf, a.dt_min));
  if (!a.geometric) return t_const;
  const float n0 = ceilf(__fmul_rn(fmaxf(__fsub_rn(a.t_switch, startt),
                                         0.0f), a.inv_dt_min));
  if (kf < n0) return t_const;
  const float t_sw = __fadd_rn(startt, __fmul_rn(n0, a.dt_min));
  return __fmul_rn(t_sw, powf(a.growth, __fsub_rn(kf, n0)));
}

__device__ __forceinline__ void position(const Ray& ray, float t,
                                         float p[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p[i] = __fadd_rn(ray.o[i], __fmul_rn(t, ray.d[i]));
}

__device__ __forceinline__ bool within(const float p[3], float lo,
                                       float hi) {
  return p[0] >= lo && p[0] <= hi && p[1] >= lo && p[1] <= hi &&
         p[2] >= lo && p[2] <= hi;
}

// Flat index of the cell at p in an n³ grid: truncation toward zero, then
// the clamp, per axis.
__device__ __forceinline__ long long cell_index(const float p[3], int n) {
  long long c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const long long v = (long long)__fmul_rn(p[i], (float)n);
    c[i] = v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
  }
  return c[0] + (long long)n * (c[1] + (long long)n * c[2]);
}

__device__ __forceinline__ void write_slot(const MarchArgs& a, long long s,
                                           float t, int r) {
  a.t[s] = t;
  a.dt[s] = fminf(fmaxf(__fmul_rn(t, a.cone), a.dt_min), a.dt_max);
  a.ray_id[s] = r;
  a.valid[s] = 1;
}

// One warp's walk of ray r: its count of valid points; with Write, each
// one written at slot base + its rank. Every lane of the warp calls it.
template <bool Write>
__device__ int walk(const MarchArgs& a, int r, int lane, long long base,
                    int* sel) {
  const Ray ray = ray_start(a, r);
  if (!ray.alive) return 0;
  const unsigned lower = (1u << lane) - 1u;
  int count = 0;
  if (!a.blocked) {
    for (int k0 = 0; k0 < a.K; k0 += 32) {
      const int k = k0 + lane;
      bool v = false;
      float t = 0.f;
      if (k < a.K) {
        float p[3];
        t = ladder_t(a, ray.startt, k);
        position(ray, t, p);
        v = within(p, a.lo, a.hi) && a.bitfield[cell_index(p, a.g)] != 0;
      }
      const unsigned vm = __ballot_sync(kFull, v);
      if (Write && v) write_slot(a, base + count + __popc(vm & lower), t, r);
      count += __popc(vm);
    }
    return count;
  }
  int nsel = 0;
  for (int b0 = 0; b0 < a.KB && nsel < a.NB; b0 += 32) {
    const int b = b0 + lane;
    bool flag = false;
    if (b < a.KB) {
      float p[3];
      position(ray, ladder_t(a, ray.startt, b * kBlock + (kBlock - 1) / 2),
               p);
      flag = within(p, a.lo_m, a.hi_m) && a.coarse[cell_index(p, a.cg)] != 0;
    }
    const unsigned m = __ballot_sync(kFull, flag);
    const int take = min(__popc(m), a.NB - nsel);
    const int rank = __popc(m & lower);
    __syncwarp();                 // the last chunk's reads of sel are done
    if (flag && rank < take) sel[rank] = b;
    __syncwarp();
    for (int j0 = 0; j0 < take; j0 += 32 / kBlock) {
      const int j = j0 + lane / kBlock;
      bool v = false;
      float t = 0.f;
      if (j < take) {
        float p[3];
        t = ladder_t(a, ray.startt, sel[j] * kBlock + lane % kBlock);
        position(ray, t, p);
        v = within(p, a.lo, a.hi) && a.bitfield[cell_index(p, a.g)] != 0;
      }
      const unsigned vm = __ballot_sync(kFull, v);
      if (Write && v) write_slot(a, base + count + __popc(vm & lower), t, r);
      count += __popc(vm);
    }
    nsel += take;
  }
  return count;
}

// One block per row of coarse cells along x, at (cy, cz): coarse cell c
// is set when a fine cell of coarse cells c − 1 to c + 1 (per axis) is.
// The block first ORs, for every fine x, the fine rows of its window in y
// and z (threads on consecutive words of a row: each row read coalesced,
// once per block, the rows' loads unrolled so that they are in flight
// together), then each coarse cell ORs its window of that column in x.
// Word: 4 bytes of a row at a time where the rows are 4-byte aligned (an
// OR of words is the bytes' ORs), else one.
template <typename Word>
__global__ void __launch_bounds__(kCoarseThreads)
march_coarse_kernel(MarchArgs a) {
  __shared__ Word column[kMaxSide / sizeof(Word)];
  const int cy = blockIdx.x % a.cg, cz = blockIdx.x / a.cg;
  const int y0 = max(cy - 1, 0) * a.f, y1 = min(cy + 2, a.cg) * a.f;
  const int z0 = max(cz - 1, 0) * a.f, z1 = min(cz + 2, a.cg) * a.f;
  const int ny = y1 - y0, rows = ny * (z1 - z0);
  const int width = a.g / (int)sizeof(Word);
  const Word* bits = reinterpret_cast<const Word*>(a.bitfield);
  for (int x = threadIdx.x; x < width; x += kCoarseThreads) {
    Word any = 0;
#pragma unroll 12
    for (int i = 0; i < rows; ++i)
      any |= bits[x + (long long)width *
                          (y0 + i % ny + (long long)a.g * (z0 + i / ny))];
    column[x] = any;
  }
  __syncthreads();
  const unsigned char* col = reinterpret_cast<const unsigned char*>(column);
  for (int cx = threadIdx.x; cx < a.cg; cx += kCoarseThreads) {
    const int x0 = max(cx - 1, 0) * a.f, x1 = min(cx + 2, a.cg) * a.f;
    unsigned char any = 0;
    for (int x = x0; x < x1; ++x) any |= col[x];
    a.coarse[cx + (long long)a.cg * (cy + (long long)a.cg * cz)] = any != 0;
  }
}

__global__ void __launch_bounds__(kThreads) march_count_kernel(MarchArgs a) {
  __shared__ int sel[kWarps][32];
  __shared__ long long sums[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  long long n = 0;
  if (r < a.R) {
    n = walk<false>(a, r, lane, 0, sel[warp]);
    if (lane == 0) a.n_valid[r] = n;
  }
  if (lane == 0) sums[warp] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < kWarps; ++w) s += sums[w];
    a.work[blockIdx.x] = s;
  }
}

__device__ __forceinline__ long long warp_inclusive(long long v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const long long u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kScanThreads) march_scan_kernel(
    MarchArgs a) {
  __shared__ long long part[kScanThreads / 32];
  __shared__ long long offset;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long first = (long long)blockIdx.x * kScanThreads;
  // the tile's offset: the sums of the count blocks before it
  long long s = 0;
  for (long long i = tid; i < first / kWarps; i += kScanThreads)
    s += a.work[i];
  s = warp_inclusive(s, lane);
  if (lane == 31) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    const long long w = warp_inclusive(part[lane], lane);
    if (lane == 31) offset = w;
  }
  __syncthreads();
  const long long base = offset;
  // the tile's inclusive scan (warp 0 read part before the barrier above)
  const long long r = first + tid;
  const long long n = r < a.R ? a.n_valid[r] : 0;
  long long inc = warp_inclusive(n, lane);
  if (lane == 31) part[warp] = inc;
  __syncthreads();
  if (warp == 0) part[lane] = warp_inclusive(part[lane], lane);
  __syncthreads();
  if (warp > 0) inc += part[warp - 1];
  if (r >= a.R) return;
  const long long cum = base + inc;
  const bool kept = cum <= a.S;
  a.ray_kept[r] = kept;
  if (kept) a.seg_start[r] = cum - n;
  long long* total = a.work + (a.R + kWarps - 1) / kWarps;
  if (kept && (r + 1 == a.R || cum + a.n_valid[r + 1] > a.S)) *total = cum;
  if (r == 0 && !kept) *total = 0;
}

__global__ void __launch_bounds__(kThreads) march_write_kernel(MarchArgs a) {
  __shared__ int sel[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + warp;
  const long long total = a.work[(a.R + kWarps - 1) / kWarps];
  if (r < a.R) {
    if (!a.ray_kept[r]) {
      if (lane == 0) a.seg_start[r] = total;
    } else if (a.n_valid[r] > 0) {
      walk<true>(a, r, lane, a.seg_start[r], sel[warp]);
    }
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long s = total + (long long)blockIdx.x * kThreads + threadIdx.x;
       s < a.S; s += stride) {
    a.t[s] = 0.f;
    a.dt[s] = a.dt_min;
    a.ray_id[s] = a.R;
    a.valid[s] = 0;
  }
}

int ray_blocks(const MarchArgs* a) { return (a->R + kWarps - 1) / kWarps; }

}  // namespace

extern "C" {

// Each launcher takes the filled MarchArgs and the stream and returns
// cudaGetLastError() after its launch. The work buffer holds
// march_work_words(R) int64: the count blocks' sums, then the total.
long long march_work_words(int R) { return (R + kWarps - 1) / kWarps + 1; }

int march_coarse_launch(const MarchArgs* a, void* stream) {
  if (a->g % 4 == 0 && (unsigned long long)a->bitfield % 4 == 0)
    march_coarse_kernel<unsigned int><<<a->cg * a->cg, kCoarseThreads, 0,
                                        (cudaStream_t)stream>>>(*a);
  else
    march_coarse_kernel<unsigned char><<<a->cg * a->cg, kCoarseThreads, 0,
                                         (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int march_count_launch(const MarchArgs* a, void* stream) {
  march_count_kernel<<<ray_blocks(a), kThreads, 0, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}

int march_scan_launch(const MarchArgs* a, void* stream) {
  march_scan_kernel<<<(a->R + kScanThreads - 1) / kScanThreads, kScanThreads,
                      0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int march_write_launch(const MarchArgs* a, void* stream) {
  march_write_kernel<<<ray_blocks(a), kThreads, 0, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}

const char* march_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
