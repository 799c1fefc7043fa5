// The NeuS composite and loss of a training step, forward and backward:
// per sample the NeuS alpha, the transmittance with its keep rule
// (T >= 1e-4), the shading, the predicted albedo and weight sum per ray,
// and the colour, mask and eikonal terms, summed to the step's loss; and
// the loss's gradient with respect to the field's outputs (sdf, ∇sdf, raw
// albedo, variance) and, when asked, the ray directions.
//
// Replaces the JAX package's training_loss (rnb_neus2_tpu/render/
// losses.py:257-424) with its sdf_to_alpha (rnb_neus2_tpu/render/
// neus.py:29), which XLA compiles, and their VJP; the TPU ran no Pallas
// kernel there. The CUDA reference does the same in one kernel,
// compute_loss_kernel (src/testbed_nerf.cu:1396-2097). The plain version
// is kernels/neus_loss.py's `plain`, the port's CPU path.
//
// The function, per slot j of ray r = ray_id[j] (the compaction orders
// slots by ray, so a ray's slots are one run starting at seg_start[r]; a
// dropped ray or one without samples owns none; unused slots carry
// ray_id == R and come last):
//
//   alive_j = valid_j ∧ r < R ∧ (per-sample attrs: attrs[j, 3] > 0.5;
//             else the ray's alive ∧ ray_kept)
//   α_j     = alive_j ? sdf_to_alpha(sdf, dirs·∇, dt, exp(10·v), a) : 0
//   lw_j    = log1p(−min(α_j, 1 − 1e−7))
//   C_j     = Σ_{i<j} lw_i over the whole buffer, a float32 value
//   T_j     = exp(C_j − C_{seg_start[r]})
//   keep_j  = alive_j ∧ T_j ≥ 1e−4,  w_j = keep_j · α_j · T_j
//   pred4_r = Σ_j w_j · albedo4_j · shade_j,  weight_sum_r = Σ_j w_j
//
// and the colour (L2 or L1, halved under RGB+, × mask_color × ray alive),
// mask (BCE or sigmoid-BCE of the clamped weight sum) and eikonal
// ((‖∇‖ − 1)² over kept samples) terms: total = (Σ colour + mask_w · Σ mask)
// / n_rays + ek_w · Σ eikonal / ek_div.
//
// The buffer-wide prefix C is the JAX package's (its cum_excl, one
// float32 cumsum over the 2^18 slots, re-based at each ray's first slot).
// Its rounding to float32 is part of the function: past |C| ≈ 1e5 a faint
// sample's log1p(−α) is below half a float32 step of C and is lost, and T
// moves in steps of up to 0.06 in log T. The card sums in a tree-shaped,
// fixed, deterministic order, the kind XLA's scan and CUB take, but in
// float64, and rounds each C to float32 once: C_j is the float32 nearest
// the exact prefix (but for the float64 sum's own error, some 1e−11 of
// |C|), as the CPU path's torch.cumsum gives it (which also sums in
// float64), and within about a float32 step of XLA's jnp.cumsum on the
// CPU. (The same tree in float32, a first form of this design, put each C
// up to 2.4 float32 steps of |C| from the exact prefix, so a ray's log T,
// a difference of two entries, sat up to 3 steps from the CPU path's.)
// Per tile, each thread's kPer consecutive slots serially, then a warp's
// threads (Kogge-Stone), then the block's warps, give each slot's prefix
// within its tile; every block that needs a tile's offset scans all tile
// totals in the same order (each thread a run of them, then warps, then
// the block); C_j = float32(offset(tile) + local_j). Every addition is
// __dadd_rn, so nvcc contracts nothing and kernels/neus_loss.py's
// `prefix_twin` gives the same bits. A ray that starts in an earlier tile
// reads its base C_s from that tile's offset and the local prefix stored
// there: the same rounded value as the slot itself.
//
// Backward, with the upstream gradient g: g_pred4 and g_ws of each ray
// from the colour and mask terms (its pred4 and weight sum saved by the
// forward); per kept sample g_w = g_ws + Σ_c g_pred4_c · albedo4_c ·
// shade; g_α = [kept] g_w · T − [α ≤ 1 − 1e−7] · G / (1 − α) with G_j =
// Σ_{k>j, same ray} g_w_k · w_k; then sdf_to_alpha's, the shading's, the
// albedo's and the eikonal term's derivatives, each where the plain
// version's autograd takes it (clamps pass their bounds, relu is strict).
// The debug stop-gradients drop their terms. JAX's VJP of the buffer-wide
// cumsum is a reverse cumsum of C's cotangent over the whole buffer; a
// ray's cotangents sum to zero, so it equals G, a reverse sum within the
// ray, up to rounding at the size of one ray's partial sums.
//
// Bound. The function's bytes (S slots, R rays; chip_smoke.py's
// neus_loss_bounds counts them on the main path's inputs), each input read
// once and each output written once; the design's intermediates (lw, the
// tiles' prefixes and totals, the alive mask) do not count. The forward
// reads ray_id and valid (and the attributes' alive column) per slot,
// sdf, ∇, dt, the direction and v per alive slot (every alive α enters
// C), the raw albedo per kept sample and the per-ray data, and writes
// keep, α and T per slot (α and T are the residuals the backward reads),
// pred4, weight sum and colour per ray and the loss. The scan's and the
// composite's rows split these bytes, each input charged to the first of
// the two that reads it, so that their bounds sum to the forward's. The
// backward reads ray_id and keep per slot, sdf, ∇, the raw albedo, dt,
// the direction, v, α and T per kept sample, the per-ray data and the
// saved pred4 and weight sum, and writes five gradients per slot.
// Operations: some 60 (α), 40 (the composite) and 150 (backward) float32
// operations per slot with a few transcendentals; at 67 TFLOP/s far below
// the bytes' time. The kernels are bound by bytes.
//
// Design (a first design was one thread per ray walking its segment: on
// a trained step about 930 rays of about 280 slots each, up to 248 of
// them walked, so some 30 warps on 132 SMs ran a dependent chain of
// loads, log1p and exp per slot; latency, not bytes, bounded it at 65–75×
// the bound). Every kernel is slot-parallel over tiles of kTile = 1024
// consecutive slots, one block of kThreads = 512 per tile (2^18 slots:
// 256 blocks, one wave of two per SM; the plan is the pair of constants
// below, which kernels/neus_loss.py's THREADS and PER repeat for the
// prefix's twin). A block brings its tile's
// per-slot streams into shared memory with cp.async.bulk on an mbarrier
// (tile_copy.cuh) where the 16-byte rule allows (a full tile of a 16-byte
// aligned tensor; ∇ only when its rows are packed, the (S, 8) attributes
// only at a row stride of 8); the ragged last tile and misaligned
// tensors are copied by the block's threads, and strided rows (the raw
// albedo) are read from device memory. A block loads one tile, once, and
// its threads never write what a bulk copy wrote, so no async-proxy fence
// is needed (the backward's per-ray sums share the attributes' room only
// when those are per ray and not staged). Per-slot work runs with thread
// t on slots t, t + kThreads, … (coalesced); the scans run with thread t
// on slots kPer·t … kPer·t + kPer − 1, exchanging through shared memory.
//
//   neus_loss_scan_kernel (forward, 1): α and alive per slot, the tile's
//     local prefix and total of lw (float64), and the tile's largest
//     inv_s; lw
//     itself only where the caller asks for it (a check; null on the
//     training path).
//   neus_loss_forward_kernel (forward, 2): every tile's offset, C (written
//     only where asked, as lw), T, keep; w, the shading, the albedo and
//     the eikonal term per slot; the per-ray sums as a segmented scan
//     over the tile's runs. Each ray is finished (pred4 and weight sum
//     to ray_saved, its colour and mask terms) by the block of the tile
//     where it starts: when it goes on past the tile, the block sums its
//     later slots itself, as the backward's carry (combining per-tile
//     partials of such rays in the last block instead left a serial
//     chain of dependent loads in that one block). Each block also takes
//     a range of rays and finishes
//     those without slots (pred4 = 0). The last block to finish (by a
//     ticket) sums the blocks' partials in a fixed order into the loss
//     and the metrics.
//   neus_loss_backward_kernel: per slot g_w·w, G as a reverse segmented
//     scan over the tile's runs; when the tile's last ray continues past
//     the tile, the block sums that ray's g_w·w over the later slots
//     itself (a fixed-order block sum per chunk of kThreads slots) and
//     carries it in. Then the derivatives per slot; every gradient entry
//     is written, so the wrapper's buffers need no fill. A per-ray g_ray_d
//     and the scalar variance's gradient go through per-block partials
//     and head records that the backward's last block combines in order.
//
// No float atomics: each sum has a fixed order, so two launches on the
// same inputs give the same bits (the tickets are the only atomics). The
// scan zeroes both tickets and each last block resets its own, so the
// forward and the backward each run again on their scratch. Arithmetic
// on the prefix (__dadd_rn, __double2float_rn), α and the transmittance
// (__f*_rn) is rounded op by op (no contraction), so the three kernels
// compute the same α and C; the shading,
// albedo and derivatives are plain float32 (nvcc may fuse multiply-adds).
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The
// launchers take host pointers to the structs below (kernels/neus_loss.py
// builds them with ctypes; tests/test_torch_neus_loss.py holds their field
// order against this file), return the cudaError_t of the launch, or
// cudaErrorInvalidValue for arguments they refuse; the caller raises if
// it is not 0. neus_loss_work_words(S) gives the scratch's size.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "tile_copy.cuh"

namespace {

constexpr int kThreads = 512;                 // threads per block
constexpr int kPer = 2;                       // slots per thread in a scan
constexpr int kTile = kThreads * kPer;        // slots per tile and block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 1 << 14;            // S ≤ 2^24
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTransEps = 1e-4f;                  // TRANSMITTANCE_EPSILON
constexpr float kAlphaCap = (float)(1.0 - 1e-7);    // log1p's clamp
constexpr float kWsLo = 1e-4f;                       // the mask's clamp
constexpr float kWsHi = (float)(1.0 - 1e-4);

}  // namespace

// Options of one call, formed on the host (neus_loss.py's _Options).
struct Options {
  int S;                    // slots
  int R;                    // rays
  int l2;                   // RenderFlags.apply_l2 (else L1)
  int rgbplus;              // apply_rgbplus
  int relu;                 // apply_relu (shading)
  int bce;                  // apply_bce (else sigmoid-BCE)
  int no_albedo;            // apply_no_albedo
  int stop_alpha_normal;    // LossConfig.debug_stopgrad_alpha_normal
  int stop_shading_normal;  // debug_stopgrad_shading_normal
  int stop_alpha_sdf;       // debug_stopgrad_alpha_sdf
  int ref_jacobian;         // rgbplus_ref_jacobian
  int dirs_per_sample;      // dirs: (S, 8) sample attrs, else (R, 3)
  int dir_stride;           // row stride of dirs: 8 or 3
  int grad_stride;          // row stride of ∇sdf (last dim contiguous)
  int albedo_stride;        // row stride of the raw albedo
  int v_per_sample;         // variance (S,), else one value
  float grad_floor;         // rgbplus_grad_floor
  float mask_w;             // mask_loss_weight
  float ek_w;               // ek_loss_weight
  float cos_anneal;         // cos_anneal_ratio
  float n_rays;             // the colour and mask divisor
  float ek_div;             // the eikonal divisor
};

// Device pointers of the inputs (neus_loss.py's _Inputs).
struct Inputs {
  const float* sdf;                // (S,)
  const float* grad;               // (S, 3), row stride grad_stride
  const float* albedo;             // (S, 3), row stride albedo_stride
  const float* v;                  // (S,) or (1,)
  const float* dirs;               // (S, 8) or (R, 3)
  const float* dt;                 // (S,)
  const long long* ray_id;         // (S,)
  const unsigned char* valid;      // (S,) bool
  const long long* seg_start;      // (R,)
  const unsigned char* alive;      // (R,) bool
  const unsigned char* ray_kept;   // (R,) bool
  const float* light;              // (R, 3) world-space light
  const float* target4;            // (R, 4)
  const float* mask_gt;            // (R,)
  const float* mask_color;         // (R,)
};

// The forward's outputs (neus_loss.py's _ForwardOut); every entry of each
// pointer that is not null is written by the kernels.
struct ForwardOut {
  float* total;          // ()
  float* metrics;        // (5,) loss_color, loss_mask, loss_ek,
                         //      weight_sum_mean, inv_s
  long long* counts;     // (2,) n_samples_kept, n_rays_alive
  float* color;          // (R,) per-ray colour loss
  unsigned char* keep;   // (S,)
  float* alpha;          // (S,) α, 0 where the slot is not alive
  float* lw;             // null, or (S,) log1p(−min(α, 1 − 1e−7)) for a
                         //   check (the training path passes null)
  float* cum;            // null, or (S,) C, the buffer-wide exclusive
                         //   prefix of lw, for a check
  float* trans;          // (S,) T = exp(C − C[seg_start])
  float* ray_saved;      // (R, 5) pred4, weight_sum
  float* work;           // neus_loss_work_words(S) words of scratch
};

// The backward's inputs from the forward, and its outputs (neus_loss.py's
// _BackwardIO); every gradient entry is written by the kernel.
struct BackwardIO {
  const float* g_total;  // (), the upstream gradient
  const float* alpha;
  const float* trans;
  const unsigned char* keep;
  const float* ray_saved;
  float* work;           // the forward's scratch
  float* g_sdf;          // (S,)
  float* g_grad;         // (S, 3)
  float* g_albedo;       // (S, 3)
  float* g_v;            // (S,) or (1,)
  float* g_dirs;         // null, or shaped as dirs (row stride dir_stride)
};

namespace {

// The scratch, in 4-byte words from `work` (16-byte aligned pieces).
struct Work {
  unsigned* ticket;      // [2] blocks done: the forward's, the backward's
  double* tile_sum;      // [nb] each tile's total of lw
  float* inv_s;          // [nb] each tile's largest inv_s
  int* head_ray;         // [nb] the backward's: the tile's first ray when
                         //      it started in an earlier tile, else −1
  float* head;           // [nb·3] that ray's g_ray_d over this tile
  float* part;           // [nb·4] per block: colour, mask, eikonal,
                         //        weight sum; the backward's g_v in [0]
  unsigned* cnt;         // [nb·2] per block: kept samples, alive rays
  double* cloc;          // [S] each slot's prefix within its tile
  unsigned char* alive;  // [S] each slot alive
};

__host__ __device__ __forceinline__ int n_tiles(int S) {
  return (S + kTile - 1) / kTile;
}

// Pieces of a buffer laid out one after another, each rounded up to 16
// bytes; with a null base only the size is counted (the launchers' sizes
// come from the same functions as the kernels' pointers).
struct Carve {
  unsigned char* base;
  long long off;
  template <typename T>
  __host__ __device__ T* take(long long count) {
    T* r = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += (count * (long long)sizeof(T) + 15) & ~15LL;
    return r;
  }
};

__host__ __device__ __forceinline__ long long layout(float* base, int S,
                                                     Work& w) {
  const long long nb = n_tiles(S);
  Carve cv{reinterpret_cast<unsigned char*>(base), 0};
  w.ticket = cv.take<unsigned>(2);
  w.tile_sum = cv.take<double>(nb);
  w.inv_s = cv.take<float>(nb);
  w.head_ray = cv.take<int>(nb);
  w.head = cv.take<float>(3 * nb);
  w.part = cv.take<float>(4 * nb);
  w.cnt = cv.take<unsigned>(2 * nb);
  w.cloc = cv.take<double>(S);
  w.alive = cv.take<unsigned char>(S);
  return cv.off / 4;
}

__device__ __forceinline__ float relu_(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float sigmoid_(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float clampf_(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);   // NaN passes, as torch.clamp
}

__device__ __forceinline__ float sign_(float x) {
  return (float)(x > 0.f) - (float)(x < 0.f);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

// sdf_to_alpha (render/neus.py) and the values its derivative needs.
struct Alpha {
  float alpha, x, r1, r2, en, ep, cn, cp, den;
};

__device__ __forceinline__ Alpha sdf_to_alpha(float sdf, float tc, float dt,
                                              float s, float a) {
  Alpha o;
  o.r1 = __fadd_rn(__fmul_rn(-tc, 0.5f), 0.5f);
  o.r2 = -tc;
  const float ic = -__fadd_rn(__fmul_rn(relu_(o.r1), __fsub_rn(1.f, a)),
                              __fmul_rn(relu_(o.r2), a));
  const float h = __fmul_rn(__fmul_rn(ic, dt), 0.5f);
  o.en = __fadd_rn(sdf, h);
  o.ep = __fsub_rn(sdf, h);
  o.cn = sigmoid_(__fmul_rn(o.en, s));
  o.cp = sigmoid_(__fmul_rn(o.ep, s));
  o.den = __fadd_rn(o.cp, 1e-5f);
  o.x = __fdiv_rn(__fadd_rn(__fsub_rn(o.cp, o.cn), 1e-5f), o.den);
  o.alpha = clampf_(o.x, 0.f, 1.f);
  return o;
}

// albedo4 (make_albedo4 of albedo_activation): a[0..2] the activated
// albedo, a[3] the RGB+ channel; q = 3 − Σa² (L2 RGB+).
struct Albedo {
  float a[4];
  float q;
};

__device__ __forceinline__ Albedo albedo4(const float* raw,
                                          const Options& o) {
  Albedo b;
  b.q = 0.f;
  if (o.no_albedo) {
    b.a[0] = b.a[1] = b.a[2] = 1.f;
    b.a[3] = 0.f;
    return b;
  }
  for (int c = 0; c < 3; ++c) b.a[c] = expf(clampf_(raw[c], -10.f, 10.f));
  if (!o.rgbplus) {
    b.a[3] = 0.f;
  } else if (o.l2) {
    b.q = 3.f - (b.a[0] * b.a[0] + b.a[1] * b.a[1] + b.a[2] * b.a[2]);
    b.a[3] = sqrtf(b.q < 0.f ? 0.f : b.q);
  } else {
    b.a[3] = 3.f - (fabsf(b.a[0]) + fabsf(b.a[1]) + fabsf(b.a[2]));
  }
  return b;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Block sums in a fixed order: N values per thread into shared `red`
// (N·kWarps of them); every thread gets the sums in `v`.
template <typename T, int N>
__device__ __forceinline__ void block_sum(T (&v)[N], T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < N; ++i) {
    const T s = warp_sum(v[i]);
    if (lane == 0) red[i * kWarps + warp] = s;
  }
  __syncthreads();
  for (int i = 0; i < N; ++i) {
    T s = 0;
    for (int w = 0; w < kWarps; ++w) s += red[i * kWarps + w];
    v[i] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const float m = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

// Inclusive Kogge-Stone scan across a warp's lanes.
__device__ __forceinline__ double warp_scan(double y, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const double up = __shfl_up_sync(kFull, y, d);
    if (lane >= d) y = __dadd_rn(y, up);
  }
  return y;
}

// The prefix order (kernels/neus_loss.py's `_block_scan`): thread t holds
// the n consecutive values a[n·t … n·t + n − 1] (shared memory, kThreads·n
// of them), which become their exclusive prefixes within the block: each
// thread's values serially, then its warp's threads, then the block's
// warps, the three parts added as (warp + lane) + own, all in float64.
// Returns the block's total to every thread. `red` holds 2·kWarps
// doubles.
__device__ double block_prefix(double* a, int n, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double* mine = a + threadIdx.x * n;
  double s = 0.0;
  for (int k = 0; k < n; ++k) {
    const double x = mine[k];
    mine[k] = s;
    s = __dadd_rn(s, x);
  }
  const double incl = warp_scan(s, lane);
  double lane_ex = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) lane_ex = 0.0;
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const double w = warp_scan(lane < kWarps ? red[lane] : 0.0, lane);
    if (lane < kWarps) red[kWarps + lane] = w;
  }
  __syncthreads();
  const double base = __dadd_rn(warp ? red[kWarps + warp - 1] : 0.0,
                                lane_ex);
  for (int k = 0; k < n; ++k) mine[k] = __dadd_rn(base, mine[k]);
  const double total = red[2 * kWarps - 1];
  __syncthreads();
  return total;
}

// C at a slot: its tile's offset plus its prefix within the tile, the one
// rounding to float32.
__device__ __forceinline__ float prefix_at(double off, double loc) {
  return __double2float_rn(__dadd_rn(off, loc));
}

// Segmented exclusive sums of N values per slot over the tile's runs of
// equal ray id: ex[c·kTile + l] = Σ of x[c·kTile + k] over the slots k of
// l's run before l (Rev: after l) within the tile. Slots l ≥ n are runs
// of their own. Thread t takes positions kPer·t …, position p being slot
// p (Rev: kTile − 1 − p). `red` holds kWarps·(N + 1) floats. Ends with
// __syncthreads().
template <int N, bool Rev>
__device__ void run_scan(const float* x, float* ex, const long long* rid,
                         int n, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float run[N];
  float part[kPer][N];
  bool head[kPer];
  bool any = false;
  for (int c = 0; c < N; ++c) run[c] = 0.f;
  for (int k = 0; k < kPer; ++k) {
    const int p = kPer * threadIdx.x + k;
    const int l = Rev ? kTile - 1 - p : p;
    const int prev = Rev ? l + 1 : l - 1;
    head[k] = l >= n || (Rev ? l == n - 1 : l == 0) || rid[l] != rid[prev];
    any |= head[k];
    for (int c = 0; c < N; ++c) {
      const float v = l < n ? x[c * kTile + l] : 0.f;
      if (head[k]) {
        part[k][c] = 0.f;
        run[c] = v;
      } else {
        part[k][c] = run[c];
        run[c] = __fadd_rn(run[c], v);
      }
    }
  }
  // the threads' aggregates (any head, its sums since the last head)
  // scanned across the warp: (f, v) then (g, u) is (f ∨ g, g ? u : v + u)
  bool f = any;
  float val[N];
  for (int c = 0; c < N; ++c) val[c] = run[c];
  for (int d = 1; d < 32; d <<= 1) {
    const bool uf = __shfl_up_sync(kFull, f, d);
    float uv[N];
    for (int c = 0; c < N; ++c) uv[c] = __shfl_up_sync(kFull, val[c], d);
    if (lane >= d) {
      if (!f)
        for (int c = 0; c < N; ++c) val[c] = __fadd_rn(uv[c], val[c]);
      f = f || uf;
    }
  }
  bool ef = __shfl_up_sync(kFull, f, 1);
  float ev[N];
  for (int c = 0; c < N; ++c) ev[c] = __shfl_up_sync(kFull, val[c], 1);
  if (lane == 0) {
    ef = false;
    for (int c = 0; c < N; ++c) ev[c] = 0.f;
  }
  float* rv = red;                       // [N][kWarps]
  float* rf = red + N * kWarps;          // [kWarps], 1.f where a head
  if (lane == 31) {
    for (int c = 0; c < N; ++c) rv[c * kWarps + warp] = val[c];
    rf[warp] = f ? 1.f : 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    bool wf = lane < kWarps && rf[lane] != 0.f;
    float wv[N];
    for (int c = 0; c < N; ++c) wv[c] = lane < kWarps ? rv[c * kWarps + lane]
                                                      : 0.f;
    for (int d = 1; d < kWarps; d <<= 1) {
      const bool uf = __shfl_up_sync(kFull, wf, d);
      float uv[N];
      for (int c = 0; c < N; ++c) uv[c] = __shfl_up_sync(kFull, wv[c], d);
      if (lane >= d) {
        if (!wf)
          for (int c = 0; c < N; ++c) wv[c] = __fadd_rn(uv[c], wv[c]);
        wf = wf || uf;
      }
    }
    __syncwarp();
    if (lane < kWarps) {
      for (int c = 0; c < N; ++c) rv[c * kWarps + lane] = wv[c];
      rf[lane] = wf ? 1.f : 0.f;
    }
  }
  __syncthreads();
  // the carry into this thread: the warps before, then the lanes before
  float cin[N];
  for (int c = 0; c < N; ++c) {
    const float wc = warp ? rv[c * kWarps + warp - 1] : 0.f;
    cin[c] = ef ? ev[c] : __fadd_rn(wc, ev[c]);
  }
  bool open = true;                      // no head yet in this thread
  for (int k = 0; k < kPer; ++k) {
    const int p = kPer * threadIdx.x + k;
    const int l = Rev ? kTile - 1 - p : p;
    open = open && !head[k];
    if (l < n)
      for (int c = 0; c < N; ++c)
        ex[c * kTile + l] = open ? __fadd_rn(cin[c], part[k][c])
                                 : part[k][c];
  }
  __syncthreads();
}

// One stream of a tile brought into shared memory.
struct Stream {
  void* dst;
  const void* src;
  int bytes;
  bool bulk;
};

__device__ __forceinline__ void copy_plain(void* dst, const void* src,
                                           int bytes) {
  if ((reinterpret_cast<uintptr_t>(src) & 3) == 0 && (bytes & 3) == 0) {
    const uint32_t* s = static_cast<const uint32_t*>(src);
    uint32_t* d = static_cast<uint32_t*>(dst);
    for (int i = threadIdx.x; i < bytes / 4; i += kThreads) d[i] = s[i];
  } else {
    const unsigned char* s = static_cast<const unsigned char*>(src);
    unsigned char* d = static_cast<unsigned char*>(dst);
    for (int i = threadIdx.x; i < bytes; i += kThreads) d[i] = s[i];
  }
}

// Bring the streams into shared memory: the bulk ones by cp.async.bulk
// on `bar` (initialised for one arrival), the others by the block's
// threads. Ends with __syncthreads().
template <int N>
__device__ void stage(const Stream (&s)[N], uint64_t* bar) {
  uint32_t tx = 0;
  for (int i = 0; i < N; ++i)
    if (s[i].src && s[i].bulk) tx += s[i].bytes;
  if (threadIdx.x == 0 && tx) {
    mbar_expect_tx(bar, tx);
    for (int i = 0; i < N; ++i)
      if (s[i].src && s[i].bulk) bulk_load(s[i].dst, s[i].src, s[i].bytes, bar);
  }
  for (int i = 0; i < N; ++i)
    if (s[i].src && !s[i].bulk) copy_plain(s[i].dst, s[i].src, s[i].bytes);
  if (tx) mbar_wait(bar, 0);
  __syncthreads();
}

__device__ __forceinline__ void init_barrier(uint64_t* bar) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
}

// Bits of the launchers' `bulk` mask: which streams are 16-byte aligned.
enum : unsigned {
  kBulkSdf = 1u, kBulkDt = 2u, kBulkRid = 4u, kBulkValid = 8u, kBulkV = 16u,
  kBulkDirs = 32u, kBulkGrad = 64u, kBulkAlpha = 128u, kBulkTrans = 256u,
  kBulkKeep = 512u, kBulkWork = 1024u
};

// The (S, 8) attributes are staged when their rows are 8 floats; ∇ when
// its rows are packed.
__host__ __device__ __forceinline__ bool stage_dirs(const Options& o) {
  return o.dirs_per_sample && o.dir_stride == 8;
}

__host__ __device__ __forceinline__ bool stage_grad(const Options& o) {
  return o.grad_stride == 3;
}

// Each kernel's dynamic shared memory, carved from its base (null: the
// size alone, for the launchers).
struct ScanShared {
  uint64_t* bar;
  float *sdf, *dt, *v, *dirs, *grad;
  double* lw;
  long long* rid;
  unsigned char* valid;
};

__host__ __device__ __forceinline__ long long carve(unsigned char* base,
                                                    const Options& o,
                                                    ScanShared& s) {
  Carve cv{base, 0};
  s.bar = cv.take<uint64_t>(2);
  s.sdf = cv.take<float>(kTile);
  s.dt = cv.take<float>(kTile);
  s.v = cv.take<float>(kTile);
  s.lw = cv.take<double>(kTile);
  s.rid = cv.take<long long>(kTile);
  s.valid = cv.take<unsigned char>(kTile);
  s.dirs = stage_dirs(o) ? cv.take<float>(8 * kTile) : nullptr;
  s.grad = stage_grad(o) ? cv.take<float>(3 * kTile) : nullptr;
  return cv.off;
}

// The tile offsets: each thread scans this many tile totals.
__host__ __device__ __forceinline__ int offsets_per_thread(const Options& o) {
  return (n_tiles(o.S) + kThreads - 1) / kThreads;
}

struct ForwardShared {
  uint64_t* bar;
  float *alpha, *grad, *x, *ex;
  double *cloc, *off;
  long long* rid;
  unsigned char* alive;
};

__host__ __device__ __forceinline__ long long carve(unsigned char* base,
                                                    const Options& o,
                                                    ForwardShared& s) {
  Carve cv{base, 0};
  s.bar = cv.take<uint64_t>(2);
  s.alpha = cv.take<float>(kTile);
  s.cloc = cv.take<double>(kTile);
  s.x = cv.take<float>(5 * kTile);
  s.ex = cv.take<float>(5 * kTile);
  s.off = cv.take<double>((long long)kThreads * offsets_per_thread(o));
  s.rid = cv.take<long long>(kTile);
  s.alive = cv.take<unsigned char>(kTile);
  s.grad = stage_grad(o) ? cv.take<float>(3 * kTile) : nullptr;
  return cv.off;
}

struct BackwardShared {
  uint64_t* bar;
  float *sdf, *dt, *v, *alpha, *trans, *gww, *gw, *G, *dirs, *grad;
  long long* rid;
  unsigned char *keep, *alive;
};

__host__ __device__ __forceinline__ long long carve(unsigned char* base,
                                                    const Options& o,
                                                    BackwardShared& s) {
  Carve cv{base, 0};
  s.bar = cv.take<uint64_t>(2);
  s.sdf = cv.take<float>(kTile);
  s.dt = cv.take<float>(kTile);
  s.v = cv.take<float>(kTile);
  s.alpha = cv.take<float>(kTile);
  s.trans = cv.take<float>(kTile);
  s.gww = cv.take<float>(kTile);
  s.gw = cv.take<float>(kTile);
  s.G = cv.take<float>(kTile);
  s.dirs = cv.take<float>(8 * kTile);
  s.rid = cv.take<long long>(kTile);
  s.keep = cv.take<unsigned char>(kTile);
  s.alive = cv.take<unsigned char>(kTile);
  s.grad = stage_grad(o) ? cv.take<float>(3 * kTile) : nullptr;
  return cv.off;
}

__device__ __forceinline__ bool ray_alive(const Inputs& in, long long r) {
  return in.alive[r] && in.ray_kept[r];
}

// A slot's direction and ∇sdf, from the staged tile or device memory.
__device__ __forceinline__ void slot_dir(const Inputs& in, const Options& o,
                                         const float* dirs_s, int l,
                                         long long j, long long rc,
                                         float d[3]) {
  for (int c = 0; c < 3; ++c)
    d[c] = !o.dirs_per_sample ? in.dirs[3 * rc + c]
           : dirs_s           ? dirs_s[8 * l + c]
                              : in.dirs[j * o.dir_stride + c];
}

__device__ __forceinline__ void slot_grad(const Inputs& in, const Options& o,
                                          const float* grad_s, int l,
                                          long long j, float g[3]) {
  for (int c = 0; c < 3; ++c)
    g[c] = grad_s ? grad_s[3 * l + c] : in.grad[j * o.grad_stride + c];
}

// ---------------------------------------------------------------------------
// forward, 1: α, alive, the tile's local prefix of lw, total and inv_s
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
neus_loss_scan_kernel(const Inputs in, const Options o, const ForwardOut out,
                      const unsigned bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2 * kWarps];
  __shared__ double dred[2 * kWarps];
  Work wk;
  layout(out.work, o.S, wk);
  const int b = blockIdx.x;
  const long long base = (long long)b * kTile;
  const int n = (int)min((long long)kTile, o.S - base);
  const bool full = n == kTile;
  ScanShared sh;
  carve(smem, o, sh);
  uint64_t* bar = sh.bar;
  float *sdf_s = sh.sdf, *dt_s = sh.dt, *v_s = sh.v, *dirs_s = sh.dirs,
        *grad_s = sh.grad;
  double* lw_s = sh.lw;
  long long* rid_s = sh.rid;
  unsigned char* valid_s = sh.valid;
  if (b == 0 && threadIdx.x == 0) wk.ticket[0] = wk.ticket[1] = 0u;
  init_barrier(bar);
  const Stream st[] = {
      {sdf_s, in.sdf + base, 4 * n, full && (bulk & kBulkSdf)},
      {dt_s, in.dt + base, 4 * n, full && (bulk & kBulkDt)},
      {rid_s, in.ray_id + base, 8 * n, full && (bulk & kBulkRid)},
      {valid_s, in.valid + base, n, full && (bulk & kBulkValid)},
      {v_s, o.v_per_sample ? in.v + base : nullptr, 4 * n,
       full && (bulk & kBulkV)},
      {dirs_s, dirs_s ? in.dirs + base * 8 : nullptr, 32 * n,
       full && (bulk & kBulkDirs)},
      {grad_s, grad_s ? in.grad + base * 3 : nullptr, 12 * n,
       full && (bulk & kBulkGrad)}};
  stage(st, bar);
  float inv_s_max = 0.f;
  for (int i = 0; i < kPer; ++i) {
    const int l = i * kThreads + threadIdx.x;
    float lw = 0.f;
    if (l < n) {
      const long long j = base + l;
      const long long r = rid_s[l];
      const long long rc = r < o.R ? r : o.R - 1;
      const bool al = valid_s[l] && r < o.R &&
                      (o.dirs_per_sample
                           ? (dirs_s ? dirs_s[8 * l + 3]
                                     : in.dirs[j * o.dir_stride + 3]) > 0.5f
                           : ray_alive(in, rc));
      const float s = expf(__fmul_rn(10.f, o.v_per_sample ? v_s[l] : in.v[0]));
      inv_s_max = fmaxf(inv_s_max, s);
      float a = 0.f;
      if (al) {
        float d[3], g[3];
        slot_dir(in, o, dirs_s, l, j, rc, d);
        slot_grad(in, o, grad_s, l, j, g);
        a = sdf_to_alpha(sdf_s[l], dot3(d, g), dt_s[l], s, o.cos_anneal)
                .alpha;
      }
      lw = log1pf(-(a > kAlphaCap ? kAlphaCap : a));
      out.alpha[j] = a;
      wk.alive[j] = al;
    }
    lw_s[l] = lw;
  }
  const float m = block_max(inv_s_max, red);
  if (threadIdx.x == 0) wk.inv_s[b] = m;
  // lw_s is complete (block_max synchronised); the logs that the prefix
  // sums are the ones written for a check
  if (out.lw)
    for (int i = 0; i < kPer; ++i) {
      const int l = i * kThreads + threadIdx.x;
      if (l < n) out.lw[base + l] = (float)lw_s[l];
    }
  __syncthreads();
  const double total = block_prefix(lw_s, kPer, dred);
  for (int k = 0; k < kPer; ++k) {
    const int l = kPer * threadIdx.x + k;
    if (l < n) wk.cloc[base + l] = lw_s[l];
  }
  if (threadIdx.x == 0) wk.tile_sum[b] = total;
}

// ---------------------------------------------------------------------------
// forward, 2: C, T, keep, the per-ray sums, the loss
// ---------------------------------------------------------------------------

struct RayLoss {
  float color, mask;
};

// A finished ray's colour and mask terms from its sums p (pred4, weight
// sum); writes its colour.
__device__ RayLoss ray_loss(const Inputs& in, const Options& o, long long r,
                            const float p[5], float* color) {
  const float raf = ray_alive(in, r) ? 1.f : 0.f;
  float cl = 0.f;
  for (int c = 0; c < 4; ++c) {
    const float d = p[c] - in.target4[4 * r + c];
    cl += o.l2 ? d * d : fabsf(d);
  }
  if (o.rgbplus) cl = cl / 2.f;
  RayLoss out;
  out.color = cl * in.mask_color[r] * raf;
  color[r] = out.color;
  const float mg = in.mask_gt[r];
  const float wc = clampf_(p[4], kWsLo, kWsHi);
  const float pp = o.bce ? wc : sigmoid_(wc);
  out.mask = -(mg * logf(pp) + (1.f - mg) * logf(1.f - pp)) * raf;
  return out;
}

// Whether ray r owns slots (its run starts at seg_start[r]).
__device__ __forceinline__ bool has_slots(const Inputs& in, const Options& o,
                                          long long r) {
  const long long s = in.seg_start[r];
  return s >= 0 && s < o.S && in.ray_id[s] == r;
}

__device__ __forceinline__ int rays_per_block(const Options& o) {
  const int nb = n_tiles(o.S);
  return (o.R + nb - 1) / nb;
}

__global__ void __launch_bounds__(kThreads)
neus_loss_forward_kernel(const Inputs in, const Options o,
                         const ForwardOut out, const unsigned bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[6 * kWarps];
  __shared__ double dred[2 * kWarps];
  __shared__ unsigned long long ured[2 * kWarps];
  __shared__ bool last, first_earlier, carried;
  Work wk;
  layout(out.work, o.S, wk);
  const int b = blockIdx.x, nb = gridDim.x;
  const long long base = (long long)b * kTile;
  const int n = (int)min((long long)kTile, o.S - base);
  const bool full = n == kTile;
  const int per_t = offsets_per_thread(o);
  ForwardShared sh;
  carve(smem, o, sh);
  uint64_t* bar = sh.bar;
  float *alpha_s = sh.alpha, *grad_s = sh.grad, *x_s = sh.x, *ex_s = sh.ex;
  double *cloc_s = sh.cloc, *off_s = sh.off;
  long long* rid_s = sh.rid;
  unsigned char* alive_s = sh.alive;
  init_barrier(bar);
  const Stream st[] = {
      {alpha_s, out.alpha + base, 4 * n, full && (bulk & kBulkAlpha)},
      {cloc_s, wk.cloc + base, 8 * n, full && (bulk & kBulkWork)},
      {rid_s, in.ray_id + base, 8 * n, full && (bulk & kBulkRid)},
      {alive_s, wk.alive + base, n, full && (bulk & kBulkWork)},
      {grad_s, grad_s ? in.grad + base * 3 : nullptr, 12 * n,
       full && (bulk & kBulkGrad)}};
  for (int i = threadIdx.x; i < kThreads * per_t; i += kThreads)
    off_s[i] = i < nb ? wk.tile_sum[i] : 0.0;
  stage(st, bar);
  block_prefix(off_s, per_t, dred);     // every tile's offset
  if (threadIdx.x == 0)
    first_earlier = b > 0 && rid_s[0] < o.R && in.ray_id[base - 1] == rid_s[0];
  // per slot: C, T, keep, w and what the sums add
  float ek = 0.f;
  unsigned kept = 0;
  const double off = off_s[b];
  for (int i = 0; i < kPer; ++i) {
    const int l = i * kThreads + threadIdx.x;
    float x[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (l < n) {
      const long long j = base + l;
      const long long r = rid_s[l];
      const long long rc = r < o.R ? r : o.R - 1;
      long long s = in.seg_start[rc];
      s = s < 0 ? 0 : (s > o.S - 1 ? o.S - 1 : s);
      const float cj = prefix_at(off, cloc_s[l]);
      const float cs = (s >= base && s < base + n)
                           ? prefix_at(off, cloc_s[s - base])
                           : prefix_at(off_s[s / kTile], __ldg(wk.cloc + s));
      const float T = expf(__fsub_rn(cj, cs));
      const bool kp = alive_s[l] && T >= kTransEps;
      if (out.cum) out.cum[j] = cj;
      out.trans[j] = T;
      out.keep[j] = kp;
      if (kp) {
        const float w = __fmul_rn(alpha_s[l], T);
        float g[3];
        slot_grad(in, o, grad_s, l, j, g);
        const float L[3] = {in.light[3 * rc], in.light[3 * rc + 1],
                            in.light[3 * rc + 2]};
        const float s0 = g[0] * L[0] + g[1] * L[1] + g[2] * L[2];
        const float sh = o.relu ? relu_(s0) : s0;
        const Albedo ab = albedo4(in.albedo + j * o.albedo_stride, o);
        for (int c = 0; c < 4; ++c) x[c] = w * ab.a[c] * sh;
        x[4] = w;
        const float gn = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2] +
                               1e-6f);
        ek += (gn - 1.f) * (gn - 1.f);
        kept += 1;
      }
    }
    for (int c = 0; c < 5; ++c) x_s[c * kTile + l] = x[c];
  }
  __syncthreads();
  run_scan<5, false>(x_s, ex_s, rid_s, n, red);
  // the tile's last ray, when it starts here and goes on past the tile:
  // its sums over the later slots, a chunk of kThreads slots at a time
  // (the same C, T and w as the later tiles' blocks compute)
  if (threadIdx.x == 0) {
    const long long r = rid_s[n - 1];
    carried = r < o.R && base + n < o.S && in.ray_id[base + n] == r &&
              !(first_earlier && r == rid_s[0]);
  }
  __syncthreads();
  float carry[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (carried) {
    const long long r = rid_s[n - 1];
    long long s = in.seg_start[r];
    s = s < 0 ? 0 : (s > o.S - 1 ? o.S - 1 : s);
    const float cs = prefix_at(off_s[s / kTile], __ldg(wk.cloc + s));
    const float L[3] = {in.light[3 * r], in.light[3 * r + 1],
                        in.light[3 * r + 2]};
    for (long long start = base + n;; start += kThreads) {
      const long long k = start + threadIdx.x;
      float x[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (k < o.S && in.ray_id[k] == r && wk.alive[k]) {
        const float T = expf(__fsub_rn(
            prefix_at(off_s[k / kTile], __ldg(wk.cloc + k)), cs));
        if (T >= kTransEps) {
          const float w = __fmul_rn(out.alpha[k], T);
          float g[3];
          slot_grad(in, o, nullptr, 0, k, g);
          const float s0 = g[0] * L[0] + g[1] * L[1] + g[2] * L[2];
          const float sh = o.relu ? relu_(s0) : s0;
          const Albedo ab = albedo4(in.albedo + k * o.albedo_stride, o);
          for (int c = 0; c < 4; ++c) x[c] = w * ab.a[c] * sh;
          x[4] = w;
        }
      }
      block_sum(x, red);
      for (int c = 0; c < 5; ++c) carry[c] = __fadd_rn(carry[c], x[c]);
      const long long next = start + kThreads;
      if (!(next < o.S && in.ray_id[next] == r)) break;
    }
  }
  // each run's end: its ray's sums, and the ray finished here unless it
  // started in an earlier tile (whose block finishes it)
  float acc[4] = {0.f, 0.f, ek, 0.f};   // colour, mask, eikonal, weight sum
  unsigned long long cnt[2] = {kept, 0};
  for (int i = 0; i < kPer; ++i) {
    const int l = i * kThreads + threadIdx.x;
    if (l >= n) continue;
    const long long r = rid_s[l];
    if (r >= o.R || (l < n - 1 && rid_s[l + 1] == r) ||
        (first_earlier && r == rid_s[0]))
      continue;
    float p[5];
    for (int c = 0; c < 5; ++c)
      p[c] = __fadd_rn(ex_s[c * kTile + l], x_s[c * kTile + l]);
    if (l == n - 1 && carried)
      for (int c = 0; c < 5; ++c) p[c] = __fadd_rn(p[c], carry[c]);
    for (int c = 0; c < 5; ++c) out.ray_saved[5 * r + c] = p[c];
    const RayLoss rl = ray_loss(in, o, r, p, out.color);
    acc[0] += rl.color;
    acc[1] += rl.mask;
    acc[3] += p[4];
  }
  // this block's range of rays: the alive count, and those without slots
  const int rpb = rays_per_block(o);
  for (long long r = (long long)b * rpb + threadIdx.x;
       r < min((long long)o.R, (long long)(b + 1) * rpb); r += kThreads) {
    cnt[1] += ray_alive(in, r);
    if (!has_slots(in, o, r)) {
      const float p[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < 5; ++c) out.ray_saved[5 * r + c] = 0.f;
      const RayLoss rl = ray_loss(in, o, r, p, out.color);
      acc[0] += rl.color;
      acc[1] += rl.mask;
    }
  }
  block_sum(acc, red);
  block_sum(cnt, ured);
  if (threadIdx.x == 0) {
    for (int c = 0; c < 4; ++c) wk.part[4 * b + c] = acc[c];
    wk.cnt[2 * b] = (unsigned)cnt[0];
    wk.cnt[2 * b + 1] = (unsigned)cnt[1];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&wk.ticket[0], 1u) == (unsigned)nb - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: the blocks' partials
  float tot[4] = {0.f, 0.f, 0.f, 0.f};
  unsigned long long tc[2] = {0, 0};
  // the blocks' partials, each thread a strided run of them in order
  for (int t = threadIdx.x; t < nb; t += kThreads) {
    for (int c = 0; c < 4; ++c) tot[c] += __ldcg(wk.part + 4 * t + c);
    tc[0] += __ldcg(wk.cnt + 2 * t);
    tc[1] += __ldcg(wk.cnt + 2 * t + 1);
  }
  float smax = 0.f;
  if (o.v_per_sample)
    for (int t = threadIdx.x; t < nb; t += kThreads)
      smax = fmaxf(smax, wk.inv_s[t]);
  block_sum(tot, red);
  block_sum(tc, ured);
  smax = o.v_per_sample ? block_max(smax, red)
                         : expf(__fmul_rn(10.f, in.v[0]));
  if (threadIdx.x == 0) {
    const float color = tot[0], mask = tot[1], ekt = tot[2], ws = tot[3];
    *out.total = (color + o.mask_w * mask) / o.n_rays +
                 o.ek_w * ekt / o.ek_div;
    out.metrics[0] = color / o.n_rays;
    out.metrics[1] = mask / o.n_rays;
    out.metrics[2] = ekt / fmaxf((float)tc[0], 1.f);
    out.metrics[3] = ws / fmaxf((float)tc[1], 1.f);
    out.metrics[4] = smax;
    out.counts[0] = (long long)tc[0];
    out.counts[1] = (long long)tc[1];
    wk.ticket[0] = 0u;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// A ray's part of every sample's gradient: g_pred4 and g_ws from its
// colour and mask terms, its light and (per-ray directions) direction.
struct RayGrad {
  float gp[4], gws, L[3];
};

__device__ __forceinline__ RayGrad ray_grad(const Inputs& in,
                                            const Options& o,
                                            const float* saved, float g,
                                            long long r) {
  RayGrad rg;
  const float raf = ray_alive(in, r) ? 1.f : 0.f;
  const float* sv = saved + 5 * r;
  const float g_cl = g / o.n_rays * in.mask_color[r] * raf *
                     (o.rgbplus ? 0.5f : 1.f);
  for (int c = 0; c < 4; ++c) {
    const float d = sv[c] - in.target4[4 * r + c];
    rg.gp[c] = o.l2 ? g_cl * 2.f * d : g_cl * sign_(d);
  }
  const float ws = sv[4], mg = in.mask_gt[r];
  const float wc = clampf_(ws, kWsLo, kWsHi);
  float dm;
  if (o.bce) {
    dm = -(mg / wc - (1.f - mg) / (1.f - wc));
  } else {
    const float sg = sigmoid_(wc);
    dm = -(mg / sg - (1.f - mg) / (1.f - sg)) * (sg * (1.f - sg));
  }
  rg.gws = (ws >= kWsLo && ws <= kWsHi) ? g * o.mask_w / o.n_rays * raf * dm
                                        : 0.f;
  for (int c = 0; c < 3; ++c) rg.L[c] = in.light[3 * r + c];
  return rg;
}

// g_w of a kept sample (the weight's cotangent): its ray's g_ws plus the
// colour's, through the albedo and the shading.
__device__ __forceinline__ float slot_gw(const Options& o, const RayGrad& rg,
                                         const float g[3], const float* raw) {
  const float s0 = g[0] * rg.L[0] + g[1] * rg.L[1] + g[2] * rg.L[2];
  const float sh = o.relu ? relu_(s0) : s0;
  const Albedo ab = albedo4(raw, o);
  const float gpa = rg.gp[0] * ab.a[0] + rg.gp[1] * ab.a[1] +
                    rg.gp[2] * ab.a[2] + rg.gp[3] * ab.a[3];
  return rg.gws + gpa * sh;
}

__global__ void __launch_bounds__(kThreads)
neus_loss_backward_kernel(const Inputs in, const Options o,
                          const BackwardIO io, const unsigned bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[4 * kWarps];
  __shared__ bool last, first_earlier, carried;
  __shared__ float carry;
  Work wk;
  layout(io.work, o.S, wk);
  const int b = blockIdx.x, nb = gridDim.x;
  const long long base = (long long)b * kTile;
  const int n = (int)min((long long)kTile, o.S - base);
  const bool full = n == kTile;
  const bool ray_dirs = io.g_dirs && !o.dirs_per_sample;
  const float g = *io.g_total;
  const float eg = g * o.ek_w / o.ek_div;
  BackwardShared sh;
  carve(smem, o, sh);
  uint64_t* bar = sh.bar;
  float *sdf_s = sh.sdf, *dt_s = sh.dt, *v_s = sh.v, *alpha_s = sh.alpha,
        *trans_s = sh.trans, *grad_s = sh.grad, *gww_s = sh.gww,
        *gw_s = sh.gw, *G_s = sh.G;
  float* dirs_s = stage_dirs(o) ? sh.dirs : nullptr;
  // the per-ray directions' segmented sums share the attributes' room
  float* x3_s = sh.dirs;
  float* ex3_s = sh.dirs + 3 * kTile;
  long long* rid_s = sh.rid;
  unsigned char *keep_s = sh.keep, *alive_s = sh.alive;
  init_barrier(bar);
  const Stream st[] = {
      {sdf_s, in.sdf + base, 4 * n, full && (bulk & kBulkSdf)},
      {dt_s, in.dt + base, 4 * n, full && (bulk & kBulkDt)},
      {rid_s, in.ray_id + base, 8 * n, full && (bulk & kBulkRid)},
      {v_s, o.v_per_sample ? in.v + base : nullptr, 4 * n,
       full && (bulk & kBulkV)},
      {alpha_s, io.alpha + base, 4 * n, full && (bulk & kBulkAlpha)},
      {trans_s, io.trans + base, 4 * n, full && (bulk & kBulkTrans)},
      {keep_s, io.keep + base, n, full && (bulk & kBulkKeep)},
      {alive_s, wk.alive + base, n, full && (bulk & kBulkWork)},
      {grad_s, grad_s ? in.grad + base * 3 : nullptr, 12 * n,
       full && (bulk & kBulkGrad)},
      {dirs_s, dirs_s ? in.dirs + base * 8 : nullptr, 32 * n,
       full && (bulk & kBulkDirs)}};
  stage(st, bar);
  // g_w and g_w·w of every slot
  for (int i = 0; i < kPer; ++i) {
    const int l = i * kThreads + threadIdx.x;
    float gw = 0.f, gww = 0.f;
    if (l < n && keep_s[l]) {
      const long long j = base + l;
      const RayGrad rg = ray_grad(in, o, io.ray_saved, g, rid_s[l]);
      float gr[3];
      slot_grad(in, o, grad_s, l, j, gr);
      gw = slot_gw(o, rg, gr, in.albedo + j * o.albedo_stride);
      gww = gw * __fmul_rn(alpha_s[l], trans_s[l]);
    }
    gw_s[l] = gw;
    gww_s[l] = gww;
  }
  if (threadIdx.x == 0) {
    const long long r = rid_s[n - 1];
    carried = r < o.R && base + n < o.S && in.ray_id[base + n] == r;
    first_earlier = b > 0 && rid_s[0] < o.R && in.ray_id[base - 1] == rid_s[0];
    carry = 0.f;
  }
  __syncthreads();
  run_scan<1, true>(gww_s, G_s, rid_s, n, red);
  // the tile's last ray continues: its g_w·w over the later slots, a
  // chunk of kThreads slots at a time
  const long long r_last = rid_s[n - 1];
  if (carried) {
    const RayGrad rg = ray_grad(in, o, io.ray_saved, g, r_last);
    for (long long start = base + n;; start += kThreads) {
      const long long k = start + threadIdx.x;
      float v[1] = {0.f};
      if (k < o.S && in.ray_id[k] == r_last && io.keep[k]) {
        float gr[3];
        slot_grad(in, o, nullptr, 0, k, gr);
        v[0] = slot_gw(o, rg, gr, in.albedo + k * o.albedo_stride) *
               __fmul_rn(io.alpha[k], io.trans[k]);
      }
      block_sum(v, red);
      if (threadIdx.x == 0) carry = __fadd_rn(carry, v[0]);
      const long long next = start + kThreads;
      if (!(next < o.S && in.ray_id[next] == r_last)) break;
    }
    __syncthreads();
  }
  // the derivatives per slot
  float gv[1] = {0.f};
  for (int i = 0; i < kPer; ++i) {
    const int l = i * kThreads + threadIdx.x;
    if (l >= n) {
      if (ray_dirs)
        for (int c = 0; c < 3; ++c) x3_s[c * kTile + l] = 0.f;
      continue;
    }
    const long long j = base + l;
    const long long r = rid_s[l];
    const long long rc = r < o.R ? r : o.R - 1;
    float gsdf = 0.f, gg[3] = {0.f, 0.f, 0.f}, ga[3] = {0.f, 0.f, 0.f};
    float gvj = 0.f, gd[3] = {0.f, 0.f, 0.f};
    if (alive_s[l]) {
      const bool kp = keep_s[l];
      const float T = trans_s[l];
      float G = G_s[l];
      if (carried && r == r_last) G = __fadd_rn(G, carry);
      float d[3], gr[3];
      slot_dir(in, o, dirs_s, l, j, rc, d);
      slot_grad(in, o, grad_s, l, j, gr);
      const float tc = dot3(d, gr);
      const float s = expf(__fmul_rn(10.f, o.v_per_sample ? v_s[l] : in.v[0]));
      const Alpha A = sdf_to_alpha(sdf_s[l], tc, dt_s[l], s, o.cos_anneal);
      const float w = kp ? __fmul_rn(A.alpha, T) : 0.f;
      float galpha = kp ? gw_s[l] * T : 0.f;
      if (A.alpha <= kAlphaCap) galpha -= G / (1.f - A.alpha);
      // sdf_to_alpha's derivative
      const float gx = (A.x >= 0.f && A.x <= 1.f) ? galpha : 0.f;
      const float gpd = gx / A.den;
      const float gcp = gpd - gx * A.x / A.den;
      const float gen_pre = -gpd * A.cn * (1.f - A.cn);
      const float gep_pre = gcp * A.cp * (1.f - A.cp);
      const float gen = gen_pre * s, gep = gep_pre * s;
      const float gs = gen_pre * A.en + gep_pre * A.ep;
      const float gic = (gen - gep) * dt_s[l] * 0.5f;
      const float gtc = gic * ((A.r1 > 0.f ? 0.5f * (1.f - o.cos_anneal)
                                           : 0.f) +
                               (A.r2 > 0.f ? o.cos_anneal : 0.f));
      gvj = gs * 10.f * s;
      gsdf = o.stop_alpha_sdf ? 0.f : gen + gep;
      if (!o.stop_alpha_normal)
        for (int c = 0; c < 3; ++c) gg[c] = gtc * d[c];
      for (int c = 0; c < 3; ++c) gd[c] = gtc * gr[c];
      if (kp) {
        // the shading, the eikonal term and the albedo
        const RayGrad rg = ray_grad(in, o, io.ray_saved, g, rc);
        const float s0 = gr[0] * rg.L[0] + gr[1] * rg.L[1] + gr[2] * rg.L[2];
        const float sh = o.relu ? relu_(s0) : s0;
        const float* raw = in.albedo + j * o.albedo_stride;
        const Albedo ab = albedo4(raw, o);
        const float gpa = rg.gp[0] * ab.a[0] + rg.gp[1] * ab.a[1] +
                          rg.gp[2] * ab.a[2] + rg.gp[3] * ab.a[3];
        float gsh = gpa * w;
        if (o.relu && !(s0 > 0.f)) gsh = 0.f;
        if (!o.stop_shading_normal)
          for (int c = 0; c < 3; ++c) gg[c] += gsh * rg.L[c];
        const float gn = sqrtf(gr[0] * gr[0] + gr[1] * gr[1] +
                               gr[2] * gr[2] + 1e-6f);
        const float ge = eg * 2.f * (gn - 1.f) / gn;
        for (int c = 0; c < 3; ++c) gg[c] += ge * gr[c];
        if (!o.no_albedo) {
          const float wsh = w * sh;
          for (int c = 0; c < 3; ++c) ga[c] = rg.gp[c] * wsh;
          const float g4 = rg.gp[3] * wsh;
          if (o.rgbplus && o.l2) {
            float gq = g4 * 0.5f / fmaxf(ab.a[3] + 1e-5f, o.grad_floor);
            if (!o.ref_jacobian && !(ab.q > 0.f)) gq = 0.f;
            for (int c = 0; c < 3; ++c) ga[c] += gq * (-2.f * ab.a[c]);
          } else if (o.rgbplus) {
            for (int c = 0; c < 3; ++c) ga[c] -= g4 * sign_(ab.a[c]);
          }
          for (int c = 0; c < 3; ++c)
            ga[c] = (raw[c] >= -10.f && raw[c] <= 10.f) ? ga[c] * ab.a[c]
                                                        : 0.f;
        }
      }
    }
    io.g_sdf[j] = gsdf;
    for (int c = 0; c < 3; ++c) {
      io.g_grad[3 * j + c] = gg[c];
      io.g_albedo[3 * j + c] = ga[c];
    }
    if (o.v_per_sample)
      io.g_v[j] = gvj;
    else
      gv[0] += gvj;
    if (io.g_dirs && o.dirs_per_sample) {
      for (int c = 0; c < o.dir_stride; ++c)
        io.g_dirs[j * o.dir_stride + c] = c < 3 ? gd[c] : 0.f;
    } else if (ray_dirs) {
      for (int c = 0; c < 3; ++c) x3_s[c * kTile + l] = gd[c];
    }
  }
  if (ray_dirs) {
    // the per-ray directions' gradient: each run's sum over this tile
    __syncthreads();
    run_scan<3, false>(x3_s, ex3_s, rid_s, n, red);
    for (int i = 0; i < kPer; ++i) {
      const int l = i * kThreads + threadIdx.x;
      if (l >= n) continue;
      const long long r = rid_s[l];
      if (r >= o.R || (l < n - 1 && rid_s[l + 1] == r)) continue;
      float p[3];
      for (int c = 0; c < 3; ++c)
        p[c] = __fadd_rn(ex3_s[c * kTile + l], x3_s[c * kTile + l]);
      if (first_earlier && r == rid_s[0]) {
        for (int c = 0; c < 3; ++c) wk.head[3 * b + c] = p[c];
        wk.head_ray[b] = (int)r;
      } else {
        for (int c = 0; c < 3; ++c) io.g_dirs[3 * r + c] = p[c];
      }
    }
    if (threadIdx.x == 0 && !first_earlier) wk.head_ray[b] = -1;
    const int rpb = rays_per_block(o);
    for (long long r = (long long)b * rpb + threadIdx.x;
         r < min((long long)o.R, (long long)(b + 1) * rpb); r += kThreads)
      if (!has_slots(in, o, r))
        for (int c = 0; c < 3; ++c) io.g_dirs[3 * r + c] = 0.f;
  }
  if (o.v_per_sample && !ray_dirs) return;
  block_sum(gv, red);
  if (threadIdx.x == 0) wk.part[4 * b] = gv[0];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&wk.ticket[1], 1u) == (unsigned)nb - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (ray_dirs) {
    for (int t = 1 + threadIdx.x; t < nb; t += kThreads) {
      const int r = __ldcg(wk.head_ray + t);
      if (r < 0 || __ldcg(wk.head_ray + t - 1) == r) continue;
      float p[3];
      for (int c = 0; c < 3; ++c) p[c] = __ldcg(io.g_dirs + 3 * r + c);
      for (int u = t; u < nb && __ldcg(wk.head_ray + u) == r; ++u)
        for (int c = 0; c < 3; ++c)
          p[c] = __fadd_rn(p[c], __ldcg(wk.head + 3 * u + c));
      for (int c = 0; c < 3; ++c) io.g_dirs[3 * r + c] = p[c];
    }
  }
  if (!o.v_per_sample) {
    float s[1] = {0.f};
    for (int t = threadIdx.x; t < nb; t += kThreads)
      s[0] += __ldcg(wk.part + 4 * t);
    block_sum(s, red);
    if (threadIdx.x == 0) *io.g_v = s[0];
  }
  if (threadIdx.x == 0) wk.ticket[1] = 0u;
}

bool options_ok(const Options& o) {
  return o.S > 0 && o.R > 0 && n_tiles(o.S) <= kMaxTiles &&
         (o.dirs_per_sample ? o.dir_stride >= 4 : o.dir_stride == 3) &&
         o.grad_stride >= 3 && o.albedo_stride >= 3;
}

template <typename Shared>
int smem_bytes(const Options& o) {
  Shared s;
  return (int)carve(nullptr, o, s);
}

template <typename Kernel, typename Out>
int launch(Kernel kernel, int smem, const Inputs& in, const Options& o,
           const Out& out, unsigned bulk, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<n_tiles(o.S), kThreads, smem, (cudaStream_t)stream>>>(in, o, out,
                                                                 bulk);
  return (int)cudaGetLastError();
}

// The bulk mask of the input streams.
unsigned input_bulk(const Inputs& in, const Options& o) {
  return (aligned16(in.sdf) ? kBulkSdf : 0u) |
         (aligned16(in.dt) ? kBulkDt : 0u) |
         (aligned16(in.ray_id) ? kBulkRid : 0u) |
         (aligned16(in.valid) ? kBulkValid : 0u) |
         (o.v_per_sample && aligned16(in.v) ? kBulkV : 0u) |
         (aligned16(in.dirs) ? kBulkDirs : 0u) |
         (aligned16(in.grad) ? kBulkGrad : 0u);
}

}  // namespace

extern "C" {

// Words (4 bytes) of the scratch that the forward and the backward share.
long long neus_loss_work_words(int S) {
  Work w;
  return layout(nullptr, S, w);
}

// inputs, options, out: host pointers to an Inputs, an Options and a
// ForwardOut. The forward's first kernel (α, the tiles' prefixes).
// Launches on `stream` and returns cudaGetLastError().
int neus_loss_scan_launch(const void* inputs, const void* options,
                          const void* out, void* stream) {
  Inputs in;
  Options o;
  ForwardOut f;
  std::memcpy(&in, inputs, sizeof(in));
  std::memcpy(&o, options, sizeof(o));
  std::memcpy(&f, out, sizeof(f));
  if (!options_ok(o)) return (int)cudaErrorInvalidValue;
  return launch(neus_loss_scan_kernel, smem_bytes<ScanShared>(o), in, o, f,
                input_bulk(in, o), stream);
}

// The forward's second kernel (C, T, keep, the sums, the loss), after
// neus_loss_scan_launch on the same ForwardOut.
int neus_loss_forward_launch(const void* inputs, const void* options,
                             const void* out, void* stream) {
  Inputs in;
  Options o;
  ForwardOut f;
  std::memcpy(&in, inputs, sizeof(in));
  std::memcpy(&o, options, sizeof(o));
  std::memcpy(&f, out, sizeof(f));
  if (!options_ok(o)) return (int)cudaErrorInvalidValue;
  const unsigned bulk = input_bulk(in, o) |
                        (aligned16(f.alpha) ? kBulkAlpha : 0u) |
                        (aligned16(f.work) ? kBulkWork : 0u);
  return launch(neus_loss_forward_kernel, smem_bytes<ForwardShared>(o), in,
                o, f, bulk, stream);
}

// inputs, options, io: host pointers to an Inputs, an Options and a
// BackwardIO whose forward's pointers are those of a completed forward.
int neus_loss_backward_launch(const void* inputs, const void* options,
                              const void* io, void* stream) {
  Inputs in;
  Options o;
  BackwardIO b;
  std::memcpy(&in, inputs, sizeof(in));
  std::memcpy(&o, options, sizeof(o));
  std::memcpy(&b, io, sizeof(b));
  if (!options_ok(o)) return (int)cudaErrorInvalidValue;
  const unsigned bulk = input_bulk(in, o) |
                        (aligned16(b.alpha) ? kBulkAlpha : 0u) |
                        (aligned16(b.trans) ? kBulkTrans : 0u) |
                        (aligned16(b.keep) ? kBulkKeep : 0u) |
                        (aligned16(b.work) ? kBulkWork : 0u);
  return launch(neus_loss_backward_kernel, smem_bytes<BackwardShared>(o),
                in, o, b, bulk, stream);
}

const char* neus_loss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
