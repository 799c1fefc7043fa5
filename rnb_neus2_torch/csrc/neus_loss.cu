// The NeuS composite and loss of a training step, forward and backward:
// per sample the NeuS alpha, per ray the segmented transmittance with its
// keep rule (T >= 1e-4), the shading, the predicted albedo and weight sum,
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
// The function, per ray r with slots j = seg_start[r], seg_start[r] + 1, …
// while ray_id[j] == r (the compaction orders slots by ray; a dropped ray
// or one without samples owns none; unused slots carry ray_id == R):
//
//   alive_j = valid_j ∧ (per-sample attrs: attrs[j, 3] > 0.5; else the
//             ray's alive ∧ ray_kept)
//   α_j     = alive_j ? sdf_to_alpha(sdf, dirs·∇, dt, exp(10·v), a) : 0
//   T_j     = exp(Σ_{i<j} log1p(−min(α_i, 1 − 1e−7)))  (this ray's slots)
//   keep_j  = alive_j ∧ T_j ≥ 1e−4,  w_j = keep_j · α_j · T_j
//   pred4   = Σ_j w_j · albedo4_j · shade_j,  weight_sum = Σ_j w_j
//
// and the colour (L2 or L1, halved under RGB+, × mask_color × ray alive),
// mask (BCE or sigmoid-BCE of the clamped weight sum) and eikonal
// ((‖∇‖ − 1)² over kept samples) terms: total = (Σ colour + mask_w · Σ mask)
// / n_rays + ek_w · Σ eikonal / ek_div. The JAX package sums the
// transmittance's logs over the whole buffer and re-bases each ray at its
// first slot; here each ray sums its own, which rounds less.
//
// Backward, per ray with the upstream gradient g: g_pred4 and g_ws from
// the colour and mask terms; per kept sample g_w = g_ws + Σ_c g_pred4_c ·
// albedo4_c · shade; g_α = g_w · T + [α ≤ 1 − 1e−7] · (−G / (1 − α)) with
// G = Σ_{k>j} g_w_k · w_k, a suffix sum that the reverse walk carries;
// then sdf_to_alpha's, the shading's, the albedo's and the eikonal term's
// derivatives, each where the plain version's autograd takes it (clamps
// pass their bounds, relu is strict). The debug stop-gradients drop
// their terms. Slots past a ray's termination get no gradient: T only
// falls, so no later slot is kept and G is 0 there.
//
// Bound. Bytes (S slots, R rays): the forward reads sdf, ∇, raw albedo,
// dt, the per-sample attrs or directions, ray_id and valid per slot and
// seg_start, the flags, light, target and masks per ray, and writes the
// keep per slot and the per-ray colour; the backward reads the same
// inputs and the forward's saved values and writes five gradients per
// slot (chip_smoke.py's neus_loss_bounds counts them on the main path's
// inputs). Operations: some 60 (forward) and 150 (backward) float32
// operations per slot with three transcendentals; at 67 TFLOP/s that is
// far below the bytes' time. Both kernels are bound by bytes.
//
// Design (the first, simple one). One thread per ray walks its segment
// front to back (the forward) and back to front (the backward), as the
// reference's compute_loss_kernel does; a ray is 4 slots on average at
// the default budget (2^18 slots, 2^16 rays) and the walk stops at
// termination. The forward saves, per walked slot, T (4 B) and, per ray,
// pred4 and the weight sum (20 B) and the walk's end (4 B): the backward
// reads them (1 MB and 1.8 MB at the default budget) instead of
// re-walking each ray forwards for its pred4 before the reverse walk, and
// recomputes α, w, the shading and the albedo from the inputs that it
// reads for their derivatives anyway. A reverse walk that re-derived T by
// subtracting logs would lose the precision that the per-ray sum gains.
// The scalar sums (colour, mask, eikonal, weight sum, kept and alive
// counts, the max inv_s, the variance's gradient) are reduced per block
// and added with one atomic per block, so their last bits vary from run
// to run; the forward's last block to finish forms the loss and the
// metrics. Float operations are plain float32 (nvcc may fuse multiply-adds):
// the kernels are held against the plain version run in float64, not bit
// for bit. Making them fast (a warp per ray with segmented scans, staged
// tiles) is later work.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The
// launchers take host pointers to the structs below (kernels/neus_loss.py
// builds them with ctypes; tests/test_torch_neus_loss.py holds their field
// order against this file), return the cudaError_t of the launch, or
// cudaErrorInvalidValue for arguments they refuse; the caller raises if
// it is not 0.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 128;
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

// The forward's block sums, zeroed by the caller.
struct Accum {
  float color, mask, ek, ws;
  unsigned int inv_s_bits;         // max of positive floats, as bits
  unsigned int done;               // blocks finished
  unsigned long long kept, alive;
};

// The forward's outputs (neus_loss.py's _ForwardOut).
struct ForwardOut {
  float* total;          // ()
  float* metrics;        // (5,) loss_color, loss_mask, loss_ek,
                         //      weight_sum_mean, inv_s
  long long* counts;     // (2,) n_samples_kept, n_rays_alive
  float* color;          // (R,) per-ray colour loss
  unsigned char* keep;   // (S,) zeroed by the caller
  float* trans;          // (S,) T at each walked slot
  float* ray_saved;      // (R, 5) pred4, weight_sum
  int* walk_end;         // (R,) one past the last walked slot
  Accum* acc;            // zeroed by the caller
};

// The backward's inputs from the forward, and its outputs, zeroed by the
// caller (neus_loss.py's _BackwardIO).
struct BackwardIO {
  const float* g_total;  // (), the upstream gradient
  const float* trans;
  const float* ray_saved;
  const int* walk_end;
  float* g_sdf;          // (S,)
  float* g_grad;         // (S, 3)
  float* g_albedo;       // (S, 3)
  float* g_v;            // (S,) or (1,)
  float* g_dirs;         // null, or shaped as dirs (row stride dir_stride)
};

namespace {

__device__ __forceinline__ float relu_(float x) { return x < 0.f ? 0.f : x; }

__device__ __forceinline__ float sigmoid_(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float clampf_(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);   // NaN passes, as torch.clamp
}

__device__ __forceinline__ float sign_(float x) {
  return (float)(x > 0.f) - (float)(x < 0.f);
}

// sdf_to_alpha (render/neus.py) and the values its derivative needs.
struct Alpha {
  float alpha, x, r1, r2, en, ep, cn, cp, den;
};

__device__ __forceinline__ Alpha sdf_to_alpha(float sdf, float tc, float dt,
                                              float s, float a) {
  Alpha o;
  o.r1 = -tc * 0.5f + 0.5f;
  o.r2 = -tc;
  const float ic = -(relu_(o.r1) * (1.f - a) + relu_(o.r2) * a);
  const float h = ic * dt * 0.5f;
  o.en = sdf + h;
  o.ep = sdf - h;
  o.cn = sigmoid_(o.en * s);
  o.cp = sigmoid_(o.ep * s);
  o.den = o.cp + 1e-5f;
  o.x = (o.cp - o.cn + 1e-5f) / o.den;
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

// One slot's fields.
struct Slot {
  float sdf, g[3], d[3], dt, s;
  bool alive;
};

__device__ __forceinline__ bool slot_alive(const Inputs& in, const Options& o,
                                           long long j, bool ray_alive) {
  if (!in.valid[j]) return false;
  return o.dirs_per_sample ? in.dirs[j * o.dir_stride + 3] > 0.5f
                           : ray_alive;
}

__device__ __forceinline__ Slot load_slot(const Inputs& in, const Options& o,
                                          long long j, const float dray[3]) {
  Slot sl;
  sl.sdf = in.sdf[j];
  for (int c = 0; c < 3; ++c) {
    sl.g[c] = in.grad[j * o.grad_stride + c];
    sl.d[c] = o.dirs_per_sample ? in.dirs[j * o.dir_stride + c] : dray[c];
  }
  sl.dt = in.dt[j];
  sl.s = expf(10.f * in.v[o.v_per_sample ? j : 0]);
  return sl;
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block sum of n floats per thread into shared `red` (n·kThreads/32
// floats); thread 0 gets the sums in `v`.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  for (int i = 0; i < N; ++i) {
    const float s = warp_sum(v[i]);
    if (lane == 0) red[i * kWarps + warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < N; ++i) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[i * kWarps + w];
      v[i] = s;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
neus_loss_forward_kernel(const Inputs in, const Options o,
                         const ForwardOut out) {
  __shared__ float red[7 * kThreads / 32];
  __shared__ bool last;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  // colour, mask, eikonal, weight sum, kept, alive, inv_s max
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float inv_s = 0.f;
  if (o.v_per_sample) {
    for (long long k = r; k < o.S; k += (long long)gridDim.x * kThreads)
      inv_s = fmaxf(inv_s, expf(10.f * in.v[k]));
  } else {
    inv_s = expf(10.f * in.v[0]);
  }
  if (r < o.R) {
    const bool ra = in.alive[r] && in.ray_kept[r];
    const float raf = ra ? 1.f : 0.f;
    const float L[3] = {in.light[3 * r], in.light[3 * r + 1],
                        in.light[3 * r + 2]};
    float dray[3] = {0.f, 0.f, 0.f};
    if (!o.dirs_per_sample)
      for (int c = 0; c < 3; ++c) dray[c] = in.dirs[3 * r + c];
    float pred[4] = {0.f, 0.f, 0.f, 0.f};
    float ws = 0.f, ek = 0.f, kept = 0.f, cum = 0.f;
    long long j = in.seg_start[r];
    for (; j < o.S && in.ray_id[j] == r; ++j) {
      const float T = expf(cum);
      if (!(T >= kTransEps)) break;       // T only falls: nothing later kept
      out.trans[j] = T;
      if (!slot_alive(in, o, j, ra)) continue;   // α = 0: cum unchanged
      const Slot sl = load_slot(in, o, j, dray);
      const Alpha A = sdf_to_alpha(sl.sdf, dot3(sl.d, sl.g), sl.dt, sl.s,
                                   o.cos_anneal);
      const float w = A.alpha * T;
      out.keep[j] = 1;
      kept += 1.f;
      const float s0 = dot3(sl.g, L);
      const float sh = o.relu ? relu_(s0) : s0;
      const Albedo b = albedo4(in.albedo + j * o.albedo_stride, o);
      for (int c = 0; c < 4; ++c) pred[c] += w * b.a[c] * sh;
      ws += w;
      const float gn = sqrtf(dot3(sl.g, sl.g) + 1e-6f);
      ek += (gn - 1.f) * (gn - 1.f);
      cum += log1pf(-(A.alpha > kAlphaCap ? kAlphaCap : A.alpha));
    }
    out.walk_end[r] = (int)j;
    for (int c = 0; c < 4; ++c) out.ray_saved[5 * r + c] = pred[c];
    out.ray_saved[5 * r + 4] = ws;
    float cl = 0.f;
    for (int c = 0; c < 4; ++c) {
      const float d = pred[c] - in.target4[4 * r + c];
      cl += o.l2 ? d * d : fabsf(d);
    }
    if (o.rgbplus) cl = cl / 2.f;
    const float color = cl * in.mask_color[r] * raf;
    out.color[r] = color;
    const float mg = in.mask_gt[r];
    const float wc = clampf_(ws, kWsLo, kWsHi);
    const float p = o.bce ? wc : sigmoid_(wc);
    const float mask = -(mg * logf(p) + (1.f - mg) * logf(1.f - p)) * raf;
    acc[0] = color;
    acc[1] = mask;
    acc[2] = ek;
    acc[3] = ws;
    acc[4] = kept;
    acc[5] = raf;
  }
  block_sum(acc, red);
  const float bmax = warp_max(inv_s);
  if ((threadIdx.x & 31) == 0) red[6 * kThreads / 32 + (threadIdx.x >> 5)] =
      bmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.f;
    for (int w = 0; w < kThreads / 32; ++w)
      m = fmaxf(m, red[6 * kThreads / 32 + w]);
    Accum* a = out.acc;
    atomicAdd(&a->color, acc[0]);
    atomicAdd(&a->mask, acc[1]);
    atomicAdd(&a->ek, acc[2]);
    atomicAdd(&a->ws, acc[3]);
    atomicAdd(&a->kept, (unsigned long long)acc[4]);
    atomicAdd(&a->alive, (unsigned long long)acc[5]);
    atomicMax(&a->inv_s_bits, __float_as_uint(m));
    __threadfence();
    last = atomicAdd(&a->done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const volatile Accum* a = out.acc;
    const float color = a->color, mask = a->mask, ek = a->ek, ws = a->ws;
    const unsigned long long kept = a->kept, alive = a->alive;
    *out.total = (color + o.mask_w * mask) / o.n_rays +
                 o.ek_w * ek / o.ek_div;
    out.metrics[0] = color / o.n_rays;
    out.metrics[1] = mask / o.n_rays;
    out.metrics[2] = ek / fmaxf((float)kept, 1.f);
    out.metrics[3] = ws / fmaxf((float)alive, 1.f);
    out.metrics[4] = __uint_as_float(a->inv_s_bits);
    out.counts[0] = (long long)kept;
    out.counts[1] = (long long)alive;
  }
}

__global__ void __launch_bounds__(kThreads)
neus_loss_backward_kernel(const Inputs in, const Options o,
                          const BackwardIO io) {
  __shared__ float red[kThreads / 32];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  float gv[1] = {0.f};
  if (r < o.R) {
    const float g = *io.g_total;
    const bool ra = in.alive[r] && in.ray_kept[r];
    const float raf = ra ? 1.f : 0.f;
    const float L[3] = {in.light[3 * r], in.light[3 * r + 1],
                        in.light[3 * r + 2]};
    float dray[3] = {0.f, 0.f, 0.f};
    if (!o.dirs_per_sample)
      for (int c = 0; c < 3; ++c) dray[c] = in.dirs[3 * r + c];
    // the colour and mask terms' gradients wrt pred4 and the weight sum
    const float* sv = io.ray_saved + 5 * r;
    const float g_cl = g / o.n_rays * in.mask_color[r] * raf *
                       (o.rgbplus ? 0.5f : 1.f);
    float gp[4];
    for (int c = 0; c < 4; ++c) {
      const float d = sv[c] - in.target4[4 * r + c];
      gp[c] = o.l2 ? g_cl * 2.f * d : g_cl * sign_(d);
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
    const float gws = (ws >= kWsLo && ws <= kWsHi)
                          ? g * o.mask_w / o.n_rays * raf * dm : 0.f;
    const float eg = g * o.ek_w / o.ek_div;
    float G = 0.f;                      // Σ_{k>j} g_w_k · w_k
    float gdir[3] = {0.f, 0.f, 0.f};
    const long long j0 = in.seg_start[r];
    for (long long j = (long long)io.walk_end[r] - 1; j >= j0; --j) {
      if (!slot_alive(in, o, j, ra)) continue;
      const float T = io.trans[j];
      const Slot sl = load_slot(in, o, j, dray);
      const float tc = dot3(sl.d, sl.g);
      const Alpha A = sdf_to_alpha(sl.sdf, tc, sl.dt, sl.s, o.cos_anneal);
      const float w = A.alpha * T;
      const float s0 = dot3(sl.g, L);
      const float sh = o.relu ? relu_(s0) : s0;
      const float* raw = in.albedo + j * o.albedo_stride;
      const Albedo b = albedo4(raw, o);
      const float gpa = gp[0] * b.a[0] + gp[1] * b.a[1] + gp[2] * b.a[2] +
                        gp[3] * b.a[3];
      const float gw = gws + gpa * sh;
      float galpha = gw * T;
      if (A.alpha <= kAlphaCap) galpha -= G / (1.f - A.alpha);
      G += gw * w;
      // sdf_to_alpha's derivative
      const float gx = (A.x >= 0.f && A.x <= 1.f) ? galpha : 0.f;
      const float gpd = gx / A.den;
      const float gcp = gpd - gx * A.x / A.den;
      const float gen_pre = -gpd * A.cn * (1.f - A.cn);
      const float gep_pre = gcp * A.cp * (1.f - A.cp);
      const float gen = gen_pre * sl.s, gep = gep_pre * sl.s;
      const float gs = gen_pre * A.en + gep_pre * A.ep;
      const float gic = (gen - gep) * sl.dt * 0.5f;
      const float gtc = gic * ((A.r1 > 0.f ? 0.5f * (1.f - o.cos_anneal)
                                           : 0.f) +
                               (A.r2 > 0.f ? o.cos_anneal : 0.f));
      const float gvj = gs * 10.f * sl.s;
      io.g_sdf[j] = o.stop_alpha_sdf ? 0.f : gen + gep;
      // ∇sdf: the alpha path, the shading and the eikonal term
      float gg[3] = {0.f, 0.f, 0.f};
      if (!o.stop_alpha_normal)
        for (int c = 0; c < 3; ++c) gg[c] = gtc * sl.d[c];
      float gsh = gpa * w;
      if (o.relu && !(s0 > 0.f)) gsh = 0.f;
      if (!o.stop_shading_normal)
        for (int c = 0; c < 3; ++c) gg[c] += gsh * L[c];
      const float gn = sqrtf(dot3(sl.g, sl.g) + 1e-6f);
      const float ge = eg * 2.f * (gn - 1.f) / gn;
      for (int c = 0; c < 3; ++c) {
        gg[c] += ge * sl.g[c];
        io.g_grad[3 * j + c] = gg[c];
      }
      // the albedo and its RGB+ channel
      if (!o.no_albedo) {
        const float wsh = w * sh;
        float ga[3];
        for (int c = 0; c < 3; ++c) ga[c] = gp[c] * wsh;
        const float g4 = gp[3] * wsh;
        if (o.rgbplus && o.l2) {
          float gq = g4 * 0.5f / fmaxf(b.a[3] + 1e-5f, o.grad_floor);
          if (!o.ref_jacobian && !(b.q > 0.f)) gq = 0.f;
          for (int c = 0; c < 3; ++c) ga[c] += gq * (-2.f * b.a[c]);
        } else if (o.rgbplus) {
          for (int c = 0; c < 3; ++c) ga[c] -= g4 * sign_(b.a[c]);
        }
        for (int c = 0; c < 3; ++c)
          io.g_albedo[3 * j + c] =
              (raw[c] >= -10.f && raw[c] <= 10.f) ? ga[c] * b.a[c] : 0.f;
      }
      if (o.v_per_sample)
        io.g_v[j] = gvj;
      else
        gv[0] += gvj;
      if (io.g_dirs) {
        if (o.dirs_per_sample) {
          for (int c = 0; c < 3; ++c)
            io.g_dirs[j * o.dir_stride + c] = gtc * sl.g[c];
        } else {
          for (int c = 0; c < 3; ++c) gdir[c] += gtc * sl.g[c];
        }
      }
    }
    if (io.g_dirs && !o.dirs_per_sample)
      for (int c = 0; c < 3; ++c) io.g_dirs[3 * r + c] = gdir[c];
  }
  if (!o.v_per_sample) {
    block_sum(gv, red);
    if (threadIdx.x == 0) atomicAdd(io.g_v, gv[0]);
  }
}

int blocks_for(int R) { return (R + kThreads - 1) / kThreads; }

bool options_ok(const Options& o) {
  return o.S > 0 && o.R > 0 &&
         (o.dirs_per_sample ? o.dir_stride >= 4 : o.dir_stride == 3) &&
         o.grad_stride >= 3 && o.albedo_stride >= 3;
}

}  // namespace

extern "C" {

// inputs, options, out: host pointers to an Inputs, an Options and a
// ForwardOut. Launches on `stream` and returns cudaGetLastError().
int neus_loss_forward_launch(const void* inputs, const void* options,
                             const void* out, void* stream) {
  Inputs in;
  Options o;
  ForwardOut f;
  std::memcpy(&in, inputs, sizeof(in));
  std::memcpy(&o, options, sizeof(o));
  std::memcpy(&f, out, sizeof(f));
  if (!options_ok(o)) return (int)cudaErrorInvalidValue;
  neus_loss_forward_kernel<<<blocks_for(o.R), kThreads, 0,
                             (cudaStream_t)stream>>>(in, o, f);
  return (int)cudaGetLastError();
}

// inputs, options, io: host pointers to an Inputs, an Options and a
// BackwardIO. Launches on `stream` and returns cudaGetLastError().
int neus_loss_backward_launch(const void* inputs, const void* options,
                              const void* io, void* stream) {
  Inputs in;
  Options o;
  BackwardIO b;
  std::memcpy(&in, inputs, sizeof(in));
  std::memcpy(&o, options, sizeof(o));
  std::memcpy(&b, io, sizeof(b));
  if (!options_ok(o)) return (int)cudaErrorInvalidValue;
  neus_loss_backward_kernel<<<blocks_for(o.R), kThreads, 0,
                              (cudaStream_t)stream>>>(in, o, b);
  return (int)cudaGetLastError();
}

const char* neus_loss_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
