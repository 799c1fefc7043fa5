// The element walk shared by the two scatter-add kernels (scatter_add.cu,
// hash_grad_small.cu): loads, the drop rules and warp aggregation.
//
// A warp takes tiles of kTile = 4 x 32 consecutive elements: lane l holds
// elements l, 32 + l, 64 + l and 96 + l of the tile, and loads all their
// indices and values before it adds anything (coalesced: a warp's loads
// are 128 B of indices and 128 or 256 B of values at a time; the values
// do not wait for the indices). At F = 1 a value is one float, at F = 2 one
// float2 (8-byte aligned values); other even F is read in float2 pairs of
// features, odd F (or a misaligned view) feature by feature.
//
// An element whose index lies outside [0, S), or whose values are all
// zero, adds nothing. Skipping zeros leaves every result bit for bit as it
// was (an entry that starts at +0.0 never becomes -0.0), and it keeps the
// padded slots of the training batch, which all sit on one row, from
// piling up atomics on one address.
//
// Warp aggregation: lanes whose rows are equal form a group
// (__match_any_sync); the group's lowest lane sums the group's values, in
// lane order from its own up, and adds them with one atomic where every
// lane would otherwise add its own. On the training path a warp's 32
// elements are 32 samples that follow each other along rays (K = 1) or
// the 8 corners of 4 samples (exact), so coarse levels repeat rows within
// a warp.

#pragma once

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kUnroll = 4;                 // elements per lane per tile
constexpr int kTile = 32 * kUnroll;        // elements per warp per tile

struct WarpGroup {
  bool leader;    // this lane adds for its group
  unsigned rest;  // in the leader, the group's other lanes; else 0
};

// Key < 0: nothing to add. All 32 lanes call it together.
__device__ __forceinline__ WarpGroup warp_group(int key, int lane) {
  const unsigned peers = __match_any_sync(kFullMask, key);
  const unsigned self = 1u << lane;
  const bool leader = key >= 0 && (peers & (self - 1u)) == 0u;
  return {leader, leader ? peers & ~self : 0u};
}

// x[] summed over the group into its leader; other lanes keep their own.
// All 32 lanes call it together: the loop runs as often as the largest
// group of the warp has other lanes (not at all when every row differs).
template <int N>
__device__ __forceinline__ void group_sum(float (&x)[N], unsigned rest,
                                          int lane) {
  float s[N];
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = x[i];
  while (__any_sync(kFullMask, rest != 0u)) {
    const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float y = __shfl_sync(kFullMask, x[i], src);
      if (rest) s[i] += y;
    }
    rest &= rest - 1u;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = s[i];
}

// How a kernel reads an element's F values, the same for every warp.
enum ValueLoad : int {
  kScalar = 0,  // feature by feature (odd F > 1, or a misaligned view)
  kOne = 1,     // F = 1: one float
  kTwo = 2,     // F = 2, 8-byte aligned: one float2, loaded with the index
  kPairs = 3,   // even F > 2, 8-byte aligned: float2 pairs of features
};

// The ValueLoad for F values per element with both pointers' alignment.
__host__ __forceinline__ int value_load(int F, const void* a,
                                        const void* b) {
  const bool aligned = ((reinterpret_cast<unsigned long long>(a) |
                         reinterpret_cast<unsigned long long>(b)) & 7u) == 0;
  if (F == 1) return kOne;
  if (!aligned || F % 2) return kScalar;
  return F == 2 ? kTwo : kPairs;
}

// One tile of a warp, starting at element `base`: for each group of equal
// rows, its leader adds the group's sums of features f (add_one(row, f,
// s)) or f and f + 1 (add_two(row, f, a, b); kTwo and kPairs), for every
// feature, or pair, whose sum is not all zero. All 32 lanes call it
// together.
template <int Load, typename AddOne, typename AddTwo>
__device__ __forceinline__ void scatter_tile(
    const int* __restrict__ idx, const float* __restrict__ v, long long n,
    int S, int F, long long base, int lane, AddOne add_one, AddTwo add_two) {
  int row[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long e = base + u * 32 + lane;
    const int r = e < n ? __ldg(idx + e) : -1;
    row[u] = (unsigned)r < (unsigned)S ? r : -1;  // drops r < 0, r >= S
  }
  if constexpr (Load == kOne || Load == kTwo) {
    constexpr int N = Load == kTwo ? 2 : 1;
    float x[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e = base + u * 32 + lane;
      if constexpr (N == 2) {
        const float2 t = e < n ? __ldg(reinterpret_cast<const float2*>(v) + e)
                               : make_float2(0.0f, 0.0f);
        x[u][0] = t.x;
        x[u][1] = t.y;
      } else {
        x[u][0] = e < n ? __ldg(v + e) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      bool live = false;
#pragma unroll
      for (int i = 0; i < N; ++i) live |= x[u][i] != 0.0f;
      const WarpGroup g = warp_group(live && row[u] >= 0 ? row[u] : -1, lane);
      group_sum(x[u], g.rest, lane);
      if constexpr (N == 2) {
        if (g.leader && (x[u][0] != 0.0f || x[u][1] != 0.0f))
          add_two(row[u], 0, x[u][0], x[u][1]);
      } else {
        if (g.leader && x[u][0] != 0.0f) add_one(row[u], 0, x[u][0]);
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float* src = v + (base + u * 32 + lane) * F;
      bool live = false;
      if (row[u] >= 0)
        for (int f = 0; f < F; ++f) live |= src[f] != 0.0f;
      const WarpGroup g = warp_group(live ? row[u] : -1, lane);
      if constexpr (Load == kPairs) {
        for (int f = 0; f < F; f += 2) {
          const float2 t = live ? *reinterpret_cast<const float2*>(src + f)
                                : make_float2(0.0f, 0.0f);
          float s[2] = {t.x, t.y};
          group_sum(s, g.rest, lane);
          if (g.leader && (s[0] != 0.0f || s[1] != 0.0f))
            add_two(row[u], f, s[0], s[1]);
        }
      } else {
        for (int f = 0; f < F; ++f) {
          float s[1] = {live ? src[f] : 0.0f};
          group_sum(s, g.rest, lane);
          if (g.leader && s[0] != 0.0f) add_one(row[u], f, s[0]);
        }
      }
    }
  }
}

// One 64-bit vector reduction of (a, b) into dst[0:2] (global memory,
// 8-byte aligned): sm_90's float2 atomicAdd, whose unused result makes it
// a fire-and-forget reduction in L2 (RED.E.ADD.F32x2).
__device__ __forceinline__ void red_add2(float* dst, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
}
