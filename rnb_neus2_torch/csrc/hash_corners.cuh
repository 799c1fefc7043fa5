// The corner arithmetic of the hash-grid encode, shared by the encode's
// forward (encode_jacobian.cu) and its K-corner backward
// (corner_backward.cu). Its plain PyTorch twin is
// rnb_neus2_torch/kernels/hash_corners.py, and both follow the JAX
// package's float32 operations one by one (rnb_neus2_tpu/ops/
// hash_encoding.py: _level_corner_arrays, fwd_math, the "stoch" branch of
// enc_bwd):
//
//   p = x·scale + 0.5 (a multiply, then an add); p0 = floor(p);
//   fr = p − p0; per corner and axis wd = on ? fr : 1 − fr;
//   w = (wx·wy)·wz; dw_x = ±(wy·wz), dw_y = ±(wx·wz), dw_z = ±(wx·wy);
//   index: dense (x + y·res + z·res²) mod size, or hashed
//   (x ^ y·2654435761 ^ z·805459861) mod size in uint32 arithmetic.
//
// Every float operation is written as its round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn), which nvcc never contracts
// into a fused multiply-add: the kernels' outputs equal the plain
// versions' bit for bit, and the K-corner pick, which compares a uniform
// with a float CDF, picks the same corner. The build flags stay those of
// every kernel (kernels/build.py's NVCC_FLAGS).

#pragma once

#include <cstdint>

constexpr int kMaxLevels = 32;     // hash_corners.py's MAX_LEVELS
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

// One level's constants, formed on the host (hash_corners.py's
// level_constants, whose LEVEL_DTYPE has this layout: 36 bytes).
struct LevelConst {
  float scale;         // lattice scale, resolution - 1
  float m;             // unlock mask: 1 or 0
  float scale_m;       // float32(scale * m), the jacobian's factor
  int res;             // resolution (dense index)
  int size;            // table rows of the level
  int offset;          // the level's first row in the whole table
  int hashed;          // 1: spatial hash, 0: dense index
  uint32_t stream;     // the draws' stream, salt * La + level
  uint32_t size_mask;  // size - 1 when size is a power of two, else 0
};
static_assert(sizeof(LevelConst) == 36, "hash_corners.py's LEVEL_DTYPE");

// Every level's constants, passed by value as a kernel parameter (1 KB).
struct Levels {
  LevelConst l[kMaxLevels];
};

// One sample's 8 corners at one level: row within the level's table,
// trilinear weight, and the weight's derivative along each axis of the
// lattice fraction.
struct Corners {
  int idx[8];
  float w[8];
  float dw[8][3];
};

// The table row of integer lattice corner (x, y, z): hashed in uint32
// (the twin's int64 masked to 32 bits), or dense with a non-negative
// remainder (the twin's int64 `%`). The same bits without a division
// where the operands allow: a power-of-two size (every hashed level of
// the default config) takes a mask, and a dense index in [0, 2·size)
// (every corner of a position in [0, 1]: at most res³ + res² + res) one
// conditional subtraction in 32 bits; other dense indices (positions
// outside the unit cube) keep the int64 remainder.
__device__ __forceinline__ int corner_index(long long x, long long y,
                                            long long z,
                                            const LevelConst& lc) {
  if (lc.hashed) {
    const uint32_t h = (uint32_t)x ^ ((uint32_t)y * kPrime1) ^
                       ((uint32_t)z * kPrime2);
    return (int)(lc.size_mask ? h & lc.size_mask : h % (uint32_t)lc.size);
  }
  const long long res = lc.res;
  const long long v = x + y * res + z * res * res;
  if ((unsigned long long)v < 2ull * (unsigned long long)lc.size) {
    const int r = (int)v;
    return r >= lc.size ? r - lc.size : r;
  }
  const long long r = v % lc.size;
  return (int)(r < 0 ? r + lc.size : r);
}

// The 8 corners of position (x, y, z) at level `lc`, corner c at offset
// (c & 1, c >> 1 & 1, c >> 2 & 1) along (x, y, z).
__device__ __forceinline__ void level_corners(const float (&pos)[3],
                                              const LevelConst& lc,
                                              Corners& out) {
  long long p0[3];
  float fr[3], om[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float p = __fadd_rn(__fmul_rn(pos[d], lc.scale), 0.5f);
    const float f = floorf(p);
    p0[d] = (long long)f;
    fr[d] = __fsub_rn(p, f);
    om[d] = __fsub_rn(1.0f, fr[d]);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const bool on[3] = {(c & 1) != 0, (c & 2) != 0, (c & 4) != 0};
    const float wx = on[0] ? fr[0] : om[0];
    const float wy = on[1] ? fr[1] : om[1];
    const float wz = on[2] ? fr[2] : om[2];
    out.w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
    // the sign ±1 multiplies exactly: a negation
    const float yz = __fmul_rn(wy, wz), xz = __fmul_rn(wx, wz),
                xy = __fmul_rn(wx, wy);
    out.dw[c][0] = on[0] ? yz : -yz;
    out.dw[c][1] = on[1] ? xz : -xz;
    out.dw[c][2] = on[2] ? xy : -xy;
    out.idx[c] = corner_index(p0[0] + on[0], p0[1] + on[1], p0[2] + on[2],
                              lc);
  }
}

// The draws' salt-free mix of the float32 bit patterns of a position
// (hash_corners.py's _position_hash).
__device__ __forceinline__ uint32_t position_hash(const float (&pos)[3]) {
  return (__float_as_uint(pos[0]) * 0x9E3779B1u) ^
         (__float_as_uint(pos[1]) * 0x85EBCA77u) ^
         (__float_as_uint(pos[2]) * 0xC2B2AE3Du);
}

// Uniform j of K in [0, 1) of stream `stream` (hash_corners.py's _draws):
// below 2^24 before the scale, so exact in float32.
__device__ __forceinline__ float draw(uint32_t base, uint32_t stream, int K,
                                      int j) {
  uint32_t h = base + 0x27D4EB2Fu * (stream * (uint32_t)K + (uint32_t)j + 1u);
  h = (h ^ (h >> 15)) * 0x2C1B3C6Du;
  h = (h ^ (h >> 12)) * 0x297A2D39u;
  h = h ^ (h >> 15);
  return __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
}
