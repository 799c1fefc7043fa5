// Table gradient of a small dense hash-grid level, as a scatter-add into
// one histogram per thread-block cluster, held in distributed shared
// memory.
//
// Replaces the TPU kernel `grad_onehot_mxu` (rnb_neus2_tpu/ops/
// hash_encoding.py:461, pallas_call at :517), which computes the same
// function as one-hot(idx)^T · cf on the TPU's matrix unit:
//
//     out[S, F] += sum over elements e with 0 <= idx[e] < S of
//                  cf[e, :] added into row idx[e];  other indices are dropped.
//
// It adds in place into `out`, a contiguous (S, F) view that the caller
// owns: on the training path, the level's rows of the table gradient,
// which is zeroed once for all levels. On that path the elements are one
// stochastic corner of each of the 2^18 samples (n = 2^18, the default
// stoch_corner_bwd = 1) or all 8 corners (n = 2^21), and S is the level's
// dense table: 4096 rows (level 0) or 13,824 rows (level 1) at the default
// config, F = 2. Every dense level of at most 2^15 entries comes here, as
// every one goes to `grad_onehot_mxu` in the JAX package.
//
// Design.
// - Clusters of 8 blocks (the portable size), launched with
//   cudaLaunchKernelEx and a cluster dimension. The cluster's shared
//   memory holds 8 / G copies (replicas) of the (S, F) histogram, each
//   spread over G blocks: in a replica, table row r lives in its block
//   r % G, at local row r / G. G is the fewest of 1, 2, 4, 8 blocks whose
//   share of the rows fits one block (the wrapper picks it, and refuses a
//   table that even 8 cannot hold): G = 1 at the default config (4096 rows,
//   32 KB + 512 B of mask, and 13,824 rows, 110,592 + 1,728 B), G = 2 for
//   a dense level of 29,792 or 32,768 rows at F = 2. A table of up to
//   2^15 rows at F <= 8 fits a cluster whole, so no block re-reads the
//   elements for another part of the table.
// - Each block zeroes its rows and a bitmask of them; cluster.sync();
//   every warp walks its tiles of elements (warp_scatter.cuh: loads, drop
//   rules, warp aggregation) and adds into its replica: into its own shared
//   memory, or, for G > 1, into the owning block's through
//   cluster.map_shared_rank (distributed shared memory), and sets the
//   row's bit (a native integer atomic). cluster.sync(); then each block
//   takes 1/8 of the table's rows, 32 at a time per warp: it reads the
//   rows' mask words of every replica through distributed shared memory,
//   reads a replica's entry only where its bit is set, and adds each
//   NON-ZERO sum to `out` with one global atomic: a 64-bit float2
//   reduction at F = 2 with 8-byte aligned `out` and `cf`, 32-bit
//   atomicAdds otherwise. The masks keep the reduction to the touched
//   rows: a K = 1 step touches a few thousand of level 1's 13,824. A last
//   cluster.sync() keeps every block alive until no block reads its
//   shared memory. An entry that no element touches keeps its bits (0.0 in
//   the table gradient), which the sparse Adam of the optimizer relies on.
// - Why replicas: sm_90 has no float add in shared memory. A float
//   atomicAdd there is a compare-and-swap loop (ATOMS.CAST.SPIN), and into
//   another block's shared memory a loop of round trips over the cluster's
//   network (ATOM.E.CAST.SPIN). With every element sent to its row's
//   owner in one histogram spread over the 8 blocks (G = 8 always), the
//   kernel measured 1.6-3.7x slower on uniform indices (n = 2^18 and
//   2^21, S = 4096 and 13,824) than with a replica in every block. So adds
//   stay in the block's own shared memory wherever a whole replica fits,
//   and the cluster's network carries only the reduction of the touched
//   entries. Tried on the card and dropped: a float2 add as one 64-bit
//   atomicCAS loop, and blocks of 1024 threads, made uniform indices
//   faster and the main path's inputs slower (their rows repeat, so adds
//   contend, and a software compare-and-swap loop loses to the hardware's
//   ATOMS.CAST.SPIN there); setting a row's bit only on its first add
//   gained nothing.
// - Warp aggregation (warp_scatter.cuh): lanes with the same row are
//   found with __match_any_sync, and their lowest lane adds the group's
//   sum, one shared-memory atomic per feature instead of one per lane. It
//   costs time where rows seldom repeat (uniform indices) and is what makes
//   the main path fast, where they mostly do.
// - Zero values are skipped, as in scatter_add.cu: adding 0.0 leaves an
//   entry bit for bit as it was, and the padded slots of the sample buffer
//   would otherwise pile tens of thousands of atomics on one row.
// - The grid is sized from n: one tile per warp, at most n / S elements'
//   worth of clusters (each cluster's flush costs up to S·F atomics), at
//   most two blocks per SM, and no more clusters than fit the card at once
//   (cudaOccupancyMaxActiveClusters: 30 at level 1's 112,320 B per block,
//   where a 33rd cluster would run in a second wave). A cluster flushes each
//   touched entry once, not once per block.
// Float atomics make the order of the sums, and so the last bits, vary
// from run to run: warps reach a histogram entry, and clusters an entry of
// `out`, in no fixed order.
//
// Bound. Each input is read once and the output written once:
// n·(4 + 4F) + S·F·4 bytes; in place, the S·F·4 term stands for the
// level's share of the one fill of the whole table gradient. At the
// default config's level 0 that is 2^18·12 + 4096·8 B ≈ 3.2 MB at K = 1
// (≈ 0.95 µs at 3.35 TB/s) and 2^21·12 + 4096·8 B ≈ 25.2 MB exact
// (≈ 7.5 µs); the n·F float adds take ≈ 0.06 µs at 67 TFLOP/s, so the
// kernel is bound by bytes. At n = 2^18 a launch's fixed costs (the
// cluster launch and barriers, zeroing S·F entries per block) are above
// that bound. What an in-place launch itself must move is less: the
// inputs, and a read and a write of each row it adds to (chip_smoke.py's
// `bound_into_ms`, against which `ms_into` is held).
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The launcher
// returns the cudaError_t of the launch; the caller raises if it is not 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "warp_scatter.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 512;
constexpr int kClusterTile = kCluster * kThreads / 32 * kTile;
constexpr int kBlocksPerSm = 2;

// Add s into entry `at` of block `owner`'s histogram: in this block's own
// shared memory directly, else through distributed shared memory.
__device__ __forceinline__ void hist_add(const cg::cluster_group& cluster,
                                         float* hist, int owner, int rank,
                                         int at, float s) {
  if (owner == rank)
    atomicAdd(hist + at, s);
  else
    atomicAdd(cluster.map_shared_rank(hist, owner) + at, s);
}

// Mark local row `local` of block `owner` as touched (a native integer
// atomic, also across the cluster).
__device__ __forceinline__ void mark(const cg::cluster_group& cluster,
                                     unsigned* mask, int owner, int rank,
                                     int local) {
  const unsigned bit = 1u << (local & 31);
  if (owner == rank)
    atomicOr(mask + (local >> 5), bit);
  else
    atomicOr(cluster.map_shared_rank(mask, owner) + (local >> 5), bit);
}

template <int Load>
__device__ __forceinline__ void hash_grad_block(const int* __restrict__ idx,
                                               const float* __restrict__ cf,
                                               float* __restrict__ out,
                                               long long n, int S, int F,
                                               int group_shift) {
  // this block's rows of its replica: table rows r with r % G equal to
  // rank % G, local row r / G at hist[(r / G) * F .. (r / G) * F + F),
  // followed by one bit per local row, set once the row is added to
  extern __shared__ float hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int G = 1 << group_shift;
  const int first = rank & ~(G - 1);       // the replica's first block
  const int rows = (S + G - 1) >> group_shift;
  const int words = (rows + 31) >> 5;
  const int entries = rows * F;
  unsigned* mask = reinterpret_cast<unsigned*>(hist + entries);
  for (int i = threadIdx.x; i < entries; i += kThreads) hist[i] = 0.0f;
  for (int i = threadIdx.x; i < words; i += kThreads) mask[i] = 0u;
  // with G = 1 no other block adds into this one's shared memory
  if (G > 1)
    cluster.sync();
  else
    __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  for (long long base = warp * kTile; base < n; base += warps * kTile)
    scatter_tile<Load>(
        idx, cf, n, S, F, base, lane,
        [&](int r, int f, float s) {
          const int owner = first + (r & (G - 1));
          const int local = r >> group_shift;
          hist_add(cluster, hist, owner, rank, local * F + f, s);
          mark(cluster, mask, owner, rank, local);
        },
        [&](int r, int f, float a, float b) {
          const int owner = first + (r & (G - 1));
          const int local = r >> group_shift;
          const int at = local * F + f;
          if (a != 0.0f) hist_add(cluster, hist, owner, rank, at, a);
          if (b != 0.0f) hist_add(cluster, hist, owner, rank, at + 1, b);
          mark(cluster, mask, owner, rank, local);
        });
  // every add into every replica is done
  cluster.sync();

  // Sum the replicas. The work is cut into (mask word w, block q of the
  // replica) pairs, one per warp at a time: table rows r = (32w + i)·G + q
  // for lanes i, held by blocks q, q + G, ... (in that order). Lane k < 8/G
  // reads block kG + q's mask word, and a lane reads a replica's entry
  // only where that replica's bit for its row is set.
  const int R = kCluster >> group_shift;
  const int pairs = words << group_shift;
  const int share = (pairs + kCluster - 1) / kCluster;
  const int end = min(pairs, (rank + 1) * share);
  for (int p = rank * share + (threadIdx.x >> 5); p < end;
       p += kThreads / 32) {
    const int q = p & (G - 1);
    const int w = p >> group_shift;
    const unsigned m = lane < R
        ? cluster.map_shared_rank(mask, lane * G + q)[w] : 0u;
    unsigned bits[kCluster];
#pragma unroll
    for (int k = 0; k < kCluster; ++k) bits[k] = __shfl_sync(kFullMask, m, k);
    const int local = w * 32 + lane;
    const long long r = (long long)local * G + q;
    if constexpr (Load == kTwo) {
      float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < kCluster; ++k) {
        if (k < R && (bits[k] >> lane & 1u)) {
          const float2 h = reinterpret_cast<const float2*>(
              cluster.map_shared_rank(hist, k * G + q))[local];
          acc.x += h.x;
          acc.y += h.y;
        }
      }
      if (acc.x != 0.0f || acc.y != 0.0f)
        red_add2(out + 2 * r, acc.x, acc.y);
    } else {
      for (int f = 0; f < F; ++f) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kCluster; ++k)
          if (k < R && (bits[k] >> lane & 1u))
            acc += cluster.map_shared_rank(hist, k * G + q)[local * F + f];
        if (acc != 0.0f) atomicAdd(out + r * F + f, acc);
      }
    }
  }
  // no block exits while another still reads its shared memory
  cluster.sync();
}

// `load`: value_load(F, cf, out), the same for every block.
__global__ void __launch_bounds__(kThreads)
hash_grad_small_kernel(const int* __restrict__ idx,
                       const float* __restrict__ cf,
                       float* __restrict__ out, long long n, int S, int F,
                       int group_shift, int load) {
  switch (load) {
    case kTwo: hash_grad_block<kTwo>(idx, cf, out, n, S, F, group_shift);
      break;
    case kOne: hash_grad_block<kOne>(idx, cf, out, n, S, F, group_shift);
      break;
    case kPairs: hash_grad_block<kPairs>(idx, cf, out, n, S, F, group_shift);
      break;
    default: hash_grad_block<kScalar>(idx, cf, out, n, S, F, group_shift);
  }
}

}  // namespace

extern "C" {

// Allow the kernel up to `max_smem` bytes of dynamic shared memory per
// block on the current device. Call once per device before the first
// launch.
int hash_grad_small_configure(int max_smem) {
  return (int)cudaFuncSetAttribute(
      hash_grad_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      max_smem);
}

// The most clusters of the kernel that the current device runs at once
// with `smem` bytes of shared memory per block (0 if the query fails).
int hash_grad_small_max_clusters(int smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, (void*)hash_grad_small_kernel,
                                     &cfg) != cudaSuccess)
    return 0;
  return clusters;
}

// Add into `out` on `stream`. idx: (n,) int32; cf: (n, F) float32
// row-major; out: (S, F) float32, contiguous. One replica of the
// histogram spans G = 1 << group_shift blocks, each holding ceil(S / G)
// rows (ceil(S / G)·F·4 bytes of shared memory, at most what
// hash_grad_small_configure allowed; the caller checks). `sms`: the
// device's SM count; `max_clusters`: hash_grad_small_max_clusters at that
// shared memory. Returns the error of cudaLaunchKernelEx, else
// cudaGetLastError() after the launch.
int hash_grad_small_launch(const void* idx, const void* cf, void* out,
                           long long n, int S, int F, int group_shift,
                           int sms, int max_clusters, void* stream) {
  if (n <= 0 || F <= 0) return 0;
  const int rows = (S + (1 << group_shift) - 1) >> group_shift;
  const size_t smem = (size_t)rows * F * sizeof(float) +
                      (size_t)((rows + 31) / 32) * sizeof(unsigned);
  long long clusters = (n + kClusterTile - 1) / kClusterTile;
  if (clusters > n / S) clusters = n / S;
  long long cap = (long long)sms * kBlocksPerSm / kCluster;
  if (max_clusters > 0 && cap > max_clusters) cap = max_clusters;
  if (clusters > cap) clusters = cap;
  if (clusters < 1) clusters = 1;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, hash_grad_small_kernel, (const int*)idx, (const float*)cf,
      (float*)out, n, S, F, group_shift, value_load(F, cf, out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* hash_grad_small_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
