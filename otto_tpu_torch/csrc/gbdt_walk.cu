// K5: the GBDT ranker's scores, scores[m] = sum over trees t of
// leaf[t, walk(feats[m], t)], from the raw float32 features in one pass.
//
// Replaces no Pallas kernel. It subsumes the tree walk of
// otto_tpu/models/gbdt.py:425 (`_predict_binned_program`), which bins the
// features, then at every level gathers each row's split-feature bins with
// the Pallas vreg gather that K1 ports; the port ran that walk as
// searchsorted, K1 and [M, T] PyTorch gathers, ~30 GB of device memory
// traffic a ranker on a 2,048-session batch (M = 1,048,576 rows).
//
// The bin decision without bins: `bin(x, f) >= thr` (bin = the count of
// edges e of feature f with !(e > x), which is torch.searchsorted's
// right=True count over ascending edges) holds exactly when thr <= n_edges
// and !(edges[f, thr - 1] > x). A split node is kept as (column, value):
// (f, edges[f, thr - 1]), or, for the no-op split thr == n_bins, a spare
// column that holds -inf in every row and the value +inf, so that
// !(value > x) is false. NaN, +-inf, -0.0 and the +inf padding of the
// edges compare as searchsorted places them (tests/test_torch_gbdt_walk.py
// holds the predicate to _bin_program).
//
// What bounds it on the card: the feature bytes, 4 F a row read once
// (0.13 ms for [1,048,576, 104] at 3.35 TB/s), set against the walk's
// shared-memory loads, two a tree level and one a leaf (600 + 150 a row at
// T = 150, D = 4). The design:
//   * Persistent blocks of ROWS x PARTS threads, as many as fit on the
//     SMs. A block builds its ranker's node table (T (2^D - 1) (column,
//     value) pairs, heap-ordered, 8 bytes each) and leaves (T 2^D floats)
//     in shared memory once, while its first tile arrives.
//   * A tile of ROWS rows comes in by 4-byte cp.async, each warp copying
//     whole rows (coalesced 128-byte requests), to a row stride S that is
//     odd: lane r reads word r S + f, so a level where every row reads one
//     column (the root) is free of bank conflicts and the others scatter
//     over the 32 banks. Two blocks an SM overlap one block's load with
//     the other's walk.
//   * Each step of a walk is two dependent shared-memory loads (the node,
//     then the row's feature), so the walk is bound by their latency
//     unless many are in flight: PARTS threads share a row, each walking
//     a contiguous part of the trees (32 warps an SM at the serving
//     shape), and each thread walks GROUP trees at once. On the H100 a
//     ranker at the serving shape took 1.43 ms with one thread a row
//     (its GROUP chains serialised by a branch between them), 0.82 with
//     the chains free to interleave, 0.53 with four parts. There the
//     shared-memory loads (2.25 a step, the features' bank conflicts
//     besides) bound it: more warps or chains, a depth known at compile
//     time, more registers a thread or a transposed, conflict-free tile
//     each gained 0-9% more.
//   * Each part adds its leaves in float64 in tree order; the first adds
//     the others' sums in part order and rounds once to float32. Every row
//     walks every tree, as the twin does.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;                // rows a tile
constexpr int PARTS = 4;                 // threads a row, each a part of the trees
constexpr int THREADS = ROWS * PARTS;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 4;                 // trees a thread walks at once (3-8 within 2%)
constexpr int SMEM_MAX = 232448;         // dynamic shared memory of a block, sm_90

struct Node {
  int col;      // column of the row's staged features
  float value;  // go right when !(value > x)
};

// G consecutive trees (nodes and leaves from the first one's) for the row
// staged at x; their leaves added to acc in tree order. Each level loads
// the G nodes first and then their features, with no branch between, so
// the G chains of loads overlap.
template <int G>
__device__ __forceinline__ double walk_trees(const Node* nodes, const float* leaves,
                                             const float* x, int inner, int D, double acc) {
  int h[G];
#pragma unroll
  for (int k = 0; k < G; ++k) h[k] = 0;
  for (int level = 0; level < D; ++level) {
    Node nd[G];
#pragma unroll
    for (int k = 0; k < G; ++k) nd[k] = nodes[k * inner + h[k]];
#pragma unroll
    for (int k = 0; k < G; ++k) h[k] = 2 * h[k] + 1 + !(nd[k].value > x[nd[k].col]);
  }
#pragma unroll
  for (int k = 0; k < G; ++k) acc += static_cast<double>(leaves[k * (inner + 1) + h[k] - inner]);
  return acc;
}

__global__ void __launch_bounds__(THREADS)
gbdt_walk_kernel(const float* __restrict__ feats, const float* __restrict__ edges,
                 const int32_t* __restrict__ gfeat, const int32_t* __restrict__ thr,
                 const float* __restrict__ leaf, float* __restrict__ scores,
                 int64_t M, int F, int n_edges, int T, int D, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* part_sums = reinterpret_cast<double*>(smem);  // parts 1.. of each row
  float* tile = reinterpret_cast<float*>(part_sums + ROWS * (PARTS - 1));
  Node* nodes = reinterpret_cast<Node*>(tile + ROWS * S);
  const int inner = (1 << D) - 1;      // split nodes a tree
  const int n_leaves = 1 << D;
  float* leaves = reinterpret_cast<float*>(nodes + T * inner);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tiles = (M + ROWS - 1) / ROWS;

  auto load_tile = [&](int64_t t) {
    const int64_t r0 = t * ROWS;
    const int rows = static_cast<int>(M - r0 < ROWS ? M - r0 : ROWS);
    for (int r = warp; r < rows; r += WARPS) {
      const float* src = feats + (r0 + r) * F;
      float* dst = tile + r * S;
      for (int f = lane; f < F; f += 32) __pipeline_memcpy_async(dst + f, src + f, 4);
    }
    __pipeline_commit();
  };

  int64_t t = blockIdx.x;
  if (t < tiles) load_tile(t);
  // the spare column F: -inf in every row, never overwritten by a tile
  if (tid < ROWS) tile[tid * S + F] = -INFINITY;
  const int W = 1 << (D - 1);
  for (int i = tid; i < T * inner; i += THREADS) {
    const int tree = i / inner, j = i - tree * inner;
    const int level = 31 - __clz(j + 1), n = j + 1 - (1 << level);
    const int at = (tree * D + level) * W + n;
    // a ranker is checked when it is made; clamped here only so that a
    // bad array cannot read outside edges
    const int f = min(max(__ldg(gfeat + at), 0), F - 1);
    const int b = __ldg(thr + at);
    Node nd;
    if (b >= 1 && b <= n_edges) {
      nd.col = f;
      nd.value = __ldg(edges + static_cast<int64_t>(f) * n_edges + b - 1);
    } else {
      nd.col = F;
      nd.value = INFINITY;
    }
    nodes[i] = nd;
  }
  for (int i = tid; i < T * n_leaves; i += THREADS) leaves[i] = __ldg(leaf + i);
  // this thread's row of a tile and its part of the trees, [ta, tb)
  const int r = tid % ROWS, part = tid / ROWS;
  const int per = (T + PARTS - 1) / PARTS;
  const int ta = min(T, part * per), tb = min(T, ta + per);

  for (; t < tiles; t += gridDim.x) {
    __pipeline_wait_prior(0);
    __syncthreads();
    const int64_t row = t * ROWS + r;
    double acc = 0.0;
    if (row < M) {
      const float* x = tile + r * S;
      int t0 = ta;
      for (; t0 + GROUP <= tb; t0 += GROUP) {
        acc = walk_trees<GROUP>(nodes + t0 * inner, leaves + t0 * n_leaves, x, inner, D, acc);
      }
      for (; t0 < tb; ++t0) {
        acc = walk_trees<1>(nodes + t0 * inner, leaves + t0 * n_leaves, x, inner, D, acc);
      }
    }
    if (part > 0) part_sums[(part - 1) * ROWS + r] = acc;
    __syncthreads();
    if (part == 0 && row < M) {
      for (int q = 1; q < PARTS; ++q) acc += part_sums[(q - 1) * ROWS + r];
      scores[row] = static_cast<float>(acc);
    }
    __syncthreads();
    if (t + gridDim.x < tiles) load_tile(t + gridDim.x);
  }
}

}  // namespace

// Dynamic shared memory a launch needs (gbdt_walk.py::smem_bytes).
extern "C" int otto_gbdt_walk_smem(int F, int T, int D) {
  const int S = (F + 1) | 1;
  return 8 * ROWS * (PARTS - 1) + 4 * ROWS * S + 8 * T * ((1 << D) - 1) + 4 * T * (1 << D);
}

// feats [M, F] float32, edges [F, n_edges] float32 ascending, gfeat / thr
// [T, D, 2^(D-1)] int32, leaf [T, 2^D] float32 -> scores [M] float32, all
// contiguous on one device. Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int otto_gbdt_walk(const void* feats, const void* edges, const void* gfeat,
                              const void* thr, const void* leaf, void* scores,
                              long long M, int F, int n_edges, int T, int D, void* stream) {
  if (M < 0 || F < 1 || n_edges < 0 || T < 1 || D < 1 || D > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = otto_gbdt_walk_smem(F, T, D);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(gbdt_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_MAX);
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gbdt_walk_kernel, THREADS, smem);
  if (per_sm < 1) per_sm = 1;
  const long long tiles = (M + ROWS - 1) / ROWS;
  const long long most = static_cast<long long>(per_sm) * sms;
  gbdt_walk_kernel<<<static_cast<unsigned>(tiles < most ? tiles : most), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const float*>(edges),
      static_cast<const int32_t*>(gfeat), static_cast<const int32_t*>(thr),
      static_cast<const float*>(leaf), static_cast<float*>(scores), M, F, n_edges, T, D,
      (F + 1) | 1);
  return static_cast<int>(cudaGetLastError());
}
