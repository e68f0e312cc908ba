// K3: exact top-k similarity search, fused: the [Q, V] score matrix never
// reaches device memory.
//
// Replaces the Pallas TPU kernel otto_tpu/ops/pallas/mips.py::
// mips_topk_pallas, which scored a 2048-row corpus tile on the MXU and
// rebuilt a running top-k from [tile ++ best] with k extract-max passes.
//
// Semantics, fixed here:
//   * l2 scores are 2 * (q . c) - |q|^2 - |c|^2 in float32, evaluated in
//     that order (mips.py:51); |q|^2 and |c|^2 come in from the wrapper.
//     dot scores are q . c. The dot product is one FFMA chain over d = 0..D-1.
//   * On an exact tie the lower corpus index comes first, whatever the
//     tiling: entries are ordered by (score desc, index asc), and that order
//     decides both whether a score enters and where it goes. (The Pallas
//     kernel puts an equal score from a later tile first, an artefact of its
//     [tile ++ best] pool; lax.top_k and the port's twin give the lower index.)
//   * Results are sorted descending; when V < k the missing entries are
//     index -1 with score -3.4e38 (mips.py:147-149).
//
// What bounds it on the card: FP32 FFMA, 2 * Q * V * D operations (about
// 2.2e14 for 600k queries against 1.8M x 100). Tensor cores are not used:
// TF32 would keep about three digits and move the distances the tests hold
// to the reference. The top-k costs about one compare per score.
//
// Design: a block owns 64 queries and walks the whole corpus in index
// order, in tiles of 128 rows staged through shared memory, both stored
// transposed ([d][row]) so that a thread reads its operands as float4.
// Each of the 256 threads keeps a 4 x 8 register micro-tile of scores
// (4 queries x 8 corpus rows), so every 3 shared-memory loads feed 32 FFMAs.
// The 8 queries of a warp's micro-tiles are exactly the warp's 2 x 16
// threads, so the warp merges its scores straight from registers: lane l
// holds entry l of each of its 8 queries' sorted top-k lists (k <= 32), a
// score is tested against the k-th entry, and the rare one that enters is
// inserted by a ballot (its position) and a shuffle (the shift).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // queries per block
constexpr int BV = 128;        // corpus rows per tile
constexpr int TQ = 4;          // queries per thread
constexpr int TV = 8;          // corpus rows per thread: 4 at tx*4, 4 at 64 + tx*4
constexpr int THREADS = 256;   // 16 query groups x 16 corpus groups
constexpr int QS = BQ + 4;     // row stride of the transposed query tile
constexpr int CS = BV + 4;     // row stride of the transposed corpus tile
constexpr int WARP_Q = 8;      // queries merged by one warp
constexpr int32_t NONE = INT32_MAX;   // index of an empty list entry
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool before(float s, int32_t i, float t, int32_t j) {
  return s > t || (s == t && i < j);
}

// rows [row0, row0 + n) of a [rows, D] matrix into a transposed
// [D][stride] shared tile; rows past `rows` become zeros
__device__ __forceinline__ void stage(float* dst, int stride,
                                     const float* __restrict__ src,
                                     int64_t row0, int n, int64_t rows, int D) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < n; r += THREADS / 32) {
    const int64_t g = row0 + r;
    for (int d = lane; d < D; d += 32) {
      dst[d * stride + r] = g < rows ? src[g * D + d] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
mips_topk_kernel(const float* __restrict__ q, const float* __restrict__ c,
                 const float* __restrict__ qsq, const float* __restrict__ csq,
                 float* __restrict__ out_s, int32_t* __restrict__ out_i,
                 int Q, int V, int D, int k, int l2) {
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [D][QS]
  float* cT = smem + D * QS;    // [D][CS]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int lane = tid & 31;
  const int half = lane >> 4;   // which of the warp's two query groups
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BQ;

  stage(qT, QS, q, q0, BQ, Q, D);
  float my_qsq[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int64_t qr = q0 + ty * TQ + i;
    my_qsq[i] = (l2 && qr < Q) ? qsq[qr] : 0.f;
  }

  // lane l < k: entry l of the sorted top-k of the warp's query w (0..7)
  float ls[WARP_Q];
  int32_t li[WARP_Q];
#pragma unroll
  for (int w = 0; w < WARP_Q; ++w) {
    ls[w] = -INFINITY;
    li[w] = NONE;
  }

  for (int v0 = 0; v0 < V; v0 += BV) {
    __syncthreads();  // every thread is done with the previous tile
    stage(cT, CS, c, v0, BV, V, D);
    __syncthreads();

    float acc[TQ][TV];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int j = 0; j < TV; ++j) acc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * QS + ty * TQ);
      const float4 b0 = *reinterpret_cast<const float4*>(cT + d * CS + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(cT + d * CS + 64 + tx * 4);
      const float av[TQ] = {a.x, a.y, a.z, a.w};
      const float bv[TV] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
#pragma unroll
        for (int j = 0; j < TV; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    int32_t col[TV];
    bool live[TV];
    float cn[TV];
#pragma unroll
    for (int j = 0; j < TV; ++j) {
      col[j] = v0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      live[j] = col[j] < V;
      cn[j] = (l2 && live[j]) ? csq[col[j]] : 0.f;
    }
    if (l2) {
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
#pragma unroll
        for (int j = 0; j < TV; ++j) {
          acc[i][j] = 2.f * acc[i][j] - my_qsq[i] - cn[j];
        }
      }
    }

    // merge: the warp's query w = half * 4 + i is held by the 16 lanes of
    // that half, 8 scores each
#pragma unroll
    for (int w = 0; w < WARP_Q; ++w) {
      const int i = w & 3;
      float ts = __shfl_sync(FULL, ls[w], k - 1);
      int32_t ti = __shfl_sync(FULL, li[w], k - 1);
#pragma unroll
      for (int j = 0; j < TV; ++j) {
        const bool cand = half == (w >> 2) && live[j] &&
                          before(acc[i][j], col[j], ts, ti);
        unsigned m = __ballot_sync(FULL, cand);
        if (m == 0) continue;
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float s = __shfl_sync(FULL, acc[i][j], src);
          const int32_t ix = __shfl_sync(FULL, col[j], src);
          const bool ahead = lane < k && before(ls[w], li[w], s, ix);
          const int pos = __popc(__ballot_sync(FULL, ahead));
          const float up_s = __shfl_up_sync(FULL, ls[w], 1);
          const int32_t up_i = __shfl_up_sync(FULL, li[w], 1);
          if (lane == pos) {
            ls[w] = s;
            li[w] = ix;
          } else if (lane > pos) {
            ls[w] = up_s;
            li[w] = up_i;
          }
        }
        ts = __shfl_sync(FULL, ls[w], k - 1);
        ti = __shfl_sync(FULL, li[w], k - 1);
      }
    }
  }

  const int warp = tid >> 5;
  if (lane < k) {
#pragma unroll
    for (int w = 0; w < WARP_Q; ++w) {
      const int64_t qr = q0 + warp * WARP_Q + w;
      if (qr < Q) {
        const bool empty = li[w] == NONE;
        out_s[qr * k + lane] = empty ? -3.4e38f : ls[w];
        out_i[qr * k + lane] = empty ? -1 : li[w];
      }
    }
  }
}

}  // namespace

// queries [Q, D], corpus [V, D], qsq [Q] and csq [V] (read only when l2 != 0)
// float32, contiguous; out_s [Q, k] float32, out_i [Q, k] int32; 1 <= k <= 32
// and D at most what fits two [D][~130] float tiles in 227 KB of shared
// memory (D <= 290). Returns cudaGetLastError() after the launch.
extern "C" int otto_mips_topk(const void* queries, const void* corpus,
                              const void* qsq, const void* csq, void* out_s,
                              void* out_i, int Q, int V, int D, int k, int l2,
                              void* stream) {
  const size_t smem = static_cast<size_t>(D) * (QS + CS) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mips_topk_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  if (Q > 0) {
    const dim3 grid((Q + BQ - 1) / BQ);
    mips_topk_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(queries), static_cast<const float*>(corpus),
        static_cast<const float*>(qsq), static_cast<const float*>(csq),
        static_cast<float*>(out_s), static_cast<int32_t*>(out_i), Q, V, D, k,
        l2);
  }
  return static_cast<int>(cudaGetLastError());
}
