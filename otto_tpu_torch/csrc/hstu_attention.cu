// K6: HSTU's pointwise attention on the jagged token layout (HSTU ranker,
// otto_tpu_torch/models/hstu.py; wrapper and plain twin in
// ops/kernels/hstu_attention.py, which states the math).
//
// One block computes one query tile (BM = 64 tokens) of one session for one
// head: y = sum_j bf16(silu(q.k_j + w_pos[dpos] + w_time[bucket(|dt|)]) /
// n_scale) * v_j under the target-aware mask, with no score tensor written to
// memory. Sessions are packed back to back (offsets), history first, so a
// block's keys are always its session's history tokens 0..min(L, q_end) - 1,
// in tiles of BN = 64; a candidate's own key is added after them, as a
// per-row dot product.
//
// What bounds it: little. A session has ~170 tokens of which ~7 are history,
// so a block does one or two key tiles; the products run on the tensor cores
// (mma.sync m16n8k16, bfloat16 operands, float32 accumulators) and the score
// stays in registers, where its biases, SiLU and mask are applied and it is
// rounded to bfloat16 as the A operand of P.V (the accumulator layout of
// m16n8 is the A layout of m16n8k16, two n-tiles a k-step). Each of the 4
// warps owns 16 query rows. Q and K tiles sit in shared memory row-major,
// V transposed, rows padded to 144 bytes so the 32-bit fragment loads of the
// 8 row groups fall in distinct banks. The bias tables (w_pos, w_time, the
// bucket thresholds) are copied to shared memory once a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;             // d_qk = d_v
constexpr int BM = 64;            // query rows a block
constexpr int BN = 64;            // keys a tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LD = D + 8;         // bf16 a shared row: 144 bytes
constexpr int MAX_POS = 1024;
constexpr int MAX_BUCKETS = 256;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  float* y;
  const int32_t* offsets;
  const int32_t* n_hist;
  const int32_t* tile_off;
  const int32_t* ts;
  const float* w_pos;
  const float* w_time;
  const long long* thr;
  long long row_stride;           // elements from one token's row to the next
  int S, H, n_pos, n_bkt;
  float n_scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// the largest b with thr[b] <= x (thr[0] = 0 <= x)
__device__ __forceinline__ int bucket_of(long long x, const long long* thr, int n) {
  int lo = 0, hi = n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (thr[mid] <= x) lo = mid; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS) hstu_attention_kernel(Params p) {
  __shared__ __align__(16) __nv_bfloat16 qs[BM][LD];
  __shared__ __align__(16) __nv_bfloat16 ks[BN][LD];
  __shared__ __align__(16) __nv_bfloat16 vt[D][LD];
  __shared__ float wpos_s[MAX_POS];
  __shared__ float wtime_s[MAX_BUCKETS];
  __shared__ long long thr_s[MAX_BUCKETS];
  __shared__ int kts_s[BN];

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  if (tile >= p.tile_off[p.S]) return;
  // the session: the largest s with tile_off[s] <= tile (empty sessions
  // share their successor's offset)
  int lo = 0, hi = p.S;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (p.tile_off[mid] <= tile) lo = mid; else hi = mid;
  }
  const int s = lo;
  const long long base = p.offsets[s];
  const int T = p.offsets[s + 1] - p.offsets[s];
  const int L = p.n_hist[s];
  const int q0 = (tile - p.tile_off[s]) * BM;
  const int q1 = min(q0 + BM, T);
  const int kmax = min(L, q1);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long rs = p.row_stride;
  const int hd = h * D;

  for (int i = tid; i < p.n_pos; i += THREADS) wpos_s[i] = p.w_pos[i];
  for (int i = tid; i < p.n_bkt; i += THREADS) {
    wtime_s[i] = p.w_time[i];
    thr_s[i] = p.thr[i];
  }
  for (int i = tid; i < BM * (D / 8); i += THREADS) {
    const int row = i >> 3, c = i & 7;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + row < T)
      val = *reinterpret_cast<const uint4*>(p.q + (base + q0 + row) * rs + hd + c * 8);
    *reinterpret_cast<uint4*>(&qs[row][c * 8]) = val;
  }
  __syncthreads();

  // this thread's two query rows: ra (accumulator elements 0, 1) and ra + 8
  // (elements 2, 3)
  int qrow[2], qpos[2], qts[2];
  bool qlive[2], qhist[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = warp * 16 + g + 8 * e;
    qrow[e] = q0 + r;
    qlive[e] = qrow[e] < T;
    qhist[e] = qrow[e] < L;
    qpos[e] = qhist[e] ? qrow[e] : L;
    qts[e] = qlive[e] ? p.ts[base + qrow[e]] : 0;
  }
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int r = warp * 16 + g;
    qa[kc][0] = ld32(&qs[r][kc * 16 + t * 2]);
    qa[kc][1] = ld32(&qs[r + 8][kc * 16 + t * 2]);
    qa[kc][2] = ld32(&qs[r][kc * 16 + t * 2 + 8]);
    qa[kc][3] = ld32(&qs[r + 8][kc * 16 + t * 2 + 8]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;

  for (int k0 = 0; k0 < kmax; k0 += BN) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < BN * (D / 8); i += THREADS) {
      const int row = i >> 3, c = i & 7;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + row < kmax) {
        const long long at = (base + k0 + row) * rs + hd + c * 8;
        kv = *reinterpret_cast<const uint4*>(p.k + at);
        vv = *reinterpret_cast<const uint4*>(p.v + at);
      }
      *reinterpret_cast<uint4*>(&ks[row][c * 8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[c * 8 + e][row] = ve[e];
    }
    for (int i = tid; i < BN; i += THREADS)
      kts_s[i] = k0 + i < kmax ? p.ts[base + k0 + i] : 0;
    __syncthreads();

    float sc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        mma(sc[j], qa[kc], ld32(&ks[j * 8 + g][kc * 16 + t * 2]),
            ld32(&ks[j * 8 + g][kc * 16 + t * 2 + 8]));
    }
    // biases, SiLU, mask; then P (bf16) . V
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = j * 8 + t * 2 + (e & 1);
        const int key = k0 + col;
        const bool ok = qlive[r] && key < kmax && (!qhist[r] || key <= qrow[r]);
        float val = 0.0f;
        if (ok) {
          const int pd = min(qpos[r] - key, p.n_pos - 1);
          long long dt = static_cast<long long>(qts[r]) - kts_s[col];
          dt = dt < 0 ? -dt : dt;
          float x = sc[j][e] + wpos_s[pd];
          x = x + wtime_s[bucket_of(dt, thr_s, p.n_bkt)];
          val = silu(x) / p.n_scale;
        }
        sc[j][e] = val;
      }
    }
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      pa[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      pa[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      pa[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        mma(o[d], pa, ld32(&vt[d * 8 + g][kc * 16 + t * 2]),
            ld32(&vt[d * 8 + g][kc * 16 + t * 2 + 8]));
    }
  }

  // a candidate's own key: the 4 threads of a row group take 16 dims each
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool self = qlive[e] && !qhist[e];
    const int r = warp * 16 + g + 8 * e;
    const long long at = (base + qrow[e]) * rs + hd;
    float part = 0.0f;
    if (self) {
#pragma unroll
      for (int d = t * 16; d < t * 16 + 16; ++d)
        part += __bfloat162float(qs[r][d]) * __bfloat162float(p.k[at + d]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (self) {
      float x = part + wpos_s[0];
      x = x + wtime_s[0];
      const float a = __bfloat162float(__float2bfloat16_rn(silu(x) / p.n_scale));
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        o[d][2 * e] += a * __bfloat162float(p.v[at + d * 8 + t * 2]);
        o[d][2 * e + 1] += a * __bfloat162float(p.v[at + d * 8 + t * 2 + 1]);
      }
    }
    if (qlive[e]) {
      float* out = p.y + ((base + qrow[e]) * p.H + h) * D;
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        *reinterpret_cast<float2*>(out + d * 8 + t * 2) = make_float2(o[d][2 * e], o[d][2 * e + 1]);
    }
  }
}

}  // namespace

// q, k [N, H, 64] and v [N, H, 64] bf16 (rows row_stride elements apart,
// 16-byte aligned), y [N, H, 64] float32; offsets [S + 1], n_hist [S],
// tile_off [S + 1] (cumulative ceil(T_s / 64)), ts [N] int32; w_pos
// [n_pos], w_time [n_bkt] float32, thr [n_bkt] int64. grid_tiles >=
// tile_off[S]. Returns cudaGetLastError() after the launch.
extern "C" int otto_hstu_attention(const void* q, const void* k, const void* v, void* y,
                                   const void* offsets, const void* n_hist,
                                   const void* tile_off, const void* ts, const void* w_pos,
                                   const void* w_time, const void* thr,
                                   long long row_stride, int S, int H, int n_pos, int n_bkt,
                                   int grid_tiles, float n_scale, void* stream) {
  if (S > 0 && grid_tiles > 0 && H > 0) {
    if (n_pos > MAX_POS || n_bkt > MAX_BUCKETS || n_pos < 1 || n_bkt < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k);
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.y = static_cast<float*>(y);
    p.offsets = static_cast<const int32_t*>(offsets);
    p.n_hist = static_cast<const int32_t*>(n_hist);
    p.tile_off = static_cast<const int32_t*>(tile_off);
    p.ts = static_cast<const int32_t*>(ts);
    p.w_pos = static_cast<const float*>(w_pos);
    p.w_time = static_cast<const float*>(w_time);
    p.thr = static_cast<const long long*>(thr);
    p.row_stride = row_stride;
    p.S = S;
    p.H = H;
    p.n_pos = n_pos;
    p.n_bkt = n_bkt;
    p.n_scale = n_scale;
    const dim3 grid(static_cast<unsigned>(grid_tiles), static_cast<unsigned>(H));
    hstu_attention_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6, softmax form: the MLA + MoE ranker's attention (models/mla_moe.py;
// wrapper and plain twin in ops/kernels/softmax_attention.py). The same
// jagged layout, target-aware mask, 64-query tiles and 64-key history tiles
// as HSTU's form above, with softmax(q.k * scale) in place of SiLU and no
// position or time biases: 16 heads of q, k 192 wide (128 latent + 64 RoPE
// dims) and v 128 wide. The softmax is online (a running row maximum and
// sum, the output rescaled as a tile raises the maximum), taken in base 2 in
// registers; P is rounded to bfloat16 as the A operand of P.V and the sum
// kept in float32. A candidate's own key is folded in after the history
// tiles as a per-row dot product. Q, K and the transposed V tile take 68 KB
// of dynamic shared memory, rows padded so the fragment loads of the 8 row
// groups fall in distinct banks.
namespace {

constexpr int SQK = 192;           // q, k width
constexpr int SV = 128;            // v width
constexpr int SBM = 64;            // query rows a block
constexpr int SBN = 64;            // keys a tile
constexpr int SLDQ = SQK + 8;      // 400 bytes a shared q or k row
constexpr int SLDV = SBN + 8;      // 144 bytes a shared v^T row
constexpr int SMEM_SOFTMAX = (SBM * SLDQ + SBN * SLDQ + SV * SLDV) * 2;

struct SoftmaxParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  float* y;
  const int32_t* offsets;
  const int32_t* n_hist;
  const int32_t* tile_off;
  int S, H;
  float scale_log2;                // the softmax scale times log2(e)
};

__global__ void __launch_bounds__(THREADS) softmax_attention_kernel(SoftmaxParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + SBM * SLDQ;
  __nv_bfloat16* vt = ks + SBN * SLDQ;

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  if (tile >= p.tile_off[p.S]) return;
  int lo = 0, hi = p.S;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (p.tile_off[mid] <= tile) lo = mid; else hi = mid;
  }
  const int s = lo;
  const long long base = p.offsets[s];
  const int T = p.offsets[s + 1] - p.offsets[s];
  const int L = p.n_hist[s];
  const int q0 = (tile - p.tile_off[s]) * SBM;
  const int q1 = min(q0 + SBM, T);
  const int kmax = min(L, q1);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qk_rs = static_cast<long long>(p.H) * SQK;
  const long long v_rs = static_cast<long long>(p.H) * SV;
  const int hq = h * SQK, hv = h * SV;
  const float NEG = __int_as_float(0xff800000);   // -inf

  for (int i = tid; i < SBM * (SQK / 8); i += THREADS) {
    const int row = i / (SQK / 8), c = i % (SQK / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + row < T)
      val = *reinterpret_cast<const uint4*>(p.q + (base + q0 + row) * qk_rs + hq + c * 8);
    *reinterpret_cast<uint4*>(qs + row * SLDQ + c * 8) = val;
  }
  __syncthreads();

  int qrow[2];
  bool qlive[2], qhist[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    qrow[e] = q0 + warp * 16 + g + 8 * e;
    qlive[e] = qrow[e] < T;
    qhist[e] = qrow[e] < L;
  }
  uint32_t qa[SQK / 16][4];
#pragma unroll
  for (int kc = 0; kc < SQK / 16; ++kc) {
    const __nv_bfloat16* r = qs + (warp * 16 + g) * SLDQ + kc * 16 + t * 2;
    qa[kc][0] = ld32(r);
    qa[kc][1] = ld32(r + 8 * SLDQ);
    qa[kc][2] = ld32(r + 8);
    qa[kc][3] = ld32(r + 8 * SLDQ + 8);
  }

  float o[SV / 8][4];
#pragma unroll
  for (int d = 0; d < SV / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};

  for (int k0 = 0; k0 < kmax; k0 += SBN) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < SBN * (SQK / 8); i += THREADS) {
      const int row = i / (SQK / 8), c = i % (SQK / 8);
      uint4 kv = make_uint4(0, 0, 0, 0);
      if (k0 + row < kmax)
        kv = *reinterpret_cast<const uint4*>(p.k + (base + k0 + row) * qk_rs + hq + c * 8);
      *reinterpret_cast<uint4*>(ks + row * SLDQ + c * 8) = kv;
    }
    for (int i = tid; i < SBN * (SV / 8); i += THREADS) {
      const int row = i / (SV / 8), c = i % (SV / 8);
      uint4 vv = make_uint4(0, 0, 0, 0);
      if (k0 + row < kmax)
        vv = *reinterpret_cast<const uint4*>(p.v + (base + k0 + row) * v_rs + hv + c * 8);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c * 8 + e) * SLDV + row] = ve[e];
    }
    __syncthreads();

    float sc[SBN / 8][4];
#pragma unroll
    for (int j = 0; j < SBN / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
      const __nv_bfloat16* kr = ks + (j * 8 + g) * SLDQ + t * 2;
#pragma unroll
      for (int kc = 0; kc < SQK / 16; ++kc) mma(sc[j], qa[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }
    // scale and mask; the rows' maxima over the 4 threads of a row group
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < SBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + j * 8 + t * 2 + (e & 1);
        const bool ok = qlive[r] && key < kmax && (!qhist[r] || key <= qrow[r]);
        const float x = ok ? sc[j][e] * p.scale_log2 : NEG;
        sc[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      mu[r] = mn == NEG ? 0.0f : mn;     // a row with no open key yet
      const float alpha = exp2f(m[r] - mu[r]);
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int d = 0; d < SV / 8; ++d) {
        o[d][2 * r] *= alpha;
        o[d][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < SBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(sc[j][e] - mu[e >> 1]);
        sc[j][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int kc = 0; kc < SBN / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      pa[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      pa[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      pa[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
#pragma unroll
      for (int d = 0; d < SV / 8; ++d) {
        const __nv_bfloat16* vr = vt + (d * 8 + g) * SLDV + kc * 16 + t * 2;
        mma(o[d], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // the rows' sums over the 4 threads; a candidate's own key: the 4
  // threads of a row group take 48 dims each
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const bool self = qlive[e] && !qhist[e];
    const int r = warp * 16 + g + 8 * e;
    float part = 0.0f;
    if (self) {
      const __nv_bfloat16* kr = p.k + (base + qrow[e]) * qk_rs + hq;
#pragma unroll 8
      for (int d = t * (SQK / 4); d < (t + 1) * (SQK / 4); ++d)
        part += __bfloat162float(qs[r * SLDQ + d]) * __bfloat162float(kr[d]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (self) {
      const float x = part * p.scale_log2;
      const float mn = fmaxf(m[e], x);
      const float alpha = exp2f(m[e] - mn);
      const float pe = exp2f(x - mn);
      l[e] = l[e] * alpha + pe;
      const __nv_bfloat16* vr = p.v + (base + qrow[e]) * v_rs + hv + t * 2;
#pragma unroll
      for (int d = 0; d < SV / 8; ++d) {
        o[d][2 * e] = o[d][2 * e] * alpha + pe * __bfloat162float(vr[d * 8]);
        o[d][2 * e + 1] = o[d][2 * e + 1] * alpha + pe * __bfloat162float(vr[d * 8 + 1]);
      }
    }
    if (qlive[e]) {
      const float inv = 1.0f / l[e];
      float* out = p.y + ((base + qrow[e]) * p.H + h) * SV + t * 2;
#pragma unroll
      for (int d = 0; d < SV / 8; ++d)
        *reinterpret_cast<float2*>(out + d * 8) = make_float2(o[d][2 * e] * inv, o[d][2 * e + 1] * inv);
    }
  }
}

}  // namespace

// q, k [N, H, 192] and v [N, H, 128] bf16, contiguous and 16-byte aligned;
// y [N, H, 128] float32; offsets [S + 1], n_hist [S], tile_off [S + 1]
// (cumulative ceil(T_s / 64)) int32; grid_tiles >= tile_off[S]. Returns
// cudaGetLastError() after the launch.
extern "C" int otto_softmax_attention(const void* q, const void* k, const void* v, void* y,
                                      const void* offsets, const void* n_hist,
                                      const void* tile_off, int S, int H, int grid_tiles,
                                      float scale, void* stream) {
  if (S > 0 && grid_tiles > 0 && H > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        softmax_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_SOFTMAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    SoftmaxParams p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k);
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.y = static_cast<float*>(y);
    p.offsets = static_cast<const int32_t*>(offsets);
    p.n_hist = static_cast<const int32_t*>(n_hist);
    p.tile_off = static_cast<const int32_t*>(tile_off);
    p.S = S;
    p.H = H;
    p.scale_log2 = scale * 1.4426950408889634f;
    const dim3 grid(static_cast<unsigned>(grid_tiles), static_cast<unsigned>(H));
    softmax_attention_kernel<<<grid, THREADS, SMEM_SOFTMAX, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
