// K9: a grouped matrix product over expert segments (the MoE layers of the
// MLA + MoE ranker, otto_tpu_torch/models/mla_moe.py; wrapper and plain twin
// in ops/kernels/grouped_gemm.py, which states the math). It replaces no TPU
// kernel: the JAX package has no experts. It was added because a MoE layer is
// ~83% of the ranker's work, and a loop of one library product an expert
// would launch 2 x 66 products a layer a chunk, most of them too small to
// fill the card.
//
// Rows are sorted by expert. One block computes one 128-row tile of one
// expert's segment by one 128-column tile of its weights: grid.y walks every
// expert's row tiles (tile_off, a cumulative count, names each tile's expert
// by a binary search; blocks past the last tile return), grid.x the column
// tiles, so the blocks in flight share one expert's weights in L2. A rows
// are gathered by index as they are loaded (the token's row of the normed
// hidden state), so no permuted copy of the tokens is written.
//
// What bounds it: the tensor cores. At 2048 -> 2 x 1408 and 1408 -> 2048 a
// 128 x 128 tile does 64 or 44 k-steps of 32 and each operand byte loaded
// feeds ~64 multiply-adds, above the card's ~295 FLOP a byte of HBM. The
// products run on mma.sync m16n8k16 (bfloat16 operands, float32
// accumulators): 8 warps, each 64 rows x 32 columns, fed by ldmatrix from a
// 4-stage cp.async ring (shared rows padded to 80 bytes, so the 8 rows an
// ldmatrix phase reads fall in distinct banks). The epilogue is fused: in
// gate_up form each warp holds 16 gate and the matching 16 up columns, so
// SiLU(g) * u is computed in registers and stored as bfloat16; in the plain
// form each row is scaled by its routing weight and written to its token's
// slot. wgmma and TMA (the card's full rate) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                // rows a block
constexpr int BN = 128;                // weight rows (output columns) a block
constexpr int BK = 32;                 // depth of a step
constexpr int STAGES = 4;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 8;            // bf16 a shared row: 80 bytes
constexpr int TILE = BM * LDS;         // elements of an A or a B tile
constexpr int CHUNKS = BK / 8;         // 16-byte chunks of a tile row
constexpr int LOADS = BM * CHUNKS / THREADS;   // chunks of A, and of B, a thread loads
constexpr int SMEM_BYTES = STAGES * 2 * TILE * 2;
static_assert(BM == BN, "A and B tiles share one shape");

struct Params {
  const __nv_bfloat16* a;
  const __nv_bfloat16* w;
  void* out;
  const int32_t* offsets;
  const int32_t* tile_off;
  const int32_t* rows;        // null: sorted row r reads a[r]
  const int32_t* out_rows;    // null: sorted row r writes out[r]
  const float* row_scale;     // null: 1
  int E, N, K;                // N: output columns
  int gate_up;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zeros where !valid (no bytes are read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

__global__ void __launch_bounds__(THREADS, 2) grouped_gemm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * TILE;

  const int tile = blockIdx.y;
  if (tile >= p.tile_off[p.E]) return;
  // the expert: the largest e with tile_off[e] <= tile (an empty expert
  // shares its successor's offset)
  int lo = 0, hi = p.E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (p.tile_off[mid] <= tile) lo = mid; else hi = mid;
  }
  const int e = lo;
  const int r0 = p.offsets[e] + (tile - p.tile_off[e]) * BM;
  const int r1 = min(r0 + BM, p.offsets[e + 1]);
  const int ct = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int K = p.K;
  const long long Nw = p.gate_up ? 2LL * p.N : p.N;
  const __nv_bfloat16* we = p.w + static_cast<long long>(e) * Nw * K;

  // this thread's A and B 16-byte chunks a stage: chunk c is row
  // c / CHUNKS, columns (c % CHUNKS) * 8 .. + 7 of the tile
  const __nv_bfloat16* a_src[LOADS];
  const __nv_bfloat16* b_src[LOADS];
  bool a_ok[LOADS];
  int dst[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int c = tid + i * THREADS;
    const int row = c / CHUNKS, col = (c % CHUNKS) * 8;
    const int r = r0 + row;
    a_ok[i] = r < r1;
    const long long ar = a_ok[i] ? (p.rows ? p.rows[r] : r) : 0;
    a_src[i] = p.a + ar * K + col;
    // gate_up: tile rows 0..63 are gate rows ct * 64 + row, 64..127 the
    // matching up rows N + ct * 64 + row - 64
    const long long n = p.gate_up ? (row < BN / 2 ? ct * (BN / 2) + row
                                                  : p.N + ct * (BN / 2) + row - BN / 2)
                                  : static_cast<long long>(ct) * BN + row;
    b_src[i] = we + n * K + col;
    dst[i] = (row * LDS + col) * 2;
  }
  const uint32_t as0 = smem_u32(As), bs0 = smem_u32(Bs);
  auto load = [&](int stage, int kt) {
    const uint32_t ab = as0 + stage * TILE * 2, bb = bs0 + stage * TILE * 2;
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      cp_async16(ab + dst[i], a_src[i] + kt * BK, a_ok[i]);
      cp_async16(bb + dst[i], b_src[i] + kt * BK, true);
    }
  };

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int wm = warp & 1, wn = warp >> 1;
  // the warp's two 16-row groups of B: n8 tiles 0-1 and 2-3
  const int brow0 = p.gate_up ? wn * 16 : wn * 32;
  const int brow1 = p.gate_up ? BN / 2 + wn * 16 : wn * 32 + 16;
  // ldmatrix row addresses: A rows (lane & 15), column half lane >> 4; B
  // rows (lane & 7) + (lane >> 4) * 8, column half (lane >> 3) & 1
  const int a_lrow = wm * 64 + (lane & 15), a_lcol = (lane >> 4) * 8;
  const int b_lrow = (lane & 7) + (lane >> 4) * 8, b_lcol = ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // step kt is in; every warp is done with step kt - 1
    {
      const int nk = kt + STAGES - 1;
      if (nk < KT) load(nk % STAGES, nk);
      cp_async_commit();
    }
    const uint32_t ab = as0 + (kt % STAGES) * TILE * 2, bb = bs0 + (kt % STAGES) * TILE * 2;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], ab + ((a_lrow + mt * 16) * LDS + ks + a_lcol) * 2);
      ldmatrix_x4(bf[0], bb + ((brow0 + b_lrow) * LDS + ks + b_lcol) * 2);
      ldmatrix_x4(bf[1], bb + ((brow1 + b_lrow) * LDS + ks + b_lcol) * 2);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma(acc[mt][nt], af[mt], bf[nt >> 1][(nt & 1) * 2], bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // accumulator element (mt, nt, 2 hh + q): row wm * 64 + mt * 16 + g + 8 hh,
  // column (of the warp's 32) nt * 8 + 2 t + q
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + wm * 64 + mt * 16 + g + 8 * hh;
      if (r >= r1) continue;
      if (p.gate_up) {
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.out) + static_cast<long long>(r) * p.N
                           + ct * (BN / 2) + wn * 16 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float v0 = silu(acc[mt][nt][2 * hh]) * acc[mt][nt + 2][2 * hh];
          const float v1 = silu(acc[mt][nt][2 * hh + 1]) * acc[mt][nt + 2][2 * hh + 1];
          *reinterpret_cast<__nv_bfloat162*>(o + nt * 8) = __floats2bfloat162_rn(v0, v1);
        }
      } else {
        const long long dr = p.out_rows ? p.out_rows[r] : r;
        const float sc = p.row_scale ? p.row_scale[r] : 1.0f;
        float* o = static_cast<float*>(p.out) + dr * p.N + ct * BN + wn * 32 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(o + nt * 8) =
              make_float2(sc * acc[mt][nt][2 * hh], sc * acc[mt][nt][2 * hh + 1]);
      }
    }
  }
}

}  // namespace

// a [*, K] bf16 (rows gathered through `rows` [R] int32, or read in order),
// w [E, N_w, K] bf16 (N_w = 2 N with gate_up), offsets / tile_off [E + 1]
// int32 (tile_off: cumulative ceil(rows / 128) an expert); gate_up: out
// [R, N] bf16; else out [*, N] float32, rows `out_rows` (or in order) scaled
// by `row_scale` (or 1). K % 32 == 0, N % 128 == 0 (% 64 with gate_up),
// row_tiles >= tile_off[E], col_tiles = N / 128 (N / 64 with gate_up).
// Returns cudaGetLastError() after the launch.
extern "C" int otto_grouped_gemm(const void* a, const void* w, void* out, const void* offsets,
                                 const void* tile_off, const void* rows, const void* out_rows,
                                 const void* row_scale, int E, int N, int K, int gate_up,
                                 int row_tiles, int col_tiles, void* stream) {
  if (E > 0 && row_tiles > 0 && col_tiles > 0) {
    if (K % BK || N % (gate_up ? BN / 2 : BN) || col_tiles != N / (gate_up ? BN / 2 : BN))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    Params p;
    p.a = static_cast<const __nv_bfloat16*>(a);
    p.w = static_cast<const __nv_bfloat16*>(w);
    p.out = out;
    p.offsets = static_cast<const int32_t*>(offsets);
    p.tile_off = static_cast<const int32_t*>(tile_off);
    p.rows = static_cast<const int32_t*>(rows);
    p.out_rows = static_cast<const int32_t*>(out_rows);
    p.row_scale = static_cast<const float*>(row_scale);
    p.E = E;
    p.N = N;
    p.K = K;
    p.gate_up = gate_up;
    const dim3 grid(static_cast<unsigned>(col_tiles), static_cast<unsigned>(row_tiles));
    grouped_gemm_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
