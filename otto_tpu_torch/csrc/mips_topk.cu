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
//     dot scores are q . c.
//   * On an exact tie the lower corpus index comes first, whatever the
//     tiling or the split: entries are ordered by (score desc, index asc),
//     and that order decides both whether a score enters and where it goes.
//     (The Pallas kernel puts an equal score from a later tile first, an
//     artefact of its [tile ++ best] pool; lax.top_k and the port's twin
//     give the lower index.)
//   * Results are sorted descending; when V < k the missing entries are
//     index -1 with score -3.4e38 (mips.py:147-149).
//
// Precision: 3xTF32 on the tensor cores. One TF32 product keeps 11
// significant bits of each operand (about 2^-11 relative error), which
// would move the distances the checks hold to float32. So each operand x
// is split into hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in
// float32; tf32() rounds the 13 low mantissa bits to nearest, ties away
// from zero, as cvt.rna.tf32.f32 does), and the product is lo_q.hi_c +
// hi_q.lo_c + hi_q.hi_c, summed in float32 accumulators. The dropped
// lo_q.lo_c term and the rounding of lo leave about 2^-21 relative error
// per product, close to float32's 2^-24 and far from single-pass TF32. The
// twin (cuBLAS in full float32) and the kernel then differ in the last
// bits, so a near-tie may swap; the checks hold such a swap to a float64
// rescoring.
//
// What bounds it on the card: the tensor cores and the top-k epilogue, on
// the same warps. The MMAs are 3 * 2 * Q * V * D operations (about 6.5e14
// for 600k queries against 1.8M x 100) on warpgroup MMAs (wgmma runs TF32
// at about 489 TFLOP/s on the card, mma.sync at about 316); alone they take
// about 47 ms of the ~63 ms a 16384 x 1.8M x 100 block takes. A warpgroup
// waits for its tile's MMAs before its epilogue (ptxas serialises every
// wgmma where one group's accumulators are read or written while another
// group is in flight), so the epilogue (a few instructions per score)
// overlaps only the other warpgroup's MMAs.
//
// Design:
//   * A block owns BQ = 128 queries and a contiguous range of the corpus
//     (the whole corpus, or one of S splits when ceil(Q / 128) blocks
//     cannot fill the card; the wrapper picks S). Two consumer warpgroups
//     each own 64 of the queries; a producer warpgroup feeds them and gives
//     its registers to them (setmaxnreg).
//   * The queries stay in registers: each consumer thread loads its A
//     fragments (4 values per k8 step) once and splits them into hi and lo
//     there, so the kernel is compiled for each k8 step count KS <= 16.
//   * A prep kernel writes the corpus once per call as the MMAs read it:
//     tiles of BV = 64 rows, each a hi part then a lo part in wgmma's
//     K-major layout without swizzle (core matrices of 8 rows x 4 depths,
//     128 contiguous bytes each), zeros past D and in the rows that pad the
//     last tile. A tile is one contiguous block.
//   * Tiles come in by bulk asynchronous copies (cp.async.bulk, one per
//     tile) into a ring of 3-4 stages with full/empty mbarriers: the
//     producer keeps the ring full while the consumers run their MMAs.
//     wgmma reads B from shared memory through a descriptor: no fragment
//     loads, and core matrices do not conflict on banks.
//   * Per tile a warpgroup queues 3 * KS wgmma m64n64k8 (lo_q.hi_c,
//     hi_q.lo_c, hi_q.hi_c per step; the first with scale-d = 0) as one
//     group; the tile's |c|^2 loads go out while the MMAs run.
//   * The epilogue works on the accumulators: a query's row is spread over
//     4 lanes x 8 n-tiles, so the lists cannot be held one query per warp.
//     Each query's sorted top-k list lives in shared memory (owned by its
//     warp); a thread keeps its two rows' k-th (score, index) as
//     thresholds. One compare per score (score >= the k-th score) sieves
//     the tile; at the accumulator positions where a lane of the warp
//     passed, before() decides, with the mask of corpus rows past the
//     block's range, and the survivor is inserted into its list by the
//     whole warp (ballot for the position, shuffle for the shift).
//     Survivors are rare at the table build's shape (about k ln(V / k) per
//     query over the whole corpus), so they are inserted at once, not
//     buffered.
//   * With S > 1 each block writes its sorted partial list to scratch
//     [S, Q, k], and a second kernel merges the S lists of each query by
//     the same order (one warp per query).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;               // queries per block
constexpr int BV = 64;                // corpus rows per tile (the wgmma N)
constexpr int CWARPS = 8;             // consumer warps: 2 warpgroups
constexpr int THREADS = (CWARPS + 4) * 32;   // + a producer warpgroup
constexpr int PRODUCER_REGS = 40;     // setmaxnreg: 128 x 40 + 256 x 232
constexpr int CONSUMER_REGS = 232;    // registers = 65,536
constexpr int NT = BV / 8;            // n-tiles of 8 rows per tile
constexpr int MAX_KS = 16;            // k8 steps the kernel is compiled for
constexpr int MIN_STAGES = 3;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int32_t NONE = INT32_MAX;   // index of an empty list entry
constexpr float EMPTY_SCORE = -3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool before(float s, int32_t i, float t, int32_t j) {
  return s > t || (s == t && i < j);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// `bytes` contiguous bytes (a multiple of 16) global -> shared, completion
// counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// x rounded to TF32 (10 explicit mantissa bits): to nearest, ties away
// from zero, as cvt.rna.tf32.f32 but in two integer operations
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo), both TF32, hi + lo = x to about 2^-22 relative
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// wgmma shared-memory descriptor of a K-major operand without swizzle:
// core matrices (8 rows x 16 bytes) `lbo` bytes apart along K and `sbo`
// bytes apart along the rows
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (+)= a . b for the warpgroup's 64 x 64 block, one k8 step; a is this
// thread's TF32 A fragment (rows r0 and r0 + 8 of its warp's 16, k slots
// q and q + 4), b a descriptor of 64 rows x 8 depths
__device__ __forceinline__ void wgmma_tf32(float (&d)[NT][4],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28,"
      " %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// keep the compiler from moving accumulator reads above wgmma.wait_group
__device__ __forceinline__ void fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e]) :: "memory");
  }
}

// insert (s, ix) into the sorted list (ls, li) of length k held in shared
// memory; called by the whole warp with the same arguments
__device__ __forceinline__ void warp_insert(float* ls, int32_t* li, int k,
                                            float s, int32_t ix, int lane) {
  const float es = lane < k ? ls[lane] : -INFINITY;
  const int32_t ei = lane < k ? li[lane] : NONE;
  const int pos = __popc(__ballot_sync(FULL, lane < k && before(es, ei, s, ix)));
  const float us = __shfl_up_sync(FULL, es, 1);
  const int32_t ui = __shfl_up_sync(FULL, ei, 1);
  if (pos < k) {
    if (lane == pos) {
      ls[lane] = s;
      li[lane] = ix;
    } else if (lane > pos && lane < k) {
      ls[lane] = us;
      li[lane] = ui;
    }
  }
  __syncwarp();
}

// 32-bit words of one prepared corpus tile of KS k8 steps: hi and lo
// parts of BV rows x 2 KS core-matrix columns of 4 depths
__host__ __device__ constexpr int tile_words(int ks) { return 2 * BV * 8 * ks; }

// shared memory: the ring, then the lists, then the mbarriers
__host__ __device__ inline size_t list_off(int ks, int stages) {
  return static_cast<size_t>(stages) * tile_words(ks) * 4;
}
__host__ __device__ inline size_t bar_off(int ks, int k, int stages) {
  return (list_off(ks, stages) + static_cast<size_t>(BQ) * k * 8 + 7) / 8 * 8;
}
inline size_t smem_bytes(int ks, int k, int stages) {
  return bar_off(ks, k, stages) + (2 * stages + 1) * 8;
}

// x [rows, D] float32 -> out [ceil(rows / BV)] tiles of tile_words(ks):
// word ((p * BV / 8 + g) * 2 ks + c) * 32 + 4 i + w of a tile is part p
// (0: hi, 1: lo) of row 8 g + i, depth 4 c + w; zeros past D and in rows
// >= rows
__global__ void __launch_bounds__(256)
mips_prep_kernel(const float* __restrict__ x, int64_t rows, int D, int ks,
                 int64_t total, uint32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int tw = tile_words(ks);
  const int64_t t = i / tw;
  const int rem = static_cast<int>(i - t * tw);
  const int w = rem & 3;
  const int ri = (rem >> 2) & 7;
  const int c = (rem >> 5) % (2 * ks);
  const int pg = (rem >> 5) / (2 * ks);
  const int64_t r = t * BV + (pg % (BV / 8)) * 8 + ri;
  const int d = 4 * c + w;
  const float v = (r < rows && d < D) ? x[r * D + d] : 0.f;
  const uint32_t hi = tf32(v);
  out[i] = pg < BV / 8 ? hi : tf32(v - __uint_as_float(hi));
}

template <int KS>
__global__ void __launch_bounds__(THREADS, 1)
mips_topk_kernel(const float* __restrict__ queries,
                 const uint32_t* __restrict__ cprep,
                 const float* __restrict__ qsq, const float* __restrict__ csq,
                 float* __restrict__ out_s, int32_t* __restrict__ out_i,
                 int Q, int V, int D, int k, int l2, int chunk, int stages) {
  constexpr int TW = tile_words(KS);
  constexpr int PART = TW / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* ct = reinterpret_cast<uint32_t*>(smem);                 // [stages][TW]
  float* lst = reinterpret_cast<float*>(smem + list_off(KS, stages));   // [BQ][k]
  int32_t* lid = reinterpret_cast<int32_t*>(lst + BQ * k);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bar_off(KS, k, stages));
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  // corpus rows [vb, ve): split blockIdx.y of `chunk` rows, the last one
  // running to V
  const int vb = blockIdx.y * chunk;
  const int ve = blockIdx.y + 1 == gridDim.y ? V : vb + chunk;
  const int tiles = (ve - vb + BV - 1) / BV;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < BQ * k; e += THREADS) {
    lst[e] = -INFINITY;
    lid[e] = NONE;
  }
  __syncthreads();

  if (warp >= CWARPS) {
    // producer warpgroup: one thread walks this block's range of corpus
    // tiles through the ring; the rest of the registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp == CWARPS && lane == 0) {
      for (int t = 0; t < tiles; ++t) {
        const int st = t % stages;
        const int use = t / stages;
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        mbar_expect_tx(&full[st], TW * 4);
        bulk_load(ct + static_cast<size_t>(st) * TW,
                  cprep + static_cast<size_t>(vb / BV + t) * TW, TW * 4,
                  &full[st]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));

  // consumer warp: queries [warp * 16, warp * 16 + 16) of the block (warp
  // w % 4 of warpgroup w / 4); this thread's fragment rows r0 = lane / 4
  // and r0 + 8, fragment column q
  const int r0 = lane >> 2;
  const int q = lane & 3;
  const int row[2] = {warp * 16 + r0, warp * 16 + r0 + 8};
  float my_qsq[2];
  float thr_s[2];
  int32_t thr_i[2];
  uint32_t ah[KS][4], al[KS][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t qr = q0 + row[h];
    my_qsq[h] = (l2 && qr < Q) ? qsq[qr] : 0.f;
    thr_s[h] = -INFINITY;
    thr_i[h] = NONE;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // a[h + 2 j]: row r0 + 8 h, k slot q + 4 j = depth 8 s + q + 4 j
        const int d = 8 * s + q + 4 * j;
        const float x = (qr < Q && d < D) ? queries[qr * D + d] : 0.f;
        split(x, ah[s][h + 2 * j], al[s][h + 2 * j]);
      }
    }
  }
  const uint32_t ring = smem_addr(ct);

  // tile t's 3 * KS MMAs into acc, as one wgmma group
  auto start_mmas = [&](float (&acc)[NT][4], int t) {
    const int st = t % stages;
    mbar_wait(&full[st], (t / stages) & 1);
    const uint32_t hi = ring + st * TW * 4;
    const uint32_t lo = hi + PART * 4;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      // step s: core-matrix columns 2 s and 2 s + 1, 128 bytes apart;
      // 8-row groups 2 KS * 128 bytes apart
      const uint64_t bh = wgmma_desc(hi + s * 256, 128, 2 * KS * 128);
      const uint64_t bl = wgmma_desc(lo + s * 256, 128, 2 * KS * 128);
      wgmma_tf32(acc, al[s], bh, s > 0);
      wgmma_tf32(acc, ah[s], bl, 1);
      wgmma_tf32(acc, ah[s], bh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  // tile t's |c|^2 terms, loaded while its MMAs run
  auto load_csq = [&](float (&cn)[NT][2], int t) {
    const int v0 = vb + t * BV;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = v0 + n * 8 + 2 * q + c;
        cn[n][c] = (l2 && col < ve) ? __ldg(csq + col) : 0.f;
      }
    }
  };

  // tile t's scores (its MMAs done) -> the lists
  auto epilogue = [&](float (&acc)[NT][4], const float (&cn)[NT][2], int t) {
    fence_acc(acc);
    // every read of this stage is done: hand it back
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[t % stages]);

    // acc[n][e] is query row[e >> 1], corpus column v0 + n * 8 + 2 q + (e & 1).
    // A score enters only if it is >= its row's k-th score: that test
    // passes for every score before() would take, so it sieves the scores.
    // On a hit anywhere in the warp, bit 4 n + e of `hits` marks the
    // positions that passed in some lane, and before() (with the range
    // mask) decides there.
    const int v0 = vb + t * BV;
    bool any = false;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& sc = acc[n][e];
        if (l2) sc = 2.f * sc - my_qsq[e >> 1] - cn[n][e & 1];
        any |= sc >= thr_s[e >> 1];
      }
    }
    if (!__any_sync(FULL, any)) return;
    uint32_t hits = 0;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hits |= static_cast<uint32_t>(acc[n][e] >= thr_s[e >> 1]) << (4 * n + e);
      }
    }
    hits = __reduce_or_sync(FULL, hits);

#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!((hits >> (4 * n + e)) & 1)) continue;
        const int h = e >> 1;
        const int col = v0 + n * 8 + 2 * q + (e & 1);
        const bool cand = col < ve && before(acc[n][e], col, thr_s[h], thr_i[h]);
        unsigned m = __ballot_sync(FULL, cand);
        if (m == 0) continue;
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float sc = __shfl_sync(FULL, acc[n][e], src);
          const int32_t ix = __shfl_sync(FULL, col, src);
          const int r = warp * 16 + (src >> 2) + h * 8;
          warp_insert(lst + r * k, lid + r * k, k, sc, ix, lane);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          thr_s[hh] = lst[row[hh] * k + k - 1];
          thr_i[hh] = lid[row[hh] * k + k - 1];
        }
      }
    }
  };

  for (int t = 0; t < tiles; ++t) {
    float acc[NT][4];
    float cn[NT][2];
    start_mmas(acc, t);
    load_csq(cn, t);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    epilogue(acc, cn, t);
  }

  // this warp's 16 lists -> out (or the block's split of the scratch)
  __syncwarp();
  float* os = out_s + static_cast<size_t>(blockIdx.y) * Q * k;
  int32_t* oi = out_i + static_cast<size_t>(blockIdx.y) * Q * k;
  for (int r = 0; r < 16; ++r) {
    const int br = warp * 16 + r;
    const int64_t qr = q0 + br;
    if (qr < Q && lane < k) {
      const int32_t ix = lid[br * k + lane];
      const bool none = ix == NONE;
      os[qr * k + lane] = none ? EMPTY_SCORE : lst[br * k + lane];
      oi[qr * k + lane] = none ? -1 : ix;
    }
  }
}

// the S sorted partial lists [S, Q, k] of each query -> one sorted list
// (index -1 marks a missing entry); one warp per query, lane l < k holds
// entry l of the merged list. With S = 0 every entry is missing.
__global__ void __launch_bounds__(256)
mips_merge_kernel(const float* __restrict__ part_s,
                  const int32_t* __restrict__ part_i, float* __restrict__ out_s,
                  int32_t* __restrict__ out_i, int Q, int k, int S) {
  const int lane = threadIdx.x & 31;
  const int64_t qr = static_cast<int64_t>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (qr >= Q) return;
  float ls = -INFINITY;
  int32_t li = NONE;
  for (int sp = 0; sp < S; ++sp) {
    const size_t base = (static_cast<size_t>(sp) * Q + qr) * k;
    const float es = lane < k ? part_s[base + lane] : EMPTY_SCORE;
    const int32_t ei = lane < k ? part_i[base + lane] : -1;
    for (int j = 0; j < k; ++j) {
      const float s = __shfl_sync(FULL, es, j);
      const int32_t ix = __shfl_sync(FULL, ei, j);
      const float ts = __shfl_sync(FULL, ls, k - 1);
      const int32_t ti = __shfl_sync(FULL, li, k - 1);
      // a partial list is sorted: nothing after this entry enters either
      if (ix < 0 || !before(s, ix, ts, ti)) break;
      const int pos = __popc(__ballot_sync(FULL, lane < k && before(ls, li, s, ix)));
      const float us = __shfl_up_sync(FULL, ls, 1);
      const int32_t ui = __shfl_up_sync(FULL, li, 1);
      if (lane == pos) {
        ls = s;
        li = ix;
      } else if (lane > pos) {
        ls = us;
        li = ui;
      }
    }
  }
  if (lane < k) {
    const bool none = li == NONE;
    out_s[qr * k + lane] = none ? EMPTY_SCORE : ls;
    out_i[qr * k + lane] = none ? -1 : li;
  }
}

typedef void (*TopkKernel)(const float*, const uint32_t*, const float*,
                           const float*, float*, int32_t*, int, int, int, int,
                           int, int, int);

// the kernel compiled for KS = 1..MAX_KS k8 steps
const TopkKernel kernels[MAX_KS] = {
    mips_topk_kernel<1>,  mips_topk_kernel<2>,  mips_topk_kernel<3>,
    mips_topk_kernel<4>,  mips_topk_kernel<5>,  mips_topk_kernel<6>,
    mips_topk_kernel<7>,  mips_topk_kernel<8>,  mips_topk_kernel<9>,
    mips_topk_kernel<10>, mips_topk_kernel<11>, mips_topk_kernel<12>,
    mips_topk_kernel<13>, mips_topk_kernel<14>, mips_topk_kernel<15>,
    mips_topk_kernel<16>,
};

}  // namespace

// queries [Q, D], corpus [V, D], qsq [Q] and csq [V] (read only when l2 != 0)
// float32, contiguous; 1 <= D <= 128, 1 <= k <= 32; out_s [Q, k] float32,
// out_i [Q, k] int32. cprep is 32-bit scratch of ceil(V / 64) tiles of
// `tile_w` = 1024 * ceil(D / 8) words (mips.py::prep_words; checked here),
// 16-byte aligned. The corpus is cut into S ranges: S - 1 of `chunk` rows
// (a multiple of 64) and the rest; with S > 1 part_s / part_i are [S, Q, k]
// scratch, else unused. Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for a shape the kernel does
// not take.
extern "C" int otto_mips_topk(const void* queries, const void* corpus,
                              const void* qsq, const void* csq, void* out_s,
                              void* out_i, void* cprep, void* part_s,
                              void* part_i, int Q, int V, int D, int k, int l2,
                              int S, int chunk, int tile_w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ks = (D + 7) / 8;
  if (Q <= 0 || k < 1 || k > 32 || D < 1 || ks > MAX_KS || S < 1 ||
      chunk % BV || tile_w != tile_words(ks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* fs = static_cast<float*>(out_s);
  int32_t* fi = static_cast<int32_t*>(out_i);
  if (V > 0) {
    int stages = MAX_STAGES;
    while (stages > MIN_STAGES && smem_bytes(ks, k, stages) > SMEM_MAX) --stages;
    const size_t bytes = smem_bytes(ks, k, stages);
    if (bytes > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t total = static_cast<int64_t>((V + BV - 1) / BV) * tile_w;
    mips_prep_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(corpus), V, D, ks, total,
        static_cast<uint32_t*>(cprep));
    const TopkKernel kernel = kernels[ks - 1];
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(bytes));
    const dim3 grid((Q + BQ - 1) / BQ, S);
    kernel<<<grid, THREADS, bytes, st>>>(
        static_cast<const float*>(queries), static_cast<const uint32_t*>(cprep),
        static_cast<const float*>(qsq), static_cast<const float*>(csq),
        S > 1 ? static_cast<float*>(part_s) : fs,
        S > 1 ? static_cast<int32_t*>(part_i) : fi, Q, V, D, k, l2, chunk,
        stages);
  }
  if (V == 0 || S > 1) {
    mips_merge_kernel<<<(Q + 7) / 8, 256, 0, st>>>(
        static_cast<const float*>(part_s), static_cast<const int32_t*>(part_i),
        fs, fi, Q, k, V == 0 ? 0 : S);
  }
  return static_cast<int>(cudaGetLastError());
}
