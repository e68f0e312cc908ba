// K1: batched row-wise gather, out[b, s, w] = cols[b][s, idx[s, w]].
//
// Replaces the Pallas TPU kernel otto_tpu/ops/pallas/gather.py::gather_rows,
// which split every row into 128-lane chunks and rebuilt the gather as
// (out-chunk x src-chunk) vreg gathers plus selects. Hopper has a real
// dynamic gather in shared memory, so none of that decomposition is kept.
//
// What bounds it on the card: bytes moved. A call reads B*S*P source words
// and S*W index words and writes B*S*W words; there is no arithmetic. So
// the design keeps device memory busy the whole time:
//   * Persistent blocks (as many as fit on the SMs) walk over tiles of
//     `rows` consecutive session rows, block i taking tiles i, i + grid,
//     ... A tile's index rows, rows*W contiguous words, come into shared
//     memory once and serve all B columns.
//   * The source comes through a ring of 1-4 stages in shared memory. One
//     thread brings each (tile, column) item in with one cp.async.bulk
//     (rows*P contiguous words) completing on the stage's mbarrier, and
//     keeps the next stages' items in flight while the block gathers the
//     current one from shared memory and stores it with 16-byte streaming
//     stores (the tile's rows*W output words are contiguous too).
//   * The B columns are read by pointer (a __grid_constant__ array of up
//     to MAX_COLS bases), so a caller with separate [S, P] columns does
//     not first copy them into one stacked tensor, which cost a full
//     extra read and write of the source.
//   * Tile and ring sizes follow the shape: narrow rows (the GBDT walk,
//     P = 104, W = 150) take 56 rows a tile, 4 stages and 4 index slots,
//     the ring running over tiles; wide rows (the transport sort,
//     P = W = 4096, B = 40) two rows a tile, 4 stages and 2 index slots,
//     the ring running over the columns. At the main paths' shapes one
//     block fills an SM's shared memory (measured on the H100: 1.5%
//     faster at the sort's shape than two blocks of half the tile, level
//     at the walk's); smaller plans leave room for more blocks an SM.
//   * An item whose global address or byte count is not a multiple of 16
//     (an odd-offset column view, the last short tile of an odd width)
//     cannot go by bulk copy: its threads copy it word by word into the
//     same stage, inside this kernel.
// Words are moved as 4-byte values, so int32 and float32 (NaN payloads
// included) share the kernel bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_COLS = 256;            // column pointers a launch takes
constexpr int SMEM_MAX = 232448;         // dynamic shared memory of a block, sm_90
constexpr int STAGE_CAP = 32 * 1024;     // source bytes of a stage, at most

struct Cols {
  const uint32_t* p[MAX_COLS];
};

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

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// global -> shared, completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool bulk_ok(const void* p, uint32_t bytes) {
  return ((reinterpret_cast<uintptr_t>(p) | bytes) & 15) == 0;
}

// One item: n = rows*W output words from the staged source rows `src`
// (rows x P) and index rows `ix` (rows x W) into the contiguous `dst`. The
// words before dst's first 16-byte boundary and after its last go one by
// one; the rest as 16-byte streaming stores of 4 consecutive words.
__device__ __forceinline__ void gather_item(const uint32_t* src, const int32_t* ix,
                                            uint32_t* dst, int n, int P, int W,
                                            float inv_w) {
  const int tid = threadIdx.x;
  const int head = min(n, static_cast<int>((4 - (reinterpret_cast<uintptr_t>(dst) >> 2)) & 3));
  const int end = head + ((n - head) & ~3);
  if (tid < head) dst[tid] = src[(tid / W) * P + ix[tid]];
  if (tid < n - end) {
    const int j = end + tid;
    dst[j] = src[(j / W) * P + ix[j]];
  }
  for (int j = head + 4 * tid; j < end; j += 4 * THREADS) {
    // row of word j: j / W by a float reciprocal, corrected by one step
    // (j < 2^24, so the estimate is off by at most one)
    int row = __float2int_rz(__int2float_rn(j) * inv_w);
    int base = row * W;
    if (base > j) {
      --row;
      base -= W;
    } else if (base + W <= j) {
      ++row;
      base += W;
    }
    int w = j - base;
    const uint32_t* r = src + row * P;
    int32_t c[4];
    if (head == 0) {
      const int4 v = *reinterpret_cast<const int4*>(ix + j);
      c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) c[q] = ix[j + q];
    }
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (w == W) {
        w = 0;
        r += P;
      }
      o[q] = r[c[q]];
      ++w;
    }
    __stcs(reinterpret_cast<uint4*>(dst + j), make_uint4(o[0], o[1], o[2], o[3]));
  }
}

// An item is (local tile it, column ib) into ring stage ist.
struct Cursor {
  int64_t issued, it;
  int ib, ist;
};

// Thread 0 brings the cursor's item in and advances the cursor: at a
// tile's first column its index rows into slot it % islots (on ifull),
// then the column's source rows into stage ist (on full). An item that
// cannot go by bulk copy still arrives on its barrier, so every item
// completes one phase; its threads copy it by hand when they reach it.
__device__ __forceinline__ void issue(Cursor& c, const Cols& cols, const int32_t* idx, int B,
                                      int S, int P, int W, int rows, int stages, int islots,
                                      int sstride, int istride, uint64_t* full, uint64_t* ifull,
                                      unsigned char* ring, unsigned char* slots) {
  const int s0 = static_cast<int>((blockIdx.x + c.it * gridDim.x) * rows);
  const int n = min(rows, S - s0);
  if (c.ib == 0) {
    const int slot = static_cast<int>(c.it % islots);
    const int32_t* g = idx + static_cast<int64_t>(s0) * W;
    const uint32_t bytes = static_cast<uint32_t>(n) * W * 4;
    if (bulk_ok(g, bytes)) {
      mbar_expect_tx(&ifull[slot], bytes);
      bulk_load(slots + slot * istride, g, bytes, &ifull[slot]);
    } else {
      mbar_arrive(&ifull[slot]);
    }
  }
  const uint32_t* g = cols.p[c.ib] + static_cast<int64_t>(s0) * P;
  const uint32_t bytes = static_cast<uint32_t>(n) * P * 4;
  if (bulk_ok(g, bytes)) {
    mbar_expect_tx(&full[c.ist], bytes);
    bulk_load(ring + c.ist * sstride, g, bytes, &full[c.ist]);
  } else {
    mbar_arrive(&full[c.ist]);
  }
  ++c.issued;
  if (++c.ib == B) {
    c.ib = 0;
    ++c.it;
  }
  if (++c.ist == stages) c.ist = 0;
}

// shared memory: the mbarriers (full[stages], ifull[islots]), the source
// ring (stages x sstride bytes), the index slots (islots x istride bytes)
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const __grid_constant__ Cols cols, const int32_t* __restrict__ idx,
                   uint32_t* __restrict__ out, int B, int S, int P, int W, int rows,
                   int stages, int islots, int sstride, int istride) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* ifull = full + stages;
  unsigned char* ring = smem + ((8 * (stages + islots) + 15) & ~15);
  unsigned char* slots = ring + stages * sstride;
  const int tid = threadIdx.x;
  const int tiles = (S + rows - 1) / rows;
  const int64_t my_tiles = static_cast<int>(blockIdx.x) < tiles
      ? (tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1 : 0;
  const int64_t n_items = my_tiles * B;
  const float inv_w = 1.0f / static_cast<float>(W);

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(&full[i], 1);
    for (int i = 0; i < islots; ++i) mbar_init(&ifull[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0's issue cursor: the next item to bring in
  Cursor cur = {0, 0, 0, 0};
  if (tid == 0) {
    while (cur.issued < n_items && cur.issued < stages) {
      issue(cur, cols, idx, B, S, P, W, rows, stages, islots, sstride, istride, full, ifull,
            ring, slots);
    }
  }

  int64_t t = 0;          // local tile of item k
  int b = 0, st = 0;      // its column and stage
  uint32_t ph = 0;        // parity of the stage's current phase
  for (int64_t k = 0; k < n_items; ++k) {
    const int s0 = static_cast<int>((blockIdx.x + t * gridDim.x) * rows);
    const int n = min(rows, S - s0);
    uint32_t* src = reinterpret_cast<uint32_t*>(ring + st * sstride);
    const int slot = static_cast<int>(t % islots);
    int32_t* ix = reinterpret_cast<int32_t*>(slots + slot * istride);
    bool copied = false;
    if (b == 0) {
      mbar_wait(&ifull[slot], static_cast<uint32_t>((t / islots) & 1));
      const int32_t* g = idx + static_cast<int64_t>(s0) * W;
      if (!bulk_ok(g, static_cast<uint32_t>(n) * W * 4)) {
        for (int i = tid; i < n * W; i += THREADS) ix[i] = g[i];
        copied = true;
      }
    }
    mbar_wait(&full[st], ph);
    const uint32_t* g = cols.p[b] + static_cast<int64_t>(s0) * P;
    if (!bulk_ok(g, static_cast<uint32_t>(n) * P * 4)) {
      for (int i = tid; i < n * P; i += THREADS) src[i] = g[i];
      copied = true;
    }
    if (copied) __syncthreads();
    gather_item(src, ix, out + (static_cast<int64_t>(b) * S + s0) * W, n * W, P, W, inv_w);
    // words this thread wrote into a stage or slot by hand must be ordered
    // before the bulk copy that refills it
    if (copied) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && cur.issued < n_items) {
      issue(cur, cols, idx, B, S, P, W, rows, stages, islots, sstride, istride, full, ifull,
            ring, slots);
    }
    if (++b == B) {
      b = 0;
      ++t;
    }
    if (++st == stages) {
      st = 0;
      ph ^= 1;
    }
  }
}

int round16(int64_t bytes) { return static_cast<int>((bytes + 15) & ~int64_t{15}); }

struct Plan {
  int rows, stages, islots, sstride, istride, smem;
};

int smem_of(const Plan& p) {
  return ((8 * (p.stages + p.islots) + 15) & ~15) + p.stages * p.sstride +
         p.islots * p.istride;
}

// Rows per tile and ring depth for a shape: 4 stages where one row of each
// fits, else 3, 2, 1. Index slots: enough that a tile's index rows are
// never overwritten while one of its columns is still to be gathered,
// 1 + ceil((stages - 1) / B). Rows per tile: as many as fit the block's
// shared memory, at most STAGE_CAP source bytes and half an even share of
// S over the SMs, a multiple of 4 from 4 up (so every tile of a 16-byte
// aligned column starts 16-byte aligned). false: not even one row of
// source and index fits a block.
bool make_plan(int B, int S, int P, int W, int sms, Plan* out) {
  for (int stages = 4; stages >= 1; --stages) {
    Plan p;
    p.stages = stages;
    p.islots = 1 + (stages - 1 + B - 1) / B;
    if (p.islots > stages) p.islots = stages;
    const int64_t per_row = int64_t{4} * (stages * int64_t{P} + p.islots * int64_t{W});
    int64_t rows = (SMEM_MAX - 64 - 16 * (stages + p.islots)) / per_row;
    const int64_t cap = STAGE_CAP / (4 * int64_t{P});
    const int64_t share = (S + 2 * sms - 1) / (2 * int64_t{sms});
    if (rows > cap) rows = cap;
    if (rows > share) rows = share;
    if (rows >= 4) rows &= ~int64_t{3};
    if (rows < 1) rows = 1;
    p.rows = static_cast<int>(rows);
    p.sstride = round16(int64_t{4} * p.rows * P);
    p.istride = round16(int64_t{4} * p.rows * W);
    p.smem = smem_of(p);
    if (p.smem <= SMEM_MAX) {
      *out = p;
      return true;
    }
  }
  return false;
}

}  // namespace

// cols: B column bases, each [S, P] 4-byte words, row-major; idx [S, W]
// int32 in [0, P); out [B, S, W]. B <= MAX_COLS. Returns
// cudaGetLastError() after the launch (nothing is launched for an empty
// output), or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int otto_gather_rows(const void* const* cols, int B, const void* idx, void* out,
                                int S, int P, int W, void* stream) {
  if (B == 0 || S == 0 || W == 0) return static_cast<int>(cudaGetLastError());
  if (B < 0 || B > MAX_COLS || S < 0 || P < 1 || W < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // four runtime queries a launch: kept once per device instead, they
  // saved no host time measurable beside the Python wrapper's own
  // (scripts/bench_k1.py, "host")
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  Plan p;
  if (!make_plan(B, S, P, W, sms, &p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(gather_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       SMEM_MAX);
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_rows_kernel, THREADS, p.smem);
  if (per_sm < 1) per_sm = 1;
  const int tiles = (S + p.rows - 1) / p.rows;
  const int most = per_sm * sms;
  Cols c;
  for (int b = 0; b < B; ++b) c.p[b] = static_cast<const uint32_t*>(cols[b]);
  gather_rows_kernel<<<tiles < most ? tiles : most, THREADS, p.smem,
                       static_cast<cudaStream_t>(stream)>>>(
      c, static_cast<const int32_t*>(idx), static_cast<uint32_t*>(out), B, S, P, W, p.rows,
      p.stages, p.islots, p.sstride, p.istride);
  return static_cast<int>(cudaGetLastError());
}
