// K4: table row gather, out[i, :] = table[clip(ids[i], 0, V - 1), :].
//
// Replaces the Pallas TPU kernel otto_tpu/ops/pallas/dma_gather.py::
// gather_rows_hbm, which issued one DMA per row with a semaphore each (at
// most ~128 in flight, a TPU limit). On the card it serves the session
// embeddings' row gather (otto_tpu/engine/session_embed.py:47): up to 2^19
// rows of 100 floats per microbatch from a [1.8M, 100] table.
//
// What bounds it on the card: scattered row reads from device memory (400
// bytes a row at D = 100, at random places in a 720 MB table) and the
// contiguous writes; there is no arithmetic. The design keeps the loads wide
// and many rows in flight: one warp per output row, 16-byte loads when D is a
// multiple of 4 and both tables are 16-byte aligned (4-byte loads otherwise),
// and each warp issues the loads of 4 rows before it stores any of them.
// Rows are moved as 4-byte words, so float32 and int32 tables share it and
// the copy is bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 4;  // rows per warp, loaded before any is stored

template <typename W>
__global__ void __launch_bounds__(THREADS)
gather_rows_hbm_kernel(const W* __restrict__ table, const int32_t* __restrict__ ids,
                       W* __restrict__ out, int64_t N, int V, int width) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const int64_t row0 = warp * ROWS;
  const W* src[ROWS];
  bool live[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    live[r] = row0 + r < N;
    int id = live[r] ? __ldg(ids + row0 + r) : 0;
    id = id < 0 ? 0 : (id >= V ? V - 1 : id);
    src[r] = table + static_cast<int64_t>(id) * width;
  }
  for (int j = lane; j < width; j += 32) {
    W v[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (live[r]) v[r] = __ldg(src[r] + j);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (live[r]) out[(row0 + r) * width + j] = v[r];
    }
  }
}

}  // namespace

// table [V, D] and out [N, D] hold 4-byte words, ids [N] int32 (clamped into
// [0, V) here); V >= 1. Returns cudaGetLastError() after the launch.
extern "C" int otto_gather_rows_hbm(const void* table, const void* ids,
                                    void* out, long long N, int V, int D,
                                    void* stream) {
  if (N > 0 && D > 0) {
    const int64_t warps = (N + ROWS - 1) / ROWS;
    const dim3 grid(static_cast<unsigned>((warps * 32 + THREADS - 1) / THREADS));
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool wide = D % 4 == 0 &&
        ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (wide) {
      gather_rows_hbm_kernel<uint4><<<grid, THREADS, 0, s>>>(
          static_cast<const uint4*>(table), static_cast<const int32_t*>(ids),
          static_cast<uint4*>(out), N, V, D / 4);
    } else {
      gather_rows_hbm_kernel<uint32_t><<<grid, THREADS, 0, s>>>(
          static_cast<const uint32_t*>(table), static_cast<const int32_t*>(ids),
          static_cast<uint32_t*>(out), N, V, D);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
