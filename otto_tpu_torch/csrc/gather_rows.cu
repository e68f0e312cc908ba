// K1: batched row-wise gather, out[b, s, w] = values[b, s, idx[s, w]].
//
// Replaces the Pallas TPU kernel otto_tpu/ops/pallas/gather.py::gather_rows,
// which split every row into 128-lane chunks and rebuilt the gather as
// (out-chunk x src-chunk) vreg gathers plus selects. Hopper has a real
// dynamic gather in shared memory, so none of that decomposition is kept.
//
// What bounds it on the card: bytes moved. Each call reads B*S*P source
// words and S*W index words and writes B*S*W words; there is no arithmetic.
// The design keeps every device-memory access coalesced: a block owns
// `rows` session rows, loads their index rows into shared memory once,
// then for each of the B stacked columns copies the source rows into
// shared memory with consecutive threads on consecutive words, and
// serves the random part of the gather from shared memory. Columns are
// moved as 4-byte words, so int32 and float32 share the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_kernel(const uint32_t* __restrict__ values,
                                   const int32_t* __restrict__ idx,
                                   uint32_t* __restrict__ out,
                                   int B, int S, int P, int W) {
  extern __shared__ uint32_t smem[];
  const int rows = blockDim.y;
  uint32_t* src = smem + threadIdx.y * P;                      // [rows, P]
  int32_t* ix = reinterpret_cast<int32_t*>(smem + rows * P)   // [rows, W]
                + threadIdx.y * W;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * rows + threadIdx.y;
  const bool live = s < S;

  if (live) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) ix[w] = idx[s * W + w];
  }
  for (int b = 0; b < B; ++b) {
    const int64_t row = static_cast<int64_t>(b) * S + s;
    if (live) {
      for (int p = threadIdx.x; p < P; p += blockDim.x) {
        src[p] = values[row * P + p];
      }
    }
    __syncthreads();
    if (live) {
      for (int w = threadIdx.x; w < W; w += blockDim.x) {
        out[row * W + w] = src[ix[w]];
      }
    }
    __syncthreads();
  }
}

}  // namespace

// values [B, S, P] and out [B, S, W] hold 4-byte words; idx [S, W] int32 in
// [0, P). Returns cudaGetLastError() after the launch.
extern "C" int otto_gather_rows(const void* values, const void* idx, void* out,
                                int B, int S, int P, int W, void* stream) {
  // one warp per 128 words of the wider row side, at most 8 warps a row;
  // narrow rows (the GBDT walk: P = 104, W = 150) share a 256-thread block
  const int widest = P > W ? P : W;
  int warps = (widest + 127) / 128;
  if (warps < 1) warps = 1;
  if (warps > 8) warps = 8;
  const int tx = 32 * warps;
  const int ty = 256 / tx > 0 ? 256 / tx : 1;
  const size_t smem = static_cast<size_t>(ty) * (P + W) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(gather_rows_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const dim3 block(tx, ty);
  const dim3 grid((S + ty - 1) / ty);
  if (S > 0 && B > 0 && W > 0) {
    gather_rows_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(values), static_cast<const int32_t*>(idx),
        static_cast<uint32_t*>(out), B, S, P, W);
  }
  return static_cast<int>(cudaGetLastError());
}
