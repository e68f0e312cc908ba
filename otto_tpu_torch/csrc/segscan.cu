// K2: inclusive segmented scan (sum | min | max) along the last axis.
//
// Replaces the Pallas TPU kernel
// otto_tpu/ops/pallas/segscan.py::segmented_scan_pallas (and, on the card,
// the Hillis-Steele network otto_tpu/ops/segment.py::segmented_scan that
// the TPU build runs by default). values [B, S, P], first [S, P] bytes
// marking segment starts. After the scan the last lane of every segment
// holds the segment's reduction, and nothing crosses a segment boundary.
//
// What bounds it on the card: bytes moved. The network reads and writes
// every column log2(P) times; this kernel reads values and flags once and
// writes once. One warp owns one (b, s) row and walks it in 32-lane chunks
// with coalesced loads. Inside a chunk a 5-step shuffle scan combines the
// (value, flag) monoid (v1,f1)+(v2,f2) = (f2 ? v2 : op(v1,v2), f1|f2); the
// running value of lane 31 carries into the next chunk, and a lane absorbs
// it only while no flag lies between the chunk start and itself.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { kSum = 0, kMin = 1, kMax = 2 };

template <typename T, int OP>
__device__ __forceinline__ T combine(T prev, T cur) {
  if (OP == kSum) return prev + cur;
  if (OP == kMin) return cur < prev ? cur : prev;
  return cur > prev ? cur : prev;
}

// int32 sums wrap in two's complement, as XLA's do
template <>
__device__ __forceinline__ int32_t combine<int32_t, kSum>(int32_t prev, int32_t cur) {
  return static_cast<int32_t>(static_cast<uint32_t>(prev) + static_cast<uint32_t>(cur));
}

template <typename T, int OP>
__global__ void segscan_kernel(const T* __restrict__ values,
                               const uint8_t* __restrict__ first,
                               T* __restrict__ out, int B, int S, int P) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= static_cast<int64_t>(B) * S) return;  // uniform across the warp
  const int64_t s = row % S;
  const T* v = values + row * P;
  const uint8_t* f = first + s * P;
  T* o = out + row * P;

  T carry = T(0);
  for (int base = 0; base < P; base += 32) {
    const int p = base + lane;
    const bool in = p < P;
    T x = in ? v[p] : T(0);
    // the row's first lane absorbs nothing; lanes past the row end start
    // their own segments so they never reach a carry
    int flag = (!in || p == 0) ? 1 : (f[p] != 0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T xu = __shfl_up_sync(0xffffffffu, x, d);
      const int fu = __shfl_up_sync(0xffffffffu, flag, d);
      if (lane >= d) {
        if (!flag) x = combine<T, OP>(xu, x);
        flag |= fu;
      }
    }
    if (!flag) x = combine<T, OP>(carry, x);
    if (in) o[p] = x;
    carry = __shfl_sync(0xffffffffu, x, 31);
  }
}

template <typename T>
cudaError_t launch(int op, const void* values, const void* first, void* out,
                   int B, int S, int P, cudaStream_t stream) {
  const int warps = 8;
  const int64_t rows = static_cast<int64_t>(B) * S;
  const dim3 block(32 * warps);
  const dim3 grid(static_cast<unsigned>((rows + warps - 1) / warps));
  const T* v = static_cast<const T*>(values);
  const uint8_t* f = static_cast<const uint8_t*>(first);
  T* o = static_cast<T*>(out);
  switch (op) {
    case kSum: segscan_kernel<T, kSum><<<grid, block, 0, stream>>>(v, f, o, B, S, P); break;
    case kMin: segscan_kernel<T, kMin><<<grid, block, 0, stream>>>(v, f, o, B, S, P); break;
    case kMax: segscan_kernel<T, kMax><<<grid, block, 0, stream>>>(v, f, o, B, S, P); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = int32, 1 = float32; op: 0 = sum, 1 = min, 2 = max.
// Returns cudaGetLastError() after the launch.
extern "C" int otto_segscan(const void* values, const void* first, void* out,
                            int B, int S, int P, int dtype, int op, void* stream) {
  if (B <= 0 || S <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<int32_t>(op, values, first, out, B, S, P, st);
  } else if (dtype == 1) {
    err = launch<float>(op, values, first, out, B, S, P, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
