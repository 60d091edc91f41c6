// Rotate-and-add reduction over rows of slot values mod t: what
// repro/kernels/rotate_reduce/rotate_reduce.py `rotate_reduce_pallas`
// computes, log2(c) stages of x <- (x + roll(x, -2^s)) mod t per row.
//
//   full mode  (c = n): every slot holds the row total mod t.  One thread
//              block per row sums the row in 64-bit registers (warp
//              shuffles, then one shared-memory pass over the warp sums),
//              takes one remainder and writes the total to every slot.
//              Exact for any t < 2^31 and any power-of-two n.
//   chunk mode (c < n): slot i holds the wrapped window sum
//              x[i] + ... + x[i + c - 1] mod t.  The row lives in dynamic
//              shared memory as 32-bit values for all log2(c) doubling
//              stages (x + y < 2t < 2^32 fits one word; one conditional
//              subtract reduces it); each thread stages its new values in
//              registers between two barriers, so one buffer serves and
//              n <= 32768 (128 KiB) fits a block.
//
// Bound on the card: bytes.  Either mode reads each int64 element once and
// writes it once, with a handful of integer operations per element between.
//
// Plain C interface for ctypes: the entry takes raw device pointers and the
// stream, launches, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxPerThread = 32;  // chunk mode: n <= kThreads * kMaxPerThread

extern __shared__ uint32_t rr_smem[];

__global__ void __launch_bounds__(kThreads)
rotate_reduce_full_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                          uint32_t t, int log_n) {
  __shared__ unsigned long long warp_sums[kThreads / 32];
  __shared__ int64_t total;
  const int n = 1 << log_n;
  const size_t row = blockIdx.x;
  const int64_t* src = in + row * (size_t)n;
  int64_t* dst = out + row * (size_t)n;

  unsigned long long acc = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += (unsigned long long)src[i];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    unsigned long long v = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) total = (int64_t)(v % t);
  }
  __syncthreads();
  const int64_t s = total;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = s;
}

__global__ void __launch_bounds__(kThreads)
rotate_reduce_chunk_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
                           uint32_t t, int log_n, int stop_log) {
  const int n = 1 << log_n;
  const int wrap = n - 1;
  const int per = n / (int)blockDim.x;  // blockDim.x = min(n, kThreads) divides n
  const size_t row = blockIdx.x;
  const int64_t* src = in + row * (size_t)n;
  int64_t* dst = out + row * (size_t)n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) rr_smem[i] = (uint32_t)src[i];
  __syncthreads();

  uint32_t v[kMaxPerThread];
  for (int s = 0; s < stop_log; ++s) {
    const int step = 1 << s;
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      if (j < per) {
        const int i = threadIdx.x + j * blockDim.x;
        const uint32_t a = rr_smem[i] + rr_smem[(i + step) & wrap];
        v[j] = a >= t ? a - t : a;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxPerThread; ++j) {
      if (j < per) rr_smem[threadIdx.x + j * blockDim.x] = v[j];
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = (int64_t)rr_smem[i];
}

}  // namespace

// stop_log == log_n is the full reduction; anything smaller is chunk mode.
extern "C" int rotate_reduce_launch(const void* in, void* out, long long rows,
                                    int log_n, int stop_log, long long t,
                                    void* stream) {
  const int n = 1 << log_n;
  if (stop_log == log_n) {
    const int threads = n < 32 ? 32 : (n > kThreads ? kThreads : n);
    rotate_reduce_full_kernel<<<(unsigned)rows, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t*)in, (int64_t*)out, (uint32_t)t, log_n);
    return (int)cudaGetLastError();
  }
  if (n > kThreads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      rotate_reduce_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n > kThreads ? kThreads : n;
  rotate_reduce_chunk_kernel<<<(unsigned)rows, threads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)in, (int64_t*)out, (uint32_t)t, log_n, stop_log);
  return (int)cudaGetLastError();
}
