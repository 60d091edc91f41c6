// Negacyclic NTT over RNS limbs: forward (Cooley-Tukey, output in
// bit-reversed order) and inverse (Gentleman-Sande, consuming that order,
// final multiply by n^-1).  Same butterfly schedule and twiddle layout as
// core/ntt.py, so results are bit-identical to the plain version.
//
// One thread block transforms one row (= one limb of one polynomial) held
// in dynamic shared memory for all log2(n) stages: at n = 32768 a row is
// 128 KiB of 32-bit residues, inside the 227 KiB a block may use.  Global
// memory is touched once on the way in and once on the way out; the
// kernel reads and writes the engine's int64 layout directly, so no cast
// pass runs before or after it.  Twiddle tables are per limb, (k, n)
// 32-bit words plus Shoup companions; row r reads limb r % k, so a batch
// of any size shares one copy of the tables (they stay in L2).
//
// Plain C interface for ctypes: every entry takes raw device pointers and
// the stream, launches, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>
#include "u32.cuh"

namespace {

extern __shared__ uint32_t row_smem[];

__global__ void ntt_fwd_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out,
                               const uint32_t* __restrict__ psi,
                               const uint32_t* __restrict__ psi_shoup,
                               const uint32_t* __restrict__ qtab,
                               int k, int log_n) {
  const int n = 1 << log_n;
  const int half = n >> 1;
  const size_t row = blockIdx.x;
  const int limb = (int)(row % (size_t)k);
  const uint32_t q = qtab[limb];
  const uint32_t* w_tab = psi + (size_t)limb * n;
  const uint32_t* ws_tab = psi_shoup + (size_t)limb * n;
  const int64_t* src = in + row * n;
  int64_t* dst = out + row * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) row_smem[i] = (uint32_t)src[i];
  __syncthreads();

  for (int s = 0; s < log_n; ++s) {
    const int m = 1 << s;
    const int t_shift = log_n - 1 - s;  // t_len = n >> (s + 1)
    const int t_len = 1 << t_shift;
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int j = b >> t_shift;
      const int i = b & (t_len - 1);
      const int lo = (j << (t_shift + 1)) + i;
      const int hi = lo + t_len;
      const uint32_t u = row_smem[lo];
      const uint32_t v = u32::shoup_mulmod(row_smem[hi], w_tab[m + j], ws_tab[m + j], q);
      row_smem[lo] = u32::add_mod(u, v, q);
      row_smem[hi] = u32::sub_mod(u, v, q);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = (int64_t)row_smem[i];
}

__global__ void ntt_inv_kernel(const int64_t* __restrict__ in,
                               int64_t* __restrict__ out,
                               const uint32_t* __restrict__ ipsi,
                               const uint32_t* __restrict__ ipsi_shoup,
                               const uint32_t* __restrict__ qtab,
                               const uint32_t* __restrict__ ninv,
                               const uint32_t* __restrict__ ninv_shoup,
                               int k, int log_n) {
  const int n = 1 << log_n;
  const int half = n >> 1;
  const size_t row = blockIdx.x;
  const int limb = (int)(row % (size_t)k);
  const uint32_t q = qtab[limb];
  const uint32_t* w_tab = ipsi + (size_t)limb * n;
  const uint32_t* ws_tab = ipsi_shoup + (size_t)limb * n;
  const int64_t* src = in + row * n;
  int64_t* dst = out + row * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) row_smem[i] = (uint32_t)src[i];
  __syncthreads();

  for (int s = 0; s < log_n; ++s) {
    const int t_len = 1 << s;
    const int h = n >> (s + 1);
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int j = b >> s;
      const int i = b & (t_len - 1);
      const int lo = (j << (s + 1)) + i;
      const int hi = lo + t_len;
      const uint32_t u = row_smem[lo];
      const uint32_t v = row_smem[hi];
      row_smem[lo] = u32::add_mod(u, v, q);
      row_smem[hi] = u32::shoup_mulmod(u32::sub_mod(u, v, q), w_tab[h + j], ws_tab[h + j], q);
    }
    __syncthreads();
  }

  const uint32_t ni = ninv[limb];
  const uint32_t nis = ninv_shoup[limb];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = (int64_t)u32::shoup_mulmod(row_smem[i], ni, nis, q);
}

int block_threads(int n) {
  int t = n / 2;
  if (t > 1024) t = 1024;
  if (t < 32) t = 32;
  return t;
}

}  // namespace

extern "C" int ntt_fwd_launch(const void* in, void* out, const void* psi,
                              const void* psi_shoup, const void* qtab,
                              long long rows, int k, int log_n, void* stream) {
  const int n = 1 << log_n;
  const size_t smem = (size_t)n * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ntt_fwd_kernel<<<(unsigned)rows, block_threads(n), smem, (cudaStream_t)stream>>>(
      (const int64_t*)in, (int64_t*)out, (const uint32_t*)psi,
      (const uint32_t*)psi_shoup, (const uint32_t*)qtab, k, log_n);
  return (int)cudaGetLastError();
}

extern "C" int ntt_inv_launch(const void* in, void* out, const void* ipsi,
                              const void* ipsi_shoup, const void* qtab,
                              const void* ninv, const void* ninv_shoup,
                              long long rows, int k, int log_n, void* stream) {
  const int n = 1 << log_n;
  const size_t smem = (size_t)n * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ntt_inv_kernel<<<(unsigned)rows, block_threads(n), smem, (cudaStream_t)stream>>>(
      (const int64_t*)in, (int64_t*)out, (const uint32_t*)ipsi,
      (const uint32_t*)ipsi_shoup, (const uint32_t*)qtab, (const uint32_t*)ninv,
      (const uint32_t*)ninv_shoup, k, log_n);
  return (int)cudaGetLastError();
}
