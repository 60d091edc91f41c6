// Negacyclic NTT over RNS limbs: forward (Cooley-Tukey, output in
// bit-reversed order) and inverse (Gentleman-Sande, consuming that order,
// final multiply by n^-1).  Same butterfly schedule and twiddle layout as
// core/ntt.py, so results are bit-identical to the plain version.
// Twiddle tables are per limb, (k, n) 32-bit words plus Shoup companions;
// row r reads limb r % k, so a batch of any size shares one copy of the
// tables (they stay in L2).  Rows are the engine's int64 layout, read and
// written directly: no cast pass runs before or after a kernel.
//
// Forward kernel.  What bounds it on the card is one row's latency: a
// row's 15 stages at n = 32768 are ~2.5 M dependent-in-stage integer
// operations, about as long as moving its 512 KiB of int64 through one
// SM's share of the memory rate.  The design cuts the stages' cost and
// overlaps one row's memory traffic with another's butterflies:
//
//   * half rows.  The first stage pairs i with i + n/2; after it the two
//     halves are independent.  Block 2r + h reads the whole of row r
//     (the second read of the pair comes from L2), computes half h of
//     stage 0 on the way in, and runs the other log2(n) - 1 stages on
//     n/2 values: 64 KiB of shared memory at n = 32768, so two blocks
//     share an SM and one's loads overlap the other's butterflies.
//   * radix 32 in registers.  Each thread holds E = 32 values and runs
//     five stages on them before it exchanges through shared memory: a
//     round covers a window of five index bits, and a thread's values
//     differ only in those bits.  At n = 32768 that is 512 threads, 3
//     rounds (5 + 5 + 4 stages), 2 exchanges and 5 barriers instead of
//     15.  Each round reads each twiddle it needs once, through the
//     read-only path.
//   * padded exchanges.  Shared index i is stored at i + i / 32, so the
//     contiguous pattern (early rounds) and the stride-32 pattern (the
//     last round) both hit 32 distinct banks.
//   * the first round reads straight from global memory, coalesced
//     across threads; the last goes through shared memory once more so
//     the int64 stores are coalesced too.
//
// The inverse kernel is the first design: one block holds a whole row in
// shared memory for all stages, one barrier per stage.
//
// Plain C interface for ctypes: every entry takes raw device pointers and
// the stream, launches, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>
#include "u32.cuh"

namespace {

extern __shared__ uint32_t row_smem[];

constexpr int kFwdMaxLogE = 5;                 // E = 32 values per thread
constexpr int kFwdMaxThreads = (32768 / 2) >> kFwdMaxLogE;

__host__ __device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// local index (within the half row) of value c of thread `tid` when the
// round's window of LE bits starts at bit `lo`
template <int LE>
__device__ __forceinline__ int window_index(int tid, int lo, int c) {
  return (((tid >> lo) << (lo + LE)) | (c << lo)) | (tid & ((1 << lo) - 1));
}

// The butterflies of one stage of a round: window bit D (local bit
// p = lo + D) when p < top.  Local bit p is stage s = lh - p of the
// row's transform; its twiddle index is 2^s + (full index >> (p + 1)),
// where the full index of a local one is h * 2^lh + local.  D is a
// template argument so that every loop has a constant trip count and
// x[] stays in registers.
template <int LE, int D>
__device__ __forceinline__ void fwd_stages(uint32_t (&x)[1 << LE], int lo, int top, int lh,
                                           int h, int hi_part,
                                           const uint32_t* __restrict__ w_tab,
                                           const uint32_t* __restrict__ ws_tab, uint32_t q) {
  constexpr int E = 1 << LE;
  const int p = lo + D;
  if (p < top) {
    const int wbase = (1 << (lh - p)) + (h << (lh - p - 1)) + (hi_part >> (p + 1));
#pragma unroll
    for (int g = 0; g < (E >> (D + 1)); ++g) {
      const uint32_t w = __ldg(w_tab + wbase + g);
      const uint32_t ws = __ldg(ws_tab + wbase + g);
#pragma unroll
      for (int r = 0; r < (1 << D); ++r) {
        constexpr int half = 1 << D;
        const int c = (g << (D + 1)) | r;
        const uint32_t u = x[c];
        const uint32_t v = u32::shoup_mulmod(x[c + half], w, ws, q);
        x[c] = u32::add_mod(u, v, q);
        x[c + half] = u32::sub_mod(u, v, q);
      }
    }
  }
  if constexpr (D > 0) fwd_stages<LE, D - 1>(x, lo, top, lh, h, hi_part, w_tab, ws_tab, q);
}

// The butterflies of one round: local bits top - 1 down to lo of the
// window [lo, lo + LE), highest first.
template <int LE>
__device__ __forceinline__ void fwd_round(uint32_t (&x)[1 << LE], int lo, int top, int lh,
                                          int h, int tid, const uint32_t* __restrict__ w_tab,
                                          const uint32_t* __restrict__ ws_tab, uint32_t q) {
  if constexpr (LE > 0)
    fwd_stages<LE, LE - 1>(x, lo, top, lh, h, (tid >> lo) << (lo + LE), w_tab, ws_tab, q);
}

// Grid: 2 * rows blocks, block 2r + h computing half h of row r; blockDim
// = 2^(log_n - 1 - LE) threads, each holding E = 2^LE values.
template <int LE>
__global__ void __launch_bounds__(kFwdMaxThreads, 2)
ntt_fwd_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
               const uint32_t* __restrict__ psi, const uint32_t* __restrict__ psi_shoup,
               const uint32_t* __restrict__ qtab, int k, int log_n) {
  constexpr int E = 1 << LE;
  const int lh = log_n - 1;                    // index bits of a half row
  const int nh = 1 << lh;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x >> 1;
  const int h = blockIdx.x & 1;
  const int limb = (int)(row % (size_t)k);
  const uint32_t q = __ldg(qtab + limb);
  const uint32_t* w_tab = psi + ((size_t)limb << log_n);
  const uint32_t* ws_tab = psi_shoup + ((size_t)limb << log_n);
  // the low words of the row's little-endian int64 residues (< 2^31):
  // 32-bit loads keep one register per value in flight, not two
  const uint32_t* src = reinterpret_cast<const uint32_t*>(in + (row << log_n));
  int64_t* dst = out + (row << log_n) + ((size_t)h << lh);

  // stage 0 on the way in: x = a[i] +- psi[1] * a[i + n/2], for the
  // local indices of the first window [lh - LE, lh)
  uint32_t x[E];
  int lo = lh - LE;
  {
    const uint32_t w = __ldg(w_tab + 1), ws = __ldg(ws_tab + 1);
#pragma unroll
    for (int c = 0; c < E; ++c) {
      const int i = (c << lo) | tid;
      const uint32_t a = __ldg(src + 2 * i);
      const uint32_t v = u32::shoup_mulmod(__ldg(src + 2 * (i + nh)), w, ws, q);
      x[c] = h ? u32::sub_mod(a, v, q) : u32::add_mod(a, v, q);
    }
  }
  fwd_round<LE>(x, lo, lh, lh, h, tid, w_tab, ws_tab, q);
  while (lo > 0) {
#pragma unroll
    for (int c = 0; c < E; ++c) row_smem[padded(window_index<LE>(tid, lo, c))] = x[c];
    __syncthreads();
    const int top = lo;
    lo = lo > LE ? lo - LE : 0;
#pragma unroll
    for (int c = 0; c < E; ++c) x[c] = row_smem[padded(window_index<LE>(tid, lo, c))];
    fwd_round<LE>(x, lo, top, lh, h, tid, w_tab, ws_tab, q);
    __syncthreads();                           // every read done before the next writes
  }
#pragma unroll
  for (int c = 0; c < E; ++c) row_smem[padded(window_index<LE>(tid, lo, c))] = x[c];
  __syncthreads();
  for (int i = tid; i < nh; i += blockDim.x) dst[i] = (int64_t)row_smem[padded(i)];
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

template <int LE>
int launch_fwd(const void* in, void* out, const void* psi, const void* psi_shoup,
               const void* qtab, long long rows, int k, int log_n, cudaStream_t stream) {
  const int nh = 1 << (log_n - 1);
  const size_t smem = (size_t)(padded(nh - 1) + 1) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_fwd_kernel<LE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ntt_fwd_kernel<LE><<<(unsigned)(2 * rows), nh >> LE, smem, stream>>>(
      (const int64_t*)in, (int64_t*)out, (const uint32_t*)psi,
      (const uint32_t*)psi_shoup, (const uint32_t*)qtab, k, log_n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ntt_fwd_launch(const void* in, void* out, const void* psi,
                              const void* psi_shoup, const void* qtab,
                              long long rows, int k, int log_n, void* stream) {
  if (log_n < 1 || log_n > 15) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (log_n - 1 < kFwdMaxLogE ? log_n - 1 : kFwdMaxLogE) {
    case 0: return launch_fwd<0>(in, out, psi, psi_shoup, qtab, rows, k, log_n, s);
    case 1: return launch_fwd<1>(in, out, psi, psi_shoup, qtab, rows, k, log_n, s);
    case 2: return launch_fwd<2>(in, out, psi, psi_shoup, qtab, rows, k, log_n, s);
    case 3: return launch_fwd<3>(in, out, psi, psi_shoup, qtab, rows, k, log_n, s);
    case 4: return launch_fwd<4>(in, out, psi, psi_shoup, qtab, rows, k, log_n, s);
    default: return launch_fwd<5>(in, out, psi, psi_shoup, qtab, rows, k, log_n, s);
  }
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
