// HPS fast base conversion of RNS residues from a base A (ka limbs) to a
// base B (kb limbs): the lift to the auxiliary base and the way back in
// every ciphertext-ciphertext multiply (core/bfv.BFVContext._fbc).
//
// It replaces a plain loop, not a TPU kernel: the JAX package computes
// `_fbc` as array code (src/repro/core/bfv.py) and has no Pallas kernel
// for it, and the port's plain version (kernels/baseconv/ref.py) issues
// about 4 * ka small torch operations a call.
//
// For x given by reduced residues x_i mod a_i in [0, a_i) — what every
// caller passes: ciphertext components and residues just taken mod a_i —
// each thread takes one coefficient of one row and computes
//
//   y_i   = x_i * hat_inv_i mod a_i                     (Shoup, exact)
//   v     = rint(sum_i double(y_i) * a_inv_i)           (float64)
//   out_j = (sum_i y_i * hat_mod_b[i][j] - v * (A mod b_j)) mod b_j
//
// bit for bit as the plain version does.  v is the plain version's sum:
// the same float64 products and sums in the same order, limb 0 first,
// each rounded to nearest (__dmul_rn / __dadd_rn: no contraction into an
// FMA, which could move v by one on a rare coefficient), then rounded
// half to even as torch.round does.  Each y_i * hat_mod_b[i][j] is taken
// up to one b_j by Shoup's method with a companion precomputed on the
// host (< 2 b_j < 2^32) and summed in 64 bits; A mod b_j times v <= ka is
// subtracted after adding ka * b_j, and one Barrett reduction brings the
// sum (< 2^38) into [0, b_j).  The result is the unique residue the plain
// version's int64 `%` gives.
//
// Bound on the card: integer operations.  An output residue costs ka
// products at about six operations each (three for the lazy Shoup
// product, two for the 64-bit sum, the table read), against 4 bytes of
// input per limb and 4 of output: 5 lanes of a 30 -> 31 conversion at
// n = 32768 are 0.91 G operations, 55 us at 16.75 T/s, and 40 MB, 12 us
// at 3.35 TB/s.  The design keeps the ka values y_i of a coefficient in
// registers and loops over the outputs, so every input is read once and
// every output written once, in the engine's int64 layout (no cast
// pass); neighbouring threads take neighbouring coefficients, so each
// limb row's reads and writes coalesce.  The table of (hat_mod_b,
// companion) pairs sits in shared memory, output-major, zero past ka, and
// every thread of a warp reads the same entry at once (a broadcast);
// the y_i loop runs over all kMaxLimbs slots so that it unrolls with no
// test of ka in it.  Where rows * n threads would leave the SMs short of
// warps (one lane: 32768 threads), the outputs are split into groups,
// one grid row each, each group recomputing y and v for its coefficient.
//
// Plain C interface for ctypes: raw device pointers and the stream;
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>
#include "u32.cuh"

namespace {

constexpr int kMaxLimbs = 32;
constexpr int kThreads = 128;
// threads a launch aims for before it splits the outputs: 132 SMs with
// eight blocks of kThreads each
constexpr long long kTargetThreads = 132LL * 8 * kThreads;

__global__ void __launch_bounds__(kThreads)
base_conv_kernel(const int64_t* __restrict__ x, long long x_row_stride,
                 int64_t* __restrict__ out, int ka, int kb, int n, int tiles,
                 int per_group, const uint32_t* __restrict__ in_q,
                 const uint32_t* __restrict__ hat_inv,    // (ka, 2): w, companion
                 const double* __restrict__ a_inv,        // (ka,)
                 const uint32_t* __restrict__ out_q,      // (kb,)
                 const uint64_t* __restrict__ out_mu,     // (kb,) floor(2^64 / b_j)
                 const uint32_t* __restrict__ a_mod_b,    // (kb,)
                 const uint32_t* __restrict__ hat_mod_b)  // (ka, kb, 2): h, companion
{
  // [j * kMaxLimbs + i]: output-major, so that the unrolled i loop reads
  // at fixed offsets from one address; zero for i >= ka
  __shared__ __align__(16) uint2 s_hat[kMaxLimbs * kMaxLimbs];
  __shared__ uint32_t s_q[kMaxLimbs], s_w[kMaxLimbs], s_ws[kMaxLimbs];
  __shared__ double s_ainv[kMaxLimbs];
  __shared__ uint32_t s_b[kMaxLimbs], s_amb[kMaxLimbs];
  __shared__ uint64_t s_mu[kMaxLimbs];

  const int tid = threadIdx.x;
  for (int t = tid; t < kb * kMaxLimbs; t += kThreads) {
    const int j = t / kMaxLimbs, i = t % kMaxLimbs;
    const int src = 2 * (i * kb + j);
    s_hat[t] = i < ka ? make_uint2(hat_mod_b[src], hat_mod_b[src + 1]) : make_uint2(0u, 0u);
  }
  if (tid < ka) {
    s_q[tid] = in_q[tid];
    s_w[tid] = hat_inv[2 * tid];
    s_ws[tid] = hat_inv[2 * tid + 1];
    s_ainv[tid] = a_inv[tid];
  }
  if (tid < kb) {
    s_b[tid] = out_q[tid];
    s_amb[tid] = a_mod_b[tid];
    s_mu[tid] = out_mu[tid];
  }
  __syncthreads();

  const long long row = blockIdx.x / tiles;
  const int c = (int)(blockIdx.x % tiles) * kThreads + tid;
  if (c >= n) return;
  const int64_t* xr = x + row * x_row_stride + c;

  uint32_t y[kMaxLimbs];
  double acc = 0.0;  // 0 + the first term is that term exactly
#pragma unroll
  for (int i = 0; i < kMaxLimbs; ++i) {
    y[i] = 0u;
    if (i < ka) {
      y[i] = u32::shoup_mulmod((uint32_t)xr[(long long)i * n], s_w[i], s_ws[i], s_q[i]);
      acc = __dadd_rn(acc, __dmul_rn(__uint2double_rn(y[i]), s_ainv[i]));
    }
  }
  // sum_i y_i / a_i lies in [0, ka): v in [0, ka]
  const uint64_t v = (uint64_t)rint(acc);

  const int j0 = blockIdx.y * per_group;
  const int j1 = min(kb, j0 + per_group);
  int64_t* orow = out + row * kb * (long long)n + c;
  for (int j = j0; j < j1; ++j) {
    const uint32_t b = s_b[j];
    const uint2* hj = s_hat + j * kMaxLimbs;
    uint64_t s = (uint64_t)ka * b - v * s_amb[j];  // >= 0: v * (A mod b) <= ka * b
#pragma unroll
    for (int i = 0; i < kMaxLimbs; ++i) {
      const uint2 h = hj[i];
      s += u32::shoup_mulmod_lazy(y[i], h.x, h.y, b);  // < 2b each; 0 past ka
    }
    orow[(long long)j * n] = (int64_t)u32::barrett_reduce(s, b, s_mu[j]);
  }
}

}  // namespace

extern "C" int base_conv_launch(const void* x, long long x_row_stride, void* out,
                                int rows, int ka, int kb, int n, const void* in_q,
                                const void* hat_inv, const void* a_inv,
                                const void* out_q, const void* out_mu,
                                const void* a_mod_b, const void* hat_mod_b,
                                void* stream) {
  if (ka < 1 || ka > kMaxLimbs || kb < 1 || kb > kMaxLimbs)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || n <= 0) return 0;
  const int tiles = (n + kThreads - 1) / kThreads;
  const long long threads = (long long)rows * tiles * kThreads;
  long long groups = (kTargetThreads + threads - 1) / threads;
  if (groups > kb) groups = kb;
  const int per_group = (int)((kb + groups - 1) / groups);
  groups = (kb + per_group - 1) / per_group;
  const dim3 grid((unsigned)((long long)rows * tiles), (unsigned)groups);
  base_conv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)x, x_row_stride, (int64_t*)out, ka, kb, n, tiles, per_group,
      (const uint32_t*)in_q, (const uint32_t*)hat_inv, (const double*)a_inv,
      (const uint32_t*)out_q, (const uint64_t*)out_mu, (const uint32_t*)a_mod_b,
      (const uint32_t*)hat_mod_b);
  return (int)cudaGetLastError();
}
