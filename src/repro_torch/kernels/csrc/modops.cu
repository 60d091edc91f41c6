// Pointwise modular multiply / add / subtract over RNS limbs — the inner
// loop of every evaluation-domain BFV operation (tensor products,
// plaintext mask multiplies) — and the scan step's key switch.
//
// The pointwise kernels are one pass over memory: 16 bytes read and 8
// written per element in the engine's int64 layout, a handful of integer
// operations in between, so they are bound by bytes.  They read and write
// int64 directly (no cast pass), walk the flat (rows * n) index space
// with a grid-stride loop so neighbouring threads touch neighbouring
// addresses, and look the modulus up per limb (row % k) instead of
// reading a tiled per-row table.  The second operand may be shorter than
// the first: element i reads b[i % b_elems], which serves a key or a
// plaintext broadcast over the leading batch axes without a copy.
//
// The key switch (keyswitch_kernel) replaces the JAX package's
// `keyswitch` (src/repro/launch/nshedb_step.py), plain array code with no
// Pallas kernel, which the port first ran as a mul_mod over a (kd, B, kj,
// n) product and a halving tree of add_mods.  For every block b, output
// limb j and coefficient c it computes, for both keys K at once,
//
//   out_j[b, c] = sum_i d_i[b, c] * K[i, j, c]  mod q_j
//
// Bound: a 64-block, 32 x 32 switch at n = 32768 moves ~2.1 GB in the
// int64 layout with each operand read once (~0.64 ms at 3.35 TB/s) and
// does 4.3 G multiply-accumulates (~0.51 ms on the int32 lanes), so it
// sits between bytes and operations.  Design: a block takes 32
// neighbouring coefficients (one a lane, so every load and store
// coalesces) and 8 output limbs, keeps that tile of both keys for every
// digit in shared memory as (b, a) word pairs, and loops its warps over
// all the ciphertext blocks: each key residue leaves device memory once a
// launch, and each digit once per 8 output limbs (the blocks that share
// it run side by side and meet in L2).  A thread holds 2 blocks x 8 limbs
// x 2 keys of 64-bit accumulators, adds `depth` products (the wrapper's
// bound, from the primes: 16 at 30 bits) and then reduces with
// u32::barrett_reduce, so nothing of size (kd, B, kj, n) exists.  The
// arithmetic is exact mod q_j: the results equal the unfused kernels'
// bit for bit.  Digits may be int32 (a mesh gathers them so) or int64.
// Measured on an H100 at that shape: 1.47-1.52 ms, 1.15 ms of it with no
// digit loads at all, so the 64-bit multiply-accumulates bound it.
//
// Plain C interface for ctypes: every entry takes raw device pointers and
// the stream, launches, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cstdint>
#include "u32.cuh"

namespace {

constexpr int kThreads = 256;

struct MulOp {
  const uint64_t* mu;
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b,
                                                 uint32_t q, int limb) const {
    return u32::barrett_mulmod(a, b, q, mu[limb]);
  }
};
struct AddOp {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b,
                                                 uint32_t q, int) const {
    return u32::add_mod(a, b, q);
  }
};
struct SubOp {
  __device__ __forceinline__ uint32_t operator()(uint32_t a, uint32_t b,
                                                 uint32_t q, int) const {
    return u32::sub_mod(a, b, q);
  }
};

template <typename Op>
__global__ void pointwise_kernel(const int64_t* __restrict__ a,
                                 const int64_t* __restrict__ b,
                                 int64_t* __restrict__ out,
                                 const uint32_t* __restrict__ qtab,
                                 long long total, long long b_elems,
                                 int k, int log_n, Op op) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int limb = (int)((i >> log_n) % k);
    const long long ib = (b_elems == total) ? i : i % b_elems;
    out[i] = (int64_t)op((uint32_t)a[i], (uint32_t)b[ib], qtab[limb], limb);
  }
}

template <typename Op>
int launch(const void* a, const void* b, void* out, const void* qtab,
           long long total, long long b_elems, int k, int log_n,
           void* stream, Op op) {
  if (total <= 0) return 0;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // a few waves per SM, then stride
  if (blocks > cap) blocks = cap;
  pointwise_kernel<Op><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)a, (const int64_t*)b, (int64_t*)out,
      (const uint32_t*)qtab, total, b_elems, k, log_n, op);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- key switch
constexpr int kKsLanes = 32;   // coefficients a block, one a lane
constexpr int kKsWarps = 8;    // warps a block, each over its own ciphertext blocks
constexpr int kKsLimbs = 8;    // output limbs a block
constexpr int kKsBlocks = 2;   // ciphertext blocks a warp accumulates at once

// A digit's residue: the low 32-bit word of an int64 (little-endian) or
// the int32 itself.  Loading the word alone, not the int64, frees the
// registers the accumulators need (1.47 against 1.90 ms at 64 blocks, 32
// x 32 digits and limbs, n = 32768, on an H100).
template <typename D>
__device__ __forceinline__ uint32_t digit_at(const D* dig, long long at) {
  return reinterpret_cast<const uint32_t*>(dig)[at * (long long)(sizeof(D) / 4)];
}

template <typename D>
__global__ void __launch_bounds__(kKsLanes * kKsWarps, 2)
keyswitch_kernel(const D* __restrict__ dig,          // (blocks, kd, n)
                 const int64_t* __restrict__ kb,     // (kd, kj, n)
                 const int64_t* __restrict__ ka,     // (kd, kj, n)
                 int64_t* __restrict__ out,          // (2, blocks, kj, n)
                 const uint32_t* __restrict__ qtab,  // (kj,)
                 const uint64_t* __restrict__ mutab, // (kj,)
                 long long blocks, int kd, int kj, int n, int depth) {
  extern __shared__ uint2 skey[];   // [kd][kKsLimbs][kKsLanes]: (K_b, K_a)
  __shared__ uint32_t sq[kKsLimbs];
  __shared__ uint64_t smu[kKsLimbs];
  const int lane = threadIdx.x % kKsLanes, warp = threadIdx.x / kKsLanes;
  const int j0 = blockIdx.x * kKsLimbs;
  const int c0 = blockIdx.y * kKsLanes;
  const int c = c0 + lane;
  const bool live = c < n;

  for (int t = threadIdx.x; t < kd * kKsLimbs * kKsLanes; t += blockDim.x) {
    const int l = t % kKsLanes, jj = (t / kKsLanes) % kKsLimbs;
    const int i = t / (kKsLanes * kKsLimbs), j = j0 + jj;
    uint2 v = make_uint2(0u, 0u);
    if (j < kj && c0 + l < n) {
      const long long at = ((long long)i * kj + j) * n + c0 + l;
      v = make_uint2((uint32_t)kb[at], (uint32_t)ka[at]);
    }
    skey[t] = v;
  }
  if (threadIdx.x < kKsLimbs) {
    const int j = min(j0 + (int)threadIdx.x, kj - 1);
    sq[threadIdx.x] = qtab[j];
    smu[threadIdx.x] = mutab[j];
  }
  __syncthreads();

  const long long plane = blocks * kj * n;    // one key's output
  for (long long b0 = (long long)warp * kKsBlocks; b0 < blocks;
       b0 += kKsWarps * kKsBlocks) {
    uint64_t acc[2][kKsBlocks][kKsLimbs];
#pragma unroll
    for (int tb = 0; tb < kKsBlocks; ++tb)
#pragma unroll
      for (int jj = 0; jj < kKsLimbs; ++jj) acc[0][tb][jj] = acc[1][tb][jj] = 0;
    for (int i0 = 0; i0 < kd; i0 += depth) {
      const int i1 = min(i0 + depth, kd);
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        uint32_t d[kKsBlocks];
#pragma unroll
        for (int tb = 0; tb < kKsBlocks; ++tb)
          d[tb] = (live && b0 + tb < blocks)
                      ? digit_at(dig, ((b0 + tb) * kd + i) * n + c) : 0u;
        const uint2* row = skey + i * kKsLimbs * kKsLanes + lane;
#pragma unroll
        for (int jj = 0; jj < kKsLimbs; ++jj) {
          const uint2 kk = row[jj * kKsLanes];
#pragma unroll
          for (int tb = 0; tb < kKsBlocks; ++tb) {
            acc[0][tb][jj] += (uint64_t)d[tb] * kk.x;
            acc[1][tb][jj] += (uint64_t)d[tb] * kk.y;
          }
        }
      }
      // at most `depth` products on a residue below q: still below 2^64
#pragma unroll
      for (int jj = 0; jj < kKsLimbs; ++jj)
#pragma unroll
        for (int tb = 0; tb < kKsBlocks; ++tb) {
          acc[0][tb][jj] = u32::barrett_reduce(acc[0][tb][jj], sq[jj], smu[jj]);
          acc[1][tb][jj] = u32::barrett_reduce(acc[1][tb][jj], sq[jj], smu[jj]);
        }
    }
    if (!live) continue;
#pragma unroll
    for (int tb = 0; tb < kKsBlocks; ++tb) {
      if (b0 + tb >= blocks) break;
#pragma unroll
      for (int jj = 0; jj < kKsLimbs; ++jj) {
        if (j0 + jj >= kj) break;
        const long long at = ((b0 + tb) * kj + j0 + jj) * n + c;
        out[at] = (int64_t)acc[0][tb][jj];
        out[plane + at] = (int64_t)acc[1][tb][jj];
      }
    }
  }
}

template <typename D>
int keyswitch_launch_t(const void* dig, const void* kb, const void* ka, void* out,
                       const void* qtab, const void* mu, long long blocks, int kd,
                       int kj, int n, int depth, void* stream) {
  if (blocks <= 0 || kd <= 0 || kj <= 0 || n <= 0) return 0;
  const int smem = kd * kKsLimbs * kKsLanes * (int)sizeof(uint2);
  cudaError_t err = cudaFuncSetAttribute(
      keyswitch_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((kj + kKsLimbs - 1) / kKsLimbs, (n + kKsLanes - 1) / kKsLanes);
  keyswitch_kernel<D><<<grid, kKsLanes * kKsWarps, smem, (cudaStream_t)stream>>>(
      (const D*)dig, (const int64_t*)kb, (const int64_t*)ka, (int64_t*)out,
      (const uint32_t*)qtab, (const uint64_t*)mu, blocks, kd, kj, n, depth);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mul_mod_launch(const void* a, const void* b, void* out,
                              const void* qtab, const void* mu,
                              long long total, long long b_elems, int k,
                              int log_n, void* stream) {
  return launch(a, b, out, qtab, total, b_elems, k, log_n, stream,
                MulOp{(const uint64_t*)mu});
}

extern "C" int add_mod_launch(const void* a, const void* b, void* out,
                              const void* qtab, long long total,
                              long long b_elems, int k, int log_n, void* stream) {
  return launch(a, b, out, qtab, total, b_elems, k, log_n, stream, AddOp{});
}

extern "C" int sub_mod_launch(const void* a, const void* b, void* out,
                              const void* qtab, long long total,
                              long long b_elems, int k, int log_n, void* stream) {
  return launch(a, b, out, qtab, total, b_elems, k, log_n, stream, SubOp{});
}

// digits of `digit_bytes` 4 (int32) or 8 (int64); `depth` products are
// accumulated between reductions (the wrapper's bound from the primes)
extern "C" int keyswitch_launch(const void* dig, int digit_bytes, const void* kb,
                                const void* ka, void* out, const void* qtab,
                                const void* mu, long long blocks, int kd, int kj,
                                int n, int depth, void* stream) {
  if (digit_bytes == 4)
    return keyswitch_launch_t<int32_t>(dig, kb, ka, out, qtab, mu, blocks, kd, kj,
                                       n, depth, stream);
  return keyswitch_launch_t<int64_t>(dig, kb, ka, out, qtab, mu, blocks, kd, kj, n,
                                     depth, stream);
}
