// Pointwise modular multiply / add / subtract over RNS limbs — the inner
// loop of every evaluation-domain BFV operation (tensor products,
// key-switch digit products, plaintext mask multiplies).
//
// The work is one pass over memory: 16 bytes read and 8 written per
// element in the engine's int64 layout, a handful of integer operations
// in between, so the kernels are bound by bytes.  They read and write
// int64 directly (no cast pass), walk the flat (rows * n) index space
// with a grid-stride loop so neighbouring threads touch neighbouring
// addresses, and look the modulus up per limb (row % k) instead of
// reading a tiled per-row table.  The second operand may be shorter than
// the first: element i reads b[i % b_elems], which serves a key or a
// plaintext broadcast over the leading batch axes without a copy.
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
