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
// Inverse kernel.  It replaces the TPU's `ntt_inv_pallas` (`_inv_kernel`,
// repro/kernels/ntt/ntt.py).  What bounds it on the card is integer
// operations (~2.5 M a row at n = 32768, just above its bytes), and,
// at the row counts the paths give it (30 or 31, 150 or 155), how few
// SMs the rows fill: with one block per row a 30-row call ran on 30 of
// the 132 SMs, for the latency of one row's 15 stages.  Its last stage
// pairs i with i + n/2, so after 14 stages each half of a row depends on
// the other and the forward kernel's half rows do not carry over.  The
// design splits a row across a thread-block cluster instead:
//
//   * C = 8 blocks per row, launched as a cluster (cudaLaunchKernelEx,
//     cudaLaunchAttributeClusterDimension): block c holds the contiguous
//     chunk [c n/C, (c + 1) n/C) in shared memory, 16 KiB at n = 32768,
//     and runs the first log2(n / C) stages alone, since they pair
//     indices inside one chunk.  A 30-row call has 240 blocks, not 30.
//   * the local stages in registers, E = 16 values per thread, four
//     stages a round, the window of index bits walking up from bit 0;
//     padded exchanges (i at i + i / 32) between rounds, stages as
//     template recursion, each twiddle read once per round through the
//     read-only path.  The chunk comes in through shared memory, where
//     the forward kernel reads global memory straight into registers:
//     a thread's first window is E neighbouring values, so a warp
//     reading them directly would touch 32 lines per load.
//   * the last log2(C) stages as one radix-C round across the cluster,
//     through distributed shared memory: after cluster.sync() block c
//     takes its n / C^2 columns j, reads the C values j + m n/C from the
//     C blocks' shared memory (map_shared_rank; neighbouring threads on
//     neighbouring columns), runs the stages in registers with the C - 1
//     twiddles every column shares, multiplies by n^-1 and writes C
//     coalesced int64 outputs; a second cluster.sync() keeps every block
//     resident until the others have read its chunk.
//
// C and E are fixed, the same at every row count.  A sweep in one call on
// an H100 80GB HBM3 at 700 W timed C = 2, 4, 8 at E = 16 and 32: C = 8
// was the fastest C at every row count the paths launch, E = 16 the
// fastest E there (ms at 30 / 150 rows: C = 2 0.0259 / 0.0841, C = 4
// 0.0155 / 0.0631, C = 8 0.0146 / 0.0554 at E = 16; C = 8, E = 32 0.0159
// / 0.0601; the one-block-per-row kernel 0.0642 / 0.2092).  At 4500 rows,
// which no path gives the inverse, E = 32 is 2 % faster.  64 registers,
// no spill at C = 8, E = 16.  Every n from 2 to 32768 goes through the
// one kernel, with C = min(8, n / 2) and E = min(16, n / C).
//
// Plain C interface for ctypes: every entry takes raw device pointers and
// the stream, launches, and returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
#include "u32.cuh"

namespace cg = cooperative_groups;

namespace {

extern __shared__ uint32_t row_smem[];

constexpr int kFwdMaxLogE = 5;                 // E = 32 values per thread
constexpr int kFwdMaxThreads = (32768 / 2) >> kFwdMaxLogE;
// The inverse's blocks per row and values per thread (source note): C = 8,
// the portable cluster maximum, and E = 16, where the chunk allows them
constexpr int kInvLogC = 3;
constexpr int kInvLogE = 4;

// threads of an inverse block at n = 32768 (at most 1024)
constexpr int inv_max_threads(int log_e, int log_c) {
  return ((32768 >> log_c) >> log_e) < 1024 ? ((32768 >> log_c) >> log_e) : 1024;
}

__host__ __device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// local index (within the forward kernel's half row, the inverse's chunk)
// of value c of thread `tid` when the round's window of LE bits starts at
// bit `lo`
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

// The butterflies of one inverse stage of a round: window bit D (chunk
// bit p = lo + D) when p >= bot, the lowest bit not yet done.  Chunk bit
// p is stage p of the row's transform (the row index's bit p); its
// twiddle index is n / 2^(p + 1) + (row index >> (p + 1)), where the row
// index of a chunk one is chunk * 2^lc + local.  Ascending D, as the
// stages run; a template argument, so every trip count is constant.
template <int LE, int D>
__device__ __forceinline__ void inv_stages(uint32_t (&x)[1 << LE], int lo, int bot, int lc,
                                           int log_n, int chunk, int hi_part,
                                           const uint32_t* __restrict__ w_tab,
                                           const uint32_t* __restrict__ ws_tab, uint32_t q) {
  if constexpr (D < LE) {
    constexpr int E = 1 << LE;
    const int p = lo + D;
    if (p >= bot) {
      const int wbase = (1 << (log_n - p - 1)) + (chunk << (lc - p - 1)) + (hi_part >> (p + 1));
#pragma unroll
      for (int g = 0; g < (E >> (D + 1)); ++g) {
        const uint32_t w = __ldg(w_tab + wbase + g);
        const uint32_t ws = __ldg(ws_tab + wbase + g);
#pragma unroll
        for (int r = 0; r < (1 << D); ++r) {
          constexpr int half = 1 << D;
          const int c = (g << (D + 1)) | r;
          const uint32_t u = x[c];
          const uint32_t v = x[c + half];
          x[c] = u32::add_mod(u, v, q);
          x[c + half] = u32::shoup_mulmod(u32::sub_mod(u, v, q), w, ws, q);
        }
      }
    }
    inv_stages<LE, D + 1>(x, lo, bot, lc, log_n, chunk, hi_part, w_tab, ws_tab, q);
  }
}

// Grid: C * rows blocks in clusters of C = 2^LOGC, cluster r on row r,
// block c of it on the chunk [c n/C, (c + 1) n/C); blockDim = n / (C E)
// threads, each holding E = 2^LE values.
template <int LE, int LOGC>
__global__ void __launch_bounds__(inv_max_threads(LE, LOGC))
ntt_inv_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out,
               const uint32_t* __restrict__ ipsi, const uint32_t* __restrict__ ipsi_shoup,
               const uint32_t* __restrict__ qtab, const uint32_t* __restrict__ ninv,
               const uint32_t* __restrict__ ninv_shoup, int k, int log_n) {
  constexpr int E = 1 << LE;
  constexpr int C = 1 << LOGC;
  cg::cluster_group cluster = cg::this_cluster();
  const int lc = log_n - LOGC;                 // index bits of a chunk
  const int nc = 1 << lc;
  const int nt = nc >> LE;                     // = blockDim.x
  const int tid = threadIdx.x;
  const int chunk = (int)cluster.block_rank();
  const size_t row = blockIdx.x >> LOGC;
  const int limb = (int)(row % (size_t)k);
  const uint32_t q = __ldg(qtab + limb);
  const uint32_t* w_tab = ipsi + ((size_t)limb << log_n);
  const uint32_t* ws_tab = ipsi_shoup + ((size_t)limb << log_n);

  // the chunk's low words (< 2^31) into shared memory, coalesced: a
  // thread's first window is bits 0 .. LE - 1, E neighbouring values,
  // which a warp could only read from global memory 32 lines at a time
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(in + (row << log_n) + ((size_t)chunk << lc));
#pragma unroll
  for (int c = 0; c < E; ++c) {
    const int i = c * nt + tid;
    row_smem[padded(i)] = __ldg(src + 2 * i);
  }
  __syncthreads();

  uint32_t x[E];
  int lo = 0;
#pragma unroll
  for (int c = 0; c < E; ++c) x[c] = row_smem[padded(window_index<LE>(tid, lo, c))];
  inv_stages<LE, 0>(x, lo, 0, lc, log_n, chunk, (tid >> lo) << (lo + LE), w_tab, ws_tab, q);
  for (int bot = LE; bot < lc; bot = lo + LE) {
    __syncthreads();                           // every read done before the writes
#pragma unroll
    for (int c = 0; c < E; ++c) row_smem[padded(window_index<LE>(tid, lo, c))] = x[c];
    __syncthreads();
    lo = bot < lc - LE ? bot : lc - LE;        // the last window ends at bit lc
#pragma unroll
    for (int c = 0; c < E; ++c) x[c] = row_smem[padded(window_index<LE>(tid, lo, c))];
    inv_stages<LE, 0>(x, lo, bot, lc, log_n, chunk, (tid >> lo) << (lo + LE), w_tab, ws_tab,
                      q);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < E; ++c) row_smem[padded(window_index<LE>(tid, lo, c))] = x[c];
  cluster.sync();                              // every chunk's stages done and visible

  // The last LOGC stages pair the chunks: column j holds the values j +
  // m n/C, m = 0 .. C - 1, one in each block's shared memory.  Stage lc +
  // d pairs m with m + 2^d; its twiddle index is 2^(LOGC - d - 1) +
  // (m >> (d + 1)), the same for every column, so the round needs only
  // ipsi[1 .. C - 1].  The columns are spread over the cluster's threads,
  // neighbouring threads on neighbouring columns: the remote reads and
  // the int64 stores are both coalesced.
  uint32_t cw[C], cws[C];
#pragma unroll
  for (int m = 1; m < C; ++m) {
    cw[m] = __ldg(w_tab + m);
    cws[m] = __ldg(ws_tab + m);
  }
  const uint32_t* part[C];
#pragma unroll
  for (int m = 0; m < C; ++m) part[m] = cluster.map_shared_rank(row_smem, m);
  const uint32_t ni = __ldg(ninv + limb);
  const uint32_t nis = __ldg(ninv_shoup + limb);
  int64_t* dst = out + (row << log_n);
  for (int j = chunk * nt + tid; j < nc; j += C * nt) {
    uint32_t y[C];
#pragma unroll
    for (int m = 0; m < C; ++m) y[m] = part[m][padded(j)];
#pragma unroll
    for (int d = 0; d < LOGC; ++d) {
#pragma unroll
      for (int g = 0; g < (C >> (d + 1)); ++g) {
        const int wi = (C >> (d + 1)) + g;
#pragma unroll
        for (int r = 0; r < (1 << d); ++r) {
          const int m = (g << (d + 1)) | r;
          const uint32_t u = y[m];
          const uint32_t v = y[m + (1 << d)];
          y[m] = u32::add_mod(u, v, q);
          y[m + (1 << d)] = u32::shoup_mulmod(u32::sub_mod(u, v, q), cw[wi], cws[wi], q);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < C; ++m)
      dst[((size_t)m << lc) + j] = (int64_t)u32::shoup_mulmod(y[m], ni, nis, q);
  }
  cluster.sync();                              // no block leaves while its chunk is read
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

template <int LE, int LOGC>
int launch_inv(const void* in, void* out, const void* ipsi, const void* ipsi_shoup,
               const void* qtab, const void* ninv, const void* ninv_shoup, long long rows,
               int k, int log_n, cudaStream_t stream) {
  const int lc = log_n - LOGC;
  if (LE > lc || lc - LE > 10) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(padded((1 << lc) - 1) + 1) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_inv_kernel<LE, LOGC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << LOGC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows << LOGC));
  cfg.blockDim = dim3(1u << (lc - LE));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ntt_inv_kernel<LE, LOGC>, (const int64_t*)in, (int64_t*)out,
                           (const uint32_t*)ipsi, (const uint32_t*)ipsi_shoup,
                           (const uint32_t*)qtab, (const uint32_t*)ninv,
                           (const uint32_t*)ninv_shoup, k, log_n);
  if (err != cudaSuccess) return (int)err;
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
  if (log_n < 1 || log_n > 15) return (int)cudaErrorInvalidValue;
  // C = min(8, n / 2) blocks per row, E = min(16, n / C) values per thread
  cudaStream_t s = (cudaStream_t)stream;
  switch (log_n) {
    case 1: return launch_inv<1, 0>(in, out, ipsi, ipsi_shoup, qtab, ninv, ninv_shoup, rows, k, log_n, s);
    case 2: return launch_inv<1, 1>(in, out, ipsi, ipsi_shoup, qtab, ninv, ninv_shoup, rows, k, log_n, s);
    case 3: return launch_inv<1, 2>(in, out, ipsi, ipsi_shoup, qtab, ninv, ninv_shoup, rows, k, log_n, s);
    case 4: return launch_inv<1, 3>(in, out, ipsi, ipsi_shoup, qtab, ninv, ninv_shoup, rows, k, log_n, s);
    case 5: return launch_inv<2, 3>(in, out, ipsi, ipsi_shoup, qtab, ninv, ninv_shoup, rows, k, log_n, s);
    case 6: return launch_inv<3, 3>(in, out, ipsi, ipsi_shoup, qtab, ninv, ninv_shoup, rows, k, log_n, s);
    default:
      return launch_inv<kInvLogE, kInvLogC>(in, out, ipsi, ipsi_shoup, qtab, ninv, ninv_shoup,
                                            rows, k, log_n, s);
  }
}
