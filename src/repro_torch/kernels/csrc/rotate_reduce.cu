// Rotate-and-add reduction over rows of slot values mod a per-row t.  It
// replaces the TPU's `rotate_reduce_pallas` (`_kernel`,
// repro/kernels/rotate_reduce/rotate_reduce.py), which runs log2(c)
// doubling stages x <- (x + roll(x, -2^s)) mod t on a VMEM-resident row.
// Those stages have one closed form: slot i ends with the wrapped window
// sum x[i] + ... + x[i + c - 1] mod t_row, and full mode is c = n, every
// slot the row total.  So this kernel computes the window sums in one
// pass from the row's prefix sums S (S[0] = 0, S[j] = x[0] + ... +
// x[j - 1] mod t):
//
//   out[i] = S[i + c] - S[i]                  mod t   (i + c <= n)
//   out[i] = S[n] - S[i] + S[i + c - n]       mod t   (the window wraps)
//
// Values are below t < 2^31, so every sum is kept in 32 bits: two of them
// add below 2^32 and one conditional subtract reduces each add.  Rows
// are int32 (the reference's width) or int64, read and written in their
// own type; the moduli are a (rows, 1) int32 or int64 table, or one t for
// every row.
//
// Bound on the card: bytes.  Each value is read once and written once,
// with a few integer operations between, no doubling stages.  At the
// shape `MockBackend.sum_slots` gives it, (2, 16384), the bytes take
// 0.08 us and the bound is one launch.  So the design is there to fill
// the card at few rows and to cost one launch at any:
//
//   * a row is split over a thread-block cluster of C blocks (C <= 8, the
//     portable maximum; the wrapper picks C from rows and n: C > 1 when
//     the rows alone would leave SMs idle).  Block c takes the slots
//     [c n/C, (c + 1) n/C) of the row.
//   * full mode: each block sums its slice in 64-bit registers (16-byte
//     loads, coalesced), reduces it mod t over the block, and after one
//     cluster.sync() reads the other blocks' sums through distributed
//     shared memory (map_shared_rank); a second cluster.sync() keeps
//     every block resident while its sum is read, then each block writes
//     the row total to its slice.  It keeps no row in shared memory and
//     takes any power-of-two n.
//   * chunk mode: each block copies its slice into shared memory
//     (16-byte loads, coalesced; 4 bytes a slot), then scans it there:
//     each thread sums a run of E consecutive slots, the warp's threads
//     by shuffles, the block's warps by one warp, and each thread writes
//     its run's prefix sums back in place (without the offsets of the
//     blocks before it).  Two short passes over shared memory in place of
//     E values a thread in registers keep three 512-thread blocks on an
//     SM at 16384 slots.  After cluster.sync() the block takes every
//     block's offset from their sums, and reads S[i] and S[i + c] from
//     whichever block holds them: four slots a thread, 16-byte reads of
//     shared memory and 16-byte stores, the one value a window needs
//     beyond its thread's group from the neighbour lane.  A second
//     cluster.sync() keeps the blocks resident while they are read.  A
//     slice holds at most 32768 slots (128 KiB), so chunk mode takes n up
//     to 8 x 32768 = 262144.
//
// Plain C interface for ctypes: the entry takes raw device pointers and
// the stream, launches, and returns the CUDA error code.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>
#include "u32.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLogC = 3;          // at most 8 blocks a row, the portable cluster size
constexpr int kMaxLogSlice = 15;     // chunk mode: a block's slice of S, 32768 words at most
constexpr int kFullThreads = 256;

extern __shared__ uint32_t slice_pre[];

// Where slot j of a slice sits in shared memory: in row j / 32 (32
// words), its 4-word group XORed by the row.  Groups stay whole, so
// 16-byte accesses stay aligned, and the accesses of a quarter warp, 8
// threads a group each (the coalesced fill, a thread's run of E >= 4
// slots) or 32 consecutive slots (the windows), fall on distinct banks
__device__ __forceinline__ int swizzled(int j) { return j ^ (((j >> 5) & 7) << 2); }

// t of one row: the table's entry, or `t` for every row when there is
// no table; the table holds int64 (`t_wide`) or int32 moduli
__device__ __forceinline__ uint32_t row_modulus(const void* t_tab, long long t_stride,
                                                int t_wide, uint32_t t, size_t row) {
  if (t_tab == nullptr) return t;
  const long long at = (long long)row * t_stride;
  return t_wide ? (uint32_t)((const long long*)t_tab)[at] : (uint32_t)((const int*)t_tab)[at];
}

// The values of one 16-byte word of rows of Elem: four int32 or two int64
// (their low words: values are below 2^31)
template <typename Elem>
__device__ __forceinline__ unsigned long long word_sum(uint4 w) {
  if constexpr (sizeof(Elem) == 4) {
    return (unsigned long long)w.x + w.y + w.z + w.w;
  } else {
    return (unsigned long long)w.x + w.z;
  }
}

template <typename Elem>
__device__ __forceinline__ uint4 word_of(uint32_t v) {
  if constexpr (sizeof(Elem) == 4) {
    return make_uint4(v, v, v, v);
  } else {
    return make_uint4(v, 0u, v, 0u);
  }
}

__device__ __forceinline__ uint32_t warp_sum_mod(uint32_t v, uint32_t t) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = u32::add_mod(v, __shfl_xor_sync(0xffffffffu, v, d), t);
  return v;
}

__device__ __forceinline__ uint32_t warp_scan_mod(uint32_t v, uint32_t t, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = u32::add_mod(v, y, t);
  }
  return v;
}

// Full mode.  Grid: rows x C blocks in clusters of C = 2^log_c, cluster r
// on row r; kFullThreads threads.  `vec`: both pointers 16-byte aligned.
template <typename Elem>
__global__ void __launch_bounds__(kFullThreads)
rr_full_kernel(const Elem* __restrict__ in, Elem* __restrict__ out, const void* t_tab,
               long long t_stride, int t_wide, uint32_t t_all, int log_n, int log_c,
               int vec) {
  constexpr int V = 16 / sizeof(Elem);
  __shared__ uint32_t warp_part[kFullThreads / 32];
  __shared__ uint32_t block_sum, row_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int lc = log_n - log_c;
  const size_t len = (size_t)1 << lc;
  const size_t row = blockIdx.x >> log_c;
  const size_t first = (row << log_n) + ((size_t)cluster.block_rank() << lc);
  const uint32_t t = row_modulus(t_tab, t_stride, t_wide, t_all, row);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool words = vec && len >= V;

  unsigned long long acc = 0;                  // < len 2^31: no overflow
  if (words) {
    const uint4* src = reinterpret_cast<const uint4*>(in + first);
#pragma unroll 4
    for (size_t k = tid; k < len / V; k += kFullThreads) acc += word_sum<Elem>(src[k]);
  } else {
    for (size_t k = tid; k < len; k += kFullThreads) acc += (uint32_t)in[first + k];
  }
  uint32_t s = warp_sum_mod((uint32_t)(acc % t), t);
  if (lane == 0) warp_part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = warp_sum_mod(lane < kFullThreads / 32 ? warp_part[lane] : 0u, t);
    if (lane == 0) block_sum = s;
  }
  cluster.sync();                              // every block's sum written and visible
  if (warp == 0) {
    const uint32_t b = lane < (1 << log_c) ? *cluster.map_shared_rank(&block_sum, lane) : 0u;
    s = warp_sum_mod(b, t);
    if (lane == 0) row_total = s;
  }
  cluster.sync();                              // the sums are read; row_total is visible
  const uint32_t total = row_total;
  if (words) {
    const uint4 w = word_of<Elem>(total);
    uint4* dst = reinterpret_cast<uint4*>(out + first);
#pragma unroll 4
    for (size_t k = tid; k < len / V; k += kFullThreads) dst[k] = w;
  } else {
    for (size_t k = tid; k < len; k += kFullThreads) out[first + k] = (Elem)total;
  }
}

// Chunk mode: windows of c = 2^log_w slots.  Grid as full mode's;
// blockDim a power of two from 32 to 1024, thread k on the E slots
// [k E, (k + 1) E) of its block's slice (E = 1 where the slice is
// narrower than the block); dynamic shared memory: the slice, 4 bytes a
// slot, which the block turns into its prefix sums.
template <typename Elem>
__global__ void __launch_bounds__(1024)
rr_chunk_kernel(const Elem* __restrict__ in, Elem* __restrict__ out, const void* t_tab,
                long long t_stride, int t_wide, uint32_t t_all, int log_n, int log_c,
                int log_w, int vec) {
  constexpr int V = 16 / sizeof(Elem);
  __shared__ uint32_t warp_part[32];
  __shared__ uint32_t block_sum;
  __shared__ uint32_t lead_of[(1 << kMaxLogC) + 1];  // blocks' offsets, then the row total
  cg::cluster_group cluster = cg::this_cluster();
  const int lc = log_n - log_c;
  const int len = 1 << lc;
  const size_t row = blockIdx.x >> log_c;
  const unsigned rank = cluster.block_rank();
  const size_t first = (size_t)rank << lc;     // the slice's first slot in the row
  const Elem* src = in + (row << log_n) + first;
  Elem* dst = out + (row << log_n) + first;
  const uint32_t t = row_modulus(t_tab, t_stride, t_wide, t_all, row);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = len > (int)blockDim.x ? len / (int)blockDim.x : 1;
  const int base = tid * E;
  const int run_len = base < len ? E : 0;

  // the slice into shared memory, coalesced: 16 bytes a load, neighbouring
  // threads on neighbouring words
  if (vec && len >= V) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll 4
    for (int k = tid; k < len / V; k += blockDim.x) {
      const uint4 w = s4[k];
      if constexpr (V == 4) {
        *reinterpret_cast<uint4*>(slice_pre + swizzled(4 * k)) = w;
      } else {
        *reinterpret_cast<uint2*>(slice_pre + swizzled(2 * k)) = make_uint2(w.x, w.z);
      }
    }
  } else {
    for (int k = tid; k < len; k += blockDim.x) slice_pre[swizzled(k)] = (uint32_t)src[k];
  }
  __syncthreads();

  // the thread's sum over its run; then the sums of the slots before it in
  // the block: its warp's lower lanes and the lower warps
  uint32_t own = 0;
  if (E >= 4) {                                // 16 bytes a read
    for (int j = 0; j < E; j += 4) {
      const uint4 w = *reinterpret_cast<const uint4*>(slice_pre + swizzled(base + j));
      own = u32::add_mod(own, u32::add_mod(u32::add_mod(w.x, w.y, t),
                                           u32::add_mod(w.z, w.w, t), t), t);
    }
  } else {
    for (int j = 0; j < run_len; ++j) own = u32::add_mod(own, slice_pre[swizzled(base + j)], t);
  }
  const uint32_t inc = warp_scan_mod(own, t, lane);
  if (lane == 31) warp_part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    const uint32_t w = warp_scan_mod(lane < warps ? warp_part[lane] : 0u, t, lane);
    if (lane < warps) warp_part[lane] = w;
    if (lane == warps - 1) block_sum = w;
  }
  __syncthreads();
  // the run's prefix sums in place (a thread reads and writes its own run only)
  uint32_t run = u32::sub_mod(inc, own, t);
  if (warp > 0) run = u32::add_mod(run, warp_part[warp - 1], t);
  if (E >= 4) {
    for (int j = 0; j < E; j += 4) {
      uint4* at = reinterpret_cast<uint4*>(slice_pre + swizzled(base + j));
      uint4 w = *at;
      w.x = run = u32::add_mod(run, w.x, t);
      w.y = run = u32::add_mod(run, w.y, t);
      w.z = run = u32::add_mod(run, w.z, t);
      w.w = run = u32::add_mod(run, w.w, t);
      *at = w;
    }
  } else {
    for (int j = 0; j < run_len; ++j) {
      uint32_t* at = slice_pre + swizzled(base + j);
      *at = run = u32::add_mod(run, *at, t);
    }
  }
  cluster.sync();                              // every slice's sums written and visible

  // each block's offset (the sums of the blocks before it) and the row total
  if (warp == 0) {
    const int blocks = 1 << log_c;
    const uint32_t b = lane < blocks ? *cluster.map_shared_rank(&block_sum, lane) : 0u;
    const uint32_t w = warp_scan_mod(b, t, lane);
    if (lane < blocks) lead_of[lane] = u32::sub_mod(w, b, t);
    if (lane == blocks - 1) lead_of[1 << kMaxLogC] = w;
  }
  __syncthreads();
  const uint32_t total = lead_of[1 << kMaxLogC];

  // The windows: out[i] = P(i + c - 1) - P(i - 1) mod t, where P(j) is
  // S[j + 1], the sum of slots 0 .. j, read from the block that holds
  // slot j, P(-1) = 0, and past the row P(n + j) = P(j) + the row total.
  // `group` reads P(j .. j + 3) for j a multiple of 4.
  const int n = 1 << log_n;
  const int c = 1 << log_w;
  const int i_first = rank << lc;
  auto offset = [&](int j, int& at) -> uint32_t {  // j in [0, 2n): block offset (+ total)
    const int jj = j < n ? j : j - n;
    const unsigned b = (unsigned)(jj >> lc);
    at = jj & (len - 1);
    const uint32_t off = lead_of[b];
    return j < n ? off : u32::add_mod(off, total, t);
  };
  auto part_of = [&](int j) -> const uint32_t* {
    const unsigned b = (unsigned)((j < n ? j : j - n) >> lc);
    return b == rank ? slice_pre : cluster.map_shared_rank(slice_pre, b);
  };
  auto prefix = [&](int j) -> uint32_t {
    if (j < 0) return 0u;
    int at;
    const uint32_t off = offset(j, at);
    return u32::add_mod(part_of(j)[swizzled(at)], off, t);
  };
  auto group = [&](int j) -> uint4 {
    int at;
    const uint32_t off = offset(j, at);
    const uint4 w = *reinterpret_cast<const uint4*>(part_of(j) + swizzled(at));
    return make_uint4(u32::add_mod(w.x, off, t), u32::add_mod(w.y, off, t),
                      u32::add_mod(w.z, off, t), u32::add_mod(w.w, off, t));
  };
  if (vec && len >= 128) {
    // four slots a thread, neighbouring threads on neighbouring groups (16-
    // byte stores); a thread's P(i - 1) and, for c = 2, P(i + 4) come from
    // its neighbour lanes, and every lane of a warp has a group: len / 4 is
    // a multiple of 32
    for (int k = tid; k < len / 4; k += blockDim.x) {
      const int i = i_first + 4 * k;
      const uint4 lo = group(i);                            // P(i .. i + 3)
      uint32_t before = __shfl_up_sync(0xffffffffu, lo.w, 1);
      if (lane == 0) before = prefix(i - 1);
      uint4 hi;                                             // P(i + c - 1 .. i + c + 2)
      if (c == 1) {
        hi = lo;
      } else if (c == 2) {
        uint32_t next = __shfl_down_sync(0xffffffffu, lo.x, 1);
        if (lane == 31) next = prefix(i + 4);
        hi = make_uint4(lo.y, lo.z, lo.w, next);
      } else {
        const uint4 g = group(i + c);
        uint32_t last = __shfl_up_sync(0xffffffffu, g.w, 1);
        if (lane == 0) last = prefix(i + c - 1);
        hi = make_uint4(last, g.x, g.y, g.z);
      }
      const uint4 r = make_uint4(u32::sub_mod(hi.x, before, t), u32::sub_mod(hi.y, lo.x, t),
                                 u32::sub_mod(hi.z, lo.y, t), u32::sub_mod(hi.w, lo.z, t));
      if constexpr (V == 4) {
        reinterpret_cast<uint4*>(dst)[k] = r;
      } else {
        reinterpret_cast<uint4*>(dst)[2 * k] = make_uint4(r.x, 0u, r.y, 0u);
        reinterpret_cast<uint4*>(dst)[2 * k + 1] = make_uint4(r.z, 0u, r.w, 0u);
      }
    }
  } else {
    for (int k = tid; k < len; k += blockDim.x) {
      const int i = i_first + k;
      dst[k] = (Elem)u32::sub_mod(prefix(i + c - 1), prefix(i - 1), t);
    }
  }
  cluster.sync();                              // no block leaves while its slice is read
}

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, long long rows, int log_c, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log_c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows << log_c));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename Elem>
int launch(const void* in_, void* out_, long long rows, int log_n, int log_c, int log_w,
           const void* t_tab, long long t_stride, int t_wide, uint32_t t,
           cudaStream_t stream) {
  const Elem* in = (const Elem*)in_;
  Elem* out = (Elem*)out_;
  const int vec = (((uintptr_t)in_ | (uintptr_t)out_) & 15) == 0;
  if (log_w == log_n)
    return launch_cluster(rr_full_kernel<Elem>, rows, log_c, kFullThreads, 0, stream, in,
                          out, t_tab, t_stride, t_wide, t, log_n, log_c, vec);
  // threads: the slice up to 256 slots, 256 up to 8192 slots (E <= 32),
  // then 32 slots a thread
  const int lc = log_n - log_c;
  const int log_e = lc < 8 ? 0 : (lc - 8 > 5 ? 5 : lc - 8);
  const int threads = lc - log_e < 5 ? 32 : 1 << (lc - log_e);
  return launch_cluster(rr_chunk_kernel<Elem>, rows, log_c, threads,
                        (size_t)sizeof(uint32_t) << lc, stream, in, out, t_tab, t_stride,
                        t_wide, t, log_n, log_c, log_w, vec);
}

}  // namespace

// x, out: (rows, 2^log_n) int32 (elem_bytes 4) or int64 (8); windows of
// 2^log_w slots (log_w == log_n: full mode); 2^log_c blocks a row.  The
// moduli: t_tab[row * t_stride], int64 when t_wide else int32, or t for
// every row when t_tab is null.
extern "C" int rotate_reduce_launch(const void* in, void* out, long long rows, int log_n,
                                    int log_w, int log_c, int elem_bytes, const void* t_tab,
                                    long long t_stride, int t_wide, long long t,
                                    void* stream) {
  if (log_c < 0 || log_c > kMaxLogC || log_c > log_n || log_w < 0 || log_w > log_n ||
      (log_w < log_n && log_n - log_c > kMaxLogSlice) ||
      rows <= 0 || (rows << log_c) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4)
    return launch<int32_t>(in, out, rows, log_n, log_c, log_w, t_tab, t_stride, t_wide,
                           (uint32_t)t, s);
  if (elem_bytes == 8)
    return launch<int64_t>(in, out, rows, log_n, log_c, log_w, t_tab, t_stride, t_wide,
                           (uint32_t)t, s);
  return (int)cudaErrorInvalidValue;
}
