// Flash attention for the LM substrate's prefill: what
// repro/kernels/flash_attn/flash_attn.py `flash_attention` (`_attn_kernel`)
// computes, softmax(mask(softcap(q k^T * scale))) v per (batch, head) row,
// with query and key positions both starting at 0:
//
//   causal   key visible if q_pos >= k_pos
//   window   key visible if q_pos - k_pos < window (window > 0)
//   softcap  s <- c * tanh(s / c), applied before the mask (c > 0)
//
// The running max m, denominator l and accumulator are float32; masked
// lanes get p = 0 explicitly (a wholly masked tile has m = -1e30 and
// exp(s - m) = 1, so underflow cannot be relied on); a row with no visible
// key gives 0 (the l == 0 -> 1 guard).  Output in the input dtype.
//
// Layout: q (B, H, Sq, D), k and v (B, Hkv, Sk, D), o (B, H, Sq, D), each
// with unit stride in D and the (batch, head, seq) strides passed in, so
// the model's (B, S, H, D) activations go in and out without a copy.  GQA
// reads KV head h / (H / Hkv); the repeated KV is never materialised.
//
// Two kernels, chosen by the input type.
//
// bfloat16 (the serving path): both products on Hopper's warpgroup
// tensor-core instructions (wgmma, csrc/wgmma.cuh), bf16 in, float32
// accumulate.  One CTA = one warpgroup (4 warps) per (64-query tile,
// batch * head); each warp owns 16 query rows across the whole head dim.
//   * Q, K and V tiles stay bf16 in shared memory as 128-byte swizzled
//     atoms, the layout wgmma reads without bank conflicts, brought in by
//     cp.async (eight threads fill one atom row); K and V in a
//     double-buffered ring, tile j + 1 loading while tile j computes.
//     The head dim is zero-padded to a multiple of 64 (one atom).
//   * S = Q K^T: m64 x BN x 16 wgmmas with both operands read from shared
//     memory (K-major).  A product of two bf16 values is exact in
//     float32, so S equals the float32 dot product of the up-cast inputs
//     up to summation order.
//   * Scale, softcap, mask and the online softmax run on the accumulator
//     registers, in the log2 domain (ex2 on the SFU); the softcap's tanh
//     is 1 - 2 / (1 + e^2y) from ex2 and rcp, absolute error ~2^-22,
//     where tanh.approx (2^-11 relative) would move a logit by ~0.02 at
//     a cap of 50; a tile whose row maxima do not move skips the rescale
//     of O; row max and row sum are reduced over the 4 lanes of a quad;
//     m, l and O stay float32 in registers.  The mask is evaluated only
//     on the tiles that need it (diagonal, window edge, ragged end).
//   * O += P V: m64 x DP x 16 wgmmas with P as the A operand straight
//     from the S accumulators in registers (no shared-memory round trip)
//     and V read MN-major (transposed) from shared memory.  P is split
//     into bf16 P_hi + P_lo, two products into one accumulator: P rounded
//     once to bf16 (2^-9 relative) moves O by up to ~1e-3, enough to
//     flip the bf16 rounding of outputs above 4 by one ulp (2^-5), past
//     the 2e-2 tolerance; the split keeps P to ~2^-17.  l sums the same
//     hi + lo parts the numerator uses.
//   * Key tiles of 64 keys; past D = 128, 32 (16 with a softcap), the
//     largest that fit 255 registers without a spill.  Query tiles are
//     launched heaviest first (grid.y reversed), and neighbouring blocks
//     are neighbouring heads, so GQA heads sharing a KV head run together
//     and share its tiles in L2.
// Bound: operations, 4 D FLOPs per visible pair (6 D with the split) at
// the bf16 tensor-core rate; with a softcap the per-pair tanh and exp add
// a floor on the special-function units.  Each wgmma group is waited for
// before the softmax that reads it; the overlap of one tile's softmax
// with the next tile's products comes only from the second CTA on the SM.
//
// float32: the CUDA-core kernel (its 1e-4 tolerance rules out TF32 or
// bf16 products).  One CTA of 256 threads per (64-query tile, batch *
// head).  The Q tile stays in shared memory; a loop over 64-key tiles
// takes the place of the Pallas kernel's sequential kv grid axis: stage
// K in shared memory, S = Q K^T (each thread a 4 x 4 block of S: rows
// 4 ty .. 4 ty + 3, keys tx + 16 j), online-softmax update with the row
// statistics reduced over the 16 threads of a row by warp shuffles, P to
// shared memory, stage V over K, acc += P V (each thread its 4 rows x
// D/16 columns tx + 16 c).  Tiles are held as float32, zero-padded past
// Sq, Sk and D (rows padded to D + 1 floats, so the 16 threads reading
// 16 key rows hit 16 banks).  Products are float32 FMAs, two
// shared-memory loads per FMA pair.
//
// Both kernels keep m, l and the accumulator in registers across the key
// loop, and never visit key tiles that the causal or window mask hides
// whole: such a tile gives p = 0 and alpha = 1, so skipping it is exact.
//
// Plain C interface for ctypes: the entry takes raw device pointers, the
// strides as a host array and the stream, launches, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include "wgmma.cuh"

namespace {

constexpr int kBM = 64;           // query rows per CTA
constexpr int kBN = 64;           // keys per tile
constexpr int kTX = 16;           // threads along keys / head dim
constexpr int kTY = 16;           // threads along query rows
constexpr int kThreads = kTX * kTY;
constexpr int kRM = kBM / kTY;    // query rows per thread
constexpr int kRN = kBN / kTX;    // keys per thread
constexpr int kLDP = kBN + 1;     // row stride of the P tile
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs[3], ks[3], vs[3], os[3];   // (batch, head, seq) strides
  int H, Hkv, Sq, Sk, D;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// rows r0 .. r0 + 63 of a (rows, D) slab with row stride `ss` into a
// [kBM][DPAD + 1] float tile, zero past `rows` and past D
template <typename T, int DPAD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss,
                                          int r0, int rows, int D) {
  constexpr int LD = DPAD + 1;
  for (int idx = threadIdx.x; idx < kBM * DPAD; idx += kThreads) {
    const int r = idx / DPAD, c = idx % DPAD;
    const int gr = r0 + r;
    float x = 0.f;
    if (gr < rows && c < D) x = to_f32(src[(long long)gr * ss + c]);
    dst[r * LD + c] = x;
  }
}

// reduce over the 16 lanes of a half-warp (the threads of one query row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DPAD>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const Args a) {
  constexpr int LD = DPAD + 1;
  constexpr int DC = DPAD / kTX;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // [kBM][LD]
  float* KVs = Qs + kBM * LD;      // [kBN][LD], K then V
  float* Ps = KVs + kBN * LD;      // [kBM][kLDP]

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int q0 = blockIdx.x * kBM;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int hk = h / (a.H / a.Hkv);
  const T* q = (const T*)a.q + b * a.qs[0] + h * a.qs[1];
  const T* k = (const T*)a.k + b * a.ks[0] + hk * a.ks[1];
  const T* v = (const T*)a.v + b * a.vs[0] + hk * a.vs[1];
  T* o = (T*)a.o + b * a.os[0] + h * a.os[1];

  load_tile<T, DPAD>(Qs, q, a.qs[2], q0, a.Sq, a.D);

  float m[kRM], l[kRM], acc[kRM][DC];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // key tiles that can hold a visible key for some row of this tile
  const int q_last = min(q0 + kBM, a.Sq) - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1) / kBN * kBN;

  for (int k0 = k_begin; k0 < k_end; k0 += kBN) {
    __syncthreads();               // the previous tile's P V is done with KVs and Ps
    load_tile<T, DPAD>(KVs, k, a.ks[2], k0, a.Sk, a.D);
    __syncthreads();

    float s[kRM][kRN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DPAD; ++d) {
      float qv[kRM], kv[kRN];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qv[i] = Qs[(ty * kRM + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kRN; ++j) kv[j] = KVs[(tx + kTX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int qp = q0 + ty * kRM + i;
      bool ok[kRN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const int kp = k0 + tx + kTX * j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        ok[j] = kp < a.Sk && (!a.causal || qp >= kp) && (a.window <= 0 || qp - kp < a.window);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * kRM + i) * kLDP + tx + kTX * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();               // S is done with K; P is in shared memory
    load_tile<T, DPAD>(KVs, v, a.vs[2], k0, a.Sk, a.D);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBN; ++kk) {
      float pv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) pv[i] = Ps[(ty * kRM + i) * kLDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = KVs[kk * LD + tx + kTX * c];
#pragma unroll
        for (int i = 0; i < kRM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int r = q0 + ty * kRM + i;
    if (r >= a.Sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + kTX * c;
      if (col < a.D) store(o + (long long)r * a.os[2] + col, acc[i][c] / denom);
    }
  }
}

template <int DPAD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(kBM * (DPAD + 1) + kBN * (DPAD + 1) + kBM * kLDP);
}

template <typename T, int DPAD>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DPAD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<T, DPAD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.Sq + kBM - 1) / kBM), (unsigned)(B * a.H));
  flash_attn_kernel<T, DPAD><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 32) return launch<T, 32>(a, B, stream);
  if (a.D <= 64) return launch<T, 64>(a, B, stream);
  if (a.D <= 128) return launch<T, 128>(a, B, stream);
  if (a.D <= 256) return launch<T, 256>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------- bfloat16: tensor cores
namespace tc {

constexpr int kThreads = 128;               // one warpgroup
constexpr int kBM = 64;                     // query rows per CTA: one wgmma M
constexpr float kLog2e = 1.4426950408889634f;

// shapes of one instantiation (DP = D rounded up to a multiple of 64, one
// swizzle atom's width).  A tile of R rows is stored as 128-byte swizzled
// atoms: columns 64 cb .. 64 cb + 63 at cb * R * 128 bytes, row r at
// r * 128, its 16-byte chunk cc at (cc ^ (r % 8)) * 16.
template <int DP, bool CAPPED>
struct Cfg {
  // keys per tile: fewer past D = 128, where O alone takes DP / 2
  // registers a thread; 16 with a softcap there, whose tanh needs more
  // (the largest tiles ptxas fits in 255 registers without a spill)
  static constexpr int BN = DP <= 128 ? 64 : CAPPED ? 16 : 32;
  static constexpr int Q_BYTES = kBM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;          // one K or V tile
  // Q, two stages of (K, V), and room to align the base to 1024 bytes
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies have landed, and are visible to the tensor cores'
// (async proxy) reads once the CTA passes a barrier
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\nfence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x and 1/x on the special-function unit (relative error ~2^-22;
// 2^-1e30 = 0, 1/inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (p0, p1) as bf16 pairs hi + lo, packed as A-fragment registers (p0 in
// the low half); returns the float sum of the four rounded parts
__device__ __forceinline__ float split_bf16x2(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(p0, p1);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  const float h0 = __uint_as_float(hi << 16), h1 = __uint_as_float(hi & 0xffff0000u);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(p0 - h0, p1 - h1);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
  const float l0 = __uint_as_float(lo << 16), l1 = __uint_as_float(lo & 0xffff0000u);
  return (h0 + l0) + (h1 + l1);
}

// rows r0 .. r0 + ROWS - 1 of a (rows, D) bf16 slab with row stride `ss`
// into the swizzled layout at shared address `dst` by cp.async; zero past
// `rows` and D (D is a multiple of 8, so each chunk is all in or all out).
// Eight consecutive threads fill one 128-byte atom row.
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, long long ss,
                                          int r0, int rows, int D) {
  constexpr int CPR = DP / 8;                       // 16-byte chunks per row
  constexpr int CHUNKS = ROWS * CPR;
  static_assert(CHUNKS % kThreads == 0, "tile chunks must split evenly");
#pragma unroll
  for (int it = 0; it < CHUNKS / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int r = idx / CPR, c = idx % CPR;
    const int gr = r0 + r;
    const bool ok = gr < rows && c * 8 < D;
    const __nv_bfloat16* g = ok ? src + (long long)gr * ss + c * 8 : src;
    cp_async16(dst + (c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4), g, ok);
  }
}

template <int DP, bool CAPPED>
__global__ void __launch_bounds__(kThreads)
flash_attn_tc_kernel(const Args a) {
  using C = Cfg<DP, CAPPED>;
  constexpr int BN = C::BN;
  constexpr int KSTEPS = DP / 16;     // k-steps of Q K^T over the head dim
  constexpr int NB_S = BN / 8;        // 8-key blocks of S
  constexpr int NB_O = DP / 8;        // 8-column blocks of O
  constexpr int PSTEPS = BN / 16;     // k-steps of P V over the keys
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_sm = (smem_addr(smem_raw) + 1023) & ~1023u;   // atoms 1024-aligned
  const uint32_t ring = q_sm + C::Q_BYTES;    // stage s: K at ring + 2 s KV_BYTES, V after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;            // fragment row group, lane in quad
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest query tiles first
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int hk = h / (a.H / a.Hkv);
  const __nv_bfloat16* q = (const __nv_bfloat16*)a.q + b * a.qs[0] + h * a.qs[1];
  const __nv_bfloat16* k = (const __nv_bfloat16*)a.k + b * a.ks[0] + hk * a.ks[1];
  const __nv_bfloat16* v = (const __nv_bfloat16*)a.v + b * a.vs[0] + hk * a.vs[1];
  __nv_bfloat16* o = (__nv_bfloat16*)a.o + b * a.os[0] + h * a.os[1];

  // key tiles that can hold a visible key for some row of this tile
  const int q_last = min(q0 + kBM, a.Sq) - 1;
  int k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1) / BN * BN;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

  load_rows<DP, kBM>(q_sm, q, a.qs[2], q0, a.Sq, a.D);
  if (n_tiles > 0) {
    load_rows<DP, BN>(ring, k, a.ks[2], k_begin, a.Sk, a.D);
    load_rows<DP, BN>(ring + C::KV_BYTES, v, a.vs[2], k_begin, a.Sk, a.D);
  }
  cp_async_commit();

  float acc[DP / 2], s[BN / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // logits in the log2 domain: x * scale * log2e, or with a softcap c
  // c * log2e * tanh(x * scale / c), tanh(y) = 1 - 2 / (1 + 2^(2 log2e y))
  // from ex2 and rcp: absolute error ~2^-22, a logit moves by ~1e-5 at
  // c = 50 (tanh.approx's 2^-11 relative would move it by ~0.02)
  const float pre = CAPPED ? 2.f * kLog2e * a.scale / a.softcap : a.scale * kLog2e;
  const float post = CAPPED ? a.softcap * kLog2e : 1.f;
  const int row0 = q0 + warp * 16 + g;              // this thread's rows: row0, row0 + 8

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BN;
    cp_async_wait_all();              // tile t (and Q) are in ...
    __syncthreads();                  // ... for every thread; tile t - 1 is done with
    if (t + 1 < n_tiles) {            // tile t + 1 into the stage tile t - 1 used
      const uint32_t nxt = ring + ((t + 1) & 1) * 2 * C::KV_BYTES;
      load_rows<DP, BN>(nxt, k, a.ks[2], k0 + BN, a.Sk, a.D);
      load_rows<DP, BN>(nxt + C::KV_BYTES, v, a.vs[2], k0 + BN, a.Sk, a.D);
      cp_async_commit();
    }
    const uint32_t k_sm = ring + (t & 1) * 2 * C::KV_BYTES, v_sm = k_sm + C::KV_BYTES;

    // S = Q K^T: Q and K both K-major; k-step kk is 32 bytes into atom
    // column kk / 4
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma::Mma<BN>::ss(s, wgmma::desc_sw128(q_sm + (kk >> 2) * kBM * 128 + (kk & 3) * 32, 16, 1024),
                         wgmma::desc_sw128(k_sm + (kk >> 2) * BN * 128 + (kk & 3) * 32, 16, 1024),
                         kk > 0);
    wgmma::commit();
    wgmma::wait_all();

    // scale, softcap, mask; s[4j + i] is row row0 + 8 (i >> 1), key
    // k0 + 8j + 2 tig + (i & 1)
    const bool need_mask = k0 + BN > a.Sk || (a.causal && k0 + BN - 1 > q0) ||
                           (a.window > 0 && q_last - k0 >= a.window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NB_S; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[4 * j + i] * pre;
        if constexpr (CAPPED) x = fmaf(-2.f * post, fast_rcp(1.f + fast_exp2(x)), post);
        if (need_mask) {
          const int qp = row0 + 8 * (i >> 1);
          const int kp = k0 + 8 * j + 2 * tig + (i & 1);
          const bool ok = kp < a.Sk && (!a.causal || qp >= kp) &&
                          (a.window <= 0 || qp - kp < a.window);
          if (!ok) x = kNegInf;
        }
        s[4 * j + i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
      // a row with no visible key so far: every logit is kNegInf, and
      // 2^(kNegInf - 0) = 0 gives the masked keys p = 0
      m_use[r] = m_new == kNegInf ? 0.f : m_new;
    }
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
      for (int j = 0; j < NB_O; ++j) {
        acc[4 * j] *= alpha[0]; acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1]; acc[4 * j + 3] *= alpha[1];
      }
    }

    // P = P_hi + P_lo straight from the S accumulators into A fragments:
    // register i of k-step kk holds rows (i & 1) ? g + 8 : g, keys 16 kk +
    // (i >> 1) * 8 + 2 tig + {0, 1}, i.e. S block 2 kk + (i >> 1)
    uint32_t ph[PSTEPS][4], pl[PSTEPS][4];
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kk + (i >> 1), r = i & 1;
        l[r] += split_bf16x2(fast_exp2(s[4 * j + 2 * r] - m_use[r]),
                             fast_exp2(s[4 * j + 2 * r + 1] - m_use[r]), ph[kk][i], pl[kk][i]);
      }
    }
    // O += P_hi V + P_lo V: V is MN-major (head dim contiguous); keys
    // 16 kk .. 16 kk + 15 are rows 16 kk .. of every atom column, which
    // lie BN * 128 bytes apart
    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < PSTEPS; ++kk) {
      const uint64_t dv = wgmma::desc_sw128(v_sm + kk * 16 * 128, BN * 128, 1024);
      wgmma::Mma<DP>::rs(acc, ph[kk], dv, 1);
      wgmma::Mma<DP>::rs(acc, pl[kk], dv, 1);
    }
    wgmma::commit();
    wgmma::wait_all();
  }
  cp_async_wait_all();                // no copy outlives the CTA (n_tiles = 0)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= a.Sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = o + (long long)row * a.os[2];
#pragma unroll
    for (int j = 0; j < NB_O; ++j) {
      const int col = 8 * j + 2 * tig;
      if (col < a.D) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom,
                                                          acc[4 * j + 2 * r + 1] / denom);
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = pair;
      }
    }
  }
}

template <int DP, bool CAPPED>
int launch_capped(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = Cfg<DP, CAPPED>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_tc_kernel<DP, CAPPED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * a.H), (unsigned)((a.Sq + kBM - 1) / kBM));
  flash_attn_tc_kernel<DP, CAPPED><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DP>
int launch(const Args& a, int B, cudaStream_t stream) {
  return a.softcap > 0.f ? launch_capped<DP, true>(a, B, stream)
                         : launch_capped<DP, false>(a, B, stream);
}

int dispatch(const Args& a, int B, cudaStream_t stream) {
  if (a.D <= 64) return launch<64>(a, B, stream);
  if (a.D <= 128) return launch<128>(a, B, stream);
  if (a.D <= 192) return launch<192>(a, B, stream);
  if (a.D <= 256) return launch<256>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// strides: 12 host int64s, (batch, head, seq) for q, k, v, o in elements.
// dtype 0 = float32, 1 = bfloat16.  window <= 0 and softcap <= 0 disable them.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                                 const long long* strides, int B, int H, int Hkv,
                                 int Sq, int Sk, int D, int causal, int window,
                                 float softcap, float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Sq < 1 || Sk < 0 || D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.H = H; a.Hkv = Hkv; a.Sq = Sq; a.Sk = Sk; a.D = D;
  a.causal = causal; a.window = window;
  a.softcap = softcap; a.scale = scale;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(a, B, s);
  if (dtype == 1) {
    if (D % 8 || (long long)B * H >= (1LL << 31) || (Sq + tc::kBM - 1) / tc::kBM > 65535)
      return (int)cudaErrorInvalidValue;
    return tc::dispatch(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
