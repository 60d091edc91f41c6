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
// Design.  One CTA of 256 threads per (64-query tile, batch * head).  The
// Q tile stays in shared memory; a loop over 64-key tiles takes the place
// of the Pallas kernel's sequential kv grid axis: stage K in shared
// memory, S = Q K^T (each thread a 4 x 4 block of S: rows 4 ty .. 4 ty + 3,
// keys tx + 16 j), online-softmax update with the row statistics reduced
// over the 16 threads of a row by warp shuffles, P to shared memory, stage
// V over K, acc += P V (each thread its 4 rows x D/16 columns tx + 16 c).
// m, l and acc stay in registers across the loop.  Key tiles that the
// causal or window mask hides whole are never visited: such a tile gives
// p = 0 and alpha = 1, so skipping it is exact.  Tiles are held as float32
// whatever the input type, zero-padded past Sq, Sk and D (rows padded to
// D + 1 floats, so the 16 threads reading 16 key rows hit 16 banks).
//
// Bound on the card: operations, 4 D FLOPs per visible pair; bytes are
// q, k, v and o once.  Both products run as float32 FMAs on the CUDA
// cores (67 TFLOP/s peak, a fifteenth of the bf16 tensor-core rate), two
// shared-memory loads per FMA pair; wgmma, TMA and warp specialisation
// are the later work that moves it toward the tensor-core bound.
//
// Plain C interface for ctypes: the entry takes raw device pointers, the
// strides as a host array and the stream, launches, and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}
