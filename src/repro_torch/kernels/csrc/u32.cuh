// Exact modular arithmetic on 32-bit residues, shared by the NTT,
// pointwise and base conversion kernels.  Device twins of kernels/u32.py
// (the plain PyTorch oracle the property tests hold against Python
// big-int arithmetic).
//
// Moduli are odd primes q with 2^28 < q < 2^31, so both the 30-bit
// ciphertext base Q and the 31-bit auxiliary base P go through the same
// code: a + b < 2q < 2^32 and Shoup's r in [0, 2q) still fit one word.
// Hopper multiplies 32x32->64 and 64x64->high-64 natively, so there is
// no 16-bit limb splitting here; results are bit-identical to it.
#pragma once
#include <cstdint>

namespace u32 {

// a * w mod q up to one q, with the precomputed companion
// ws = floor(w * 2^32 / q): a value congruent to a * w in [0, 2q).
// Valid for any a < 2^32 and w < q.
__device__ __forceinline__ uint32_t shoup_mulmod_lazy(uint32_t a, uint32_t w,
                                                      uint32_t ws, uint32_t q) {
  uint32_t hi = __umulhi(a, ws);
  return a * w - hi * q;  // exact in the low word: true r in [0, 2q)
}

// a * w mod q, as above; result < q.
__device__ __forceinline__ uint32_t shoup_mulmod(uint32_t a, uint32_t w,
                                                 uint32_t ws, uint32_t q) {
  uint32_t r = shoup_mulmod_lazy(a, w, ws, q);
  return r >= q ? r - q : r;
}

// x mod q for any x < 2^64, with mu = floor(2^64 / q): qhat =
// floor(x * mu / 2^64) is floor(x/q) or one less, so r = x - qhat*q
// lies in [0, 2q): one conditional subtraction.
__device__ __forceinline__ uint32_t barrett_reduce(uint64_t x, uint32_t q,
                                                   uint64_t mu) {
  uint64_t qhat = __umul64hi(x, mu);
  uint64_t r = x - qhat * q;
  return (uint32_t)(r >= q ? r - q : r);
}

// a * b mod q for a, b < q (P = a*b < 2^62), with mu = floor(2^64 / q).
__device__ __forceinline__ uint32_t barrett_mulmod(uint32_t a, uint32_t b,
                                                   uint32_t q, uint64_t mu) {
  return barrett_reduce((uint64_t)a * b, q, mu);
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  uint32_t s = a + b;  // < 2q < 2^32
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

}  // namespace u32
