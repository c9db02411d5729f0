// 256-bit prime-field arithmetic in Montgomery form (R = 2^256) with
// eight 32-bit limbs, least significant first, and CIOS multiplication.
//
// Generic over the modulus: every function takes the modulus p and
// pinv = -p^{-1} mod 2^32 (and to_mont takes R^2 mod p), so the Poseidon
// kernel and later kernels (the MSM) share one core. All moduli this
// package uses are below 2^255, so a sum or a CIOS result of canonical
// inputs is below 2p < 2^256 and one conditional subtraction makes it
// canonical.
//
// The functions are written for the device and compile for the host as
// well (without nvcc), so the arithmetic can be checked off the card.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FE_FN __host__ __device__ __forceinline__
#else
#define FE_FN inline
#endif

namespace fe {

constexpr int N = 8;

// Read-only load of one element from device memory (through the
// read-only cache on the card).
FE_FN void load(uint32_t r[N], const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#ifdef __CUDA_ARCH__
    r[i] = __ldg(src + i);
#else
    r[i] = src[i];
#endif
  }
}

FE_FN void copy(uint32_t r[N], const uint32_t a[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = a[i];
}

// r = (hi:a) - p if that is non-negative, else a. hi is the carry limb
// above a (0 or 1).
FE_FN void cond_sub_p(uint32_t r[N], const uint32_t a[N], uint32_t hi,
                      const uint32_t p[N]) {
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)a[i] - p[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  bool keep = (hi == 0) && borrow;
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = keep ? a[i] : d[i];
}

// r = a + b mod p, for canonical a and b. r may alias a or b.
FE_FN void add(uint32_t r[N], const uint32_t a[N], const uint32_t b[N],
               const uint32_t p[N]) {
  uint32_t s[N];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c += (uint64_t)a[i] + b[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  cond_sub_p(r, s, (uint32_t)c, p);
}

// r = a - b mod p, for canonical a and b. r may alias a or b.
FE_FN void sub(uint32_t r[N], const uint32_t a[N], const uint32_t b[N],
               const uint32_t p[N]) {
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  const uint32_t mask = 0u - (uint32_t)borrow;   // add p back on a borrow
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c += (uint64_t)d[i] + (p[i] & mask);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

FE_FN bool is_zero(const uint32_t a[N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc |= a[i];
  return acc == 0;
}

// r = a * b / R mod p (CIOS). Canonical for a < 2^256 and b < p (or
// the other way round). r may alias a or b.
FE_FN void mul(uint32_t r[N], const uint32_t a[N], const uint32_t b[N],
               const uint32_t p[N], uint32_t pinv) {
  uint32_t t[N + 2];
#pragma unroll
  for (int j = 0; j < N + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N] = (uint32_t)c;
    t[N + 1] = (uint32_t)(c >> 32);

    uint32_t m = t[0] * pinv;
    c = ((uint64_t)m * p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      c += (uint64_t)m * p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[N];
    t[N - 1] = (uint32_t)c;
    t[N] = t[N + 1] + (uint32_t)(c >> 32);
  }
  cond_sub_p(r, t, t[N], p);
}

// Montgomery form of any a < 2^256 (reduced mod p on the way).
FE_FN void to_mont(uint32_t r[N], const uint32_t a[N], const uint32_t r2[N],
                   const uint32_t p[N], uint32_t pinv) {
  mul(r, a, r2, p, pinv);
}

// Canonical value of a Montgomery-form element.
FE_FN void from_mont(uint32_t r[N], const uint32_t a[N], const uint32_t p[N],
                     uint32_t pinv) {
  uint32_t one[N] = {1, 0, 0, 0, 0, 0, 0, 0};
  mul(r, a, one, p, pinv);
}

}  // namespace fe
