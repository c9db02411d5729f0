// 256-bit prime-field arithmetic in Montgomery form (R = 2^256) with
// eight 32-bit limbs, least significant first.
//
// Generic over the modulus: every function takes the modulus p and
// pinv = -p^{-1} mod 2^32 (and to_mont takes R^2 mod p), so the Poseidon
// kernels and the MSM share one core. All moduli this package uses are
// below 2^255, so a sum or a CIOS result of canonical inputs is below
// 2p < 2^256 and one conditional subtraction makes it canonical.
//
// On the card the additions, subtractions and the sums of wide products
// are PTX carry chains (add.cc / addc), one asm block per chain, so
// nothing the compiler emits can land between two instructions that pass
// the carry flag; the products and reductions (mul, mad_row, sqr_wide,
// redc_steps) are C with 64-bit multiply-adds, which nvcc lets overlap
// where one PTX carry flag per thread serialises them (see mul). Without
// __CUDA_ARCH__ (g++, or nvcc's host pass) each PTX chain has a plain C++
// body with the same results, so the arithmetic can be checked off the
// card; nothing on the card takes that body.
//
// Besides the CIOS product (mul), a row of products can be summed
// unreduced and reduced once: mul_wide gives the 512-bit product,
// wide_add sums products into a 17-word accumulator, and redc_wide
// reduces it with R' = 2^288 (nine reduction steps), which takes any
// input below p 2^288: 66 products of canonical values are below
// 66 p^2 < 2^515, far inside. Because redc_wide divides by 2^288, one
// factor of each product carries an extra 2^32 (scale_32 makes it).
// sqr squares with 36 wide products (sqr_wide) and the eight-step
// reduction (redc_steps<8>, R = 2^256), the same value as mul(a, a).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FE_FN __host__ __device__ __forceinline__
#else
#define FE_FN inline
#endif

namespace fe {

constexpr int N = 8;
constexpr int W = 2 * N + 1;       // words of a wide accumulator

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
#ifdef __CUDA_ARCH__
  uint32_t bw;
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %25, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(bw)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(p[0]), "r"(p[1]), "r"(p[2]), "r"(p[3]),
        "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]), "r"(hi));
  const bool keep = bw == 0xFFFFFFFFu;      // hi = 0 and a borrow
#else
  uint64_t borrow = 0;
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)a[i] - p[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  const bool keep = (hi == 0) && borrow;
#endif
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = keep ? a[i] : d[i];
}

// r = a + b mod p, for canonical a and b. r may alias a or b.
FE_FN void add(uint32_t r[N], const uint32_t a[N], const uint32_t b[N],
               const uint32_t p[N]) {
  uint32_t s[N], c;
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, 0, 0;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
        "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "=r"(c)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
#else
  uint64_t cc = 0;
  for (int i = 0; i < N; ++i) {
    cc += (uint64_t)a[i] + b[i];
    s[i] = (uint32_t)cc;
    cc >>= 32;
  }
  c = (uint32_t)cc;
#endif
  cond_sub_p(r, s, c, p);
}

// r = a - b mod p, for canonical a and b. r may alias a or b.
FE_FN void sub(uint32_t r[N], const uint32_t a[N], const uint32_t b[N],
               const uint32_t p[N]) {
  uint32_t d[N], mask;
#ifdef __CUDA_ARCH__
  asm("sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "=r"(mask)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  // mask is all ones on a borrow: add p back
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(p[0] & mask), "r"(p[1] & mask), "r"(p[2] & mask),
        "r"(p[3] & mask), "r"(p[4] & mask), "r"(p[5] & mask),
        "r"(p[6] & mask), "r"(p[7] & mask));
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = d[i];
#else
  uint64_t borrow = 0;
  for (int i = 0; i < N; ++i) {
    uint64_t v = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  mask = 0u - (uint32_t)borrow;
  uint64_t c = 0;
  for (int i = 0; i < N; ++i) {
    c += (uint64_t)d[i] + (p[i] & mask);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
#endif
}

FE_FN bool is_zero(const uint32_t a[N]) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc |= a[i];
  return acc == 0;
}

// t[0..9] += a * b (a: 8 words, b: one word). The caller guarantees the
// sum fits in t[0..9]; the carry out of t[8] lands in t[9].
FE_FN void mad_row(uint32_t t[N + 2], const uint32_t a[N], uint32_t b) {
  uint64_t c = 0;
  for (int j = 0; j < N; ++j) {
    c += (uint64_t)a[j] * b + t[j];
    t[j] = (uint32_t)c;
    c >>= 32;
  }
  c += t[N];
  t[N] = (uint32_t)c;
  t[N + 1] += (uint32_t)(c >> 32);
}

// r = a * b / R mod p (CIOS). Canonical for a < 2^256 and b < p (or
// the other way round). r may alias a or b. Written in C on the card as
// well: nvcc's 64-bit multiply-adds let independent products overlap,
// which one PTX carry flag per thread serialises; a PTX version ran K1,
// K2, the folded kernel and K6's accumulation slower on the H100, and
// PTX versions of mad_row and redc_steps ran K1, K2 and the folded
// kernel up to 1.3x slower than these C ones.
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

    const uint32_t m = t[0] * pinv;
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

// t[0..15] = a * b, the full 512-bit product.
FE_FN void mul_wide(uint32_t t[2 * N], const uint32_t a[N],
                    const uint32_t b[N]) {
  uint32_t u[2 * N + 1];
#pragma unroll
  for (int j = 0; j < 2 * N + 1; ++j) u[j] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) mad_row(u + i, a, b[i]);   // u[i+9] is 0
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) t[j] = u[j];
}

// acc[0..16] += t[0..15]. The caller keeps the sum below 2^544.
FE_FN void wide_add(uint32_t acc[W], const uint32_t t[2 * N]) {
#ifdef __CUDA_ARCH__
  uint32_t c;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, 0, 0;"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
        "+r"(acc[4]), "+r"(acc[5]), "+r"(acc[6]), "+r"(acc[7]), "=r"(c)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]));
  // c + 0xFFFFFFFF sets the carry flag again exactly when c is 1
  asm("add.cc.u32 %9, %9, 0xFFFFFFFF;\n\t"
      "addc.cc.u32 %0, %0, %10;\n\t"
      "addc.cc.u32 %1, %1, %11;\n\t"
      "addc.cc.u32 %2, %2, %12;\n\t"
      "addc.cc.u32 %3, %3, %13;\n\t"
      "addc.cc.u32 %4, %4, %14;\n\t"
      "addc.cc.u32 %5, %5, %15;\n\t"
      "addc.cc.u32 %6, %6, %16;\n\t"
      "addc.cc.u32 %7, %7, %17;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(acc[8]), "+r"(acc[9]), "+r"(acc[10]), "+r"(acc[11]),
        "+r"(acc[12]), "+r"(acc[13]), "+r"(acc[14]), "+r"(acc[15]),
        "+r"(acc[16]), "+r"(c)
      : "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]), "r"(t[12]),
        "r"(t[13]), "r"(t[14]), "r"(t[15]));
#else
  uint64_t c = 0;
  for (int j = 0; j < 2 * N; ++j) {
    c += (uint64_t)acc[j] + t[j];
    acc[j] = (uint32_t)c;
    c >>= 32;
  }
  acc[2 * N] += (uint32_t)c;
#endif
}

// acc += a * b, unreduced.
FE_FN void wide_mac(uint32_t acc[W], const uint32_t a[N],
                    const uint32_t b[N]) {
  uint32_t t[2 * N];
  mul_wide(t, a, b);
  wide_add(acc, t);
}

// acc[0..16] += b[0..16] (two wide accumulators).
FE_FN void wide_sum(uint32_t acc[W], const uint32_t b[W]) {
  wide_add(acc, b);
  acc[2 * N] += b[2 * N];     // the sum stays below 2^544: no carry out
}

FE_FN void wide_zero(uint32_t acc[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) acc[j] = 0;
}

// r = acc / 2^(32 S) mod p, canonical, for acc (N + S words) below
// p 2^(32 S): S Montgomery reduction steps. The carry out of step i's
// word i + 8 belongs to word i + 9 and is added in step i + 1.
template <int S>
FE_FN void redc_steps(uint32_t r[N], const uint32_t acc[N + S],
                      const uint32_t p[N], uint32_t pinv) {
  uint32_t t[N + S + 1];
#pragma unroll
  for (int j = 0; j < N + S; ++j) t[j] = acc[j];
  t[N + S] = 0;
  uint32_t hold = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const uint32_t m = t[i] * pinv;
    uint32_t* u = t + i;
    uint64_t c = 0;
    for (int j = 0; j < N; ++j) {
      c += (uint64_t)p[j] * m + u[j];
      u[j] = (uint32_t)c;
      c >>= 32;
    }
    c += (uint64_t)u[N] + hold;
    u[N] = (uint32_t)c;
    hold = (uint32_t)(c >> 32);
  }
  cond_sub_p(r, t + S, t[N + S] + hold, p);
}

// r = acc / 2^288 mod p, canonical, for acc < p 2^288 (nine steps).
FE_FN void redc_wide(uint32_t r[N], const uint32_t acc[W],
                     const uint32_t p[N], uint32_t pinv) {
  redc_steps<N + 1>(r, acc, p, pinv);
}

// t[0..15] = a^2: the 28 products a_i a_j (i < j) once, doubled, plus
// the 8 squares a_i^2; 36 wide products against mul_wide's 64. In C on
// the card as well, as mul.
FE_FN void sqr_wide(uint32_t t[2 * N], const uint32_t a[N]) {
  uint32_t u[2 * N];
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) u[j] = 0;
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      c += (uint64_t)a[i] * a[j] + u[i + j];
      u[i + j] = (uint32_t)c;
      c >>= 32;
    }
    u[i + N] = (uint32_t)c;       // no row wrote this word yet
  }
  // the cross sum is below 2^511, so doubling it shifts no bit out
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t d = (uint64_t)a[i] * a[i];
    const uint32_t lo = (u[2 * i] << 1) | (i ? u[2 * i - 1] >> 31 : 0);
    const uint32_t hi = (u[2 * i + 1] << 1) | (u[2 * i] >> 31);
    c += (uint64_t)lo + (uint32_t)d;
    t[2 * i] = (uint32_t)c;
    c >>= 32;
    c += (uint64_t)hi + (d >> 32);
    t[2 * i + 1] = (uint32_t)c;
    c >>= 32;
  }
}

// r = a^2 / R mod p, canonical, for canonical a: mul(r, a, a) with 36
// wide products and one reduction of eight steps. r may alias a.
FE_FN void sqr(uint32_t r[N], const uint32_t a[N], const uint32_t p[N],
               uint32_t pinv) {
  uint32_t t[2 * N];
  sqr_wide(t, a);
  redc_steps<N>(r, t, p, pinv);
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

// r = a 2^32 mod p (a Montgomery element scaled for redc_wide), from
// r2 = R^2 mod p: mul(r2, 2^32) is R 2^32, and mul(a, R 2^32) is a 2^32.
FE_FN void scale_32(uint32_t r[N], const uint32_t a[N], const uint32_t r2[N],
                    const uint32_t p[N], uint32_t pinv) {
  const uint32_t two32[N] = {0, 1, 0, 0, 0, 0, 0, 0};
  uint32_t k[N];
  mul(k, r2, two32, p, pinv);
  mul(r, a, k, p, pinv);
}

}  // namespace fe
