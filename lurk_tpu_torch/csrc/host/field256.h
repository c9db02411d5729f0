// 4x64-limb Montgomery field arithmetic for the host C++ of
// lurk_tpu_torch (pedersen.cpp, srs.cpp, poseidon.cpp, ...); a copy of
// the JAX package's lurk_tpu/native/field256.h with another product
// (fe_mul, for a modulus below 2^255 - 2^193). Modulus-generic:
// parameters arrive at runtime (p, R^2 mod p); -p^{-1} mod 2^64 derived
// by Newton iteration.
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

struct Field {
    u64 p[4];
    u64 r2[4];
    u64 n0inv;

    // fe_mul needs p's top limb below 2^63 - 2, as it is for every
    // field the port uses (BN254's two, Pallas's and Vesta's); another
    // modulus ends the process rather than give wrong products
    void init(const u64* mod, const u64* rsq) {
        if (mod[3] >= 0x7FFFFFFFFFFFFFFEULL) {
            std::fprintf(stderr, "field256: a modulus whose top limb is "
                                 "2^63 - 2 or more is not supported\n");
            std::abort();
        }
        std::memcpy(p, mod, 32);
        std::memcpy(r2, rsq, 32);
        u64 inv = 1;
        for (int i = 0; i < 6; i++) inv *= 2 - p[0] * inv;
        n0inv = ~inv + 1;
    }
};

struct Fe { u64 v[4]; };

static inline bool fe_is_zero(const Fe& a) {
    return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

static inline bool fe_eq(const Fe& a, const Fe& b) {
    return a.v[0] == b.v[0] && a.v[1] == b.v[1] && a.v[2] == b.v[2] &&
           a.v[3] == b.v[3];
}

static inline bool ge_p(const u64* a, const u64* p) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] > p[i]) return true;
        if (a[i] < p[i]) return false;
    }
    return true;
}

static inline void sub_p(u64* a, const u64* p) {
    u128 borrow = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - p[i] - borrow;
        a[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
}

static inline void fe_add(const Field& f, Fe& out, const Fe& a,
                          const Fe& b) {
    u128 carry = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        t[i] = (u64)s;
        carry = s >> 64;
    }
    if (carry || ge_p(t, f.p)) sub_p(t, f.p);
    std::memcpy(out.v, t, 32);
}

static inline void fe_sub(const Field& f, Fe& out, const Fe& a,
                          const Fe& b) {
    u128 borrow = 0;
    u64 t[4];
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        t[i] = (u64)d;
        borrow = (d >> 64) & 1;
    }
    if (borrow) {
        u128 carry = 0;
        for (int i = 0; i < 4; i++) {
            u128 s = (u128)t[i] + f.p[i] + carry;
            t[i] = (u64)s;
            carry = s >> 64;
        }
    }
    std::memcpy(out.v, t, 32);
}

// Montgomery multiplication, out = a * b / 2^256 mod p (CIOS without
// the extra limb, "no-carry"). Both operands must be below p; the
// running value then stays below 2p < 2^256, since p's top limb is
// below 2^63 - 2 (Field::init), and the result is below p. The last
// subtraction is branch-free.
static inline void fe_mul(const Field& f, Fe& out, const Fe& a,
                          const Fe& b) {
    const u64* p = f.p;
    u64 t0 = 0, t1 = 0, t2 = 0, t3 = 0;
    for (int i = 0; i < 4; i++) {
        const u64 bi = b.v[i];
        u128 s = (u128)a.v[0] * bi + t0;
        u64 hi = (u64)(s >> 64);
        const u64 lo = (u64)s;
        const u64 m = lo * f.n0inv;
        u128 r = (u128)m * p[0] + lo;
        u64 c = (u64)(r >> 64);
        s = (u128)a.v[1] * bi + t1 + hi;
        hi = (u64)(s >> 64);
        r = (u128)m * p[1] + (u64)s + c;
        c = (u64)(r >> 64);
        t0 = (u64)r;
        s = (u128)a.v[2] * bi + t2 + hi;
        hi = (u64)(s >> 64);
        r = (u128)m * p[2] + (u64)s + c;
        c = (u64)(r >> 64);
        t1 = (u64)r;
        s = (u128)a.v[3] * bi + t3 + hi;
        hi = (u64)(s >> 64);
        r = (u128)m * p[3] + (u64)s + c;
        c = (u64)(r >> 64);
        t2 = (u64)r;
        t3 = c + hi;
    }
    u64 d[4];
    u128 x = (u128)t0 - p[0];
    d[0] = (u64)x;
    x = (u128)t1 - p[1] - (u64)((x >> 64) & 1);
    d[1] = (u64)x;
    x = (u128)t2 - p[2] - (u64)((x >> 64) & 1);
    d[2] = (u64)x;
    x = (u128)t3 - p[3] - (u64)((x >> 64) & 1);
    d[3] = (u64)x;
    const u64 keep = 0 - (u64)((x >> 64) & 1);   // all ones: t < p
    out.v[0] = (t0 & keep) | (d[0] & ~keep);
    out.v[1] = (t1 & keep) | (d[1] & ~keep);
    out.v[2] = (t2 & keep) | (d[2] & ~keep);
    out.v[3] = (t3 & keep) | (d[3] & ~keep);
}

static inline void fe_dbl(const Field& f, Fe& out, const Fe& a) {
    fe_add(f, out, a, a);
}
