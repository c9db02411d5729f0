// 4x64-limb Montgomery field arithmetic for the host C++ of
// lurk_tpu_torch (pedersen.cpp, srs.cpp, poseidon.cpp); a copy of the
// JAX package's lurk_tpu/native/field256.h. Modulus-generic: parameters
// arrive at runtime (p, R^2 mod p); -p^{-1} mod 2^64 derived by Newton
// iteration.
#pragma once

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

struct Field {
    u64 p[4];
    u64 r2[4];
    u64 n0inv;

    void init(const u64* mod, const u64* rsq) {
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

// Montgomery multiplication (CIOS with extra limb; any p < 2^256)
static inline void fe_mul(const Field& f, Fe& out, const Fe& a,
                          const Fe& b) {
    u64 t[5] = {0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 carry = 0;
        u64 ai = a.v[i];
        for (int j = 0; j < 4; j++) {
            u128 s = (u128)t[j] + (u128)ai * b.v[j] + carry;
            t[j] = (u64)s;
            carry = s >> 64;
        }
        u128 s4 = (u128)t[4] + carry;
        u64 t4 = (u64)s4;
        u64 carry_hi = (u64)(s4 >> 64);

        u64 m = t[0] * f.n0inv;
        u128 s = (u128)t[0] + (u128)m * f.p[0];
        u128 c2 = s >> 64;
        for (int j = 1; j < 4; j++) {
            s = (u128)t[j] + (u128)m * f.p[j] + c2;
            t[j - 1] = (u64)s;
            c2 = s >> 64;
        }
        s = (u128)t4 + c2;
        t[3] = (u64)s;
        t[4] = carry_hi + (u64)(s >> 64);
    }
    if (t[4] || ge_p(t, f.p)) sub_p(t, f.p);
    std::memcpy(out.v, t, 32);
}

static inline void fe_dbl(const Field& f, Fe& out, const Fe& a) {
    fe_add(f, out, a, a);
}
