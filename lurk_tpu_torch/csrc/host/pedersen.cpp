// Native Pedersen generator derivation: shake256 try-and-increment over
// a short-Weierstrass curve y^2 = x^3 + b, threaded over indices.
//
// A copy of the JAX package's lurk_tpu/native/pedersen.cpp. Bit-exact
// with the Python oracle
// (lurk_tpu_torch/curves/weierstrass.py derive_generators_from):
//   h = shake256(label || i_le8 || attempt_le8).digest(33)
//   x = le(h[:32]) mod p ; y parity = h[32] & 1 ; y^2 = x^3 + b.
// The reference's arecibo derives its commitment key via from_label +
// hash-to-curve (external crate; no vectors offline) — this replaces the
// prover's dominant cold-start cost (~590k python Tonelli-Shanks pows
// for one fib proof's key) with native field arithmetic.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "field256.h"

// ---------------------------------------------------------------------------
// SHAKE256 (Keccak-f[1600]); inputs here are < rate, single-block.
// ---------------------------------------------------------------------------

static const u64 KC_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static const int KC_RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55,
                               20, 3,  10, 43, 25, 39, 41, 45, 15,
                               21, 8,  18, 2,  61, 56, 14};

static inline u64 rotl64(u64 x, int n) {
    return n == 0 ? x : (x << n) | (x >> (64 - n));
}

static void keccak_f(u64 st[25]) {
    for (int round = 0; round < 24; round++) {
        u64 c[5], d[5];
        for (int i = 0; i < 5; i++)
            c[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
        for (int i = 0; i < 5; i++)
            d[i] = c[(i + 4) % 5] ^ rotl64(c[(i + 1) % 5], 1);
        for (int i = 0; i < 25; i++) st[i] ^= d[i % 5];
        u64 tmp[25];
        for (int x = 0; x < 5; x++)
            for (int y = 0; y < 5; y++) {
                int src = x + 5 * y;
                int dst = y + 5 * ((2 * x + 3 * y) % 5);
                tmp[dst] = rotl64(st[src], KC_RHO[src]);
            }
        for (int y = 0; y < 5; y++)
            for (int x = 0; x < 5; x++)
                st[x + 5 * y] = tmp[x + 5 * y] ^
                    (~tmp[(x + 1) % 5 + 5 * y] & tmp[(x + 2) % 5 + 5 * y]);
        st[0] ^= KC_RC[round];
    }
}

// shake256 of a message < 136 bytes, squeezing `outlen` <= 136 bytes.
static void shake256_small(const uint8_t* msg, size_t len, uint8_t* out,
                           size_t outlen) {
    const size_t rate = 136;
    uint8_t block[136];
    std::memset(block, 0, rate);
    std::memcpy(block, msg, len);
    block[len] = 0x1f;
    block[rate - 1] |= 0x80;
    u64 st[25];
    std::memset(st, 0, sizeof(st));
    for (size_t i = 0; i < rate / 8; i++) {
        u64 w;
        std::memcpy(&w, block + 8 * i, 8);
        st[i] ^= w;
    }
    keccak_f(st);
    std::memcpy(out, st, outlen);
}

// ---------------------------------------------------------------------------
// field helpers on top of field256.h (values in Montgomery form)
// ---------------------------------------------------------------------------

static void fe_pow(const Field& f, Fe& out, const Fe& base,
                   const u64* exp) {
    // out = base^exp (Montgomery in/out); exp is a plain 4x64 integer.
    Fe acc;  // 1 in Montgomery form = REDC(r2)
    Fe one_raw{{1, 0, 0, 0}};
    fe_mul(f, acc, one_raw, *(const Fe*)f.r2);
    bool started = false;
    for (int w = 3; w >= 0; w--) {
        for (int b = 63; b >= 0; b--) {
            if (started) fe_mul(f, acc, acc, acc);
            if ((exp[w] >> b) & 1) {
                if (started) {
                    fe_mul(f, acc, acc, base);
                } else {
                    acc = base;
                    started = true;
                }
            }
        }
    }
    out = acc;
}

struct SqrtCtx {
    u64 p_minus1_half[4];   // (p-1)/2
    u64 q[4];               // odd part of p-1
    u64 q_plus1_half[4];    // (q+1)/2
    int s;                  // p-1 = q * 2^s
    Fe z_q;                 // c0 = z^q (Montgomery), z = smallest non-residue
    Fe one;                 // Montgomery 1
};

static void shr1(u64* a) {
    for (int i = 0; i < 3; i++) a[i] = (a[i] >> 1) | (a[i + 1] << 63);
    a[3] >>= 1;
}

static bool fe_is_one_mont(const SqrtCtx& ctx, const Fe& a) {
    return fe_eq(a, ctx.one);
}

static void sqrt_ctx_init(const Field& f, SqrtCtx& ctx) {
    u64 pm1[4];
    std::memcpy(pm1, f.p, 32);
    pm1[0] -= 1;  // p is odd
    std::memcpy(ctx.p_minus1_half, pm1, 32);
    shr1(ctx.p_minus1_half);
    std::memcpy(ctx.q, pm1, 32);
    ctx.s = 0;
    while ((ctx.q[0] & 1) == 0) {
        shr1(ctx.q);
        ctx.s++;
    }
    std::memcpy(ctx.q_plus1_half, ctx.q, 32);
    // q odd: (q+1)/2 = q>>1 + 1 (no carry past limb 0 since q < 2^256-1)
    shr1(ctx.q_plus1_half);
    u128 carry = (u128)ctx.q_plus1_half[0] + 1;
    ctx.q_plus1_half[0] = (u64)carry;
    for (int i = 1; carry >> 64 && i < 4; i++) {
        carry = (u128)ctx.q_plus1_half[i] + 1;
        ctx.q_plus1_half[i] = (u64)carry;
    }
    Fe one_raw{{1, 0, 0, 0}};
    fe_mul(f, ctx.one, one_raw, *(const Fe*)f.r2);
    // smallest quadratic non-residue z
    for (u64 z = 2;; z++) {
        Fe zf{{z, 0, 0, 0}}, zm, ls;
        fe_mul(f, zm, zf, *(const Fe*)f.r2);
        fe_pow(f, ls, zm, ctx.p_minus1_half);
        if (!fe_is_one_mont(ctx, ls) && !fe_is_zero(ls)) {
            fe_pow(f, ctx.z_q, zm, ctx.q);
            break;
        }
    }
}

// Tonelli-Shanks; a in Montgomery form, nonzero. Returns false if a is
// a non-residue, else out = sqrt(a) (Montgomery).
static bool fe_sqrt(const Field& f, const SqrtCtx& ctx, Fe& out,
                    const Fe& a) {
    Fe ls;
    fe_pow(f, ls, a, ctx.p_minus1_half);
    if (!fe_is_one_mont(ctx, ls)) return false;
    int m = ctx.s;
    Fe c = ctx.z_q;
    Fe t, r;
    fe_pow(f, t, a, ctx.q);
    fe_pow(f, r, a, ctx.q_plus1_half);
    while (!fe_is_one_mont(ctx, t)) {
        Fe tt = t;
        int i = 0;
        while (!fe_is_one_mont(ctx, tt)) {
            fe_mul(f, tt, tt, tt);
            i++;
        }
        Fe b = c;
        for (int j = 0; j < m - i - 1; j++) fe_mul(f, b, b, b);
        fe_mul(f, c, b, b);
        fe_mul(f, t, t, c);
        fe_mul(f, r, r, b);
        m = i;
    }
    out = r;
    return true;
}

// ---------------------------------------------------------------------------
// entry point
// ---------------------------------------------------------------------------

extern "C" int derive_generators(
    const u64* p_limbs, const u64* r2_limbs, const u64* b_limbs,
    const uint8_t* label, int64_t label_len, int64_t start, int64_t end,
    u64* out /* [end-start, 8] canonical x,y */, int n_threads) {
    Field f;
    f.init(p_limbs, r2_limbs);
    SqrtCtx ctx;
    sqrt_ctx_init(f, ctx);
    Fe b_raw, b_mont;
    std::memcpy(b_raw.v, b_limbs, 32);
    fe_mul(f, b_mont, b_raw, *(const Fe*)f.r2);

    if (label_len > 100) return -2;  // single-block shake only
    std::atomic<int64_t> next(start);
    std::atomic<int> failed(0);
    int64_t n = end - start;
    if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
    if (n_threads < 1) n_threads = 1;

    auto worker = [&]() {
        uint8_t msg[116];
        std::memcpy(msg, label, label_len);
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= end || failed.load()) break;
            std::memcpy(msg + label_len, &i, 8);  // little-endian
            bool ok = false;
            for (int64_t attempt = 0; attempt < 256; attempt++) {
                std::memcpy(msg + label_len + 8, &attempt, 8);
                uint8_t h[33];
                shake256_small(msg, label_len + 16, h, 33);
                // x = le(h[:32]) mod p (canonical), then to Montgomery
                u64 x_can[5];
                std::memcpy(x_can, h, 32);
                x_can[4] = 0;
                // h < 2^256 and p >= 2^253 -> at most 7 subtractions
                for (int k = 0; k < 8 && ge_p(x_can, f.p); k++)
                    sub_p(x_can, f.p);
                Fe xm, x_raw;
                std::memcpy(x_raw.v, x_can, 32);
                fe_mul(f, xm, x_raw, *(const Fe*)f.r2);
                // y^2 = x^3 + b
                Fe x2, x3, y2, y;
                fe_mul(f, x2, xm, xm);
                fe_mul(f, x3, x2, xm);
                fe_add(f, y2, x3, b_mont);
                if (fe_is_zero(y2)) {
                    // y = 0 point; parity 0
                    if ((h[32] & 1) != 0) continue;
                    u64* o = out + (i - start) * 8;
                    std::memcpy(o, x_can, 32);
                    std::memset(o + 4, 0, 32);
                    ok = true;
                    break;
                }
                if (!fe_sqrt(f, ctx, y, y2)) continue;
                // back from Montgomery to canonical
                Fe y_can, one_raw{{1, 0, 0, 0}};
                fe_mul(f, y_can, y, one_raw);
                if ((y_can.v[0] & 1) != (u64)(h[32] & 1)) {
                    // y = p - y
                    u64 neg[4];
                    u128 borrow = 0;
                    for (int k = 0; k < 4; k++) {
                        u128 d = (u128)f.p[k] - y_can.v[k] - borrow;
                        neg[k] = (u64)d;
                        borrow = (d >> 64) & 1;
                    }
                    std::memcpy(y_can.v, neg, 32);
                }
                u64* o = out + (i - start) * 8;
                std::memcpy(o, x_can, 32);
                std::memcpy(o + 4, y_can.v, 32);
                ok = true;
                break;
            }
            if (!ok) failed.store(1);
        }
    };

    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
    return failed.load() ? -1 : 0;
}
