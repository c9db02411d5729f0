// Host multi-scalar multiplication (Pippenger) for short-Weierstrass
// curves with a = 0 (Pallas/Vesta/BN254 G1/Grumpkin): the commitment
// route of a CPU key (lurk_tpu_torch/proof/nova.py CommitmentKey). A
// CUDA key commits through the MSM kernel (csrc/msm.cu) instead.
//
// A copy of the JAX package's lurk_tpu/native/msm.cpp, the route that
// package takes without a device, with its batch-affine bucket
// accumulation only (opt-in there, where the serial mixed adds are the
// default): an affine addition costs about 6 products where a mixed
// Jacobian one costs 11. Oracle: lurk_tpu_torch/curves/weierstrass.py
// Curve.pippenger.
//
// Field arithmetic: 4x64-bit Montgomery (CIOS) using unsigned __int128
// (field256.h). The modulus and R^2 mod p arrive from Python; field256.h
// derives -p^{-1} mod 2^64. Threads parallelize over Pippenger windows.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "field256.h"

namespace {

struct Jac { Fe x, y, z; };   // z == 0 -> infinity

static inline bool jac_is_inf(const Jac& a) { return fe_is_zero(a.z); }

static void jac_double(const Field& f, Jac& out, const Jac& a) {
    if (jac_is_inf(a)) { out = a; return; }
    Fe aa, b, c, d, e, ff, t, t2;
    fe_mul(f, aa, a.x, a.x);                // A = X1^2
    fe_mul(f, b, a.y, a.y);                 // B = Y1^2
    fe_mul(f, c, b, b);                     // C = B^2
    fe_add(f, t, a.x, b);
    fe_mul(f, t, t, t);                     // (X1+B)^2
    fe_sub(f, t, t, aa);
    fe_sub(f, t, t, c);
    fe_dbl(f, d, t);                        // D = 2((X1+B)^2-A-C)
    fe_add(f, e, aa, aa);
    fe_add(f, e, e, aa);                    // E = 3A (a=0 curve)
    fe_mul(f, ff, e, e);                    // F = E^2
    fe_sub(f, out.x, ff, d);
    fe_sub(f, out.x, out.x, d);             // X3 = F - 2D
    fe_sub(f, t, d, out.x);
    fe_mul(f, t, e, t);
    fe_dbl(f, t2, c);
    fe_dbl(f, t2, t2);
    fe_dbl(f, t2, t2);                      // 8C
    Fe y1z1;
    fe_mul(f, y1z1, a.y, a.z);
    fe_sub(f, out.y, t, t2);                // Y3 = E(D-X3) - 8C
    fe_dbl(f, out.z, y1z1);                 // Z3 = 2 Y1 Z1
}

static void jac_add(const Field& f, Jac& out, const Jac& a,
                    const Jac& b) {
    if (jac_is_inf(a)) { out = b; return; }
    if (jac_is_inf(b)) { out = a; return; }
    Fe z1z1, z2z2, u1, u2, s1, s2, t;
    fe_mul(f, z1z1, a.z, a.z);
    fe_mul(f, z2z2, b.z, b.z);
    fe_mul(f, u1, a.x, z2z2);
    fe_mul(f, u2, b.x, z1z1);
    fe_mul(f, t, a.y, b.z);
    fe_mul(f, s1, t, z2z2);
    fe_mul(f, t, b.y, a.z);
    fe_mul(f, s2, t, z1z1);
    if (fe_eq(u1, u2)) {
        if (!fe_eq(s1, s2)) {
            std::memset(&out, 0, sizeof(out));   // infinity
            return;
        }
        jac_double(f, out, a);
        return;
    }
    Fe h, i, j, r, v;
    fe_sub(f, h, u2, u1);
    fe_dbl(f, i, h);
    fe_mul(f, i, i, i);                     // I = (2H)^2
    fe_mul(f, j, h, i);                     // J = H*I
    fe_sub(f, r, s2, s1);
    fe_dbl(f, r, r);                        // r = 2(S2-S1)
    fe_mul(f, v, u1, i);                    // V = U1*I
    Fe rr, t2;
    fe_mul(f, rr, r, r);
    fe_sub(f, rr, rr, j);
    fe_sub(f, rr, rr, v);
    fe_sub(f, out.x, rr, v);                // X3 = r^2 - J - 2V
    fe_sub(f, t, v, out.x);
    fe_mul(f, t, r, t);
    fe_mul(f, t2, s1, j);
    fe_dbl(f, t2, t2);
    fe_sub(f, out.y, t, t2);                // Y3 = r(V-X3) - 2 S1 J
    fe_add(f, t, a.z, b.z);
    fe_mul(f, t, t, t);
    fe_sub(f, t, t, z1z1);
    fe_sub(f, t, t, z2z2);
    fe_mul(f, out.z, t, h);                 // Z3 = ((Z1+Z2)^2-Z1Z1-Z2Z2)H
}

// madd-2007-bl mixed addition: b is affine (Z2 = 1, Montgomery coords);
// 8M rather than jac_add's 12M — the bucket-accumulation hot path.
static void jac_add_mixed(const Field& f, Jac& out, const Jac& a,
                          const Fe& bx, const Fe& by, const Fe& one_m) {
    if (jac_is_inf(a)) {
        out.x = bx;
        out.y = by;
        out.z = one_m;
        return;
    }
    Fe z1z1, u2, s2, t;
    fe_mul(f, z1z1, a.z, a.z);
    fe_mul(f, u2, bx, z1z1);
    fe_mul(f, t, by, a.z);
    fe_mul(f, s2, t, z1z1);
    if (fe_eq(a.x, u2)) {
        if (!fe_eq(a.y, s2)) {
            std::memset(&out, 0, sizeof(out));   // infinity
            return;
        }
        jac_double(f, out, a);
        return;
    }
    Fe h, hh, i, j, r, v;
    fe_sub(f, h, u2, a.x);                  // H = U2 - X1
    fe_mul(f, hh, h, h);                    // HH = H^2
    fe_dbl(f, i, hh);
    fe_dbl(f, i, i);                        // I = 4 HH
    fe_mul(f, j, h, i);                     // J = H*I
    fe_sub(f, r, s2, a.y);
    fe_dbl(f, r, r);                        // r = 2(S2 - Y1)
    fe_mul(f, v, a.x, i);                   // V = X1*I
    Fe rr, t2;
    fe_mul(f, rr, r, r);
    fe_sub(f, rr, rr, j);
    fe_sub(f, rr, rr, v);
    fe_sub(f, out.x, rr, v);                // X3 = r^2 - J - 2V
    fe_sub(f, t, v, out.x);
    fe_mul(f, t, r, t);
    fe_mul(f, t2, a.y, j);
    fe_dbl(f, t2, t2);
    fe_sub(f, out.y, t, t2);                // Y3 = r(V-X3) - 2 Y1 J
    fe_add(f, t, a.z, h);
    fe_mul(f, t, t, t);
    fe_sub(f, t, t, z1z1);
    fe_sub(f, t, t, hh);
    out.z = t;                              // Z3 = (Z1+H)^2 - Z1Z1 - HH
}

// Montgomery-domain inversion via Fermat (a^(p-2)); one call per
// batch-inversion pass, so the ~380 muls amortize to nothing.
static void fe_inv(const Field& f, Fe& out, const Fe& a) {
    u64 e[4];
    std::memcpy(e, f.p, 32);
    e[0] -= 2;                               // p odd >= 3: no borrow
    Fe one = {{1, 0, 0, 0}}, r2, r;
    std::memcpy(r2.v, f.r2, 32);
    fe_mul(f, r, one, r2);                   // mont(1)
    for (int i = 255; i >= 0; i--) {
        fe_mul(f, r, r, r);
        if ((e[i >> 6] >> (i & 63)) & 1) fe_mul(f, r, r, a);
    }
    out = r;
}

struct WindowJob {
    const Field* f;
    const Jac* pts;        // Montgomery-form affine points (Z = mont 1)
    const Fe* one_m;
    const u64* scalars;    // n * 4 limbs, canonical
    size_t n;
    int c;
    int w;                 // window index
    Jac result;
};

static inline u64 window_digit(const u64* s, int bit, u64 mask) {
    int limb = bit >> 6;
    int off = bit & 63;
    u64 d = s[limb] >> off;
    if (off && limb < 3) d |= s[limb + 1] << (64 - off);
    return d & mask;
}

// Batch-affine bucket accumulation: counting-sort the window's points
// by bucket, then reduce every bucket by pairwise affine additions —
// each round pairs the survivors of every bucket and completes ALL
// pair additions with ONE modular inversion (Montgomery batch trick,
// 3M amortized per pair). An affine add is then ~6M vs the mixed
// Jacobian add's ~11M. Sorted segments need no retry when two points
// fall in one bucket.
static void run_window(WindowJob* job) {
    const Field& f = *job->f;
    int c = job->c;
    size_t n_buckets = ((size_t)1 << c) - 1;
    u64 mask = n_buckets;
    int bit = c * job->w;

    // pass 1: digits + bucket counts
    std::vector<uint32_t> digit(job->n);
    std::vector<uint32_t> start(n_buckets + 1, 0);
    for (size_t i = 0; i < job->n; i++) {
        u64 d = window_digit(job->scalars + 4 * i, bit, mask);
        if (d && !jac_is_inf(job->pts[i])) {
            digit[i] = (uint32_t)d;
            start[d]++;                      // count for bucket d-1
        } else {
            digit[i] = 0;
        }
    }
    // counts live at position d = b+1; a running inclusive prefix makes
    // bucket b span [start[b], start[b+1])
    for (size_t k = 1; k <= n_buckets; k++) start[k] += start[k - 1];
    size_t m = start[n_buckets];
    std::vector<Fe> X(m), Y(m);
    std::vector<uint32_t> len(n_buckets);
    for (size_t k = 0; k < n_buckets; k++)
        len[k] = start[k + 1] - start[k];
    {
        std::vector<uint32_t> fill(start.begin(), start.end() - 1);
        for (size_t i = 0; i < job->n; i++) {
            if (!digit[i]) continue;
            uint32_t pos = fill[digit[i] - 1]++;
            X[pos] = job->pts[i].x;
            Y[pos] = job->pts[i].y;
        }
    }

    // pairwise reduction rounds, fully in place: pair (s+q, s+q+1)
    // completes into s+q/2 in FORWARD order, which never clobbers an
    // unread source (q/2 < q); survivors and odd leftovers stay put.
    // Only buckets still active (len > 1) are visited after round 1.
    std::vector<Fe> den, num, dinv, pref;
    std::vector<uint32_t> src_a, active, nactive;
    for (size_t k = 0; k < n_buckets; k++)
        if (len[k] > 1) active.push_back((uint32_t)k);
    while (!active.empty()) {
        den.clear(); num.clear(); src_a.clear();
        for (uint32_t k : active) {
            uint32_t l = len[k], s = start[k];
            for (uint32_t q = 0; q + 1 < l; q += 2) {
                uint32_t i = s + q, j = s + q + 1;
                if (fe_eq(X[i], X[j])) {
                    Fe ysum;
                    fe_add(f, ysum, Y[i], Y[j]);
                    if (fe_is_zero(ysum)) {           // P + (-P) = O
                        src_a.push_back(i | 0x80000000u);
                        continue;
                    }
                    Fe d2, xx, n3;                    // doubling branch
                    fe_dbl(f, d2, Y[i]);
                    fe_mul(f, xx, X[i], X[i]);
                    fe_dbl(f, n3, xx);
                    fe_add(f, n3, n3, xx);            // 3 x^2 (a = 0)
                    den.push_back(d2);
                    num.push_back(n3);
                } else {
                    Fe dd, nn;
                    fe_sub(f, dd, X[j], X[i]);
                    fe_sub(f, nn, Y[j], Y[i]);
                    den.push_back(dd);
                    num.push_back(nn);
                }
                src_a.push_back(i);
            }
        }

        // batch inversion into dinv[] (annihilated pairs excluded)
        size_t np = den.size();
        if (np) {
            pref.resize(np);
            dinv.resize(np);
            pref[0] = den[0];
            for (size_t i = 1; i < np; i++)
                fe_mul(f, pref[i], pref[i - 1], den[i]);
            Fe inv;
            fe_inv(f, inv, pref[np - 1]);
            for (size_t i = np; i-- > 1;) {
                fe_mul(f, dinv[i], inv, pref[i - 1]);
                fe_mul(f, inv, inv, den[i]);
            }
            dinv[0] = inv;
        }

        // forward completion + in-place compaction
        nactive.clear();
        size_t pair_idx = 0, inv_idx = 0;
        for (uint32_t k : active) {
            uint32_t l = len[k], s = start[k];
            uint32_t outp = s;
            for (uint32_t q = 0; q + 1 < l; q += 2, pair_idx++) {
                uint32_t tag = src_a[pair_idx];
                if (tag & 0x80000000u) continue;      // annihilated
                uint32_t i = s + q, j = s + q + 1, o = outp++;
                Fe lam, x3, y3, t;
                fe_mul(f, lam, num[inv_idx], dinv[inv_idx]);
                inv_idx++;
                fe_mul(f, x3, lam, lam);
                fe_sub(f, x3, x3, X[i]);
                fe_sub(f, x3, x3, X[j]);
                fe_sub(f, t, X[i], x3);
                fe_mul(f, t, lam, t);
                fe_sub(f, y3, t, Y[i]);
                X[o] = x3;
                Y[o] = y3;
            }
            if (l & 1) {                      // odd leftover moves down
                uint32_t o = outp++;
                if (o != s + l - 1) {
                    X[o] = X[s + l - 1];
                    Y[o] = Y[s + l - 1];
                }
            }
            len[k] = outp - s;
            if (len[k] > 1) nactive.push_back(k);
        }
        active.swap(nactive);
    }

    // bucket reduction: survivors are affine -> mixed adds for `run`
    Jac run, total;
    std::memset(&run, 0, sizeof(run));
    std::memset(&total, 0, sizeof(total));
    for (size_t k = n_buckets; k-- > 0;) {
        if (len[k])
            jac_add_mixed(f, run, run, X[start[k]], Y[start[k]],
                          *job->one_m);
        jac_add(f, total, total, run);
    }
    job->result = total;
}

}   // namespace

extern "C" {

// points: n * 8 limbs (x, y canonical; x=y=0 encodes infinity)
// scalars: n * 4 limbs canonical (< group order < 2^255)
// out: 12 limbs canonical Jacobian (X, Y, Z); Z=0 for infinity
void lurk_msm(const u64* mod_limbs, const u64* r2_limbs,
              const u64* points, const u64* scalars, size_t n,
              int c, int n_threads, int scalar_bits, u64* out) {
    Field f;
    f.init(mod_limbs, r2_limbs);
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);

    // to Montgomery Jacobian
    std::vector<Jac> pts(n);
    Fe one_m;                       // R mod p = mont(1)
    {
        Fe one = {{1, 0, 0, 0}};
        fe_mul(f, one_m, one, r2);
    }
    for (size_t i = 0; i < n; i++) {
        Fe x, y;
        std::memcpy(x.v, points + 8 * i, 32);
        std::memcpy(y.v, points + 8 * i + 32 / 8 /*4 limbs*/, 32);
        if (fe_is_zero(x) && fe_is_zero(y)) {
            std::memset(&pts[i], 0, sizeof(Jac));
        } else {
            fe_mul(f, pts[i].x, x, r2);
            fe_mul(f, pts[i].y, y, r2);
            pts[i].z = one_m;
        }
    }

    int n_windows = (scalar_bits + c - 1) / c;
    std::vector<WindowJob> jobs(n_windows);
    for (int w = 0; w < n_windows; w++) {
        jobs[w] = WindowJob{&f, pts.data(), &one_m, scalars, n, c, w, {}};
    }
    if (n_threads <= 1) {
        for (int w = 0; w < n_windows; w++) run_window(&jobs[w]);
    } else {
        std::vector<std::thread> threads;
        int next = 0;
        auto worker = [&jobs, &next, n_windows]() {
            for (;;) {
                int w = __atomic_fetch_add(&next, 1, __ATOMIC_RELAXED);
                if (w >= n_windows) return;
                run_window(&jobs[w]);
            }
        };
        int nt = n_threads < n_windows ? n_threads : n_windows;
        for (int t = 0; t < nt; t++) threads.emplace_back(worker);
        for (auto& t : threads) t.join();
    }

    // horner over windows: acc = sum_w 2^{cw} * window_w
    Jac acc;
    std::memset(&acc, 0, sizeof(acc));
    for (int w = n_windows - 1; w >= 0; w--) {
        for (int k = 0; k < c; k++) jac_double(f, acc, acc);
        jac_add(f, acc, acc, jobs[w].result);
    }

    // from Montgomery: multiply each coord by 1 (REDC)
    Fe one = {{1, 0, 0, 0}};
    Fe xo, yo, zo;
    fe_mul(f, xo, acc.x, one);
    fe_mul(f, yo, acc.y, one);
    fe_mul(f, zo, acc.z, one);
    std::memcpy(out, xo.v, 32);
    std::memcpy(out + 4, yo.v, 32);
    std::memcpy(out + 8, zo.v, 32);
}

}   // extern "C"
