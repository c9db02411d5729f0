// Host sumcheck vector kernels for the Spartan compression SNARK
// (lurk_tpu_torch/proof/spartan.py) and the HyperKZG fold chain
// (proof/hyperkzg.py): a copy of the JAX package's
// lurk_tpu/native/spartan.cpp. The reference reaches this through
// arecibo's spartan::sumcheck (Rust, rayon); here: threaded C++ over
// 4x64-limb Montgomery arrays. The Fiat-Shamir loop stays in Python —
// these kernels compute one round's evaluations / one bind at a time.
// Oracle: the JAX package's Python loops in lurk_tpu/proof/mle.py and
// hyperkzg.py, held in tests/test_torch_compress.py.
//
// Domain conventions: "mont" arrays hold Montgomery-form elements and
// stay native-side across rounds; scalars cross the boundary in plain
// (canonical) form.

#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include "field256.h"

namespace {

void parallel_chunks(size_t n, int n_threads,
                     const std::function<void(size_t, size_t)>& fn) {
    if (n_threads <= 1 || n < 4096) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> ts;
    size_t per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        size_t lo = t * per, hi = std::min(n, lo + per);
        if (lo >= hi) break;
        ts.emplace_back(fn, lo, hi);
    }
    for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// plain -> Montgomery, elementwise
void lurk_vec_to_mont(const u64* mod, const u64* r2l, u64 n,
                      const u64* in, u64* out, int n_threads) {
    Field f;
    f.init(mod, r2l);
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    const Fe* a = (const Fe*)in;
    Fe* o = (Fe*)out;
    parallel_chunks(n, n_threads, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; i++) fe_mul(f, o[i], a[i], r2);
    });
}

// Montgomery -> plain, elementwise
void lurk_vec_from_mont(const u64* mod, const u64* r2l, u64 n,
                        const u64* in, u64* out, int n_threads) {
    Field f;
    f.init(mod, r2l);
    Fe one;
    std::memset(&one, 0, sizeof(one));
    one.v[0] = 1;
    const Fe* a = (const Fe*)in;
    Fe* o = (Fe*)out;
    parallel_chunks(n, n_threads, [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; i++) fe_mul(f, o[i], a[i], one);
    });
}

// One degree-3 round of sumcheck 1:
//   comb(x) = eq(x) * (az(x)*bz(x) - u*cz(x) - e(x))
// Arrays (len 2*half) are Montgomery; u plain. out: 4 plain evals at
// t = 0..3.
void lurk_sc_round1(const u64* mod, const u64* r2l, u64 half,
                    const u64* eq_l, const u64* az_l, const u64* bz_l,
                    const u64* cz_l, const u64* e_l, const u64* u_l,
                    u64* out_evals, int n_threads) {
    Field f;
    f.init(mod, r2l);
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe um;                                  // mont(u)
    {
        Fe u;
        std::memcpy(u.v, u_l, 32);
        fe_mul(f, um, u, r2);
    }
    const Fe* eq = (const Fe*)eq_l;
    const Fe* az = (const Fe*)az_l;
    const Fe* bz = (const Fe*)bz_l;
    const Fe* cz = (const Fe*)cz_l;
    const Fe* ev = (const Fe*)e_l;
    int nt = n_threads < 1 ? 1 : n_threads;
    std::vector<Fe> sums(4 * nt);
    std::memset(sums.data(), 0, sums.size() * sizeof(Fe));
    size_t per = (half + nt - 1) / nt;
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++) {
        size_t lo = t * per, hi = std::min((size_t)half, lo + per);
        if (lo >= hi) break;
        ts.emplace_back([&, t, lo, hi]() {
            Fe* acc = &sums[4 * t];
            Fe qe, qa, qb, qc, qv, de, da, db, dc, dv;
            Fe t1, t2, t3;
            for (size_t i = lo; i < hi; i++) {
                qe = eq[i]; qa = az[i]; qb = bz[i];
                qc = cz[i]; qv = ev[i];
                fe_sub(f, de, eq[i + half], eq[i]);
                fe_sub(f, da, az[i + half], az[i]);
                fe_sub(f, db, bz[i + half], bz[i]);
                fe_sub(f, dc, cz[i + half], cz[i]);
                fe_sub(f, dv, ev[i + half], ev[i]);
                for (int tt = 0; tt < 4; tt++) {
                    fe_mul(f, t1, qa, qb);       // mont(az*bz)
                    fe_mul(f, t2, um, qc);       // mont(u*cz)
                    fe_sub(f, t1, t1, t2);
                    fe_sub(f, t1, t1, qv);
                    fe_mul(f, t3, qe, t1);
                    fe_add(f, acc[tt], acc[tt], t3);
                    if (tt < 3) {
                        fe_add(f, qe, qe, de);
                        fe_add(f, qa, qa, da);
                        fe_add(f, qb, qb, db);
                        fe_add(f, qc, qc, dc);
                        fe_add(f, qv, qv, dv);
                    }
                }
            }
        });
    }
    for (auto& th : ts) th.join();
    Fe one;
    std::memset(&one, 0, sizeof(one));
    one.v[0] = 1;
    Fe* out = (Fe*)out_evals;
    for (int tt = 0; tt < 4; tt++) {
        Fe acc;
        std::memset(&acc, 0, sizeof(acc));
        for (int t = 0; t < nt; t++)
            fe_add(f, acc, acc, sums[4 * t + tt]);
        fe_mul(f, out[tt], acc, one);    // unmont
    }
}

// One degree-2 round of sumcheck 2: comb(x) = m(x) * z(x).
// out: 3 plain evals at t = 0..2.
void lurk_sc_round2(const u64* mod, const u64* r2l, u64 half,
                    const u64* m_l, const u64* z_l, u64* out_evals,
                    int n_threads) {
    Field f;
    f.init(mod, r2l);
    const Fe* mv = (const Fe*)m_l;
    const Fe* zv = (const Fe*)z_l;
    int nt = n_threads < 1 ? 1 : n_threads;
    std::vector<Fe> sums(3 * nt);
    std::memset(sums.data(), 0, sums.size() * sizeof(Fe));
    size_t per = (half + nt - 1) / nt;
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++) {
        size_t lo = t * per, hi = std::min((size_t)half, lo + per);
        if (lo >= hi) break;
        ts.emplace_back([&, t, lo, hi]() {
            Fe* acc = &sums[3 * t];
            Fe qm, qz, dm, dz, t1;
            for (size_t i = lo; i < hi; i++) {
                qm = mv[i]; qz = zv[i];
                fe_sub(f, dm, mv[i + half], mv[i]);
                fe_sub(f, dz, zv[i + half], zv[i]);
                for (int tt = 0; tt < 3; tt++) {
                    fe_mul(f, t1, qm, qz);
                    fe_add(f, acc[tt], acc[tt], t1);
                    if (tt < 2) {
                        fe_add(f, qm, qm, dm);
                        fe_add(f, qz, qz, dz);
                    }
                }
            }
        });
    }
    for (auto& th : ts) th.join();
    Fe one;
    std::memset(&one, 0, sizeof(one));
    one.v[0] = 1;
    Fe* out = (Fe*)out_evals;
    for (int tt = 0; tt < 3; tt++) {
        Fe acc;
        std::memset(&acc, 0, sizeof(acc));
        for (int t = 0; t < nt; t++)
            fe_add(f, acc, acc, sums[3 * t + tt]);
        fe_mul(f, out[tt], acc, one);
    }
}

// In-place bind of the top variable: a[i] += r * (a[i+half] - a[i]).
// Array Montgomery (len 2*half, result in first half); r plain.
void lurk_sc_bind(const u64* mod, const u64* r2l, u64 half, u64* arr,
                  const u64* r_l, int n_threads) {
    Field f;
    f.init(mod, r2l);
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe rm;
    {
        Fe r;
        std::memcpy(r.v, r_l, 32);
        fe_mul(f, rm, r, r2);
    }
    Fe* a = (Fe*)arr;
    parallel_chunks(half, n_threads, [&](size_t lo, size_t hi) {
        Fe d, t;
        for (size_t i = lo; i < hi; i++) {
            fe_sub(f, d, a[i + half], a[i]);
            fe_mul(f, t, rm, d);
            fe_add(f, a[i], a[i], t);
        }
    });
}

// chi table over k variables (rs plain, MSB-first); out plain [2^k].
void lurk_chi_table(const u64* mod, const u64* r2l, u64 k,
                    const u64* rs_l, u64* out_limbs, int n_threads) {
    Field f;
    f.init(mod, r2l);
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe one_m;                            // mont(1)
    {
        Fe one;
        std::memset(&one, 0, sizeof(one));
        one.v[0] = 1;
        fe_mul(f, one_m, one, r2);
    }
    Fe* chi = (Fe*)out_limbs;            // build in mont, unmont at end
    chi[0] = one_m;
    size_t size = 1;
    for (long j = (long)k - 1; j >= 0; j--) {   // reversed(rs)
        Fe r, rm, nr;
        std::memcpy(r.v, rs_l + 4 * j, 32);
        fe_mul(f, rm, r, r2);
        fe_sub(f, nr, one_m, rm);
        Fe* lo = chi;
        Fe* hi = chi + size;
        size_t sz = size;
        parallel_chunks(sz, n_threads, [&](size_t a, size_t b) {
            Fe t;
            for (size_t i = a; i < b; i++) {
                fe_mul(f, t, chi[i], rm);
                fe_mul(f, lo[i], chi[i], nr);
                hi[i] = t;
            }
        });
        size *= 2;
    }
    Fe one;
    std::memset(&one, 0, sizeof(one));
    one.v[0] = 1;
    parallel_chunks(size, n_threads, [&](size_t a, size_t b) {
        for (size_t i = a; i < b; i++)
            fe_mul(f, chi[i], chi[i], one);
    });
}

}

extern "C" {

// Even/odd fold on PLAIN packed arrays (HyperKZG Gemini fold):
// out[i] = a[2i] + x * (a[2i+1] - a[2i]), i < half; in-place safe
// (ascending i reads indices >= i).
void lurk_bind_eo(const u64* mod, const u64* r2l, u64 half, u64* arr,
                  const u64* x_l, int n_threads) {
    Field f;
    f.init(mod, r2l);
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe xm;
    {
        Fe x;
        std::memcpy(x.v, x_l, 32);
        fe_mul(f, xm, x, r2);
    }
    Fe* a = (Fe*)arr;
    // sequential (in-place aliasing between chunks is only safe
    // ascending); half the elements of a mul each — fast enough
    Fe d, t;
    for (size_t i = 0; i < half; i++) {
        fe_sub(f, d, a[2 * i + 1], a[2 * i]);
        fe_mul(f, t, xm, d);
        fe_add(f, a[i], a[2 * i], t);
    }
}

// Horner evaluation of a plain packed coefficient vector at plain z.
void lurk_poly_eval(const u64* mod, const u64* r2l, u64 n,
                    const u64* coeffs, const u64* z_l, u64* out) {
    Field f;
    f.init(mod, r2l);
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe zm;
    {
        Fe z;
        std::memcpy(z.v, z_l, 32);
        fe_mul(f, zm, z, r2);
    }
    const Fe* c = (const Fe*)coeffs;
    Fe acc;
    std::memset(&acc, 0, sizeof(acc));
    for (long i = (long)n - 1; i >= 0; i--) {
        Fe t;
        fe_mul(f, t, zm, acc);          // plain(z * acc)
        fe_add(f, acc, t, c[i]);
    }
    std::memcpy(out, acc.v, 32);
}

// Synthetic division (p(X) - p(z)) / (X - z): out has n-1 coeffs.
void lurk_poly_quotient(const u64* mod, const u64* r2l, u64 n,
                        const u64* coeffs, const u64* z_l, u64* out) {
    Field f;
    f.init(mod, r2l);
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe zm;
    {
        Fe z;
        std::memcpy(z.v, z_l, 32);
        fe_mul(f, zm, z, r2);
    }
    const Fe* c = (const Fe*)coeffs;
    Fe* o = (Fe*)out;
    Fe acc;
    std::memset(&acc, 0, sizeof(acc));
    for (long i = (long)n - 1; i >= 1; i--) {
        Fe t;
        fe_mul(f, t, zm, acc);
        fe_add(f, acc, t, c[i]);
        o[i - 1] = acc;
    }
}

}
