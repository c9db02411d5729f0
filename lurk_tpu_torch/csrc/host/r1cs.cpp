// Host sparse R1CS kernels for the Nova fold: matvecs (Az, Bz, Cz),
// cross-term computation, and relaxed/strict satisfiability checks.
//
// A copy of the JAX package's lurk_tpu/native/r1cs.cpp, with its
// Spartan entries (lurk_spartan_mvec, lurk_spartan_matrix_evals: the
// compression's sparse products over the split-z domain).
// Role parity: arecibo's r1cs.rs sparse ops (the reference's fold hot
// loop outside the MSMs). Oracle: the JAX package's Python loops in
// lurk_tpu/proof/nova.py (R1CSShape.matvecs, check_relaxed, cross_term,
// fold_witness), held in tests/test_torch_fold.py.
//
// Representation: one CSR per matrix; coefficients are stored in
// Montgomery form so coeff x canonical-z products come out canonical
// with a single fe_mul. Shapes are registered once per process and
// addressed by handle (they are uniform across fold steps).

#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include "field256.h"

namespace {

struct Csr {
    std::vector<uint64_t> indptr;    // m+1
    std::vector<uint64_t> idx;       // nnz (column = z index)
    std::vector<Fe> coef;            // nnz, Montgomery form
};

struct Shape {
    Field f;
    size_t m;          // rows
    size_t n_vars;     // z length
    Csr a, b, c;
};

std::vector<Shape*> g_shapes;
std::mutex g_mu;

void load_csr(Csr& out, const Field& f, size_t m, const u64* indptr,
              const u64* idx, const u64* coef_limbs) {
    out.indptr.assign(indptr, indptr + m + 1);
    size_t nnz = indptr[m];
    out.idx.assign(idx, idx + nnz);
    out.coef.resize(nnz);
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    for (size_t i = 0; i < nnz; i++) {
        Fe c;
        std::memcpy(c.v, coef_limbs + 4 * i, 32);
        fe_mul(f, out.coef[i], c, r2);   // to Montgomery
    }
}

// az[row] = sum_j coef_m[j] * z[idx[j]]  (canonical out)
inline void spmv_row(const Field& f, const Csr& m, const Fe* z,
                     size_t row, Fe& out) {
    std::memset(&out, 0, sizeof(out));
    Fe t;
    for (u64 j = m.indptr[row]; j < m.indptr[row + 1]; j++) {
        fe_mul(f, t, m.coef[j], z[m.idx[j]]);
        fe_add(f, out, out, t);
    }
}

void parallel_rows(size_t m, int n_threads,
                   const std::function<void(size_t, size_t)>& fn) {
    if (n_threads <= 1 || m < 1024) {
        fn(0, m);
        return;
    }
    std::vector<std::thread> ts;
    size_t chunk = (m + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
        size_t lo = t * chunk;
        size_t hi = lo + chunk < m ? lo + chunk : m;
        if (lo >= hi) break;
        ts.emplace_back([&fn, lo, hi]() { fn(lo, hi); });
    }
    for (auto& t : ts) t.join();
}

}   // namespace

extern "C" {

// Register a shape; returns its handle.
long lurk_r1cs_shape(const u64* mod_limbs, const u64* r2_limbs,
                     u64 m, u64 n_vars,
                     const u64* a_indptr, const u64* a_idx,
                     const u64* a_coef,
                     const u64* b_indptr, const u64* b_idx,
                     const u64* b_coef,
                     const u64* c_indptr, const u64* c_idx,
                     const u64* c_coef) {
    Shape* s = new Shape();
    s->f.init(mod_limbs, r2_limbs);
    s->m = m;
    s->n_vars = n_vars;
    load_csr(s->a, s->f, m, a_indptr, a_idx, a_coef);
    load_csr(s->b, s->f, m, b_indptr, b_idx, b_coef);
    load_csr(s->c, s->f, m, c_indptr, c_idx, c_coef);
    std::lock_guard<std::mutex> lk(g_mu);
    g_shapes.push_back(s);
    return (long)g_shapes.size() - 1;
}

// out_abc: 3 * m * 4 limbs (Az | Bz | Cz), canonical.
void lurk_r1cs_matvecs(long h, const u64* z_limbs, int n_threads,
                       u64* out_abc) {
    const Shape& s = *g_shapes[h];
    const Fe* z = (const Fe*)z_limbs;
    Fe* az = (Fe*)out_abc;
    Fe* bz = az + s.m;
    Fe* cz = bz + s.m;
    parallel_rows(s.m, n_threads, [&](size_t lo, size_t hi) {
        for (size_t r = lo; r < hi; r++) {
            spmv_row(s.f, s.a, z, r, az[r]);
            spmv_row(s.f, s.b, z, r, bz[r]);
            spmv_row(s.f, s.c, z, r, cz[r]);
        }
    });
}

// T = Az1.Bz2 + Az2.Bz1 - u1*Cz2 - Cz1  (z2 strict, u2 = 1)
void lurk_r1cs_cross_term(long h, const u64* z1_limbs,
                          const u64* u1_limbs, const u64* z2_limbs,
                          int n_threads, u64* out) {
    const Shape& s = *g_shapes[h];
    const Field& f = s.f;
    const Fe* z1 = (const Fe*)z1_limbs;
    const Fe* z2 = (const Fe*)z2_limbs;
    Fe* t_out = (Fe*)out;
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe u1m;
    {
        Fe u1;
        std::memcpy(u1.v, u1_limbs, 32);
        fe_mul(f, u1m, u1, r2);   // Montgomery u1
    }
    parallel_rows(s.m, n_threads, [&](size_t lo, size_t hi) {
        Fe a1, b1, c1, a2, b2, c2, t1, t2, t3, acc;
        for (size_t r = lo; r < hi; r++) {
            spmv_row(f, s.a, z1, r, a1);
            spmv_row(f, s.b, z1, r, b1);
            spmv_row(f, s.c, z1, r, c1);
            spmv_row(f, s.a, z2, r, a2);
            spmv_row(f, s.b, z2, r, b2);
            spmv_row(f, s.c, z2, r, c2);
            // canonical products need one Montgomery lift per pair
            fe_mul(f, t1, a1, r2);       // mont(a1)
            fe_mul(f, t1, t1, b2);       // a1*b2 canonical
            fe_mul(f, t2, a2, r2);
            fe_mul(f, t2, t2, b1);       // a2*b1
            fe_mul(f, t3, u1m, c2);      // u1*c2
            fe_add(f, acc, t1, t2);
            fe_sub(f, acc, acc, t3);
            fe_sub(f, t_out[r], acc, c1);
        }
    });
}

// out = a + r*b (mod p), elementwise over n packed field elements —
// the fold's random linear combination of witness/error vectors.
void lurk_vec_rlc(const u64* mod_limbs, const u64* r2_limbs,
                  const u64* a_limbs, const u64* b_limbs,
                  const u64* r_limbs, u64 n, int n_threads,
                  u64* out_limbs) {
    Field f;
    f.init(mod_limbs, r2_limbs);
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe rm;
    {
        Fe r;
        std::memcpy(r.v, r_limbs, 32);
        fe_mul(f, rm, r, r2);            // r in Montgomery form
    }
    const Fe* a = (const Fe*)a_limbs;
    const Fe* b = (const Fe*)b_limbs;
    Fe* out = (Fe*)out_limbs;
    parallel_rows(n, n_threads, [&](size_t lo, size_t hi) {
        Fe t;
        for (size_t i = lo; i < hi; i++) {
            fe_mul(f, t, rm, b[i]);      // r*b canonical (REDC(rR * b))
            fe_add(f, out[i], a[i], t);
        }
    });
}

// returns number of unsatisfied rows for Az.Bz = u*Cz + E
u64 lurk_r1cs_check_relaxed(long h, const u64* z_limbs,
                            const u64* u_limbs, const u64* e_limbs,
                            int n_threads) {
    const Shape& s = *g_shapes[h];
    const Field& f = s.f;
    const Fe* z = (const Fe*)z_limbs;
    const Fe* e = (const Fe*)e_limbs;
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe um;
    {
        Fe u;
        std::memcpy(u.v, u_limbs, 32);
        fe_mul(f, um, u, r2);
    }
    std::mutex mu;
    u64 total_bad = 0;
    parallel_rows(s.m, n_threads, [&](size_t lo, size_t hi) {
        Fe a, b, c, lhs, rhs, t;
        u64 local = 0;
        for (size_t r = lo; r < hi; r++) {
            spmv_row(f, s.a, z, r, a);
            spmv_row(f, s.b, z, r, b);
            spmv_row(f, s.c, z, r, c);
            fe_mul(f, t, a, r2);
            fe_mul(f, lhs, t, b);        // a*b canonical
            fe_mul(f, rhs, um, c);       // u*c canonical
            fe_add(f, rhs, rhs, e[r]);
            if (!fe_eq(lhs, rhs)) local++;
        }
        std::lock_guard<std::mutex> lk(mu);
        total_bad += local;
    });
    return total_bad;
}

// Cross term with CACHED accumulator matvecs: abc1 = (Az1|Bz1|Cz1)
// precomputed (the accumulator's z folds linearly, z1' = z1 + r z2,
// so its matvecs fold forward with one RLC instead of 3 spmv); also
// outputs (Az2|Bz2|Cz2) so the caller can fold them into the cache.
void lurk_r1cs_cross_term_cached(long h, const u64* abc1_limbs,
                                 const u64* u1_limbs,
                                 const u64* z2_limbs, int n_threads,
                                 u64* out_t, u64* out_abc2) {
    const Shape& s = *g_shapes[h];
    const Field& f = s.f;
    const Fe* a1v = (const Fe*)abc1_limbs;
    const Fe* b1v = a1v + s.m;
    const Fe* c1v = b1v + s.m;
    const Fe* z2 = (const Fe*)z2_limbs;
    Fe* t_out = (Fe*)out_t;
    Fe* a2v = (Fe*)out_abc2;
    Fe* b2v = a2v + s.m;
    Fe* c2v = b2v + s.m;
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe u1m;
    {
        Fe u1;
        std::memcpy(u1.v, u1_limbs, 32);
        fe_mul(f, u1m, u1, r2);
    }
    parallel_rows(s.m, n_threads, [&](size_t lo, size_t hi) {
        Fe t1, t2, t3, acc;
        for (size_t r = lo; r < hi; r++) {
            spmv_row(f, s.a, z2, r, a2v[r]);
            spmv_row(f, s.b, z2, r, b2v[r]);
            spmv_row(f, s.c, z2, r, c2v[r]);
            fe_mul(f, t1, a1v[r], r2);
            fe_mul(f, t1, t1, b2v[r]);      // a1*b2 canonical
            fe_mul(f, t2, a2v[r], r2);
            fe_mul(f, t2, t2, b1v[r]);      // a2*b1
            fe_mul(f, t3, u1m, c2v[r]);     // u1*c2
            fe_add(f, acc, t1, t2);
            fe_sub(f, acc, acc, t3);
            fe_sub(f, t_out[r], acc, c1v[r]);
        }
    });
}

// ---------------------------------------------------------------------------
// Spartan compression helpers over a registered shape (proof/spartan.py):
// the split-z column map sends j -> j (j < num_inputs) else
// n_half + (j - num_inputs).
// ---------------------------------------------------------------------------

// m_vec = (A + r B + r^2 C)^T chi over the split-z domain; out plain
// [2 * n_half].
void lurk_spartan_mvec(long h, const u64* chi_limbs, const u64* r_limbs,
                       u64 n_half, u64 num_inputs, u64* out_limbs) {
    const Shape& s = *g_shapes[h];
    const Field& f = s.f;
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe rm;                              // mont(r)
    {
        Fe r;
        std::memcpy(r.v, r_limbs, 32);
        fe_mul(f, rm, r, r2);
    }
    const Fe* chi = (const Fe*)chi_limbs;
    std::vector<Fe> acc(2 * n_half);    // plain accumulation
    std::memset(acc.data(), 0, acc.size() * sizeof(Fe));
    const Csr* mats[3] = {&s.a, &s.b, &s.c};
    Fe t, w;
    for (size_t row = 0; row < s.m; row++) {
        Fe chim;
        fe_mul(f, chim, chi[row], r2);          // mont(chi)
        Fe wk = chim;                           // mont(chi * r^k)
        for (int k = 0; k < 3; k++) {
            const Csr& m = *mats[k];
            for (u64 j = m.indptr[row]; j < m.indptr[row + 1]; j++) {
                u64 col = m.idx[j];
                u64 out_col = col < num_inputs
                    ? col : n_half + (col - num_inputs);
                // mont(w) * mont(val) = mont(w*val); one more unmont
                // happens lazily: coef is mont, wk is mont ->
                // fe_mul gives mont(w*val); multiply by ONE later.
                fe_mul(f, t, wk, m.coef[j]);
                fe_add(f, acc[out_col], acc[out_col], t);
            }
            if (k < 2) fe_mul(f, wk, wk, rm);
        }
    }
    // unmont: multiply by plain 1
    Fe one;
    std::memset(&one, 0, sizeof(one));
    one.v[0] = 1;
    Fe* out = (Fe*)out_limbs;
    for (size_t i = 0; i < 2 * n_half; i++)
        fe_mul(f, out[i], acc[i], one);
}

// evals[k] = sum_i chi_rx[i] * sum_j M_k[i][j] * chi_ry[colmap(j)];
// chi vectors plain; out plain [3].
void lurk_spartan_matrix_evals(long h, const u64* chi_rx_limbs,
                               const u64* chi_ry_limbs, u64 n_half,
                               u64 num_inputs, u64* out_limbs) {
    const Shape& s = *g_shapes[h];
    const Field& f = s.f;
    const Fe* chi_rx = (const Fe*)chi_rx_limbs;
    const Fe* chi_ry = (const Fe*)chi_ry_limbs;
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe evals[3];
    std::memset(evals, 0, sizeof(evals));
    const Csr* mats[3] = {&s.a, &s.b, &s.c};
    Fe t, inner, rxm;
    for (size_t row = 0; row < s.m; row++) {
        fe_mul(f, rxm, chi_rx[row], r2);        // mont(chi_rx)
        for (int k = 0; k < 3; k++) {
            const Csr& m = *mats[k];
            std::memset(&inner, 0, sizeof(inner));
            for (u64 j = m.indptr[row]; j < m.indptr[row + 1]; j++) {
                u64 col = m.idx[j];
                u64 out_col = col < num_inputs
                    ? col : n_half + (col - num_inputs);
                fe_mul(f, t, m.coef[j], chi_ry[out_col]); // plain
                fe_add(f, inner, inner, t);
            }
            fe_mul(f, t, rxm, inner);           // plain(chi_rx*inner)
            fe_add(f, evals[k], evals[k], t);
        }
    }
    std::memcpy(out_limbs, evals, sizeof(evals));
}

}   // extern "C"
