// Native powers-of-tau SRS generation: out[i] = tau^{start+i} * G
// (affine, canonical) for a short-Weierstrass a=0 curve (BN254 G1).
//
// A copy of the JAX package's lurk_tpu/native/srs.cpp.
//
// The python path (proof/hyperkzg.py::_fixed_base_mul per point) costs
// ~1.5 ms/point — ~50 min for the 2^21 dev SRS on a cold cache. Here:
// a shared c=8 window table of G (32 rows x 255 Jacobian entries),
// tau-power iteration in the ORDER field (Montgomery), ~32 mixed window
// adds per point, threaded over contiguous ranges, and one batch
// inversion per thread chunk for the Jacobian->affine conversion.
// Bit-exact vs the python oracle (proof/hyperkzg.py checks three points
// of every batch against it and raises on a mismatch).

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
    fe_mul(f, aa, a.x, a.x);
    fe_mul(f, b, a.y, a.y);
    fe_mul(f, c, b, b);
    fe_add(f, t, a.x, b);
    fe_mul(f, t, t, t);
    fe_sub(f, t, t, aa);
    fe_sub(f, t, t, c);
    fe_dbl(f, d, t);
    fe_add(f, e, aa, aa);
    fe_add(f, e, e, aa);                    // 3A (a=0 curve)
    fe_mul(f, ff, e, e);
    fe_sub(f, out.x, ff, d);
    fe_sub(f, out.x, out.x, d);
    fe_sub(f, t, d, out.x);
    fe_mul(f, t, e, t);
    fe_dbl(f, t2, c);
    fe_dbl(f, t2, t2);
    fe_dbl(f, t2, t2);
    Fe y1z1;
    fe_mul(f, y1z1, a.y, a.z);
    fe_sub(f, out.y, t, t2);
    fe_dbl(f, out.z, y1z1);
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
    fe_mul(f, s1, a.y, b.z);
    fe_mul(f, s1, s1, z2z2);
    fe_mul(f, s2, b.y, a.z);
    fe_mul(f, s2, s2, z1z1);
    if (fe_eq(u1, u2)) {
        if (fe_eq(s1, s2)) { jac_double(f, out, a); return; }
        std::memset(&out, 0, sizeof(out));
        return;
    }
    Fe h, i, j, r, v;
    fe_sub(f, h, u2, u1);
    fe_dbl(f, i, h);
    fe_mul(f, i, i, i);                     // (2H)^2
    fe_mul(f, j, h, i);
    fe_sub(f, r, s2, s1);
    fe_dbl(f, r, r);
    fe_mul(f, v, u1, i);
    Fe r2;
    fe_mul(f, r2, r, r);
    fe_sub(f, out.x, r2, j);
    fe_sub(f, out.x, out.x, v);
    fe_sub(f, out.x, out.x, v);
    fe_sub(f, t, v, out.x);
    fe_mul(f, t, r, t);
    Fe s1j;
    fe_mul(f, s1j, s1, j);
    fe_dbl(f, s1j, s1j);
    fe_sub(f, out.y, t, s1j);
    Fe zz;
    fe_add(f, zz, a.z, b.z);
    fe_mul(f, zz, zz, zz);
    fe_sub(f, zz, zz, z1z1);
    fe_sub(f, zz, zz, z2z2);
    fe_mul(f, out.z, zz, h);
}

// out = a^e (Montgomery), square-and-multiply over e's bits
static void fe_pow_limbs(const Field& f, Fe& out, const Fe& a,
                         const u64* e) {
    Fe one = {{1, 0, 0, 0}};
    Fe r;                                   // mont(1) = R mod p
    Fe r2v;
    std::memcpy(r2v.v, f.r2, 32);
    fe_mul(f, r, one, r2v);
    Fe acc = r;
    for (int i = 255; i >= 0; i--) {
        fe_mul(f, acc, acc, acc);
        if ((e[i / 64] >> (i % 64)) & 1) fe_mul(f, acc, acc, a);
    }
    out = acc;
}

static void fe_inv(const Field& f, Fe& out, const Fe& a) {
    u64 e[4];
    std::memcpy(e, f.p, 32);
    e[0] -= 2;                              // p is odd, no borrow
    fe_pow_limbs(f, out, a, e);
}

}  // namespace

extern "C" {

// base_*: base field (coordinates); ord_*: scalar field (group order).
// gen_xy: 8 limbs canonical affine generator. tau: 4 limbs canonical.
// Writes n points (powers start..start+n) as 8 canonical limbs each.
void lurk_srs_powers(const u64* base_mod, const u64* base_r2,
                     const u64* ord_mod, const u64* ord_r2,
                     const u64* gen_xy, const u64* tau,
                     u64 start, u64 n, u64* out, int n_threads) {
    Field fb, fo;
    fb.init(base_mod, base_r2);
    fo.init(ord_mod, ord_r2);
    Fe one = {{1, 0, 0, 0}};
    Fe br2, or2;
    std::memcpy(br2.v, fb.r2, 32);
    std::memcpy(or2.v, fo.r2, 32);
    Fe one_mb;
    fe_mul(fb, one_mb, one, br2);           // mont(1) base field

    // window table: rows w=0..31, entries d=1..255: d * 2^{8w} * G
    constexpr int C = 8, N_WIN = 32, N_ENT = 255;
    std::vector<Jac> table((size_t)N_WIN * N_ENT);
    Jac base;
    {
        Fe gx, gy;
        std::memcpy(gx.v, gen_xy, 32);
        std::memcpy(gy.v, gen_xy + 4, 32);
        fe_mul(fb, base.x, gx, br2);
        fe_mul(fb, base.y, gy, br2);
        base.z = one_mb;
    }
    for (int w = 0; w < N_WIN; w++) {
        Jac acc = base;
        table[(size_t)w * N_ENT] = acc;
        for (int d = 1; d < N_ENT; d++) {
            jac_add(fb, acc, acc, base);
            table[(size_t)w * N_ENT + d] = acc;
        }
        for (int k = 0; k < C; k++) jac_double(fb, base, base);
    }

    Fe tau_m;                               // mont(tau) in order field
    {
        Fe tc;
        std::memcpy(tc.v, tau, 32);
        fe_mul(fo, tau_m, tc, or2);
    }

    int nt = n_threads < 1 ? 1 : n_threads;
    if ((u64)nt > n) nt = (int)n;
    std::vector<std::thread> threads;
    u64 chunk = (n + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        u64 i0 = (u64)t * chunk;
        u64 i1 = i0 + chunk < n ? i0 + chunk : n;
        if (i0 >= i1) break;
        threads.emplace_back([&, i0, i1]() {
            // s = tau^{start+i0} (Montgomery, order field) by
            // square-and-multiply over the exponent's bits
            u64 e = start + i0;
            Fe s;
            fe_mul(fo, s, one, or2);        // mont(1)
            for (int b = 63; b >= 0; b--) {
                fe_mul(fo, s, s, s);
                if ((e >> b) & 1) fe_mul(fo, s, s, tau_m);
            }
            u64 m = i1 - i0;
            std::vector<Jac> pts(m);
            for (u64 i = 0; i < m; i++) {
                Fe sc;
                fe_mul(fo, sc, s, one);     // canonical scalar
                Jac acc;
                std::memset(&acc, 0, sizeof(acc));
                const unsigned char* bytes =
                    reinterpret_cast<const unsigned char*>(sc.v);
                for (int w = 0; w < N_WIN; w++) {
                    unsigned d = bytes[w];
                    if (d)
                        jac_add(fb, acc, acc,
                                table[(size_t)w * N_ENT + d - 1]);
                }
                pts[i] = acc;
                fe_mul(fo, s, s, tau_m);
            }
            // batch inversion of the z coordinates (Montgomery trick)
            std::vector<Fe> prefix(m);
            Fe run = one_mb;
            for (u64 i = 0; i < m; i++) {
                prefix[i] = run;
                if (!jac_is_inf(pts[i])) fe_mul(fb, run, run, pts[i].z);
            }
            Fe inv;
            fe_inv(fb, inv, run);
            for (u64 i = m; i-- > 0;) {
                u64* o = out + 8 * (i0 + i);
                if (jac_is_inf(pts[i])) {
                    std::memset(o, 0, 64);
                    continue;
                }
                Fe zi;
                fe_mul(fb, zi, inv, prefix[i]);
                fe_mul(fb, inv, inv, pts[i].z);
                Fe zi2, zi3, xa, ya;
                fe_mul(fb, zi2, zi, zi);
                fe_mul(fb, zi3, zi2, zi);
                fe_mul(fb, xa, pts[i].x, zi2);
                fe_mul(fb, ya, pts[i].y, zi3);
                fe_mul(fb, xa, xa, one);    // -> canonical
                fe_mul(fb, ya, ya, one);
                std::memcpy(o, xa.v, 32);
                std::memcpy(o + 4, ya.v, 32);
            }
        });
    }
    for (auto& t : threads) t.join();
}

}
