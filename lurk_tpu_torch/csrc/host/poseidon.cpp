// Native Poseidon witness-trace generator: the aux trace of
// poseidon_circuit (x2, x4, x5 per S-box in allocation order) plus the
// digest, for the witness-only synthesis path. A copy of the JAX
// package's lurk_tpu/native/poseidon.cpp, built by
// lurk_tpu_torch/native.py:build_host with g++.
//
// Role parity: neptune's circuit2_witness::poseidon_hash_allocated_witness
// (the reference's witness fast path, src/circuit/gadgets/hashes.rs:6).
// Oracle: lurk_tpu_torch/poseidon/circuit.py:witness_trace_and_digest.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include "field256.h"

namespace {

struct Spec {
    Field f;
    int t, rf, rp;
    std::vector<Fe> rc;      // (rf+rp)*t, Montgomery
    std::vector<Fe> mds;     // t*t, Montgomery, row-major [i][j]
};

std::vector<Spec*> g_specs;
std::mutex g_mu;

// The spec of handle h; g_specs may grow while another thread reads it.
const Spec& spec_at(long h) {
    std::lock_guard<std::mutex> lk(g_mu);
    return *g_specs[h];
}

}   // namespace

extern "C" {

long lurk_poseidon_new(const u64* mod_limbs, const u64* r2_limbs,
                       int t, int rf, int rp, const u64* rc_limbs,
                       const u64* mds_limbs) {
    Spec* s = new Spec();
    s->f.init(mod_limbs, r2_limbs);
    s->t = t;
    s->rf = rf;
    s->rp = rp;
    Fe r2;
    std::memcpy(r2.v, s->f.r2, 32);
    int n_rc = (rf + rp) * t;
    s->rc.resize(n_rc);
    for (int i = 0; i < n_rc; i++) {
        Fe c;
        std::memcpy(c.v, rc_limbs + 4 * i, 32);
        fe_mul(s->f, s->rc[i], c, r2);
    }
    s->mds.resize(t * t);
    for (int i = 0; i < t * t; i++) {
        Fe c;
        std::memcpy(c.v, mds_limbs + 4 * i, 32);
        fe_mul(s->f, s->mds[i], c, r2);
    }
    std::lock_guard<std::mutex> lk(g_mu);
    g_specs.push_back(s);
    return (long)g_specs.size() - 1;
}

// state0: t*4 limbs canonical. out_trace: n_sboxes*3*4 limbs canonical
// (x2, x4, x5 per S-box, allocation order). out_digest: 4 limbs.
void lurk_poseidon_trace(long h, const u64* state0_limbs,
                         u64* out_trace, u64* out_digest) {
    const Spec& sp = spec_at(h);
    const Field& f = sp.f;
    int t = sp.t;
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    std::vector<Fe> st(t), nxt(t);
    for (int i = 0; i < t; i++) {
        Fe x;
        std::memcpy(x.v, state0_limbs + 4 * i, 32);
        fe_mul(f, st[i], x, r2);             // to Montgomery
    }
    size_t tr = 0;
    int off = 0;
    Fe one = {{1, 0, 0, 0}};

    auto sbox = [&](Fe& x) {
        Fe x2, x4, x5, out;
        fe_mul(f, x2, x, x);
        fe_mul(f, x4, x2, x2);
        fe_mul(f, x5, x4, x);
        fe_mul(f, out, x2, one);             // from Montgomery
        std::memcpy(out_trace + tr, out.v, 32); tr += 4;
        fe_mul(f, out, x4, one);
        std::memcpy(out_trace + tr, out.v, 32); tr += 4;
        fe_mul(f, out, x5, one);
        std::memcpy(out_trace + tr, out.v, 32); tr += 4;
        x = x5;
    };
    auto add_rc = [&]() {
        for (int i = 0; i < t; i++) fe_add(f, st[i], st[i], sp.rc[off + i]);
        off += t;
    };
    auto mds = [&]() {
        // result[j] = sum_i M[i][j] st[i]  (neptune orientation)
        for (int j = 0; j < t; j++) {
            Fe acc, tmp;
            std::memset(&acc, 0, sizeof(acc));
            for (int i = 0; i < t; i++) {
                fe_mul(f, tmp, sp.mds[i * t + j], st[i]);
                fe_add(f, acc, acc, tmp);
            }
            nxt[j] = acc;
        }
        st.swap(nxt);
    };

    int half = sp.rf / 2;
    for (int r = 0; r < half; r++) {
        add_rc();
        for (int i = 0; i < t; i++) sbox(st[i]);
        mds();
    }
    for (int r = 0; r < sp.rp; r++) {
        add_rc();
        sbox(st[0]);
        mds();
    }
    for (int r = 0; r < half; r++) {
        add_rc();
        for (int i = 0; i < t; i++) sbox(st[i]);
        mds();
    }
    Fe dg;
    fe_mul(f, dg, st[1], one);
    std::memcpy(out_digest, dg.v, 32);
}

// Batched digest-only hashing (store hydration waves): states0 is
// n * t * 4 limbs canonical; out n * 4 limbs.
void lurk_poseidon_hash_many(long h, const u64* states0, u64 n,
                             u64* out) {
    const Spec& sp = spec_at(h);
    const Field& f = sp.f;
    int t = sp.t;
    Fe r2;
    std::memcpy(r2.v, f.r2, 32);
    Fe one = {{1, 0, 0, 0}};
    std::vector<Fe> st(t), nxt(t);
    for (u64 k = 0; k < n; k++) {
        for (int i = 0; i < t; i++) {
            Fe x;
            std::memcpy(x.v, states0 + (k * t + i) * 4, 32);
            fe_mul(f, st[i], x, r2);
        }
        int off = 0;
        auto sbox = [&](Fe& x) {
            Fe x2, x4;
            fe_mul(f, x2, x, x);
            fe_mul(f, x4, x2, x2);
            fe_mul(f, x, x4, x);
        };
        auto add_rc = [&]() {
            for (int i = 0; i < t; i++)
                fe_add(f, st[i], st[i], sp.rc[off + i]);
            off += t;
        };
        auto mds = [&]() {
            for (int j = 0; j < t; j++) {
                Fe acc, tmp;
                std::memset(&acc, 0, sizeof(acc));
                for (int i = 0; i < t; i++) {
                    fe_mul(f, tmp, sp.mds[i * t + j], st[i]);
                    fe_add(f, acc, acc, tmp);
                }
                nxt[j] = acc;
            }
            st.swap(nxt);
        };
        int half = sp.rf / 2;
        for (int r = 0; r < half; r++) {
            add_rc();
            for (int i = 0; i < t; i++) sbox(st[i]);
            mds();
        }
        for (int r = 0; r < sp.rp; r++) {
            add_rc();
            sbox(st[0]);
            mds();
        }
        for (int r = 0; r < half; r++) {
            add_rc();
            for (int i = 0; i < t; i++) sbox(st[i]);
            mds();
        }
        Fe dg;
        fe_mul(f, dg, st[1], one);
        std::memcpy(out + k * 4, dg.v, 32);
    }
}

}
