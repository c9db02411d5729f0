// Batched Poseidon with the sparse partial-round schedule (opt_spec), K1.
//
// Replaces the JAX package's TPU kernel
// lurk_tpu/poseidon/pallas_nib12_opt.py (build_pallas_nib12_opt_hasher),
// computing the same Neptune-compatible digests; the plain PyTorch version
// is lurk_tpu_torch/poseidon/kernel.py:poseidon_hash_plain.
//
// Bound on this card: 32-bit integer multiply-adds (IMAD). At arity 4 a
// hash moves 320 B (64 B of limbs per input element read as int32
// words, 64 B of digest) and needs at least 200,104 IMAD (squarings as
// squarings, one reduction per mix row; chip_smoke.py's imad_per_hash),
// some 600 operations per byte; this kernel's thread shape does 201,864.
//
// What the design does about it (csrc/poseidon_common.cuh):
// - Arithmetic: the S-box squares twice (fe::sqr, 36 wide products) and
//   multiplies once; each mix row (the dense rows and each sparse
//   round's s0' = m00 s0 + sum_j w_j s_j) is summed unreduced and
//   reduced once (redc_wide), its factors staged times 2^32; the rest of
//   a sparse round (s_j += v_hat_j s0) is one CIOS product per element.
//   All constants (54,912 B at t = 9) are staged once per block in
//   shared memory.
// - Two shapes, one launcher, chosen by the batch B against
//   kThreadFrom: below it a group of 8 lanes (16 at t = 9, so that no
//   lane holds two elements and none carries a second row's latency)
//   per hash, so a small hydration wave spreads over 8-16x the threads
//   and a partial round's dependent chain is the S-box, one broadcast
//   product or one group sum, and one reduction; from it one thread per
//   hash, which issues the fewest instructions per hash once the batch
//   fills the card. kThreadFrom = 2^14: on the card (chip_smoke.py phase
//   0.5, both shapes timed) the group shape was faster up to 2^13 and
//   the thread shape from 2^14, Poseidon-4 over Pallas and Poseidon-8
//   over BN256 alike (at 2^13: 0.672 / 0.678 ms and 1.313 / 1.464 ms,
//   group / thread; at 2^14: 1.351 / 0.692 and 2.567 / 1.470).
// - ptxas (sm_90a): the group kernel 68, 66, 64 and 70 registers at
//   t = 4/5/7/9, the thread kernel 86, 112, 142 and 154; 0 bytes of
//   stack and spills in all eight. SASS (cuobjdump, static count of the
//   thread kernel at t = 9): 42% IMAD, 46% the adds and selects of the
//   carries and conditional subtractions.
// - Measured (chip_smoke.py on an H100 80GB HBM3, 700.00 W power limit):
//   fib(100)'s four hydration waves (arity 8 x 114, 344, 226 and arity
//   4 x 123) 0.225-0.237 ms a launch in the group shape, 0.926 ms for
//   the four; Poseidon-4 over Pallas 3.694 ms at 2^17 and 29.703 ms at
//   2^20 in the thread shape, 42.2% of the IMAD bound. The thread shape
//   runs 16 warps an SM (registers and shared memory), too few to hide
//   its carry chains: the IMAD pipe stays under half busy.
//
// Layout: x is int32[arity, 16, B] (16-bit limbs, limb-major, batch
// last), out is int32[16, B]. k is the constant buffer of
// kernel.py:constants: a 24-word header (p, R^2 mod p, -p^{-1} mod 2^32)
// and then, in Montgomery form, pre[t], post[RF+RP][t], mds[t][t],
// tail[t][t] (pre_sparse) and sparse[RP][2t-1] = m00, w[t-1], v_hat[t-1].
#include <stdint.h>

#include "poseidon_common.cuh"

namespace k1 {

using pos::ld;

// batches of at least this many hashes take one thread per hash
constexpr long long kThreadFrom = 1 << 14;

// Element offsets (after the header) of the buffer's parts.
struct Tables {
  int t, rf, rp;
  FE_FN int post() const { return t; }
  FE_FN int mds() const { return t + (rf + rp) * t; }
  FE_FN int tail() const { return mds() + t * t; }
  FE_FN int sparse() const { return tail() + t * t; }
  FE_FN int n_elems() const { return sparse() + rp * (2 * t - 1); }
  // element e is a mix-row factor (staged times 2^32): the dense
  // matrices, and m00 and w of each sparse round
  FE_FN bool scaled(int e) const {
    if (e < mds()) return false;
    if (e < sparse()) return true;
    return (e - sparse()) % (2 * t - 1) < t;
  }
  FE_FN bool full(int r) const { return r < rf / 2 || r >= rf / 2 + rp; }
  // the round whose mix is sparse[0], then sparse[k] in round first + k
  FE_FN int first_sparse() const { return rf / 2 - 1; }
  FE_FN bool sparse_round(int r) const {
    return r >= first_sparse() && r < rf / 2 + rp - 1;
  }
  // the dense matrix of a round that is not sparse
  FE_FN int dense(int r) const {
    return r == rf / 2 + rp - 1 ? tail() : mds();
  }
};

// One thread per hash; scratch word (e, w) of the thread's dense rows at
// scratch[(e N + w) stride] (shared memory on the card).
template <int T>
struct Thread {
  const uint32_t* el;
  uint32_t* scratch;
  int stride;
  pos::Field f;
  Tables tb;

  FE_FN const uint32_t* elem(int e) const { return el + fe::N * e; }

  FE_FN void add(uint32_t s[T][fe::N], int off) const {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint32_t c[fe::N];
      ld(c, elem(off + i));
      fe::add(s[i], s[i], c, f.p);
    }
  }

  // sparse[kk]: s0' = m00 s0 + sum_j w_j s_j; s_j' = s_j + v_hat_j s0
  FE_FN void sparse(uint32_t s[T][fe::N], int kk) const {
    const int off = tb.sparse() + kk * (2 * T - 1);
    uint32_t n0[fe::N];
    f.row<T>(n0, elem(off), s);
#pragma unroll
    for (int j = 1; j < T; ++j) {
      uint32_t c[fe::N], prod[fe::N];
      ld(c, elem(off + T + j - 1));
      fe::mul(prod, s[0], c, f.p, f.pinv);
      fe::add(s[j], s[j], prod, f.p);
    }
    fe::copy(s[0], n0);
  }

  FE_FN void hash(const uint32_t* x, uint32_t* out, long long b, long long B,
                  const uint32_t r2[fe::N]) const {
    uint32_t s[T][fe::N];
    f.load_inputs<T>(s, x, b, B, r2);
    add(s, 0);                              // pre_keys, the tag folded in
#pragma unroll 1
    for (int r = 0; r < tb.rf + tb.rp; ++r) {
      f.sbox(s[0]);
      if (tb.full(r)) {
#pragma unroll
        for (int i = 1; i < T; ++i) f.sbox(s[i]);
      }
      if (tb.sparse_round(r))
        sparse(s, r - tb.first_sparse());
      else
        f.mix<T>(s, elem(tb.dense(r)), scratch, stride);
      add(s, tb.post() + r * T);
    }
    f.store(out, s[1], b, B);
  }
};

// A group of lanes per hash (poseidon_common.cuh's Group).
template <int T, class Lanes>
struct Group {
  static constexpr int L = Lanes::L;
  const uint32_t* el;
  pos::Group<T, Lanes> g;
  Tables tb;

  FE_FN const uint32_t* elem(int e) const { return el + fe::N * e; }

  // sparse[kk]: each lane's term of s0' summed by the group and reduced
  // (kept by lane 0) while lane j >= 1 adds v_hat_j s0
  FE_FN void sparse(uint32_t s[L][fe::N], int kk) const {
    const int off = tb.sparse() + kk * (2 * T - 1);
    uint32_t acc[L][fe::W], s0[L][fe::N];
#pragma unroll
    for (int ln = 0; ln < L; ++ln) {
      const int e = Lanes::lane(ln);
      fe::wide_zero(acc[ln]);
      if (e < T) {
        uint32_t c[fe::N];
        ld(c, elem(off + e));
        fe::wide_mac(acc[ln], c, s[ln]);
      }
    }
    Lanes::bcast(s0, s, 0);
    Lanes::sum(acc);
#pragma unroll
    for (int ln = 0; ln < L; ++ln) {
      const int e = Lanes::lane(ln);
      uint32_t n0[fe::N], c[fe::N], v[fe::N];
      fe::redc_wide(n0, acc[ln], g.f.p, g.f.pinv);
      ld(c, elem(off + T + (e >= 1 && e < T ? e - 1 : 0)));
      fe::mul(v, s0[ln], c, g.f.p, g.f.pinv);
      fe::add(v, s[ln], v, g.f.p);
#pragma unroll
      for (int w = 0; w < fe::N; ++w)
        s[ln][w] = e == 0 ? n0[w] : (e < T ? v[w] : s[ln][w]);
    }
  }

  FE_FN void hash(const uint32_t* x, uint32_t* out, long long b, long long B,
                  const uint32_t r2[fe::N], bool store) const {
    uint32_t s[L][fe::N];
    g.load_inputs(s, x, b, B, r2);
    g.add(s, elem(0));                      // pre_keys
#pragma unroll 1
    for (int r = 0; r < tb.rf + tb.rp; ++r) {
      g.sbox(s, tb.full(r));
      if (tb.sparse_round(r))
        sparse(s, r - tb.first_sparse());
      else
        g.mix(s, elem(tb.dense(r)));
      g.add(s, elem(tb.post() + r * T));
    }
    g.store(out, s, b, B, store);
  }
};

}  // namespace k1

#ifdef __CUDACC__

namespace k1 {

template <int T>
int launch(const uint32_t* x, uint32_t* out, const uint32_t* k, int rf,
           int rp, long long B, cudaStream_t stream) {
  return pos::launch<T, Tables, Thread, Group>(x, out, k, rf, rp, B,
                                             kThreadFrom, stream);
}

}  // namespace k1

// Hash B preimages of the given arity; returns a CUDA error code (0 on
// success).
extern "C" int lurk_poseidon_sparse(const void* x, void* out,
                                    const void* consts, int arity, int rf,
                                    int rp, long long B, void* stream) {
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t* k = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || rf < 2 || rp < 1) return (int)cudaErrorInvalidValue;
  switch (arity) {
    case 3: return k1::launch<4>(xi, o, k, rf, rp, B, s);
    case 4: return k1::launch<5>(xi, o, k, rf, rp, B, s);
    case 6: return k1::launch<7>(xi, o, k, rf, rp, B, s);
    case 8: return k1::launch<9>(xi, o, k, rf, rp, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The batch from which lurk_poseidon_sparse takes one thread per hash.
extern "C" long long lurk_poseidon_sparse_thread_from() {
  return k1::kThreadFrom;
}

#endif  // __CUDACC__
