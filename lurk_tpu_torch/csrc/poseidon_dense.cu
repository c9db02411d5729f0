// Batched Poseidon with the dense schedule (K2).
//
// Replaces the JAX package's TPU kernel
// lurk_tpu/poseidon/pallas_nib12.py (build_pallas_nib12_hasher :125), the
// per-shard kernel of parallel/sharding.py's shard_hash_batch; it also
// computes what pallas_nib.py:build_pallas_nib_hasher (K3a),
// pallas_mxu.py:build_pallas_mxu_hasher (K4a) and
// pallas_kernel.py:build_pallas_hasher (K5) compute, with their schedule:
// the spec's round constants and a full t x t MDS every round. The plain
// PyTorch version is lurk_tpu_torch/poseidon/kernel.py:
// poseidon_hash_dense_plain; the host oracle is poseidon/host.py.
//
// Bound on this card: 32-bit integer multiply-adds (IMAD). The digest
// needs at least 200,104 IMAD per arity-4 hash (chip_smoke.py's
// imad_per_hash, the sparse schedule's count) for 320 bytes of input and
// output; the dense schedule itself needs 314,792 (64 rounds of 5 MDS
// rows of 5 products, each row reduced once; this kernel's thread shape
// does 320,360), so this kernel can reach at most 63.6% of the digest's
// bound.
//
// What the design does about it (csrc/poseidon_common.cuh):
// - Arithmetic: the S-box squares twice (fe::sqr) and multiplies once;
//   each MDS row is summed unreduced and reduced once (redc_wide), the
//   MDS staged times 2^32. The round constants and the MDS
//   ((RF+RP) t + t^2 elements, at most 21 KB at t = 9) are staged once
//   per block in shared memory.
// - Two shapes, one launcher, chosen by the batch B against
//   kThreadFrom: below it a group of 8 lanes (16 at t = 9) per hash,
//   lane j forming MDS row j over the broadcast elements, so a small
//   shard spreads over 8-16x the threads and a partial round's
//   dependent chain is the S-box, one product and one reduction; from
//   it one thread per hash, which issues the fewest instructions per
//   hash once the batch fills the card. kThreadFrom = 2^14: on the card
//   (chip_smoke.py phase 0.5) the group shape was faster up to 2^13 and
//   the thread shape from 2^14, Poseidon-4 over Pallas and Poseidon-8
//   over BN256 alike (at 2^13: 0.698 / 0.916 ms and 1.821 / 2.741 ms,
//   group / thread; at 2^14: 1.352 / 0.919 and 3.570 / 2.759).
// - ptxas (sm_90a): the group kernel 64, 56, 66 and 56 registers at
//   t = 4/5/7/9, the thread kernel 90, 114, 136 and 156; 0 bytes of
//   stack and spills in all eight. SASS (cuobjdump, static count of the
//   thread kernel at t = 9): 42% IMAD, 46% adds and selects.
// - Measured (chip_smoke.py on an H100 80GB HBM3, 700.00 W power limit):
//   fib(100)'s sharded hydration (shards of 64, 256, 64 and 128) 0.258-
//   0.362 ms a launch in the group shape, 2.677 ms for its eight;
//   Poseidon-4 over Pallas 5.691 ms at 2^17 and 44.032 ms at 2^20 in
//   the thread shape, 28.5% of the digest's bound (45% of the dense
//   schedule's own).
//
// Layout: x is int32[arity, 16, B] (16-bit limbs, limb-major, batch
// last), out is int32[16, B]. k is the buffer of kernel.py:
// dense_constants: a 24-word header (p, R^2 mod p, -p^{-1} mod 2^32),
// then in Montgomery form rc[(RF+RP) t] (the domain tag folded into
// rc[0], the state's slot 0 starting at 0) and mds[t][t], row j holding
// M[i][j] over i (out[j] = sum_i M[i][j] s[i], neptune's orientation).
#include <stdint.h>

#include "poseidon_common.cuh"

namespace k2 {

using pos::ld;

// batches of at least this many hashes take one thread per hash
constexpr long long kThreadFrom = 1 << 14;

// Element offsets (after the header) of the buffer's parts.
struct Tables {
  int t, rf, rp;
  FE_FN int mds() const { return (rf + rp) * t; }
  FE_FN int n_elems() const { return mds() + t * t; }
  FE_FN bool scaled(int e) const { return e >= mds(); }
  FE_FN bool full(int r) const { return r < rf / 2 || r >= rf / 2 + rp; }
};

// One thread per hash; scratch as k1::Thread's.
template <int T>
struct Thread {
  const uint32_t* el;
  uint32_t* scratch;
  int stride;
  pos::Field f;
  Tables tb;

  FE_FN const uint32_t* elem(int e) const { return el + fe::N * e; }

  FE_FN void hash(const uint32_t* x, uint32_t* out, long long b, long long B,
                  const uint32_t r2[fe::N]) const {
    uint32_t s[T][fe::N];
    f.load_inputs<T>(s, x, b, B, r2);
    // round r: constants into every element, S-box on every element in
    // full rounds and on element 0 in partial rounds, then the MDS
#pragma unroll 1
    for (int r = 0; r < tb.rf + tb.rp; ++r) {
#pragma unroll
      for (int i = 0; i < T; ++i) {
        uint32_t c[fe::N];
        ld(c, elem(r * T + i));
        fe::add(s[i], s[i], c, f.p);
      }
      f.sbox(s[0]);
      if (tb.full(r)) {
#pragma unroll
        for (int i = 1; i < T; ++i) f.sbox(s[i]);
      }
      f.mix<T>(s, elem(tb.mds()), scratch, stride);
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

  FE_FN void hash(const uint32_t* x, uint32_t* out, long long b, long long B,
                  const uint32_t r2[fe::N], bool store) const {
    uint32_t s[L][fe::N];
    g.load_inputs(s, x, b, B, r2);
#pragma unroll 1
    for (int r = 0; r < tb.rf + tb.rp; ++r) {
      g.add(s, elem(r * T));
      g.sbox(s, tb.full(r));
      g.mix(s, elem(tb.mds()));
    }
    g.store(out, s, b, B, store);
  }
};

}  // namespace k2

#ifdef __CUDACC__

namespace k2 {

template <int T>
int launch(const uint32_t* x, uint32_t* out, const uint32_t* k, int rf,
           int rp, long long B, cudaStream_t stream) {
  return pos::launch<T, Tables, Thread, Group>(x, out, k, rf, rp, B,
                                             kThreadFrom, stream);
}

}  // namespace k2

// Hash B preimages of the given arity; returns a CUDA error code (0 on
// success).
extern "C" int lurk_poseidon_dense(const void* x, void* out,
                                   const void* consts, int arity, int rf,
                                   int rp, long long B, void* stream) {
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t* k = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || rf < 2 || rp < 1) return (int)cudaErrorInvalidValue;
  switch (arity) {
    case 3: return k2::launch<4>(xi, o, k, rf, rp, B, s);
    case 4: return k2::launch<5>(xi, o, k, rf, rp, B, s);
    case 6: return k2::launch<7>(xi, o, k, rf, rp, B, s);
    case 8: return k2::launch<9>(xi, o, k, rf, rp, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The batch from which lurk_poseidon_dense takes one thread per hash.
extern "C" long long lurk_poseidon_dense_thread_from() {
  return k2::kThreadFrom;
}

#endif  // __CUDACC__
