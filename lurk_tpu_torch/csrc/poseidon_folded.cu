// Batched Poseidon with the folded partial span.
//
// Replaces the JAX package's two TPU kernels of this schedule:
// lurk_tpu/poseidon/pallas_nib.py:build_pallas_nib_opt_hasher (K3b, int8
// digit planes) and lurk_tpu/poseidon/pallas_mxu.py:
// build_pallas_mxu_opt_hasher (K4b, bf16 planes; it stops at arity 4,
// this kernel takes arities 3/4/6/8). The plain PyTorch version is
// lurk_tpu_torch/poseidon/kernel.py:poseidon_hash_folded_plain; the host
// oracle is poseidon/host.py:hash_preimage (the same digests as K1/K2).
//
// Schedule (poseidon/partial_opt.py): the RF/2 full rounds on each side
// run the spec's way (constants, S-box on every element, MDS). Between
// them only element 0 meets the S-box, so the span is folded: partial
// round r's S-box input is
//   u_r = alpha_r . s_a + beta_r + sum_{q<r} gamma_{r-1-q} delta_q
// over the state s_a entering the span and the earlier S-box outputs
// delta_q = u_q^5, and the state leaving the span is rebuilt once as
//   A s_a + B + W delta.
//
// Bound on this card: 32-bit integer multiply-adds. The digest needs at
// least 200,104 of them per arity-4 hash (the sparse schedule, squarings
// as squarings and one reduction per mix row; chip_smoke.py's
// imad_per_hash). This schedule, counted the same way, needs about
// 378,000: the quadratic window sum_{q<r} makes the span 56 rows of
// 5 + r terms (1,820 products), and the rebuild 5 rows of 61 more. So it
// can reach at most about 53% of the digest's bound.
//
// Design: a group of kGroup = 8 lanes of one warp works on one hash.
// - The history stays in registers. Lane l keeps delta_q for q = l mod 8
//   (at most 8 of the 56-57: slot q / 8), and the state elements
//   e = l mod 8 (two at t = 9). Every loop that indexes these arrays is
//   unrolled over the slot and rolled over the lane phase, so each index
//   is a compile-time constant and nothing goes to local memory.
// - One reduction per row. Each lane sums its share of a row (its
//   elements' and its deltas' products) unreduced, 512-bit products in
//   a 17-word accumulator (field.cuh's wide_mac), the group adds its
//   lanes' accumulators with __shfl_xor_sync, and every lane reduces the
//   row once (redc_wide, R' = 2^288; the tables' product factors are
//   staged times 2^32 for it) and applies the S-box, so delta_r is known
//   to all eight and kept by lane r mod 8. The rebuild A s_a + B + W
//   delta is split the same way, one row at a time. A full round's MDS
//   row j is summed by lane j mod 8 over all t S-box outputs, broadcast
//   with __shfl_sync.
// - The S-box of the span (three products on the row's critical path)
//   runs on all eight lanes at once: that is the price of the split,
//   and with the shuffles what bounds the kernel now (it does about 1.9x
//   the digest's least work, plus the eight lanes' redundant S-boxes).
// - ptxas (chip_smoke.py's build log): 152 registers at t = 4/5/7 and
//   160 at t = 9, 0 bytes of stack at every width.
// - All tables (full rounds' keys, the MDS and the six folded tables:
//   1,383 elements, 44 KB at t = 9) are staged once per block in dynamic
//   shared memory, where a group's lanes read distinct elements and the
//   groups of a warp read the same ones.
//
// Layout: x is int32[arity, 16, B] (16-bit limbs, limb-major, batch
// last), out is int32[16, B]. k is the buffer of kernel.py:
// folded_constants: a 24-word header (p, R^2 mod p, -p^{-1} mod 2^32),
// then in Montgomery form rc[RF][t] (the full rounds' constants, the
// domain tag folded into rc[0][0]), mds[t][t] (row j holding M[i][j] over
// i), alpha[RP][t], beta[RP], gamma[RP], a_mat[t][t], b_vec[t] and
// w_mat[t][RP].
//
// The body is written over Lanes: on the card each thread is one lane
// (Lanes::L = 1, shuffles); on the host (g++, tests) one call runs the
// group's eight lanes as arrays (Lanes::L = 8), so the same code is
// checked off the card.
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int kHeaderWords = 24;
constexpr int kGroup = 8;               // lanes per hash
constexpr int kThreads = 256;           // 32 hashes a block
constexpr int kMaxRp = 64;
constexpr int kDeltaSlots = kMaxRp / kGroup; // deltas per lane

FE_FN void ld(uint32_t r[fe::N], const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < fe::N; ++i) r[i] = src[i];
}

// Offsets (in elements, after the header) of the folded buffer's tables.
struct Tables {
  int t, rf, rp;
  FE_FN int mds() const { return rf * t; }
  FE_FN int alpha() const { return mds() + t * t; }
  FE_FN int beta() const { return alpha() + rp * t; }
  FE_FN int gamma() const { return beta() + rp; }
  FE_FN int a_mat() const { return gamma() + rp; }
  FE_FN int b_vec() const { return a_mat() + t * t; }
  FE_FN int w_mat() const { return b_vec() + t; }
  FE_FN int n_elems() const { return w_mat() + t * rp; }
  // element e multiplies a state value (and is staged times 2^32)
  FE_FN bool product(int e) const {
    return (e >= mds() && e < beta()) || (e >= gamma() && e < b_vec()) ||
           e >= w_mat();
  }
};

// Stage element e of the buffer k into elems: factors of products times
// 2^32 (for redc_wide), the added constants as they are.
FE_FN void stage_elem(int e, const uint32_t* k, const Tables& tb,
                      uint32_t* elems) {
  uint32_t v[fe::N], p[fe::N], r2[fe::N];
  ld(v, k + kHeaderWords + fe::N * e);
  if (tb.product(e)) {
    ld(p, k);
    ld(r2, k + 8);
    fe::scale_32(v, v, r2, p, k[16]);
  }
#pragma unroll
  for (int i = 0; i < fe::N; ++i) elems[fe::N * e + i] = v[i];
}

#ifdef __CUDACC__
// One lane per thread: lane = threadIdx.x mod 8.
struct DeviceLanes {
  static constexpr int L = 1;
  __device__ __forceinline__ static int lane(int) {
    return threadIdx.x & (kGroup - 1);
  }
  // every lane's acc becomes the group's sum
  __device__ __forceinline__ static void sum(uint32_t acc[L][fe::W]) {
#pragma unroll
    for (int m = 1; m < kGroup; m <<= 1) {
      uint32_t o[fe::W];
#pragma unroll
      for (int w = 0; w < fe::W; ++w)
        o[w] = __shfl_xor_sync(0xFFFFFFFFu, acc[0][w], m, kGroup);
      fe::wide_sum(acc[0], o);
    }
  }
  // out = v of lane src, in every lane
  __device__ __forceinline__ static void bcast(uint32_t out[L][fe::N],
                                               uint32_t v[L][fe::N], int src) {
#pragma unroll
    for (int w = 0; w < fe::N; ++w)
      out[0][w] = __shfl_sync(0xFFFFFFFFu, v[0][w], src, kGroup);
  }
};
#endif

// The whole group in one thread (host check).
struct HostLanes {
  static constexpr int L = kGroup;
  static int lane(int ln) { return ln; }
  static void sum(uint32_t acc[L][fe::W]) {
    for (int ln = 1; ln < L; ++ln) fe::wide_sum(acc[0], acc[ln]);
    for (int ln = 1; ln < L; ++ln)
      for (int w = 0; w < fe::W; ++w) acc[ln][w] = acc[0][w];
  }
  static void bcast(uint32_t out[L][fe::N], uint32_t v[L][fe::N], int src) {
    for (int ln = 0; ln < L; ++ln)
      for (int w = 0; w < fe::N; ++w) out[ln][w] = v[src][w];
  }
};

template <int T, class Lanes>
struct FoldedPoseidon {
  static constexpr int L = Lanes::L;
  static constexpr int kOwn = (T + kGroup - 1) / kGroup;   // elements a lane
  const uint32_t* elems;   // the staged tables (shared memory on the card)
  uint32_t p[fe::N];
  uint32_t pinv;
  Tables tb;

  FE_FN const uint32_t* elem(int e) const { return elems + fe::N * e; }

  FE_FN void sbox(uint32_t x[fe::N]) const {
    uint32_t x2[fe::N], x4[fe::N];
    fe::mul(x2, x, x, p, pinv);
    fe::mul(x4, x2, x2, p, pinv);
    fe::mul(x, x4, x, p, pinv);
  }

  // acc += (staged factor e) * v
  FE_FN void mac(uint32_t acc[fe::W], int e, const uint32_t v[fe::N]) const {
    uint32_t c[fe::N];
    ld(c, elem(e));
    fe::wide_mac(acc, c, v);
  }

  // full round r: constants and S-box on the lane's elements, then lane
  // j mod 8 sums MDS row j over every element
  FE_FN void full_round(uint32_t own[L][kOwn][fe::N], int r) const {
    uint32_t acc[L][kOwn][fe::W];
#pragma unroll
    for (int ln = 0; ln < L; ++ln)
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        const int e = kGroup * k + Lanes::lane(ln);
        fe::wide_zero(acc[ln][k]);
        if (e < T) {
          uint32_t c[fe::N];
          ld(c, elem(r * T + e));
          fe::add(own[ln][k], own[ln][k], c, p);
          sbox(own[ln][k]);
        }
      }
#pragma unroll
    for (int k2 = 0; k2 < kOwn; ++k2) {
      uint32_t src[L][fe::N], v[L][fe::N];
#pragma unroll
      for (int ln = 0; ln < L; ++ln) fe::copy(src[ln], own[ln][k2]);
#pragma unroll 1
      for (int l = 0; l < kGroup; ++l) {
        const int i = kGroup * k2 + l;
        if (i >= T) break;
        Lanes::bcast(v, src, l);
#pragma unroll
        for (int ln = 0; ln < L; ++ln)
#pragma unroll
          for (int k = 0; k < kOwn; ++k) {
            const int j = kGroup * k + Lanes::lane(ln);
            if (j < T) mac(acc[ln][k], tb.mds() + j * T + i, v[ln]);
          }
      }
    }
#pragma unroll
    for (int ln = 0; ln < L; ++ln)
#pragma unroll
      for (int k = 0; k < kOwn; ++k)
        if (kGroup * k + Lanes::lane(ln) < T)
          fe::redc_wide(own[ln][k], acc[ln][k], p, pinv);
  }

  // partial round r = kGroup s + l (s the slot, a constant here): u_r
  // summed by the group, S-box, delta_r kept by lane l in slot s
  template <int S>
  FE_FN void partial_round(const uint32_t own[L][kOwn][fe::N],
                           uint32_t dl[L][kDeltaSlots][fe::N], int l) const {
    const int r = kGroup * S + l;
    uint32_t acc[L][fe::W];
#pragma unroll
    for (int ln = 0; ln < L; ++ln) {
      const int lane = Lanes::lane(ln);
      fe::wide_zero(acc[ln]);
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        const int e = kGroup * k + lane;
        if (e < T) mac(acc[ln], tb.alpha() + r * T + e, own[ln][k]);
      }
#pragma unroll
      for (int s2 = 0; s2 <= S; ++s2) {
        const int q = kGroup * s2 + lane;
        if (q < r) mac(acc[ln], tb.gamma() + r - 1 - q, dl[ln][s2]);
      }
    }
    Lanes::sum(acc);
#pragma unroll
    for (int ln = 0; ln < L; ++ln) {
      uint32_t u[fe::N], c[fe::N];
      fe::redc_wide(u, acc[ln], p, pinv);
      ld(c, elem(tb.beta() + r));
      fe::add(u, u, c, p);
      sbox(u);
      if (Lanes::lane(ln) == l) fe::copy(dl[ln][S], u);
    }
  }

  template <int S>
  FE_FN void span_slot(const uint32_t own[L][kOwn][fe::N],
                       uint32_t dl[L][kDeltaSlots][fe::N]) const {
#pragma unroll 1
    for (int l = 0; l < kGroup; ++l) {
      if (kGroup * S + l >= tb.rp) break;
      partial_round<S>(own, dl, l);
    }
  }

  // the partial span on own = s_a, then s = A s_a + B + W delta
  FE_FN void span(uint32_t own[L][kOwn][fe::N]) const {
    uint32_t dl[L][kDeltaSlots][fe::N];
#pragma unroll
    for (int ln = 0; ln < L; ++ln)
#pragma unroll
      for (int s = 0; s < kDeltaSlots; ++s)
#pragma unroll
        for (int w = 0; w < fe::N; ++w) dl[ln][s][w] = 0;
    span_slot<0>(own, dl);
    span_slot<1>(own, dl);
    span_slot<2>(own, dl);
    span_slot<3>(own, dl);
    span_slot<4>(own, dl);
    span_slot<5>(own, dl);
    span_slot<6>(own, dl);
    span_slot<7>(own, dl);
    static_assert(kDeltaSlots == 8, "span_slot calls follow kDeltaSlots");
    uint32_t next[L][kOwn][fe::N];
#pragma unroll
    for (int k2 = 0; k2 < kOwn; ++k2) {
#pragma unroll 1
      for (int l = 0; l < kGroup; ++l) {
        const int i = kGroup * k2 + l;
        if (i >= T) break;
        uint32_t acc[L][fe::W];
#pragma unroll
        for (int ln = 0; ln < L; ++ln) {
          const int lane = Lanes::lane(ln);
          fe::wide_zero(acc[ln]);
#pragma unroll
          for (int k = 0; k < kOwn; ++k) {
            const int e = kGroup * k + lane;
            if (e < T) mac(acc[ln], tb.a_mat() + i * T + e, own[ln][k]);
          }
#pragma unroll
          for (int s = 0; s < kDeltaSlots; ++s) {
            const int q = kGroup * s + lane;
            if (q < tb.rp) mac(acc[ln], tb.w_mat() + i * tb.rp + q, dl[ln][s]);
          }
        }
        Lanes::sum(acc);
#pragma unroll
        for (int ln = 0; ln < L; ++ln) {
          if (Lanes::lane(ln) != l) continue;
          uint32_t v[fe::N], c[fe::N];
          fe::redc_wide(v, acc[ln], p, pinv);
          ld(c, elem(tb.b_vec() + i));
          fe::add(next[ln][k2], v, c, p);
        }
      }
    }
#pragma unroll
    for (int ln = 0; ln < L; ++ln)
#pragma unroll
      for (int k = 0; k < kOwn; ++k)
        if (kGroup * k + Lanes::lane(ln) < T) fe::copy(own[ln][k], next[ln][k]);
  }

  // hash b: x holds limb-major 16-bit limbs, stride B between limbs; r2
  // is R^2 mod p. With `store` false the lanes only take part.
  FE_FN void hash(const uint32_t* x, uint32_t* out, long long b, long long B,
                  const uint32_t r2[fe::N], bool store) const {
    uint32_t own[L][kOwn][fe::N];
#pragma unroll
    for (int ln = 0; ln < L; ++ln)
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        const int e = kGroup * k + Lanes::lane(ln);
#pragma unroll
        for (int w = 0; w < fe::N; ++w) own[ln][k][w] = 0;
        if (e == 0 || e >= T) continue;
        const uint32_t* xa = x + (long long)(e - 1) * 16 * B + b;
        uint32_t v[fe::N];
#pragma unroll
        for (int w = 0; w < fe::N; ++w)
          v[w] = xa[(2 * w) * B] | (xa[(2 * w + 1) * B] << 16);
        fe::to_mont(own[ln][k], v, r2, p, pinv);
      }
    const int half = tb.rf / 2;
#pragma unroll 1
    for (int r = 0; r < half; ++r) full_round(own, r);
    span(own);
#pragma unroll 1
    for (int r = half; r < tb.rf; ++r) full_round(own, r);
#pragma unroll
    for (int ln = 0; ln < L; ++ln) {
      if (!store || Lanes::lane(ln) != 1) continue;   // the digest, s[1]
      uint32_t d[fe::N];
      fe::from_mont(d, own[ln][0], p, pinv);
#pragma unroll
      for (int w = 0; w < fe::N; ++w) {
        out[(2 * w) * B + b] = d[w] & 0xFFFFu;
        out[(2 * w + 1) * B + b] = d[w] >> 16;
      }
    }
  }
};

template <int T, class Lanes>
FE_FN FoldedPoseidon<T, Lanes> make_folded(const uint32_t* header,
                                           const uint32_t* elems, int rf,
                                           int rp) {
  FoldedPoseidon<T, Lanes> h;
  h.elems = elems;
  ld(h.p, header);
  h.pinv = header[16];
  h.tb = Tables{T, rf, rp};
  return h;
}

}  // namespace

#ifdef __CUDACC__

#include <cuda_runtime.h>

// Needs every thread of a block: the groups' lanes shuffle with a full
// mask, so a lane past B hashes lane B - 1 again and stores nothing.
// One block an SM at least, so nvcc may take the registers it needs:
// under the 128 it chose for two blocks it spilled 32 bytes at t = 4/5/7
// and ran slower on the H100.
template <int T>
__global__ void __launch_bounds__(kThreads, 1)
poseidon_folded_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ k, int rf, int rp,
                       long long B) {
  extern __shared__ uint32_t elems[];
  const Tables tb{T, rf, rp};
  for (int e = threadIdx.x; e < tb.n_elems(); e += blockDim.x)
    stage_elem(e, k, tb, elems);
  __syncthreads();
  const long long b =
      (long long)blockIdx.x * (kThreads / kGroup) + threadIdx.x / kGroup;
  uint32_t header[kHeaderWords];
#pragma unroll
  for (int i = 0; i < kHeaderWords; ++i) header[i] = __ldg(k + i);
  make_folded<T, DeviceLanes>(header, elems, rf, rp)
      .hash(x, out, b < B ? b : B - 1, B, header + 8, b < B);
}

template <int T>
static int launch(const uint32_t* x, uint32_t* out, const uint32_t* k,
                  int rf, int rp, long long B, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) * fe::N * Tables{T, rf, rp}.n_elems();
  cudaError_t err = cudaFuncSetAttribute(
      poseidon_folded_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long per = kThreads / kGroup;
  const unsigned blocks = (unsigned)((B + per - 1) / per);
  poseidon_folded_kernel<T><<<blocks, kThreads, smem, stream>>>(x, out, k,
                                                               rf, rp, B);
  return (int)cudaGetLastError();
}

// Hash B preimages of the given arity; returns a CUDA error code (0 on
// success).
extern "C" int lurk_poseidon_folded(const void* x, void* out,
                                    const void* consts, int arity, int rf,
                                    int rp, long long B, void* stream) {
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t* k = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || rf < 2 || rf % 2 || rp < 1 || rp > kMaxRp)
    return (int)cudaErrorInvalidValue;
  switch (arity) {
    case 3: return launch<4>(xi, o, k, rf, rp, B, s);
    case 4: return launch<5>(xi, o, k, rf, rp, B, s);
    case 6: return launch<7>(xi, o, k, rf, rp, B, s);
    case 8: return launch<9>(xi, o, k, rf, rp, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // __CUDACC__
