// Batched Poseidon with the sparse partial-round schedule (opt_spec).
//
// Replaces the JAX package's TPU kernel
// lurk_tpu/poseidon/pallas_nib12_opt.py (build_pallas_nib12_opt_hasher),
// computing the same Neptune-compatible digests; the plain PyTorch version
// is lurk_tpu_torch/poseidon/kernel.py:poseidon_hash_plain.
//
// Design: one thread per hash, the whole t-element state in registers
// (8 x 32-bit limbs per element), constants read through the read-only
// cache (every thread of a warp reads the same word, so each load is a
// broadcast). Tensor cores are left alone: the TPU kernel's int8 digit
// planes exist to feed its matrix unit, and Hopper's 32-bit integer
// multiply-add needs no such split.
//
// Bound on this card: 32-bit integer multiply-add throughput. At arity 4
// a hash moves 320 B (64 B of limbs per input element read as int32
// words, 64 B of digest) but does ~1e3 field products of ~264
// multiply-adds each (CIOS with 8 limbs: 2 * 64 wide products for a*b,
// 2 * 64 for m*p, 8 for m), about 1e3 operations per byte. The function
// needs about a quarter less (squarings as squarings, one reduction per
// mix row); chip_smoke.py bounds the kernel by that count.
//
// The rounds run as one loop whose body holds one S-box per element,
// one sparse mix and one dense-mix row (the rows staged in shared
// memory), so the code stays small and nvcc builds it in seconds, not
// minutes. Arity 8 (t = 9) keeps 72 state registers and may spill;
// ptxas -v reports it in the build log.
//
// Layout: x is int32[arity, 16, B] (16-bit limbs, limb-major, batch
// last), out is int32[16, B]. k is the constant buffer of
// kernel.py:constants: a 24-word header (p, R^2 mod p, -p^{-1} mod 2^32)
// and then, in Montgomery form, pre[t], post[RF+RP][t], mds[t][t],
// tail[t][t] (pre_sparse) and sparse[RP][2t-1] = m00, w[t-1], v_hat[t-1].
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int kHeaderWords = 24;
constexpr int kThreads = 128;

template <int T>
struct Poseidon {
  const uint32_t* k;
  // scratch word (e, w) of this thread's dense-mix output at
  // scratch[(e * N + w) * stride]: shared memory on the card
  uint32_t* scratch;
  int stride;
  uint32_t p[fe::N];
  uint32_t pinv;
  int rf, rp;

  FE_FN const uint32_t* elem(int e) const {
    return k + kHeaderWords + fe::N * e;
  }
  FE_FN int post_off() const { return T; }
  FE_FN int mds_off() const { return T + (rf + rp) * T; }
  FE_FN int tail_off() const { return mds_off() + T * T; }
  FE_FN int sparse_off() const { return tail_off() + T * T; }

  FE_FN void sbox(uint32_t x[fe::N]) const {
    uint32_t x2[fe::N], x4[fe::N];
    fe::mul(x2, x, x, p, pinv);
    fe::mul(x4, x2, x2, p, pinv);
    fe::mul(x, x4, x, p, pinv);
  }

  // acc += s * (element e), the multiply-accumulate of the mixes
  FE_FN void mac(uint32_t acc[fe::N], const uint32_t s[fe::N], int e) const {
    uint32_t c[fe::N], prod[fe::N];
    fe::load(c, elem(e));
    fe::mul(prod, s, c, p, pinv);
    fe::add(acc, acc, prod, p);
  }

  FE_FN void add_post(uint32_t s[T][fe::N], int r) const {
    uint32_t c[fe::N];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      fe::load(c, elem(post_off() + r * T + i));
      fe::add(s[i], s[i], c, p);
    }
  }

  // s = M s for the dense column-convention matrix at element off. One
  // output row per iteration, staged in scratch, keeps the code size at
  // T products instead of T^2.
  FE_FN void dense(uint32_t s[T][fe::N], int off) const {
#pragma unroll 1
    for (int i = 0; i < T; ++i) {
      uint32_t acc[fe::N] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < T; ++j) mac(acc, s[j], off + i * T + j);
#pragma unroll
      for (int w = 0; w < fe::N; ++w)
        scratch[(i * fe::N + w) * stride] = acc[w];
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int w = 0; w < fe::N; ++w)
        s[i][w] = scratch[(i * fe::N + w) * stride];
  }

  // sparse[kk]: s0' = m00 s0 + sum_j w_j s_j; s_j' = s_j + v_hat_j s0
  FE_FN void sparse(uint32_t s[T][fe::N], int kk) const {
    const int off = sparse_off() + kk * (2 * T - 1);
    uint32_t s0[fe::N], n0[fe::N] = {0, 0, 0, 0, 0, 0, 0, 0};
    fe::copy(s0, s[0]);
#pragma unroll
    for (int j = 0; j < T; ++j) mac(n0, s[j], off + j);
#pragma unroll
    for (int j = 1; j < T; ++j) mac(s[j], s0, off + T + j - 1);
    fe::copy(s[0], n0);
  }

  // x: limb-major 16-bit limbs of hash b, stride B between limbs.
  FE_FN void hash(const uint32_t* x, uint32_t* out, long long b,
                  long long B) const {
    uint32_t r2[fe::N];
    fe::load(r2, k + 8);
    uint32_t s[T][fe::N];
    // 1. load, pack to 32-bit limbs, to Montgomery form; slot 0 is the
    //    domain tag, folded into pre[0]
#pragma unroll
    for (int w = 0; w < fe::N; ++w) s[0][w] = 0;
#pragma unroll
    for (int a = 0; a < T - 1; ++a) {
      const uint32_t* xa = x + (long long)a * 16 * B + b;
      uint32_t v[fe::N];
#pragma unroll
      for (int w = 0; w < fe::N; ++w)
        v[w] = xa[(2 * w) * B] | (xa[(2 * w + 1) * B] << 16);
      fe::to_mont(s[a + 1], v, r2, p, pinv);
    }
    // 2. pre_keys
    {
      uint32_t c[fe::N];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        fe::load(c, elem(i));
        fe::add(s[i], s[i], c, p);
      }
    }
    // 3.-7. one round per iteration (the branches are uniform across
    // the batch): S-box on element 0, and on all elements in full rounds;
    // then round rf/2-1 and partial rounds 0..rp-2 apply sparse[0..rp-1],
    // the last partial round the dense pre_sparse tail, the other full
    // rounds the dense MDS; then post_keys[r].
    const int rf_half = rf / 2;
#pragma unroll 1
    for (int r = 0; r < rf + rp; ++r) {
      sbox(s[0]);
      if (r < rf_half || r >= rf_half + rp) {
#pragma unroll
        for (int i = 1; i < T; ++i) sbox(s[i]);
      }
      if (r >= rf_half - 1 && r < rf_half + rp - 1)
        sparse(s, r - (rf_half - 1));
      else
        dense(s, r == rf_half + rp - 1 ? tail_off() : mds_off());
      add_post(s, r);
    }
    // 8. digest s[1], out of Montgomery form, canonical, 16-bit limbs
    uint32_t d[fe::N];
    fe::from_mont(d, s[1], p, pinv);
#pragma unroll
    for (int w = 0; w < fe::N; ++w) {
      out[(2 * w) * B + b] = d[w] & 0xFFFFu;
      out[(2 * w + 1) * B + b] = d[w] >> 16;
    }
  }
};

template <int T>
FE_FN Poseidon<T> make_poseidon(const uint32_t* k, int rf, int rp,
                                uint32_t* scratch, int stride) {
  Poseidon<T> h;
  h.k = k;
  h.scratch = scratch;
  h.stride = stride;
  fe::load(h.p, k);
#ifdef __CUDA_ARCH__
  h.pinv = __ldg(k + 16);
#else
  h.pinv = k[16];
#endif
  h.rf = rf;
  h.rp = rp;
  return h;
}

}  // namespace

#ifdef __CUDACC__

#include <cuda_runtime.h>

template <int T>
__global__ void __launch_bounds__(kThreads)
poseidon_sparse_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ k, int rf, int rp,
                       long long B) {
  __shared__ uint32_t scratch[T * fe::N * kThreads];
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  make_poseidon<T>(k, rf, rp, scratch + threadIdx.x, kThreads)
      .hash(x, out, b, B);
}

template <int T>
static void launch(const uint32_t* x, uint32_t* out, const uint32_t* k,
                   int rf, int rp, long long B, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  poseidon_sparse_kernel<T><<<blocks, kThreads, 0, stream>>>(x, out, k, rf,
                                                             rp, B);
}

// Hash B preimages of the given arity; returns cudaGetLastError().
extern "C" int lurk_poseidon_sparse(const void* x, void* out,
                                    const void* consts, int arity, int rf,
                                    int rp, long long B, void* stream) {
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* o = static_cast<uint32_t*>(out);
  const uint32_t* k = static_cast<const uint32_t*>(consts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || rf < 2 || rp < 1) return (int)cudaErrorInvalidValue;
  switch (arity) {
    case 3: launch<4>(xi, o, k, rf, rp, B, s); break;
    case 4: launch<5>(xi, o, k, rf, rp, B, s); break;
    case 6: launch<7>(xi, o, k, rf, rp, B, s); break;
    case 8: launch<9>(xi, o, k, rf, rp, B, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
