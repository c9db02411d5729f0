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
// can reach at most about 53% of the digest's bound; this kernel, with a
// full CIOS reduction per product, does about 2,600 field products per
// arity-4 hash and will stay well below that.
//
// Design: one thread per hash, the t-element state in registers (8 x
// 32-bit limbs each, field.cuh's CIOS), as K1 and K2. All constants (full
// rounds' keys, the MDS and the six folded tables: 1,383 elements, 44 KB
// at t = 9) are staged once per block in dynamic shared memory, where a
// warp's threads read the same word (a broadcast). The MDS and the rebuild
// run one output row per iteration, staged in shared memory. Every round
// loop stays rolled, so nvcc builds the file in seconds.
//
// What holds it back: the quadratic window, and the delta history. Each
// thread keeps its rp (56 or 57) S-box outputs, 1.8 KB, which cannot stay
// in registers: they live in per-thread local memory (L1, spilling to L2)
// and every partial round reads all earlier ones back. A faster kernel
// would share the window across threads as a matrix product (wgmma/mma
// over digit planes) and batch the rebuild the same way.
//
// Layout: x is int32[arity, 16, B] (16-bit limbs, limb-major, batch
// last), out is int32[16, B]. k is the buffer of kernel.py:
// folded_constants: a 24-word header (p, R^2 mod p, -p^{-1} mod 2^32),
// then in Montgomery form rc[RF][t] (the full rounds' constants, the
// domain tag folded into rc[0][0]), mds[t][t] (row j holding M[i][j] over
// i), alpha[RP][t], beta[RP], gamma[RP], a_mat[t][t], b_vec[t] and
// w_mat[t][RP].
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int kHeaderWords = 24;
constexpr int kThreads = 128;
constexpr int kMaxRp = 64;

FE_FN void ld(uint32_t r[fe::N], const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < fe::N; ++i) r[i] = src[i];
}

template <int T>
struct FoldedPoseidon {
  const uint32_t* elems;   // the tables, Montgomery; shared memory
  // scratch word (e, w) of this thread's row output at
  // scratch[(e * N + w) * stride]: shared memory on the card
  uint32_t* scratch;
  int stride;
  uint32_t p[fe::N];
  uint32_t pinv;
  int rf, rp;

  FE_FN const uint32_t* elem(int e) const { return elems + fe::N * e; }
  FE_FN int mds_off() const { return rf * T; }
  FE_FN int alpha_off() const { return mds_off() + T * T; }
  FE_FN int beta_off() const { return alpha_off() + rp * T; }
  FE_FN int gamma_off() const { return beta_off() + rp; }
  FE_FN int a_off() const { return gamma_off() + rp; }
  FE_FN int b_off() const { return a_off() + T * T; }
  FE_FN int w_off() const { return b_off() + T; }

  FE_FN void sbox(uint32_t x[fe::N]) const {
    uint32_t x2[fe::N], x4[fe::N];
    fe::mul(x2, x, x, p, pinv);
    fe::mul(x4, x2, x2, p, pinv);
    fe::mul(x, x4, x, p, pinv);
  }

  // acc += c * v, c the constant element e
  FE_FN void mac(uint32_t acc[fe::N], int e, const uint32_t v[fe::N]) const {
    uint32_t c[fe::N], prod[fe::N];
    ld(c, elem(e));
    fe::mul(prod, v, c, p, pinv);
    fe::add(acc, acc, prod, p);
  }

  // scratch row j -> s[j] for every j
  FE_FN void from_scratch(uint32_t s[T][fe::N]) const {
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int w = 0; w < fe::N; ++w)
        s[j][w] = scratch[(j * fe::N + w) * stride];
  }

  FE_FN void to_scratch(int j, const uint32_t v[fe::N]) const {
#pragma unroll
    for (int w = 0; w < fe::N; ++w) scratch[(j * fe::N + w) * stride] = v[w];
  }

  // full round r of the buffer (0 <= r < rf): constants, S-box on every
  // element, then s = M s one output row per iteration
  FE_FN void full_round(uint32_t s[T][fe::N], int r) const {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint32_t c[fe::N];
      ld(c, elem(r * T + i));
      fe::add(s[i], s[i], c, p);
      sbox(s[i]);
    }
#pragma unroll 1
    for (int j = 0; j < T; ++j) {
      uint32_t acc[fe::N] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < T; ++i) mac(acc, mds_off() + j * T + i, s[i]);
      to_scratch(j, acc);
    }
    from_scratch(s);
  }

  // the partial span on s = s_a; delta holds kMaxRp elements
  FE_FN void span(uint32_t s[T][fe::N], uint32_t (*delta)[fe::N]) const {
#pragma unroll 1
    for (int r = 0; r < rp; ++r) {
      uint32_t u[fe::N];
      ld(u, elem(beta_off() + r));
#pragma unroll
      for (int i = 0; i < T; ++i) mac(u, alpha_off() + r * T + i, s[i]);
#pragma unroll 1
      for (int q = 0; q < r; ++q) {
        uint32_t d[fe::N];
        ld(d, delta[q]);
        mac(u, gamma_off() + r - 1 - q, d);
      }
      sbox(u);
#pragma unroll
      for (int w = 0; w < fe::N; ++w) delta[r][w] = u[w];
    }
    // s = A s_a + B + W delta, one row per iteration
#pragma unroll 1
    for (int i = 0; i < T; ++i) {
      uint32_t acc[fe::N];
      ld(acc, elem(b_off() + i));
#pragma unroll
      for (int j = 0; j < T; ++j) mac(acc, a_off() + i * T + j, s[j]);
#pragma unroll 1
      for (int q = 0; q < rp; ++q) {
        uint32_t d[fe::N];
        ld(d, delta[q]);
        mac(acc, w_off() + i * rp + q, d);
      }
      to_scratch(i, acc);
    }
    from_scratch(s);
  }

  // x: limb-major 16-bit limbs of hash b, stride B between limbs; r2 is
  // R^2 mod p.
  FE_FN void hash(const uint32_t* x, uint32_t* out, long long b, long long B,
                  const uint32_t r2[fe::N]) const {
    uint32_t s[T][fe::N];
    uint32_t delta[kMaxRp][fe::N];     // local memory on the card
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
    const int half = rf / 2;
#pragma unroll 1
    for (int r = 0; r < half; ++r) full_round(s, r);
    span(s, delta);
#pragma unroll 1
    for (int r = half; r < rf; ++r) full_round(s, r);
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
FE_FN FoldedPoseidon<T> make_folded(const uint32_t* header,
                                    const uint32_t* elems, int rf, int rp,
                                    uint32_t* scratch, int stride) {
  FoldedPoseidon<T> h;
  h.elems = elems;
  h.scratch = scratch;
  h.stride = stride;
  ld(h.p, header);
  h.pinv = header[16];
  h.rf = rf;
  h.rp = rp;
  return h;
}

// Elements (after the header) of the buffer for width t.
FE_FN int folded_elems(int t, int rf, int rp) {
  return rf * t + 2 * t * t + rp * t + 2 * rp + t + t * rp;
}

}  // namespace

#ifdef __CUDACC__

#include <cuda_runtime.h>

template <int T>
__global__ void __launch_bounds__(kThreads)
poseidon_folded_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out,
                       const uint32_t* __restrict__ k, int rf, int rp,
                       long long B) {
  extern __shared__ uint32_t smem[];
  const int n_words = fe::N * folded_elems(T, rf, rp);
  uint32_t* elems = smem;
  uint32_t* scratch = smem + n_words;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x)
    elems[i] = __ldg(k + kHeaderWords + i);
  __syncthreads();
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t header[kHeaderWords];
#pragma unroll
  for (int i = 0; i < kHeaderWords; ++i) header[i] = __ldg(k + i);
  make_folded<T>(header, elems, rf, rp, scratch + threadIdx.x, kThreads)
      .hash(x, out, b, B, header + 8);
}

template <int T>
static int launch(const uint32_t* x, uint32_t* out, const uint32_t* k,
                  int rf, int rp, long long B, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) *
      (fe::N * folded_elems(T, rf, rp) + T * fe::N * kThreads);
  cudaError_t err = cudaFuncSetAttribute(
      poseidon_folded_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
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
