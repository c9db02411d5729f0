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
// Bound on this card: 32-bit integer multiply-adds. A dense arity-4 hash
// does 96 S-boxes and 64 rounds x 5 MDS rows of 5 products, about
// 3.1e5 multiply-adds for 320 bytes of input and output: some 1e3
// operations per byte, far past the card's balance point.
//
// What the design does about it: one thread per hash with the t-element
// state in registers (8 x 32-bit limbs each, field.cuh's CIOS), nothing
// but the inputs and the digest in device memory. The round constants
// and the MDS ((RF+RP) t + t^2 elements, at most 21 KB at t = 9) are
// staged once per block in shared memory, where every thread of a warp
// reads the same word (a broadcast). The round loop stays rolled and the
// MDS runs one output row per iteration, staged in shared memory, so the
// code holds t products per mix and nvcc builds it in seconds.
//
// Layout: x is int32[arity, 16, B] (16-bit limbs, limb-major, batch
// last), out is int32[16, B]. k is the buffer of kernel.py:
// dense_constants: a 24-word header (p, R^2 mod p, -p^{-1} mod 2^32),
// then in Montgomery form rc[(RF+RP) t] (the domain tag folded into
// rc[0], the state's slot 0 starting at 0) and mds[t][t], row j holding
// M[i][j] over i (out[j] = sum_i M[i][j] s[i], neptune's orientation).
#include <stdint.h>

#include "field.cuh"

namespace {

constexpr int kHeaderWords = 24;
constexpr int kThreads = 128;

FE_FN void ld(uint32_t r[fe::N], const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < fe::N; ++i) r[i] = src[i];
}

template <int T>
struct DensePoseidon {
  const uint32_t* elems;   // rc then mds, Montgomery; shared memory
  // scratch word (e, w) of this thread's mix output at
  // scratch[(e * N + w) * stride]: shared memory on the card
  uint32_t* scratch;
  int stride;
  uint32_t p[fe::N];
  uint32_t pinv;
  int rf, rp;

  FE_FN const uint32_t* elem(int e) const { return elems + fe::N * e; }
  FE_FN int mds_off() const { return (rf + rp) * T; }

  FE_FN void sbox(uint32_t x[fe::N]) const {
    uint32_t x2[fe::N], x4[fe::N];
    fe::mul(x2, x, x, p, pinv);
    fe::mul(x4, x2, x2, p, pinv);
    fe::mul(x, x4, x, p, pinv);
  }

  // s = M s: one output row per iteration, staged in scratch
  FE_FN void mix(uint32_t s[T][fe::N]) const {
#pragma unroll 1
    for (int j = 0; j < T; ++j) {
      uint32_t acc[fe::N] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < T; ++i) {
        uint32_t c[fe::N], prod[fe::N];
        ld(c, elem(mds_off() + j * T + i));
        fe::mul(prod, s[i], c, p, pinv);
        fe::add(acc, acc, prod, p);
      }
#pragma unroll
      for (int w = 0; w < fe::N; ++w)
        scratch[(j * fe::N + w) * stride] = acc[w];
    }
#pragma unroll
    for (int j = 0; j < T; ++j)
#pragma unroll
      for (int w = 0; w < fe::N; ++w)
        s[j][w] = scratch[(j * fe::N + w) * stride];
  }

  // x: limb-major 16-bit limbs of hash b, stride B between limbs; r2 is
  // R^2 mod p.
  FE_FN void hash(const uint32_t* x, uint32_t* out, long long b, long long B,
                  const uint32_t r2[fe::N]) const {
    uint32_t s[T][fe::N];
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
    // round r: constants into every element, S-box on every element in
    // full rounds and on element 0 in partial rounds, then the MDS
    const int rf_half = rf / 2;
#pragma unroll 1
    for (int r = 0; r < rf + rp; ++r) {
#pragma unroll
      for (int i = 0; i < T; ++i) {
        uint32_t c[fe::N];
        ld(c, elem(r * T + i));
        fe::add(s[i], s[i], c, p);
      }
      sbox(s[0]);
      if (r < rf_half || r >= rf_half + rp) {
#pragma unroll
        for (int i = 1; i < T; ++i) sbox(s[i]);
      }
      mix(s);
    }
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
FE_FN DensePoseidon<T> make_dense(const uint32_t* header,
                                  const uint32_t* elems, int rf, int rp,
                                  uint32_t* scratch, int stride) {
  DensePoseidon<T> h;
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
FE_FN int dense_elems(int t, int rf, int rp) { return (rf + rp) * t + t * t; }

}  // namespace

#ifdef __CUDACC__

#include <cuda_runtime.h>

template <int T>
__global__ void __launch_bounds__(kThreads)
poseidon_dense_kernel(const uint32_t* __restrict__ x,
                      uint32_t* __restrict__ out,
                      const uint32_t* __restrict__ k, int rf, int rp,
                      long long B) {
  extern __shared__ uint32_t smem[];
  const int n_words = fe::N * dense_elems(T, rf, rp);
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
  make_dense<T>(header, elems, rf, rp, scratch + threadIdx.x, kThreads)
      .hash(x, out, b, B, header + 8);
}

template <int T>
static int launch(const uint32_t* x, uint32_t* out, const uint32_t* k,
                  int rf, int rp, long long B, cudaStream_t stream) {
  const size_t smem = sizeof(uint32_t) *
      (fe::N * dense_elems(T, rf, rp) + T * fe::N * kThreads);
  cudaError_t err = cudaFuncSetAttribute(
      poseidon_dense_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  poseidon_dense_kernel<T><<<blocks, kThreads, smem, stream>>>(x, out, k, rf,
                                                              rp, B);
  return (int)cudaGetLastError();
}

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
    case 3: return launch<4>(xi, o, k, rf, rp, B, s);
    case 4: return launch<5>(xi, o, k, rf, rp, B, s);
    case 6: return launch<7>(xi, o, k, rf, rp, B, s);
    case 8: return launch<9>(xi, o, k, rf, rp, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // __CUDACC__
