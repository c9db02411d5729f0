// What the sparse (csrc/poseidon.cu, K1) and dense (csrc/poseidon_dense.cu,
// K2) Poseidon kernels share: the constant buffer's header, the staging
// of its elements into shared memory, the S-box, a mix row summed
// unreduced and reduced once, and the two shapes' mixes.
//
// Two shapes, one body each per kernel:
// - Thread: one thread per hash, the t-element state in registers. A
//   t x t mix runs one output row per iteration of a rolled loop, the
//   row kept in shared-memory scratch until all rows are done, so the
//   code holds t products per mix.
// - Group: a group of G lanes of one warp per hash (G = 8 for t <= 8,
//   16 for t = 9, so each lane holds at most one element: lane e holds
//   element e, lanes e >= t hold nothing). A lane S-boxes its element
//   and forms its own mix row from the group's elements, each broadcast
//   with __shfl_sync; a row with one output (K1's sparse s0') is summed
//   by the group with __shfl_xor_sync. The body is written over a Lanes
//   policy: on the card each thread is one lane (L = 1); on the host
//   (g++, tests) one call runs the group's G lanes as arrays (L = G).
//
// Every mix row is summed as 512-bit products in a 17-word accumulator
// and reduced once (field.cuh's wide_mac and redc_wide, R' = 2^288);
// the row factors are staged into shared memory times 2^32 for it
// (stage), so the buffers stay as kernel.py builds them.
#pragma once

#include <stdint.h>

#include "field.cuh"

namespace pos {

constexpr int kHeaderWords = 24;       // p[8], R^2 mod p[8], pinv, padding

FE_FN void ld(uint32_t r[fe::N], const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < fe::N; ++i) r[i] = src[i];
}

// lanes per hash in the group shape
template <int T>
FE_FN constexpr int group_size() { return T <= 8 ? 8 : 16; }

// Stage element e of the buffer k into el: a row factor (scaled) times
// 2^32 for redc_wide, anything else as it is.
FE_FN void stage(int e, const uint32_t* k, bool scaled, uint32_t* el) {
  uint32_t v[fe::N];
  ld(v, k + kHeaderWords + fe::N * e);
  if (scaled) {
    uint32_t p[fe::N], r2[fe::N];
    ld(p, k);
    ld(r2, k + 8);
    fe::scale_32(v, v, r2, p, k[16]);
  }
#pragma unroll
  for (int i = 0; i < fe::N; ++i) el[fe::N * e + i] = v[i];
}

struct Field {
  uint32_t p[fe::N];
  uint32_t pinv;

  FE_FN void load(const uint32_t* header) {
    ld(p, header);
    pinv = header[16];
  }

  // x^5: two squarings and one product
  FE_FN void sbox(uint32_t x[fe::N]) const {
    uint32_t x2[fe::N], x4[fe::N];
    fe::sqr(x2, x, p, pinv);
    fe::sqr(x4, x2, p, pinv);
    fe::mul(x, x4, x, p, pinv);
  }

  // out = sum_j f_j s_j over T staged factors f_j at el (one reduction)
  template <int T>
  FE_FN void row(uint32_t out[fe::N], const uint32_t* el,
                 const uint32_t s[T][fe::N]) const {
    uint32_t acc[fe::W];
    fe::wide_zero(acc);
#pragma unroll
    for (int j = 0; j < T; ++j) {
      uint32_t c[fe::N];
      ld(c, el + fe::N * j);
      fe::wide_mac(acc, c, s[j]);
    }
    fe::redc_wide(out, acc, p, pinv);
  }

  // Thread shape: s = M s, M's row i the T staged factors at
  // el + N T i; row i waits in scratch[(i N + w) stride] until all are
  // done.
  template <int T>
  FE_FN void mix(uint32_t s[T][fe::N], const uint32_t* el, uint32_t* scratch,
                 int stride) const {
#pragma unroll 1
    for (int i = 0; i < T; ++i) {
      uint32_t r[fe::N];
      row<T>(r, el + fe::N * T * i, s);
#pragma unroll
      for (int w = 0; w < fe::N; ++w)
        scratch[(i * fe::N + w) * stride] = r[w];
    }
#pragma unroll
    for (int i = 0; i < T; ++i)
#pragma unroll
      for (int w = 0; w < fe::N; ++w)
        s[i][w] = scratch[(i * fe::N + w) * stride];
  }

  // Thread shape: the inputs of hash b (limb-major 16-bit limbs, stride
  // B between limbs) into s[1..T-1] in Montgomery form, s[0] = 0.
  template <int T>
  FE_FN void load_inputs(uint32_t s[T][fe::N], const uint32_t* x, long long b,
                         long long B, const uint32_t r2[fe::N]) const {
#pragma unroll
    for (int w = 0; w < fe::N; ++w) s[0][w] = 0;
#pragma unroll
    for (int a = 0; a < T - 1; ++a) input(s[a + 1], x, a, b, B, r2);
  }

  // input a of hash b in Montgomery form
  FE_FN void input(uint32_t r[fe::N], const uint32_t* x, int a, long long b,
                   long long B, const uint32_t r2[fe::N]) const {
    const uint32_t* xa = x + (long long)a * 16 * B + b;
    uint32_t v[fe::N];
#pragma unroll
    for (int w = 0; w < fe::N; ++w)
      v[w] = xa[(2 * w) * B] | (xa[(2 * w + 1) * B] << 16);
    fe::to_mont(r, v, r2, p, pinv);
  }

  // the digest d (Montgomery form) of hash b, canonical, as 16-bit limbs
  FE_FN void store(uint32_t* out, const uint32_t d[fe::N], long long b,
                   long long B) const {
    uint32_t v[fe::N];
    fe::from_mont(v, d, p, pinv);
#pragma unroll
    for (int w = 0; w < fe::N; ++w) {
      out[(2 * w) * B + b] = v[w] & 0xFFFFu;
      out[(2 * w + 1) * B + b] = v[w] >> 16;
    }
  }
};

#ifdef __CUDACC__
// One lane per thread: lane = threadIdx.x mod G.
template <int G>
struct DeviceLanes {
  static constexpr int L = 1;
  __device__ __forceinline__ static int lane(int) {
    return threadIdx.x & (G - 1);
  }
  // every lane's acc becomes the group's sum
  __device__ __forceinline__ static void sum(uint32_t acc[L][fe::W]) {
#pragma unroll
    for (int m = 1; m < G; m <<= 1) {
      uint32_t o[fe::W];
#pragma unroll
      for (int w = 0; w < fe::W; ++w)
        o[w] = __shfl_xor_sync(0xFFFFFFFFu, acc[0][w], m, G);
      fe::wide_sum(acc[0], o);
    }
  }
  // out = v of lane src, in every lane
  __device__ __forceinline__ static void bcast(uint32_t out[L][fe::N],
                                               const uint32_t v[L][fe::N],
                                               int src) {
#pragma unroll
    for (int w = 0; w < fe::N; ++w)
      out[0][w] = __shfl_sync(0xFFFFFFFFu, v[0][w], src, G);
  }
};
#endif

// The whole group in one thread (host check).
template <int G>
struct HostLanes {
  static constexpr int L = G;
  static int lane(int ln) { return ln; }
  static void sum(uint32_t acc[L][fe::W]) {
    for (int ln = 1; ln < L; ++ln) fe::wide_sum(acc[0], acc[ln]);
    for (int ln = 1; ln < L; ++ln)
      for (int w = 0; w < fe::W; ++w) acc[ln][w] = acc[0][w];
  }
  static void bcast(uint32_t out[L][fe::N], const uint32_t v[L][fe::N],
                    int src) {
    uint32_t s[fe::N];
    for (int w = 0; w < fe::N; ++w) s[w] = v[src][w];
    for (int ln = 0; ln < L; ++ln)
      for (int w = 0; w < fe::N; ++w) out[ln][w] = s[w];
  }
};

// Group shape: lane e holds element e of the state (lanes e >= T hold
// zeros and take part in the shuffles only).
template <int T, class Lanes>
struct Group {
  static constexpr int L = Lanes::L;
  Field f;

  // S-box on each lane's element in a full round, on element 0 only in
  // a partial one. Every lane computes it and keeps it or not, so no
  // branch splits the warp and the lanes' other work can overlap it.
  FE_FN void sbox(uint32_t s[L][fe::N], bool full) const {
#pragma unroll
    for (int ln = 0; ln < L; ++ln) {
      uint32_t v[fe::N];
      fe::copy(v, s[ln]);
      f.sbox(v);
      const bool keep = full || Lanes::lane(ln) == 0;
#pragma unroll
      for (int w = 0; w < fe::N; ++w) s[ln][w] = keep ? v[w] : s[ln][w];
    }
  }

  // s = M s, M's row j the T staged factors at el + N T j: lane j sums
  // its row over the broadcast elements and reduces it once.
  FE_FN void mix(uint32_t s[L][fe::N], const uint32_t* el) const {
    uint32_t acc[L][fe::W];
#pragma unroll
    for (int ln = 0; ln < L; ++ln) fe::wide_zero(acc[ln]);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      uint32_t v[L][fe::N];
      Lanes::bcast(v, s, i);
#pragma unroll
      for (int ln = 0; ln < L; ++ln) {
        const int j = Lanes::lane(ln);
        if (j < T) {
          uint32_t c[fe::N];
          ld(c, el + fe::N * (T * j + i));
          fe::wide_mac(acc[ln], c, v[ln]);
        }
      }
    }
#pragma unroll
    for (int ln = 0; ln < L; ++ln)
      if (Lanes::lane(ln) < T) fe::redc_wide(s[ln], acc[ln], f.p, f.pinv);
  }

  // s_e += (element e of the T elements at el), on each lane's element
  FE_FN void add(uint32_t s[L][fe::N], const uint32_t* el) const {
#pragma unroll
    for (int ln = 0; ln < L; ++ln) {
      const int e = Lanes::lane(ln);
      if (e < T) {
        uint32_t c[fe::N];
        ld(c, el + fe::N * e);
        fe::add(s[ln], s[ln], c, f.p);
      }
    }
  }

  // the inputs of hash b into lanes 1..T-1 (Montgomery form), 0 elsewhere
  FE_FN void load_inputs(uint32_t s[L][fe::N], const uint32_t* x, long long b,
                         long long B, const uint32_t r2[fe::N]) const {
#pragma unroll
    for (int ln = 0; ln < L; ++ln) {
      const int e = Lanes::lane(ln);
#pragma unroll
      for (int w = 0; w < fe::N; ++w) s[ln][w] = 0;
      if (e >= 1 && e < T) f.input(s[ln], x, e - 1, b, B, r2);
    }
  }

  // lane 1 stores the digest s[1] when `store`
  FE_FN void store(uint32_t* out, const uint32_t s[L][fe::N], long long b,
                   long long B, bool store) const {
#pragma unroll
    for (int ln = 0; ln < L; ++ln)
      if (store && Lanes::lane(ln) == 1) f.store(out, s[ln], b, B);
  }
};

}  // namespace pos

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace pos {

constexpr int kThreads = 128;

// Every element of the buffer k (the kernel's Tables tb) staged into el
// by the block, then the block waits for it.
template <class Tables>
__device__ __forceinline__ void stage_all(const uint32_t* k, const Tables& tb,
                                          uint32_t* el) {
  for (int e = threadIdx.x; e < tb.n_elems(); e += blockDim.x)
    stage(e, k, tb.scaled(e), el);
  __syncthreads();
}

__device__ __forceinline__ void header(uint32_t h[kHeaderWords],
                                       const uint32_t* k) {
#pragma unroll
  for (int i = 0; i < kHeaderWords; ++i) h[i] = __ldg(k + i);
}

// One thread per hash; its dense rows wait in shared memory after the
// tables.
template <int T, class Tables, class Thread>
__global__ void __launch_bounds__(kThreads)
thread_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
              const uint32_t* __restrict__ k, int rf, int rp, long long B) {
  extern __shared__ uint32_t smem[];
  const Tables tb{T, rf, rp};
  stage_all(k, tb, smem);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t h[kHeaderWords];
  header(h, k);
  Thread th;
  th.el = smem;
  th.scratch = smem + fe::N * tb.n_elems() + threadIdx.x;
  th.stride = kThreads;
  th.f.load(h);
  th.tb = tb;
  th.hash(x, out, b, B, h + 8);
}

// A group of lanes per hash. Needs every thread of a block: the lanes
// shuffle with a full mask, so a lane past B hashes B - 1 again and
// stores nothing.
template <int T, class Tables, class Group>
__global__ void __launch_bounds__(kThreads)
group_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             const uint32_t* __restrict__ k, int rf, int rp, long long B) {
  constexpr int G = group_size<T>();
  extern __shared__ uint32_t smem[];
  const Tables tb{T, rf, rp};
  stage_all(k, tb, smem);
  const long long b = (long long)blockIdx.x * (kThreads / G) + threadIdx.x / G;
  uint32_t h[kHeaderWords];
  header(h, k);
  Group gr;
  gr.el = smem;
  gr.g.f.load(h);
  gr.tb = tb;
  gr.hash(x, out, b < B ? b : B - 1, B, h + 8, b < B);
}

// B hashes of width T: the group kernel below thread_from hashes, the
// thread kernel from it. Returns a CUDA error code (0 on success).
template <int T, class Tables, template <int> class Thread,
          template <int, class> class Group>
int launch(const uint32_t* x, uint32_t* out, const uint32_t* k, int rf,
           int rp, long long B, long long thread_from, cudaStream_t stream) {
  const size_t tables = sizeof(uint32_t) * fe::N * Tables{T, rf, rp}.n_elems();
  if (B >= thread_from) {
    const auto kernel = thread_kernel<T, Tables, Thread<T>>;
    const size_t smem = tables + sizeof(uint32_t) * T * fe::N * kThreads;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
    kernel<<<blocks, kThreads, smem, stream>>>(x, out, k, rf, rp, B);
  } else {
    constexpr int G = group_size<T>();
    const auto kernel = group_kernel<T, Tables, Group<T, DeviceLanes<G>>>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tables);
    if (err != cudaSuccess) return (int)err;
    const long long per = kThreads / G;
    const unsigned blocks = (unsigned)((B + per - 1) / per);
    kernel<<<blocks, kThreads, tables, stream>>>(x, out, k, rf, rp, B);
  }
  return (int)cudaGetLastError();
}

}  // namespace pos

#endif  // __CUDACC__
