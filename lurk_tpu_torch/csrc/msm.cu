// Pippenger multi-scalar multiplication over a resident affine table (K6).
//
// Replaces the JAX package's device MSM, lurk_tpu/msm/device_v2.py
// (_msm_kernel :249, MsmTable :477), and so the per-shard work of
// parallel/sharding.py's ShardedMsmTable. Same steps, not the TPU layout
// (no 22 x 12-bit fe12 rows, no lane-major scan): signed c-bit digits,
// a per-window bucket sort, bucket accumulation with complete mixed
// additions, a grouped running-sum bucket reduction, the window combine.
// The plain PyTorch version is lurk_tpu_torch/msm/kernel.py:msm_plain.
//
// Bound on this card: 32-bit integer multiply-adds. At n = 2^20 with
// 16-bit windows the function needs about 16 x 2^20 additions of an
// affine point to a bucket; the cheapest known, an XYZZ mixed addition
// (8 products, 2 squarings), takes 2,392 IMAD with lazy reduction, so
// about 4.0e10 IMAD; the bucket reduction adds 16 x 2 x 2^15 additions.
// This kernel's complete mixed addition (RCB15 Algorithm 8: 11 products,
// each with its own reduction) does about a fifth more than that. The
// bytes (a 64 MB table, 32 MB of scalars) take a tenth of that time.
//
// What the design does about it: one thread per (window, bucket) run
// keeps each accumulator in registers and reads each of its points
// once (64 contiguous bytes); the sort that builds the runs is a
// counting sort of the kernel's own (histogram, scan, scatter), so no
// comparison sort over 16 n keys. Every curve operation is a complete
// formula on field.cuh (8 x 32-bit CIOS, modulus passed at run time, one
// compiled body for every curve): repeated bases, P + (-P) and the
// identity need no branch. The reductions after the accumulation are
// short: a 64-bucket running sum per thread, a pairwise tree, and one
// thread per window for its doublings. Complete additions are
// __noinline__ so the cold reduction kernels share one copy and nvcc
// stays fast.
//
// Layout (all 32-bit words, little-endian):
//   table  [n][2][8]  affine (x, y) in Montgomery form; an all-zero row
//                     is a padding row and is never added;
//   words  [n][8]     scalars, reduced mod the group order;
//   params [32]       p[8], -p^{-1} mod 2^32, 7 words of padding,
//                     3b[8] and R mod p[8] (both Montgomery);
//   out    [3][8]     projective (X : Y : Z), Montgomery; Z = 0 is the
//                     identity.
// The workspace (lurk_msm_workspace_bytes) holds bucket counts and
// offsets, the sorted (index << 1 | negate) stream, the bucket points and
// the reduction buffers.
#include <stddef.h>
#include <stdint.h>

#include "field.cuh"

#ifdef __CUDACC__
#define EC_FN __host__ __device__ __noinline__
#else
#define EC_FN inline
#endif

namespace msm {

constexpr int kThreads = 128;
constexpr int kScanThreads = 1024;
constexpr int kPtWords = 3 * fe::N;

struct Curve {
  uint32_t p[fe::N];
  uint32_t pinv;
  uint32_t b3[fe::N];
  uint32_t one[fe::N];
};

struct Pt {
  uint32_t x[fe::N], y[fe::N], z[fe::N];
};

// Window width and what follows from it: 16 windows of 256-bit scalars,
// bucket ids 1..kHalf (0 means "skip"), running sums over groups of kGroup
// buckets.
constexpr int kC = 16;
constexpr int kWin = 256 / kC;
constexpr int kHalf = 1 << (kC - 1);
constexpr int kSlots = kHalf + 1;
constexpr int kGroup = 64;
constexpr int kGroups = kHalf / kGroup;

FE_FN void load_curve(Curve& c, const uint32_t* params) {
  fe::load(c.p, params);
#ifdef __CUDA_ARCH__
  c.pinv = __ldg(params + 8);
#else
  c.pinv = params[8];
#endif
  fe::load(c.b3, params + 16);
  fe::load(c.one, params + 24);
}

FE_FN void identity(Pt& r, const Curve& c) {
#pragma unroll
  for (int i = 0; i < fe::N; ++i) {
    r.x[i] = 0;
    r.y[i] = c.one[i];
    r.z[i] = 0;
  }
}

FE_FN void load_pt(Pt& r, const uint32_t* src) {
  fe::load(r.x, src);
  fe::load(r.y, src + fe::N);
  fe::load(r.z, src + 2 * fe::N);
}

FE_FN void store_pt(uint32_t* dst, const Pt& r) {
#pragma unroll
  for (int i = 0; i < fe::N; ++i) {
    dst[i] = r.x[i];
    dst[fe::N + i] = r.y[i];
    dst[2 * fe::N + i] = r.z[i];
  }
}

// r = a + (x2, y2) (RCB15 Algorithm 8, complete mixed addition, a = 0).
// The affine operand must be a point of the curve; a may be the
// identity. r may alias a.
FE_FN void madd(Pt& r, const Pt& a, const uint32_t x2[fe::N],
                const uint32_t y2[fe::N], const Curve& c) {
  const uint32_t* p = c.p;
  const uint32_t pi = c.pinv;
  uint32_t t0[fe::N], t1[fe::N], t2[fe::N], t3[fe::N], t4[fe::N];
  uint32_t x3[fe::N], y3[fe::N], z3[fe::N];
  fe::mul(t0, a.x, x2, p, pi);
  fe::mul(t1, a.y, y2, p, pi);
  fe::add(t3, x2, y2, p);
  fe::add(t4, a.x, a.y, p);
  fe::mul(t3, t3, t4, p, pi);
  fe::add(t4, t0, t1, p);
  fe::sub(t3, t3, t4, p);
  fe::mul(t4, y2, a.z, p, pi);
  fe::add(t4, t4, a.y, p);
  fe::mul(y3, x2, a.z, p, pi);
  fe::add(y3, y3, a.x, p);
  fe::add(x3, t0, t0, p);
  fe::add(t0, x3, t0, p);
  fe::mul(t2, c.b3, a.z, p, pi);
  fe::add(z3, t1, t2, p);
  fe::sub(t1, t1, t2, p);
  fe::mul(y3, c.b3, y3, p, pi);
  fe::mul(x3, t4, y3, p, pi);
  fe::mul(t2, t3, t1, p, pi);
  fe::sub(x3, t2, x3, p);
  fe::mul(y3, y3, t0, p, pi);
  fe::mul(t1, t1, z3, p, pi);
  fe::add(y3, t1, y3, p);
  fe::mul(t0, t0, t3, p, pi);
  fe::mul(z3, z3, t4, p, pi);
  fe::add(z3, z3, t0, p);
  fe::copy(r.x, x3);
  fe::copy(r.y, y3);
  fe::copy(r.z, z3);
}

// r = a + b (RCB15 Algorithm 7, complete addition, a = 0): doubling,
// inverses and the identity included. r may alias a or b.
EC_FN void add(Pt& r, const Pt& a, const Pt& b, const Curve& c) {
  const uint32_t* p = c.p;
  const uint32_t pi = c.pinv;
  uint32_t t0[fe::N], t1[fe::N], t2[fe::N], t3[fe::N], t4[fe::N];
  uint32_t x3[fe::N], y3[fe::N], z3[fe::N];
  fe::mul(t0, a.x, b.x, p, pi);
  fe::mul(t1, a.y, b.y, p, pi);
  fe::mul(t2, a.z, b.z, p, pi);
  fe::add(t3, a.x, a.y, p);
  fe::add(t4, b.x, b.y, p);
  fe::mul(t3, t3, t4, p, pi);
  fe::add(t4, t0, t1, p);
  fe::sub(t3, t3, t4, p);
  fe::add(t4, a.y, a.z, p);
  fe::add(x3, b.y, b.z, p);
  fe::mul(t4, t4, x3, p, pi);
  fe::add(x3, t1, t2, p);
  fe::sub(t4, t4, x3, p);
  fe::add(x3, a.x, a.z, p);
  fe::add(y3, b.x, b.z, p);
  fe::mul(x3, x3, y3, p, pi);
  fe::add(y3, t0, t2, p);
  fe::sub(y3, x3, y3, p);
  fe::add(x3, t0, t0, p);
  fe::add(t0, x3, t0, p);
  fe::mul(t2, c.b3, t2, p, pi);
  fe::add(z3, t1, t2, p);
  fe::sub(t1, t1, t2, p);
  fe::mul(y3, c.b3, y3, p, pi);
  fe::mul(x3, t4, y3, p, pi);
  fe::mul(t2, t3, t1, p, pi);
  fe::sub(x3, t2, x3, p);
  fe::mul(y3, y3, t0, p, pi);
  fe::mul(t1, t1, z3, p, pi);
  fe::add(y3, t1, y3, p);
  fe::mul(t0, t0, t3, p, pi);
  fe::mul(z3, z3, t4, p, pi);
  fe::add(z3, z3, t0, p);
  fe::copy(r.x, x3);
  fe::copy(r.y, y3);
  fe::copy(r.z, z3);
}

// Raw kC-bit window `win` of a 256-bit scalar given as 8 words.
FE_FN int window_raw(const uint32_t w[fe::N], int win) {
  const int off = kC * win, word = off / 32, sh = off % 32;
  uint32_t d = w[word] >> sh;
  if (sh + kC > 32 && word + 1 < fe::N) d |= w[word + 1] << (32 - sh);
  return (int)(d & ((1u << kC) - 1));
}

// Signed digit of window `win` from the running carry (updated): the
// bucket id in [0, half] and whether the point is negated. The top
// window stays unsigned (device_v2.py:signed_digits).
FE_FN int signed_digit(const uint32_t w[fe::N], int win, int& carry,
                       int& neg) {
  const int d = window_raw(w, win) + carry;
  neg = (win != kWin - 1) && d > kHalf;
  carry = neg;
  return neg ? (1 << kC) - d : d;
}

FE_FN int atomic_add(int* ptr, int v) {
#ifdef __CUDA_ARCH__
  return atomicAdd(ptr, v);
#else
  const int old = *ptr;
  *ptr += v;
  return old;
#endif
}

FE_FN void load_words(uint32_t w[fe::N], const uint32_t* words, long long i) {
  fe::load(w, words + i * fe::N);
}

// ---- per-thread bodies (the kernels below; also callable on the host) ----

// 1. histogram of the bucket ids of scalar i
FE_FN void hist_body(long long i, const uint32_t* words, int* count) {
  uint32_t w[fe::N];
  load_words(w, words, i);
  int carry = 0, neg;
  for (int win = 0; win < kWin; ++win) {
    const int b = signed_digit(w, win, carry, neg);
    if (b) atomic_add(count + win * kSlots + b, 1);
  }
}

// 3. scatter scalar i into its buckets' runs of the sorted stream
FE_FN void scatter_body(long long i, const uint32_t* words, long long n,
                        int* cursor, int* sorted) {
  uint32_t w[fe::N];
  load_words(w, words, i);
  int carry = 0, neg;
  for (int win = 0; win < kWin; ++win) {
    const int b = signed_digit(w, win, carry, neg);
    if (b) {
      const int pos = atomic_add(cursor + win * kSlots + b, 1);
      sorted[(long long)win * n + pos] = (int)((i << 1) | neg);
    }
  }
}

// 4. bucket t = (window, id - 1): the sum of its run, by mixed additions
FE_FN void accum_body(long long t, const uint32_t* table, long long n,
                      const int* count, const int* offs, const int* sorted,
                      const Curve& c, uint32_t* buckets) {
  const int win = (int)(t / kHalf), b = (int)(t % kHalf) + 1;
  const int slot = win * kSlots + b;
  const int* run = sorted + (long long)win * n + offs[slot];
  const int len = count[slot];
  Pt acc;
  identity(acc, c);
  for (int k = 0; k < len; ++k) {
    const int v = run[k];
    const uint32_t* row = table + (long long)(v >> 1) * 2 * fe::N;
    uint32_t x[fe::N], y[fe::N];
    fe::load(x, row);
    fe::load(y, row + fe::N);
    if (fe::is_zero(x) && fe::is_zero(y)) continue;    // padding row
    if (v & 1) {
      const uint32_t zero[fe::N] = {0, 0, 0, 0, 0, 0, 0, 0};
      fe::sub(y, zero, y, c.p);
    }
    madd(acc, acc, x, y, c);
  }
  store_pt(buckets + t * kPtWords, acc);
}

// 5a. group t = (window, k): sum_j (k g + j) B_{k g + j}, j = 1..g, as
// tot + (k g) run from the running sums run = sum_j B, tot = sum_j j B.
FE_FN void group_body(long long t, const uint32_t* buckets,
                      const Curve& c, uint32_t* out) {
  const int win = (int)(t / kGroups), k = (int)(t % kGroups);
  const uint32_t* first = buckets +
      ((long long)win * kHalf + (long long)k * kGroup) * kPtWords;
  Pt run, tot, bucket;
  identity(run, c);
  identity(tot, c);
  for (int j = kGroup; j >= 1; --j) {
    load_pt(bucket, first + (long long)(j - 1) * kPtWords);
    add(run, run, bucket, c);
    add(tot, tot, run, c);
  }
  Pt acc;
  identity(acc, c);
  const int s = k * kGroup;              // below kHalf
  for (int bit = kC - 2; bit >= 0; --bit) {
    add(acc, acc, acc, c);
    if ((s >> bit) & 1) add(acc, acc, run, c);
  }
  add(acc, acc, tot, c);
  store_pt(out + t * kPtWords, acc);
}

// 5b. one level of a pairwise tree: segment s of m points -> ceil(m/2)
FE_FN void pair_body(long long t, const uint32_t* src, int m,
                     const Curve& c, uint32_t* dst) {
  const int half_m = (m + 1) / 2;
  const long long s = t / half_m;
  const int i = (int)(t % half_m);
  Pt a, b;
  load_pt(a, src + (s * m + 2 * i) * kPtWords);
  if (2 * i + 1 < m) {
    load_pt(b, src + (s * m + 2 * i + 1) * kPtWords);
    add(a, a, b, c);
  }
  store_pt(dst + t * kPtWords, a);
}

// 6. window combine: window w's sum times 2^(kC w)
FE_FN void window_body(int w, const uint32_t* src,
                       const Curve& c, uint32_t* dst) {
  Pt a;
  load_pt(a, src + (long long)w * kPtWords);
  for (int k = 0; k < kC * w; ++k) add(a, a, a, c);
  store_pt(dst + (long long)w * kPtWords, a);
}

// Byte offsets of the workspace's parts.
struct Workspace {
  size_t count, offs, cursor, sorted, buckets, red_a, red_b, total;
};

inline size_t align256(size_t v) { return (v + 255) & ~(size_t)255; }

inline Workspace workspace(long long n) {
  Workspace ws;
  const size_t slots = (size_t)kWin * kSlots * sizeof(int);
  const size_t red = (size_t)kWin * kGroups * kPtWords * 4;
  size_t at = 0;
  ws.count = at;   at += align256(slots);
  ws.offs = at;    at += align256(slots);
  ws.cursor = at;  at += align256(slots);
  ws.sorted = at;  at += align256((size_t)kWin * n * sizeof(int));
  ws.buckets = at; at += align256((size_t)kWin * kHalf * kPtWords * 4);
  ws.red_a = at;   at += align256(red);
  ws.red_b = at;   at += align256(red);
  ws.total = at;
  return ws;
}

}  // namespace msm

extern "C" long long lurk_msm_workspace_bytes(long long n) {
  if (n <= 0) return -1;
  return (long long)msm::workspace(n).total;
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace msm {

__device__ __forceinline__ long long tid() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint32_t* __restrict__ words, long long n,
            int* __restrict__ count) {
  const long long i = tid();
  if (i < n) hist_body(i, words, count);
}

// 2. exclusive scan of each window's counts (one block per window):
// offsets of the runs in the window's part of the sorted stream.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ count, int* __restrict__ offs,
            int* __restrict__ cursor) {
  __shared__ int part[kScanThreads];
  const long long base = (long long)blockIdx.x * kSlots;
  const int per = (kSlots + kScanThreads - 1) / kScanThreads;
  const int lo = min(kSlots, (int)threadIdx.x * per);
  const int hi = min(kSlots, lo + per);
  int s = 0;
  for (int b = lo; b < hi; ++b) s += count[base + b];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  int run = part[threadIdx.x] - s;
  for (int b = lo; b < hi; ++b) {
    offs[base + b] = run;
    cursor[base + b] = run;
    run += count[base + b];
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint32_t* __restrict__ words, long long n,
               int* __restrict__ cursor, int* __restrict__ sorted) {
  const long long i = tid();
  if (i < n) scatter_body(i, words, n, cursor, sorted);
}

// At most 128 registers, so 4 blocks fit on an SM: left free, nvcc takes
// 153 and fits 3, and the accumulation runs about 4% slower on the H100
// despite the 56-byte spill the cap costs.
__global__ void __launch_bounds__(kThreads, 4)
accum_kernel(const uint32_t* __restrict__ table, long long n,
             const int* __restrict__ count, const int* __restrict__ offs,
             const int* __restrict__ sorted,
             const uint32_t* __restrict__ params,
             uint32_t* __restrict__ buckets) {
  const long long t = tid();
  if (t >= (long long)kWin * kHalf) return;
  Curve c;
  load_curve(c, params);
  accum_body(t, table, n, count, offs, sorted, c, buckets);
}

__global__ void __launch_bounds__(kThreads)
group_kernel(const uint32_t* __restrict__ buckets,
             const uint32_t* __restrict__ params, uint32_t* __restrict__ out) {
  const long long t = tid();
  if (t >= (long long)kWin * kGroups) return;
  Curve c;
  load_curve(c, params);
  group_body(t, buckets, c, out);
}

__global__ void __launch_bounds__(kThreads)
pair_kernel(const uint32_t* __restrict__ src, long long outputs, int m,
            const uint32_t* __restrict__ params, uint32_t* __restrict__ dst) {
  const long long t = tid();
  if (t >= outputs) return;
  Curve c;
  load_curve(c, params);
  pair_body(t, src, m, c, dst);
}

__global__ void window_kernel(const uint32_t* __restrict__ src,
                              const uint32_t* __restrict__ params,
                              uint32_t* __restrict__ dst) {
  const int w = (int)tid();
  if (w >= kWin) return;
  Curve c;
  load_curve(c, params);
  window_body(w, src, c, dst);
}

inline unsigned blocks(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

// Pairwise tree over `segs` segments of m points each, ping-ponging
// between *src and *other; leaves the segments' sums at the start of
// *src.
inline void tree(uint32_t** src, uint32_t** other, long long segs, int m,
                 const uint32_t* params, cudaStream_t s) {
  while (m > 1) {
    const int half_m = (m + 1) / 2;
    pair_kernel<<<blocks(segs * half_m), kThreads, 0, s>>>(
        *src, segs * half_m, m, params, *other);
    uint32_t* t = *src;
    *src = *other;
    *other = t;
    m = half_m;
  }
}

}  // namespace msm

// MSM of the n scalars in `words` against the n affine points of `table`
// with kC-bit windows; the projective result goes to `out`. Every buffer
// lies on the card; the launches go to `stream`. Returns
// cudaGetLastError().
extern "C" int lurk_msm(const void* table, const void* words, long long n,
                        const void* params, void* workspace, void* out,
                        void* stream) {
  using namespace msm;
  if (n <= 0 || n >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const Workspace ws = msm::workspace(n);
  char* base = static_cast<char*>(workspace);
  int* count = reinterpret_cast<int*>(base + ws.count);
  int* offs = reinterpret_cast<int*>(base + ws.offs);
  int* cursor = reinterpret_cast<int*>(base + ws.cursor);
  int* sorted = reinterpret_cast<int*>(base + ws.sorted);
  uint32_t* buckets = reinterpret_cast<uint32_t*>(base + ws.buckets);
  uint32_t* ra = reinterpret_cast<uint32_t*>(base + ws.red_a);
  uint32_t* rb = reinterpret_cast<uint32_t*>(base + ws.red_b);
  const uint32_t* tab = static_cast<const uint32_t*>(table);
  const uint32_t* wd = static_cast<const uint32_t*>(words);
  const uint32_t* prm = static_cast<const uint32_t*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  cudaMemsetAsync(count, 0, (size_t)kWin * kSlots * sizeof(int), s);
  hist_kernel<<<blocks(n), kThreads, 0, s>>>(wd, n, count);
  scan_kernel<<<kWin, kScanThreads, 0, s>>>(count, offs, cursor);
  scatter_kernel<<<blocks(n), kThreads, 0, s>>>(wd, n, cursor, sorted);
  accum_kernel<<<blocks((long long)kWin * kHalf), kThreads, 0, s>>>(
      tab, n, count, offs, sorted, prm, buckets);
  group_kernel<<<blocks((long long)kWin * kGroups), kThreads, 0, s>>>(
      buckets, prm, ra);
  tree(&ra, &rb, kWin, kGroups, prm, s);      // per-window sums in ra
  window_kernel<<<1, 32, 0, s>>>(ra, prm, rb);
  tree(&rb, &ra, 1, kWin, prm, s);            // the total in rb[0]
  cudaMemcpyAsync(out, rb, kPtWords * 4, cudaMemcpyDeviceToDevice, s);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
