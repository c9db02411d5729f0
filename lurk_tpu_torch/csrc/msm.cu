// Pippenger multi-scalar multiplication over a resident affine table (K6).
//
// Replaces the JAX package's device MSM, lurk_tpu/msm/device_v2.py
// (_msm_kernel :249, MsmTable :477), and so the per-shard work of
// parallel/sharding.py's ShardedMsmTable. Same steps as that kernel, not
// its TPU layout (no 22 x 12-bit fe12 rows): signed 16-bit digits, a
// bucket sort of every window's digits, bucket accumulation over
// equal-length slices of the sorted stream with the runs that cross a
// slice joined afterwards, a grouped running-sum bucket reduction, the
// window combine. The plain PyTorch version is
// lurk_tpu_torch/msm/kernel.py:msm_plain.
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
// What the design does about it.
// - Equal work whatever the skew. The prover's witnesses repeat values
//   (fib(100)'s W: 902,300 scalars, 49,161 distinct; one bucket run of
//   16,388 points), so one thread per bucket run would wait for its
//   longest run. Instead the whole sorted stream (every window's
//   non-zero digits, keyed by window and bucket) is cut into at most
//   kSlices = 2^17 equal slices of at least kMinSlice = 8 entries, one
//   thread each, as the TPU kernel's lanes take equal chunks; the slice
//   length is the stream's length over 2^17, found on the card, so a
//   sparse vector's few digits are not left to few long slices. A run
//   that begins and ends inside a slice, not as its first or last run,
//   is written to its bucket at once; each slice leaves its first and
//   its last run as two boundary records. The records are sorted by key
//   like the stream, so the same slicing joins them (kRecSlice records
//   a lane group, complete additions), level by level, until one slice
//   holds them all and writes every run. 2^17 slices (about two waves
//   of 128-thread blocks at 4 a SM) was chosen on the H100 against 2^15
//   to 2^19 slices at 2^20 random, W and all-equal scalars: 2^15 to 2^18
//   came within 4% of each other, 2^19 was 6-9% slower.
// - Short reductions. sum_b b B_b per window is built in levels of
//   kFan = 16: a segment's pair (r, f) = (sum X_k, sum (k - start) X_k),
//   and 16 segments of length L merge to (sum r_i, sum f_i +
//   L sum_i i r_i), a running sum of 31 additions and log2 L
//   doublings. 2^15 buckets take four levels (2048, 128, 8 and 1
//   segments a window) instead of one 128-addition group per thread;
//   the last level and the window combine (Horner: 240 dedicated
//   doublings) share one block. The narrow stages after the accumulation
//   (joins, merge levels 2-4, the combine) run on lane groups that
//   spread each operation's products over eight lanes (add_g, dbl_g);
//   level 1's 2^15 segments run a thread each. Additions of the
//   identity are skipped, so a sparse input's empty buckets cost
//   nothing.
// - The field core is field.cuh's (PTX carry chains for sums and
//   differences, the CIOS product in C). Every curve operation is a
//   complete formula (RCB15, a = 0), so repeated bases, P + (-P) and the
//   identity need no branch; XYZZ buckets (fewer products, but branches
//   for those cases) are not taken. Products by 3b are additions
//   (mul_b3), so the kernel takes only curves whose 3b is a small
//   integer, 0 < |3b| < 64: BN254 (9), Grumpkin (-51), Pallas and Vesta
//   (15); msm/kernel.py:curve_params refuses any other.
// - Counting sort of the kernel's own (histogram, a scan per window,
//   scatter), with warp-aggregated atomics: equal scalars in one warp
//   touch their bucket's counter once.
//
// Layout (all 32-bit words, little-endian):
//   table  [n][2][8]  affine (x, y) in Montgomery form; an all-zero row
//                     is a padding row and is never added;
//   words  [n][8]     scalars, reduced mod the group order;
//   params [32]       p[8], -p^{-1} mod 2^32, 3b as a small signed
//                     integer, 6 words of padding, 3b[8] (Montgomery; the
//                     plain version's) and R mod p[8];
//   out    [3][8]     projective (X : Y : Z), Montgomery; Z = 0 is the
//                     identity.
// The workspace (lurk_msm_workspace_bytes) holds the bucket counts and
// cursors, the sorted stream ((window, bucket) key << 32 | index << 1 |
// negate, 64 bits an entry), the boundary records, the buckets and the
// reduction levels. The entry's low word limits n to 2^31 - 1 (so do
// the int bucket counts and positions, at most n each).
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
  int b3;                 // 3b as a small signed integer, 0 < |3b| < 64
  uint32_t one[fe::N];
};

struct Pt {
  uint32_t x[fe::N], y[fe::N], z[fe::N];
};

// Window width and what follows from it: 16 windows of 256-bit scalars,
// bucket ids 1..kHalf (0 means "skip").
constexpr int kC = 16;
constexpr int kWin = 256 / kC;
constexpr int kHalf = 1 << (kC - 1);
constexpr int kSlots = kHalf + 1;
// Bucket reduction: segments merge kFan at a time; kSeg1..kSeg3
// segments a window after levels 1-3 (level 4 leaves one).
constexpr int kFan = 16;
constexpr int kSeg1 = kHalf / kFan;
constexpr int kSeg2 = kSeg1 / kFan;
constexpr int kSeg3 = kSeg2 / kFan;
// The accumulation: at most kSlices slices (threads), of at least
// kMinSlice entries; the slice length is the stream's length over
// kSlices, found on the card (so every stream of up to 2^20 entries, as
// the tests' are, is cut into slices of kMinSlice).
constexpr long long kSlices = 1 << 17;
constexpr long long kMinSlice = 8;
// Boundary records per lane group when joining runs across slices: a
// join level's time is kRecSlice operations' latency, and a level cuts
// the records to 2 / kRecSlice of them.
constexpr int kRecSlice = 8;
// meta: the windows' digit counts, then the stream's length and the
// record count of each join level.
constexpr int kMetaLen = kWin;
constexpr int kMaxLevels = 12;

FE_FN void load_curve(Curve& c, const uint32_t* params) {
  fe::load(c.p, params);
#ifdef __CUDA_ARCH__
  c.pinv = __ldg(params + 8);
  c.b3 = (int)__ldg(params + 9);
#else
  c.pinv = params[8];
  c.b3 = (int)params[9];
#endif
  fe::load(c.one, params + 24);
}

// r = 3b a by doublings and additions (3b is 9, -51 and 15 on BN254,
// Grumpkin and Pallas/Vesta): a few modular additions in place of a
// Montgomery product, one product level less in every formula below.
FE_FN void mul_b3(uint32_t r[fe::N], const uint32_t a[fe::N],
                  const Curve& c) {
  const int k = c.b3 < 0 ? -c.b3 : c.b3;
  uint32_t acc[fe::N];
  bool started = false;
  for (int bit = 5; bit >= 0; --bit) {
    if (started) fe::add(acc, acc, acc, c.p);
    if ((k >> bit) & 1) {
      if (started) {
        fe::add(acc, acc, a, c.p);
      } else {
        fe::copy(acc, a);
        started = true;
      }
    }
  }
  if (c.b3 < 0) {
    const uint32_t zero[fe::N] = {0, 0, 0, 0, 0, 0, 0, 0};
    fe::sub(acc, zero, acc, c.p);
  }
  fe::copy(r, acc);
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

// A point by plain loads (shared memory takes no read-only-cache load).
FE_FN void load_pt_plain(Pt& r, const uint32_t* src) {
#pragma unroll
  for (int i = 0; i < fe::N; ++i) {
    r.x[i] = src[i];
    r.y[i] = src[fe::N + i];
    r.z[i] = src[2 * fe::N + i];
  }
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
  mul_b3(t2, a.z, c);
  fe::add(z3, t1, t2, p);
  fe::sub(t1, t1, t2, p);
  mul_b3(y3, y3, c);
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
  mul_b3(t2, t2, c);
  fe::add(z3, t1, t2, p);
  fe::sub(t1, t1, t2, p);
  mul_b3(y3, y3, c);
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

// r = 2 a (RCB15 Algorithm 9, complete doubling, a = 0; as
// msm/kernel.py:ec_dbl). r may alias a.
EC_FN void dbl(Pt& r, const Pt& a, const Curve& c) {
  const uint32_t* p = c.p;
  const uint32_t pi = c.pinv;
  uint32_t t0[fe::N], t1[fe::N], t2[fe::N], xy[fe::N];
  uint32_t x3[fe::N], y3[fe::N], z3[fe::N];
  fe::mul(t0, a.y, a.y, p, pi);
  fe::mul(t1, a.y, a.z, p, pi);
  fe::mul(t2, a.z, a.z, p, pi);
  fe::mul(xy, a.x, a.y, p, pi);
  mul_b3(t2, t2, c);
  fe::add(z3, t0, t0, p);
  fe::add(z3, z3, z3, p);
  fe::add(z3, z3, z3, p);              // 8 t0
  fe::add(y3, t0, t2, p);
  fe::add(x3, t2, t2, p);
  fe::add(x3, x3, t2, p);              // 3 t2
  fe::sub(t0, t0, x3, p);
  fe::mul(x3, t2, z3, p, pi);
  fe::mul(z3, t1, z3, p, pi);
  fe::mul(y3, t0, y3, p, pi);
  fe::mul(t1, t0, xy, p, pi);
  fe::add(y3, x3, y3, p);
  fe::add(x3, t1, t1, p);
  fe::copy(r.x, x3);
  fe::copy(r.y, y3);
  fe::copy(r.z, z3);
}

// ---- point operations of a lane group (the reductions) ----
//
// The reductions after the accumulation run few threads, each a chain of
// hundreds of point operations, so their time is one operation's
// latency. A group of kCoop lanes of one warp therefore does each
// operation together: every lane holds the same operands and result,
// each level of independent products (RCB15 Algorithm 7: 6 and 6;
// Algorithm 9: 4 and 4; the products by 3b are additions, mul_b3) is
// spread over the lanes, one product a lane, and shared by __shfl_sync,
// so an operation takes two products' latency instead of twelve. The
// additions between levels run on every lane.
// Off the card the group is one thread and these are add and dbl.
constexpr int kCoop = 8;

// out = the j-th of six elements (a select on every word: the operands
// stay in registers).
FE_FN void pick6(uint32_t out[fe::N], int j, const uint32_t s0[fe::N],
                 const uint32_t s1[fe::N], const uint32_t s2[fe::N],
                 const uint32_t s3[fe::N], const uint32_t s4[fe::N],
                 const uint32_t s5[fe::N]) {
#pragma unroll
  for (int w = 0; w < fe::N; ++w)
    out[w] = j == 0 ? s0[w] : j == 1 ? s1[w] : j == 2 ? s2[w]
           : j == 3 ? s3[w] : j == 4 ? s4[w] : s5[w];
}

#ifdef __CUDA_ARCH__
// The group's mask and this lane's index in it.
__device__ __forceinline__ unsigned group_mask() {
  return 0xFFu << (threadIdx.x & 24);
}
__device__ __forceinline__ int group_lane() {
  return threadIdx.x & (kCoop - 1);
}

// out[k] = lane k's v, for k < count
template <int K>
__device__ __forceinline__ void share(uint32_t out[K][fe::N],
                                      const uint32_t v[fe::N]) {
  const unsigned mask = group_mask();
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int w = 0; w < fe::N; ++w)
      out[k][w] = __shfl_sync(mask, v[w], k, kCoop);
}
#endif

// r = a + b (Algorithm 7) by the group. r may alias a or b.
EC_FN void add_g(Pt& r, const Pt& a, const Pt& b, const Curve& c) {
#ifdef __CUDA_ARCH__
  const uint32_t* p = c.p;
  const uint32_t pi = c.pinv;
  const int j = group_lane() < 6 ? group_lane() : 0;
  const uint32_t zero[fe::N] = {0, 0, 0, 0, 0, 0, 0, 0};
  uint32_t u[fe::N], v[fe::N], w[fe::N], prod[fe::N];
  // level 1: X1X2, Y1Y2, Z1Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
  // (X1+Z1)(X2+Z2)
  pick6(u, j, a.x, a.y, a.z, a.x, a.y, a.x);
  pick6(w, j, zero, zero, zero, a.y, a.z, a.z);
  fe::add(u, u, w, p);
  pick6(v, j, b.x, b.y, b.z, b.x, b.y, b.x);
  pick6(w, j, zero, zero, zero, b.y, b.z, b.z);
  fe::add(v, v, w, p);
  fe::mul(prod, u, v, p, pi);
  uint32_t l1[6][fe::N];
  share<6>(l1, prod);
  uint32_t t0[fe::N], t1[fe::N], t2[fe::N], t3[fe::N], t4[fe::N], y3[fe::N];
  fe::copy(t0, l1[0]);
  fe::copy(t1, l1[1]);
  fe::copy(t2, l1[2]);
  fe::add(w, t0, t1, p);
  fe::sub(t3, l1[3], w, p);
  fe::add(w, t1, t2, p);
  fe::sub(t4, l1[4], w, p);
  fe::add(w, t0, t2, p);
  fe::sub(y3, l1[5], w, p);
  fe::add(w, t0, t0, p);
  fe::add(t0, w, t0, p);
  // 3b Z1Z2 and 3b y3 by additions, on every lane
  mul_b3(t2, t2, c);
  mul_b3(y3, y3, c);
  uint32_t z3[fe::N];
  fe::add(z3, t1, t2, p);
  fe::sub(t1, t1, t2, p);
  // level 2: t4 y3, t3 t1, y3 t0, t1 z3, t0 t3, z3 t4
  pick6(u, j, t4, t3, y3, t1, t0, z3);
  pick6(v, j, y3, t1, t0, z3, t3, t4);
  fe::mul(prod, u, v, p, pi);
  uint32_t l3[6][fe::N];
  share<6>(l3, prod);
  fe::sub(r.x, l3[1], l3[0], p);
  fe::add(r.y, l3[3], l3[2], p);
  fe::add(r.z, l3[5], l3[4], p);
#else
  add(r, a, b, c);
#endif
}

// r = 2 a (Algorithm 9) by the group. r may alias a.
EC_FN void dbl_g(Pt& r, const Pt& a, const Curve& c) {
#ifdef __CUDA_ARCH__
  const uint32_t* p = c.p;
  const uint32_t pi = c.pinv;
  const int j = group_lane() < 4 ? group_lane() : 0;
  uint32_t u[fe::N], v[fe::N], prod[fe::N];
  // level 1: Y Y, Y Z, Z Z, X Y
  pick6(u, j, a.y, a.y, a.z, a.x, a.x, a.x);
  pick6(v, j, a.y, a.z, a.z, a.y, a.y, a.y);
  fe::mul(prod, u, v, p, pi);
  uint32_t l1[4][fe::N];
  share<4>(l1, prod);
  uint32_t t2[fe::N], z3[fe::N], y3[fe::N], x3[fe::N], t0[fe::N];
  mul_b3(t2, l1[2], c);                  // on every lane
  fe::add(z3, l1[0], l1[0], p);
  fe::add(z3, z3, z3, p);
  fe::add(z3, z3, z3, p);                // 8 t0
  fe::add(y3, l1[0], t2, p);
  fe::add(x3, t2, t2, p);
  fe::add(x3, x3, t2, p);                // 3 t2
  fe::sub(t0, l1[0], x3, p);
  // level 2: t2 z3, t1 z3, t0 y3, t0 xy
  pick6(u, j, t2, l1[1], t0, t0, t0, t0);
  pick6(v, j, z3, z3, y3, l1[3], l1[3], l1[3]);
  fe::mul(prod, u, v, p, pi);
  uint32_t l3[4][fe::N];
  share<4>(l3, prod);
  fe::add(r.y, l3[0], l3[2], p);
  fe::add(r.x, l3[3], l3[3], p);
  fe::copy(r.z, l3[1]);
#else
  dbl(r, a, c);
#endif
}

// Whether this thread writes the group's result (lane 0; always off the
// card).
FE_FN bool group_lead() {
#ifdef __CUDA_ARCH__
  return group_lane() == 0;
#else
  return true;
#endif
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

FE_FN void load_words(uint32_t w[fe::N], const uint32_t* words, long long i) {
  fe::load(w, words + i * fe::N);
}

// Count slot (win * kSlots + bucket) of each window of scalar i, -1
// where the digit is 0; neg[win] is the negate flag.
FE_FN void digit_slots(long long i, const uint32_t* words, int slot[kWin],
                       int neg[kWin]) {
  uint32_t w[fe::N];
  load_words(w, words, i);
  int carry = 0;
#pragma unroll
  for (int win = 0; win < kWin; ++win) {
    const int b = signed_digit(w, win, carry, neg[win]);
    slot[win] = b ? win * kSlots + b : -1;
  }
}

// Stream entry of scalar i in count slot `slot`: key (win * kHalf +
// bucket - 1) above, index << 1 | negate below.
FE_FN uint64_t entry(int slot, long long i, int neg) {
  const uint32_t key = (uint32_t)(slot / kSlots * kHalf + slot % kSlots - 1);
  return ((uint64_t)key << 32) | (uint32_t)((i << 1) | neg);
}

// r += x by one thread (G false) or a lane group (G true), skipping the
// identity on either side: a sparse input's empty buckets and segments
// then cost no operation. The identity test is Z = 0 (the complete
// formulas keep it so).
template <bool G>
FE_FN void acc_add(Pt& r, const Pt& x, const Curve& c) {
  if (fe::is_zero(x.z)) return;
  if (fe::is_zero(r.z)) {
    r = x;
  } else if (G) {
    add_g(r, r, x, c);
  } else {
    add(r, r, x, c);
  }
}

// ---- per-thread bodies (the kernels below; also callable on the host) ----

// Slice t of a sorted keyed stream of m entries: the runs of equal keys
// in [t s, t s + s). A run neither first nor last in the slice lies
// wholly inside it and goes to its bucket; the first and the last run
// go to boundary records 2t and 2t + 1 (the second is the identity,
// under the same key, when the slice holds one run). With `final` (one
// slice holds the whole stream) every run goes to its bucket. Src
// supplies key(pos) and add(acc, pos); where Src::kGroup, a lane group
// runs the slice and its lead writes.
template <class Src>
FE_FN void slice_body(long long t, long long s, long long m, const Src& src,
                      bool final, const Curve& c, uint32_t* buckets,
                      uint32_t* rec, uint32_t* rec_key) {
  const long long lo = t * s;
  if (lo >= m) return;
  const long long hi = lo + s < m ? lo + s : m;
  const bool lead = !Src::kGroup || group_lead();
  Pt acc;
  identity(acc, c);
  uint32_t cur = src.key(lo);
  bool first = true;
  for (long long pos = lo; pos < hi; ++pos) {
    const uint32_t k = src.key(pos);
    if (k != cur) {
      if (lead && first && !final) {
        store_pt(rec + 2 * t * kPtWords, acc);
        rec_key[2 * t] = cur;
      } else if (lead) {
        store_pt(buckets + (long long)cur * kPtWords, acc);
      }
      first = false;
      identity(acc, c);
      cur = k;
    }
    src.add(acc, pos, c);
  }
  if (!lead) return;
  if (final) {
    store_pt(buckets + (long long)cur * kPtWords, acc);
    return;
  }
  if (first) {
    store_pt(rec + 2 * t * kPtWords, acc);
    rec_key[2 * t] = cur;
    identity(acc, c);
  }
  store_pt(rec + (2 * t + 1) * kPtWords, acc);
  rec_key[2 * t + 1] = cur;
}

// The accumulation's stream: affine table rows added by mixed addition
// (negated where the digit was), padding rows skipped.
struct TableSrc {
  static constexpr bool kGroup = false;
  const uint32_t* table;
  const uint64_t* stream;
  FE_FN uint32_t key(long long pos) const {
#ifdef __CUDA_ARCH__
    return (uint32_t)(__ldg((const unsigned long long*)stream + pos) >> 32);
#else
    return (uint32_t)(stream[pos] >> 32);
#endif
  }
  FE_FN void add(Pt& acc, long long pos, const Curve& c) const {
#ifdef __CUDA_ARCH__
    const uint32_t v = (uint32_t)__ldg((const unsigned long long*)stream + pos);
#else
    const uint32_t v = (uint32_t)stream[pos];
#endif
    const uint32_t* row = table + (long long)(v >> 1) * 2 * fe::N;
    uint32_t x[fe::N], y[fe::N];
    fe::load(x, row);
    fe::load(y, row + fe::N);
    if (fe::is_zero(x) && fe::is_zero(y)) return;    // padding row
    if (v & 1) {
      const uint32_t zero[fe::N] = {0, 0, 0, 0, 0, 0, 0, 0};
      fe::sub(y, zero, y, c.p);
    }
    madd(acc, acc, x, y, c);
  }
};

// A level of boundary records: projective points by complete addition,
// a lane group to a slice.
struct RecSrc {
  static constexpr bool kGroup = true;
  const uint32_t* pts;
  const uint32_t* keys;
  FE_FN uint32_t key(long long pos) const {
#ifdef __CUDA_ARCH__
    return __ldg(keys + pos);
#else
    return keys[pos];
#endif
  }
  FE_FN void add(Pt& acc, long long pos, const Curve& c) const {
    Pt b;
    load_pt(b, pts + pos * kPtWords);
    acc_add<true>(acc, b, c);
  }
};

// Record count of the level after one of m entries cut into slices of
// s: 0 when one slice holds them all (that level is the last).
FE_FN constexpr long long next_records(long long m, long long s) {
  return m > s ? 2 * ((m + s - 1) / s) : 0;
}

// One level of the bucket reduction, segment t = (window, j), by one
// thread (G false: the first level, which has 2^15 segments) or a lane
// group (G true: the later, narrow levels): merge kFan consecutive
// segments of length `len` (2^log2_len) into one. Input segment i has
// (r_i, f_i), r_i = sum of its points, f_i = sum of (k - start) X_k; the
// merged pair is (sum r_i, sum f_i + len sum_i i r_i). At the first
// level the inputs are the buckets (f_i = 0, an empty bucket the
// identity), taken from `r_in` with `count` given.
template <bool G>
FE_FN void merge_body(long long t, const uint32_t* r_in, const uint32_t* f_in,
                      const int* count, int log2_len, const Curve& c,
                      Pt& r, Pt& f) {
  const long long first = t * kFan;
  Pt x;
  identity(r, c);
  identity(f, c);
  for (int i = kFan - 1; i >= 0; --i) {
    const long long k = first + i;
    if (count != nullptr && count[k / kHalf * kSlots + k % kHalf + 1] == 0)
      identity(x, c);
    else
      load_pt(x, r_in + k * kPtWords);
    acc_add<G>(r, x, c);
    if (i) acc_add<G>(f, r, c);
  }
  if (f_in == nullptr) return;
  if (!fe::is_zero(f.z))
    for (int i = 0; i < log2_len; ++i) dbl_g(f, f, c);
  for (int i = 0; i < kFan; ++i) {
    load_pt(x, f_in + (first + i) * kPtWords);
    acc_add<G>(f, x, c);
  }
}

// Level 4 for window w, by a lane group: its kSeg3 segments of length
// 4096 (r3, f3; plain loads) merged, and the window's sum sum_b b B_b =
// f + r (bucket b sits at k = b - 1) into sums[w].
FE_FN void window_body(int w, const uint32_t* r3, const uint32_t* f3,
                       const Curve& c, uint32_t* sums) {
  Pt r, f, x;
  identity(r, c);
  identity(f, c);
  for (int i = kSeg3 - 1; i >= 0; --i) {
    load_pt_plain(x, r3 + (w * kSeg3 + i) * kPtWords);
    acc_add<true>(r, x, c);
    if (i) acc_add<true>(f, r, c);
  }
  if (!fe::is_zero(f.z))
    for (int i = 0; i < 12; ++i) dbl_g(f, f, c);
  for (int i = 0; i < kSeg3; ++i) {
    load_pt_plain(x, f3 + (w * kSeg3 + i) * kPtWords);
    acc_add<true>(f, x, c);
  }
  acc_add<true>(f, r, c);
  if (group_lead()) store_pt(sums + w * kPtWords, f);
}

// The window combine by a lane group, Horner's sum_w 2^(kC w) S_w
// (plain loads); the lead writes.
FE_FN void combine_body(const uint32_t* sums, const Curve& c,
                        uint32_t* out) {
  Pt acc, x;
  load_pt_plain(acc, sums + (kWin - 1) * kPtWords);
  for (int w = kWin - 2; w >= 0; --w) {
    for (int i = 0; i < kC; ++i) dbl_g(acc, acc, c);
    load_pt_plain(x, sums + w * kPtWords);
    add_g(acc, acc, x, c);
  }
  if (group_lead()) store_pt(out, acc);     // the same point from each
}

// Byte offsets of the workspace's parts for n scalars.
struct Workspace {
  size_t count, cursor, meta, stream, rec_pts, rec_keys, buckets, red,
      total;
  long long rec_cap;
};

inline size_t align256(size_t v) { return (v + 255) & ~(size_t)255; }

inline Workspace workspace(long long n) {
  Workspace ws;
  const size_t slots = (size_t)kWin * kSlots * sizeof(int);
  ws.rec_cap = 2 * kSlices;
  size_t at = 0;
  ws.count = at;    at += align256(slots);
  ws.cursor = at;   at += align256(slots);
  ws.meta = at;     at += align256((kMetaLen + kMaxLevels + 2) *
                                   sizeof(long long));
  ws.stream = at;   at += align256((size_t)kWin * n * sizeof(uint64_t));
  ws.rec_pts = at;  at += 2 * align256((size_t)ws.rec_cap * kPtWords * 4);
  ws.rec_keys = at; at += 2 * align256((size_t)ws.rec_cap * 4);
  ws.buckets = at;  at += align256((size_t)kWin * kHalf * kPtWords * 4);
  ws.red = at;      at += align256((size_t)kWin * 2 *
                                   (kSeg1 + kSeg2 + kSeg3) * kPtWords * 4);
  ws.total = at;
  return ws;
}

// Join levels after an accumulation of at most kSlices slices.
constexpr int record_levels() {
  int levels = 0;
  for (long long m = 2 * kSlices; m > 0; m = next_records(m, kRecSlice))
    ++levels;
  return levels;
}
static_assert(record_levels() <= kMaxLevels, "too many join levels");

// The accumulation's slice length for a stream of m entries.
FE_FN long long slice_len(long long m) {
  const long long s = (m + kSlices - 1) / kSlices;
  return s > kMinSlice ? s : kMinSlice;
}

// Start of window w's part of the stream: the counts of windows < w.
FE_FN long long window_base(const long long* meta, int w) {
  long long base = 0;
  for (int v = 0; v < w; ++v) base += meta[v];
  return base;
}

}  // namespace msm

extern "C" long long lurk_msm_workspace_bytes(long long n) {
  if (n <= 0 || n >= (1LL << 31)) return -1;     // index << 1 | negate
  return (long long)msm::workspace(n).total;
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace msm {

__device__ __forceinline__ long long tid() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

// Position of this lane's entry among the lanes of its warp with the
// same slot: one atomic add per distinct slot (slot -1: no entry).
__device__ __forceinline__ int warp_claim(int* counter, int slot) {
  const unsigned mask = __activemask();
  const unsigned peers = __match_any_sync(mask, slot);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader && slot >= 0)
    base = atomicAdd(counter + slot, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1));
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint32_t* __restrict__ words, long long n,
            int* __restrict__ count) {
  const long long i = tid();
  int slot[kWin], neg[kWin];
  if (i < n) {
    digit_slots(i, words, slot, neg);
  } else {
#pragma unroll
    for (int w = 0; w < kWin; ++w) slot[w] = -1;
  }
#pragma unroll
  for (int w = 0; w < kWin; ++w) warp_claim(count, slot[w]);
}

// Exclusive scan of window blockIdx.x's counts, kScanThreads at a time
// (warp shuffles, then the warps' sums): each slot's first position in
// its window's part of the stream (into cursor); the window's count into
// meta[window].
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ count, int* __restrict__ cursor,
            long long* __restrict__ meta) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  const int* in = count + (long long)blockIdx.x * kSlots;
  int* out = cursor + (long long)blockIdx.x * kSlots;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  for (int at = 0; at < kSlots; at += kScanThreads) {
    const int i = at + threadIdx.x;
    const int v = i < kSlots ? in[i] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
        if (lane >= o) w += y;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp ? warp_sum[warp - 1] : 0) + x - v;
    if (i < kSlots) out[i] = before;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) meta[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint32_t* __restrict__ words, long long n,
               const long long* __restrict__ meta, int* __restrict__ cursor,
               uint64_t* __restrict__ stream) {
  const long long i = tid();
  int slot[kWin], neg[kWin];
  if (i < n) {
    digit_slots(i, words, slot, neg);
  } else {
#pragma unroll
    for (int w = 0; w < kWin; ++w) slot[w] = -1;
  }
  long long base = 0;
#pragma unroll
  for (int w = 0; w < kWin; ++w) {
    const int pos = warp_claim(cursor, slot[w]);
    if (slot[w] >= 0) stream[base + pos] = entry(slot[w], i, neg[w]);
    base += meta[w];
  }
}

// The stream's length T (from the windows' counts) into meta[kMetaLen],
// the first join level's record count after it; slice t of
// slice_len(T) entries.
__global__ void __launch_bounds__(kThreads, 4)
accum_kernel(const uint32_t* __restrict__ table,
             const uint64_t* __restrict__ stream,
             long long* __restrict__ meta,
             const uint32_t* __restrict__ params,
             uint32_t* __restrict__ buckets, uint32_t* __restrict__ rec,
             uint32_t* __restrict__ rec_key) {
  const long long m = window_base(meta, kWin);
  const long long s = slice_len(m);
  const long long t = tid();
  if (t == 0) {
    meta[kMetaLen] = m;
    meta[kMetaLen + 1] = next_records(m, s);
  }
  Curve c;
  load_curve(c, params);
  slice_body(t, s, m, TableSrc{table, stream}, m <= s, c, buckets, rec,
             rec_key);
}

// Level `level` (1-based) of the boundary records, a lane group to a
// slice: meta[kMetaLen + level] records in (pts, keys); the next level's
// go to (out, out_key).
__global__ void __launch_bounds__(kThreads)
join_kernel(const uint32_t* __restrict__ pts,
            const uint32_t* __restrict__ keys, int level,
            long long* __restrict__ meta,
            const uint32_t* __restrict__ params,
            uint32_t* __restrict__ buckets, uint32_t* __restrict__ out,
            uint32_t* __restrict__ out_key) {
  const long long m = meta[kMetaLen + level];
  const long long t = tid() / kCoop;
  if (tid() == 0) meta[kMetaLen + level + 1] = next_records(m, kRecSlice);
  if (m == 0) return;
  Curve c;
  load_curve(c, params);
  slice_body(t, (long long)kRecSlice, m, RecSrc{pts, keys},
             m <= kRecSlice, c, buckets, out, out_key);
}

template <bool G>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const uint32_t* __restrict__ r_in,
             const uint32_t* __restrict__ f_in, const int* __restrict__ count,
             int log2_len, long long segments,
             const uint32_t* __restrict__ params, uint32_t* __restrict__ r_out,
             uint32_t* __restrict__ f_out) {
  const long long t = G ? tid() / kCoop : tid();
  if (t >= segments) return;
  Curve c;
  load_curve(c, params);
  Pt r, f;
  merge_body<G>(t, r_in, f_in, count, log2_len, c, r, f);
  if (G && !group_lead()) return;
  store_pt(r_out + t * kPtWords, r);
  store_pt(f_out + t * kPtWords, f);
}

// Level 4 of the bucket reduction and the window combine in one block,
// a lane group to a window (r3, f3: level 3's segments; sums: the
// windows' sums); warp 0 runs the combine.
__global__ void __launch_bounds__(kWin * kCoop)
finish_kernel(const uint32_t* __restrict__ r3, const uint32_t* __restrict__ f3,
              const uint32_t* __restrict__ params, uint32_t* __restrict__ out) {
  __shared__ uint32_t sums[kWin * kPtWords];
  Curve c;
  load_curve(c, params);
  window_body(threadIdx.x / kCoop, r3, f3, c, sums);
  __syncthreads();
  if (threadIdx.x < 32) combine_body(sums, c, out);   // each group alike
}

inline unsigned blocks(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace msm

// MSM of the n scalars in `words` against the first n affine points of
// `table` (kC-bit windows); the projective result goes to `out`. Every
// buffer lies on the card; the launches go to `stream`. Returns
// cudaGetLastError().
extern "C" int lurk_msm(const void* table, const void* words, long long n,
                        const void* params, void* workspace, void* out,
                        void* stream) {
  using namespace msm;
  if (lurk_msm_workspace_bytes(n) < 0) return (int)cudaErrorInvalidValue;
  const Workspace ws = msm::workspace(n);
  char* base = static_cast<char*>(workspace);
  int* count = reinterpret_cast<int*>(base + ws.count);
  int* cursor = reinterpret_cast<int*>(base + ws.cursor);
  long long* meta = reinterpret_cast<long long*>(base + ws.meta);
  uint64_t* sorted = reinterpret_cast<uint64_t*>(base + ws.stream);
  uint32_t* rec[2] = {
      reinterpret_cast<uint32_t*>(base + ws.rec_pts),
      reinterpret_cast<uint32_t*>(base + ws.rec_pts +
                                  align256((size_t)ws.rec_cap * kPtWords * 4))};
  uint32_t* key[2] = {
      reinterpret_cast<uint32_t*>(base + ws.rec_keys),
      reinterpret_cast<uint32_t*>(base + ws.rec_keys +
                                  align256((size_t)ws.rec_cap * 4))};
  uint32_t* buckets = reinterpret_cast<uint32_t*>(base + ws.buckets);
  uint32_t* r1 = reinterpret_cast<uint32_t*>(base + ws.red);
  uint32_t* f1 = r1 + (size_t)kWin * kSeg1 * kPtWords;
  uint32_t* r2 = f1 + (size_t)kWin * kSeg1 * kPtWords;
  uint32_t* f2 = r2 + (size_t)kWin * kSeg2 * kPtWords;
  uint32_t* r3 = f2 + (size_t)kWin * kSeg2 * kPtWords;
  uint32_t* f3 = r3 + (size_t)kWin * kSeg3 * kPtWords;
  const uint32_t* tab = static_cast<const uint32_t*>(table);
  const uint32_t* wd = static_cast<const uint32_t*>(words);
  const uint32_t* prm = static_cast<const uint32_t*>(params);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaMemsetAsync(count, 0, (size_t)kWin * kSlots * sizeof(int), st);
  hist_kernel<<<blocks(n), kThreads, 0, st>>>(wd, n, count);
  scan_kernel<<<kWin, kScanThreads, 0, st>>>(count, cursor, meta);
  scatter_kernel<<<blocks(n), kThreads, 0, st>>>(wd, n, meta, cursor, sorted);
  accum_kernel<<<blocks(kSlices), kThreads, 0, st>>>(
      tab, sorted, meta, prm, buckets, rec[0], key[0]);
  long long m = 2 * kSlices;
  for (int level = 1; m > 0; ++level, m = next_records(m, kRecSlice)) {
    const int in = (level - 1) & 1;
    join_kernel<<<blocks((m + kRecSlice - 1) / kRecSlice * kCoop), kThreads,
                  0, st>>>(
        rec[in], key[in], level, meta, prm, buckets, rec[in ^ 1],
        key[in ^ 1]);
  }
  merge_kernel<false><<<blocks((long long)kWin * kSeg1), kThreads, 0, st>>>(
      buckets, nullptr, count, 0, (long long)kWin * kSeg1, prm, r1, f1);
  merge_kernel<true><<<blocks((long long)kWin * kSeg2 * kCoop), kThreads, 0,
                       st>>>(
      r1, f1, nullptr, 4, (long long)kWin * kSeg2, prm, r2, f2);
  merge_kernel<true><<<blocks((long long)kWin * kSeg3 * kCoop), kThreads, 0,
                       st>>>(r2, f2, nullptr, 8, (long long)kWin * kSeg3, prm,
                             r3, f3);
  finish_kernel<<<1, kWin * kCoop, 0, st>>>(r3, f3, prm,
                                            static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
