// Host runner of the CUDA kernels' per-thread bodies, for checking their
// arithmetic off the card: csrc/msm.cu (K6), csrc/poseidon_folded.cu,
// csrc/poseidon.cu (K1) and csrc/poseidon_dense.cu (K2) compile here
// with g++ (their __global__ kernels and launchers sit under
// __CUDACC__), and these functions run the bodies in the order the
// launchers run them, one index after another; K1's and K2's in both
// shapes (a lane group per hash, its lanes as arrays, and one thread
// per hash). Built by lurk_tpu_torch/native.py:build_host;
// tests/test_torch_kernel_bodies.py holds the results against
// msm/kernel.py:msm_plain and poseidon/kernel.py's plain versions.

#include <cstdint>
#include <vector>

#include "../msm.cu"
#include "../poseidon.cu"
#include "../poseidon_dense.cu"
#include "../poseidon_folded.cu"

namespace {

template <int T>
void folded_batch(const uint32_t* x, uint32_t* out, const uint32_t* k,
                  int rf, int rp, long long B) {
  const Tables tb{T, rf, rp};
  std::vector<uint32_t> elems((size_t)fe::N * tb.n_elems());
  for (int e = 0; e < tb.n_elems(); ++e) stage_elem(e, k, tb, elems.data());
  const auto h = make_folded<T, HostLanes>(k, elems.data(), rf, rp);
  for (long long b = 0; b < B; ++b) h.hash(x, out, b, B, k + 8, true);
}

// K1 or K2 (Kn = k1 or k2) on B hashes in both shapes: the group's
// digests to group_out, one thread's to thread_out.
template <class Tables, class Group, class Thread>
void shapes_batch(const uint32_t* x, uint32_t* group_out,
                  uint32_t* thread_out, const uint32_t* k, Tables tb,
                  long long B) {
  std::vector<uint32_t> el((size_t)fe::N * tb.n_elems());
  for (int e = 0; e < tb.n_elems(); ++e)
    pos::stage(e, k, tb.scaled(e), el.data());
  Group gr;
  gr.el = el.data();
  gr.g.f.load(k);
  gr.tb = tb;
  for (long long b = 0; b < B; ++b) gr.hash(x, group_out, b, B, k + 8, true);
  std::vector<uint32_t> scratch((size_t)fe::N * tb.t);
  Thread th;
  th.el = el.data();
  th.scratch = scratch.data();
  th.stride = 1;
  th.f.load(k);
  th.tb = tb;
  for (long long b = 0; b < B; ++b) th.hash(x, thread_out, b, B, k + 8);
}

template <int T>
void sparse_batch(const uint32_t* x, uint32_t* group_out,
                  uint32_t* thread_out, const uint32_t* k, int rf, int rp,
                  long long B) {
  using Lanes = pos::HostLanes<pos::group_size<T>()>;
  shapes_batch<k1::Tables, k1::Group<T, Lanes>, k1::Thread<T>>(
      x, group_out, thread_out, k, k1::Tables{T, rf, rp}, B);
}

template <int T>
void dense_batch(const uint32_t* x, uint32_t* group_out,
                 uint32_t* thread_out, const uint32_t* k, int rf, int rp,
                 long long B) {
  using Lanes = pos::HostLanes<pos::group_size<T>()>;
  shapes_batch<k2::Tables, k2::Group<T, Lanes>, k2::Thread<T>>(
      x, group_out, thread_out, k, k2::Tables{T, rf, rp}, B);
}

}  // namespace

extern "C" {

// sq[i] = fe::sqr(a[i]) and mu[i] = fe::mul(a[i], a[i]) for n canonical
// elements a (8 words each).
void lurk_host_sqr(const uint32_t* a, int n, const uint32_t* p,
                   uint32_t pinv, uint32_t* sq, uint32_t* mu) {
  for (int i = 0; i < n; ++i) {
    fe::sqr(sq + fe::N * i, a + fe::N * i, p, pinv);
    fe::mul(mu + fe::N * i, a + fe::N * i, a + fe::N * i, p, pinv);
  }
}

// As lurk_poseidon_sparse (K1) and lurk_poseidon_dense (K2), on host
// buffers, in both shapes (group_out, thread_out); return 0, or -1 for
// an arity or schedule the kernels do not take.
int lurk_host_poseidon_sparse(const uint32_t* x, uint32_t* group_out,
                              uint32_t* thread_out, const uint32_t* k,
                              int arity, int rf, int rp, long long B) {
  if (B <= 0 || rf < 2 || rp < 1) return -1;
  switch (arity) {
    case 3: sparse_batch<4>(x, group_out, thread_out, k, rf, rp, B); return 0;
    case 4: sparse_batch<5>(x, group_out, thread_out, k, rf, rp, B); return 0;
    case 6: sparse_batch<7>(x, group_out, thread_out, k, rf, rp, B); return 0;
    case 8: sparse_batch<9>(x, group_out, thread_out, k, rf, rp, B); return 0;
    default: return -1;
  }
}

int lurk_host_poseidon_dense(const uint32_t* x, uint32_t* group_out,
                             uint32_t* thread_out, const uint32_t* k,
                             int arity, int rf, int rp, long long B) {
  if (B <= 0 || rf < 2 || rp < 1) return -1;
  switch (arity) {
    case 3: dense_batch<4>(x, group_out, thread_out, k, rf, rp, B); return 0;
    case 4: dense_batch<5>(x, group_out, thread_out, k, rf, rp, B); return 0;
    case 6: dense_batch<7>(x, group_out, thread_out, k, rf, rp, B); return 0;
    case 8: dense_batch<9>(x, group_out, thread_out, k, rf, rp, B); return 0;
    default: return -1;
  }
}

// out = (sum_{j<k} a_j b_j) / 2^288 mod p through field.cuh's wide row
// (mul_wide, wide_add, redc_wide): a and b hold k canonical elements.
void lurk_host_wide_row(const uint32_t* a, const uint32_t* b, int k,
                        const uint32_t* p, uint32_t pinv, uint32_t* out) {
  uint32_t acc[fe::W];
  fe::wide_zero(acc);
  for (int j = 0; j < k; ++j) fe::wide_mac(acc, a + fe::N * j, b + fe::N * j);
  fe::redc_wide(out, acc, p, pinv);
}

// out = 3b a (csrc/msm.cu's mul_b3) for the curve of params.
void lurk_host_mul_b3(const uint32_t* params, const uint32_t* a,
                      uint32_t* out) {
  msm::Curve c;
  msm::load_curve(c, params);
  msm::mul_b3(out, a, c);
}

// As lurk_poseidon_folded, on host buffers; returns 0, or -1 for an
// arity or schedule the kernel does not take.
int lurk_host_poseidon_folded(const uint32_t* x, uint32_t* out,
                              const uint32_t* k, int arity, int rf, int rp,
                              long long B) {
  if (B <= 0 || rf < 2 || rf % 2 || rp < 1 || rp > kMaxRp) return -1;
  switch (arity) {
    case 3: folded_batch<4>(x, out, k, rf, rp, B); return 0;
    case 4: folded_batch<5>(x, out, k, rf, rp, B); return 0;
    case 6: folded_batch<7>(x, out, k, rf, rp, B); return 0;
    case 8: folded_batch<9>(x, out, k, rf, rp, B); return 0;
    default: return -1;
  }
}

// As lurk_msm, on host buffers; returns 0, or -1 for an n the kernel
// does not take. The longest bucket run goes to *longest.
int lurk_host_msm(const uint32_t* table, const uint32_t* words, long long n,
                  const uint32_t* params, uint32_t* out, long long* longest) {
  using namespace msm;
  if (lurk_msm_workspace_bytes(n) < 0) return -1;
  std::vector<int> count((size_t)kWin * kSlots, 0), cursor(count.size());
  std::vector<long long> meta(kMetaLen + kMaxLevels + 2, 0);
  int slot[kWin], neg[kWin];
  for (long long i = 0; i < n; ++i) {
    digit_slots(i, words, slot, neg);
    for (int w = 0; w < kWin; ++w)
      if (slot[w] >= 0) ++count[slot[w]];
  }
  *longest = 0;
  for (int w = 0; w < kWin; ++w) {             // scan_kernel, per window
    int run = 0;
    for (int b = 0; b < kSlots; ++b) {
      const int k = count[(size_t)w * kSlots + b];
      cursor[(size_t)w * kSlots + b] = run;
      run += k;
      if (k > *longest) *longest = k;
    }
    meta[w] = run;
  }
  const long long m = window_base(meta.data(), kWin);
  std::vector<uint64_t> stream(m > 0 ? m : 1);
  for (long long i = 0; i < n; ++i) {          // scatter_kernel
    digit_slots(i, words, slot, neg);
    for (int w = 0; w < kWin; ++w)
      if (slot[w] >= 0)
        stream[window_base(meta.data(), w) + cursor[slot[w]]++] =
            entry(slot[w], i, neg[w]);
  }
  Curve c;
  load_curve(c, params);
  std::vector<uint32_t> buckets((size_t)kWin * kHalf * kPtWords);
  std::vector<uint32_t> pts[2], keys[2];
  for (int k = 0; k < 2; ++k) {
    pts[k].resize((size_t)2 * kSlices * kPtWords);
    keys[k].resize((size_t)2 * kSlices);
  }
  const long long s = slice_len(m);            // accum_kernel
  for (long long t = 0; t * s < m; ++t)
    slice_body(t, s, m, TableSrc{table, stream.data()}, m <= s, c,
               buckets.data(), pts[0].data(), keys[0].data());
  int in = 0;                                  // join_kernel, per level
  for (long long r = next_records(m, s); r > 0;
       r = next_records(r, kRecSlice), in ^= 1)
    for (long long t = 0; t * kRecSlice < r; ++t)
      slice_body(t, (long long)kRecSlice, r,
                 RecSrc{pts[in].data(), keys[in].data()}, r <= kRecSlice, c,
                 buckets.data(), pts[in ^ 1].data(), keys[in ^ 1].data());
  // merge_kernel three times, then finish_kernel: levels 1-3 of the
  // bucket reduction, level 4 and the window combine
  const long long segs[3] = {(long long)kWin * kSeg1, (long long)kWin * kSeg2,
                             (long long)kWin * kSeg3};
  std::vector<uint32_t> r_lv[3], f_lv[3];
  const uint32_t* r_in = buckets.data();
  const uint32_t* f_in = nullptr;
  for (int lv = 0; lv < 3; ++lv) {
    r_lv[lv].resize((size_t)segs[lv] * kPtWords);
    f_lv[lv].resize((size_t)segs[lv] * kPtWords);
    for (long long t = 0; t < segs[lv]; ++t) {
      Pt r, f;
      merge_body<false>(t, r_in, f_in, lv == 0 ? count.data() : nullptr,
                        4 * lv, c, r, f);
      store_pt(r_lv[lv].data() + t * kPtWords, r);
      store_pt(f_lv[lv].data() + t * kPtWords, f);
    }
    r_in = r_lv[lv].data();
    f_in = f_lv[lv].data();
  }
  std::vector<uint32_t> sums((size_t)kWin * kPtWords);
  for (int w = 0; w < kWin; ++w)
    window_body(w, r_lv[2].data(), f_lv[2].data(), c, sums.data());
  combine_body(sums.data(), c, out);
  return 0;
}

}  // extern "C"
