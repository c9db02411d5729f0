// Probe of the card's 32-bit integer multiply-add rate, the unit of the
// kernels' bounds (chip_smoke.py's Bound assumes 64 IMAD per clock per
// SM). Each thread runs `iters` rounds of kRepeat mad.lo.cc /
// madc.hi.cc carry chains of 16 instructions, the 32-bit multiply-adds
// the bounds count; many warps per SM keep the pipes fed while each
// chain waits on its carry, and a round's 64 IMAD leave the loop's
// counter and branch a small share of the instructions. Not a kernel of
// any path: chip_smoke.py times it with CUDA events, reads the SM clock
// under it and prints the measured rate beside the assumed.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kRepeat = 4;                // chains per round
constexpr int kChain = 16 * kRepeat;      // IMAD per round

__global__ void imad_kernel(uint32_t* out, int iters, uint32_t seed) {
  uint32_t a = seed ^ threadIdx.x, b = seed + blockIdx.x;
  uint32_t t0 = a, t1 = b, t2 = a ^ b, t3 = a + b;
  uint32_t t4 = a * 3, t5 = b * 5, t6 = a * 7, t7 = b * 11;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < kRepeat; ++r)
      asm volatile(
          "mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
          "madc.hi.cc.u32 %1, %8, %9, %1;\n\t"
          "madc.lo.cc.u32 %2, %8, %9, %2;\n\t"
          "madc.hi.cc.u32 %3, %8, %9, %3;\n\t"
          "madc.lo.cc.u32 %4, %8, %9, %4;\n\t"
          "madc.hi.cc.u32 %5, %8, %9, %5;\n\t"
          "madc.lo.cc.u32 %6, %8, %9, %6;\n\t"
          "madc.hi.cc.u32 %7, %8, %9, %7;\n\t"
          "madc.lo.cc.u32 %0, %9, %8, %0;\n\t"
          "madc.hi.cc.u32 %1, %9, %8, %1;\n\t"
          "madc.lo.cc.u32 %2, %9, %8, %2;\n\t"
          "madc.hi.cc.u32 %3, %9, %8, %3;\n\t"
          "madc.lo.cc.u32 %4, %9, %8, %4;\n\t"
          "madc.hi.cc.u32 %5, %9, %8, %5;\n\t"
          "madc.lo.cc.u32 %6, %9, %8, %6;\n\t"
          "madc.hi.u32 %7, %9, %8, %7;"
          : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5),
            "+r"(t6), "+r"(t7)
          : "r"(a), "r"(b));
  }
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] =
      t0 ^ t1 ^ t2 ^ t3 ^ t4 ^ t5 ^ t6 ^ t7;
}

}  // namespace

// IMAD per launch for the arguments of lurk_imad_probe.
extern "C" long long lurk_imad_count(int blocks, int threads, int iters) {
  return (long long)blocks * threads * iters * kChain;
}

// One launch on `stream`: out holds blocks * threads words. Returns
// cudaGetLastError().
extern "C" int lurk_imad_probe(void* out, int blocks, int threads, int iters,
                               void* stream) {
  imad_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), iters, 0x9E3779B9u);
  return (int)cudaGetLastError();
}
