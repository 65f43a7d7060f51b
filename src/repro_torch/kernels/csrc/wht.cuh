// The register-radix Walsh-Hadamard body that fwht.cu and
// ovsf_decompress.cu share: the unnormalised WHT of rows of length
// L = 2^N (1 <= L <= 32768) in fp32, with the radix-2 passes of
// core.ovsf.fwht in the same ascending order (h = 1, 2, 4, ...), so every
// add and subtract takes the same operands as the plain version and the
// result is equal to it bit for bit.
//
// A block transforms `rows` consecutive rows, viewed as one flat array of
// rows * L elements. Each thread holds R = 2^B of them in registers (B = 5;
// B = 6 at L = 64), and the transform runs in stages of B bits:
//   * a stage whose registers hold flat bits [p, p + B) runs the passes of
//     its new bits with no memory traffic and no barrier; the thread's other
//     flat bits are its index, low bits first (`flat0`). Stage 1 (p = 0)
//     holds R contiguous elements; the last stage (p = N - B) gives 32 lanes
//     32 neighbouring elements for each register, so stores coalesce;
//   * between stages the rows go once through shared memory (`exchange`).
//     Exchange 1 stays within a warp (a warp holds flat bits [0, 10) in
//     both stages), so __syncwarp suffices; exchange 2 (L >= 2048) crosses
//     the warps of a row and takes one __syncthreads. One exchange up to
//     L = 1024, two from 2048 to 32768: never a barrier per pass;
//   * the buffer is swizzled (`swz`): word i ^ (s << 2), s a 3-bit XOR of
//     the line index i >> 5, so 16-byte stage-1 accesses (a quarter-warp's
//     8 lanes 32 or 64 words apart) and the scalar accesses of the later
//     stages (lanes on 32 consecutive or 16 + 16 elements) hit distinct
//     banks. tests/test_torch_wht_sm90.py checks every access of every plan.
// N is a template parameter, so each stage's layout is known at compile
// time: `swz` is linear over XOR and a register's flat bits are disjoint
// from its thread's, so a register's word is a per-thread base XOR a
// constant (one instruction an access), and the passes unroll fully.
// The block shape (rows, threads, shared bytes) comes from
// kernels/fwht.py:wht_plan, whose stages the launchers check against these.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

namespace wht {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// The stages of rows of length 2^N: B bits of registers, the register-bit
// base of stages 2 and 3 (-1: no such stage), the last stage's base.
template <int N>
struct Stages {
  static constexpr int B = N == 6 ? 6 : 5;
  static constexpr int R = 1 << B;
  static constexpr int P2 = N > B ? (N - B < B ? N - B : B) : -1;
  static constexpr int P3 = N > 2 * B ? N - B : -1;
  static constexpr int LAST = P3 >= 0 ? P3 : P2 >= 0 ? P2 : 0;
};

// Word of flat element i in the exchange buffer (SWIZZLE in kernels/fwht.py:
// line bits 0, 1, 2, 3, 4 flip 16-byte groups 1, 2, 4, 3, 5). Linear:
// swz(a ^ b) == swz(a) ^ swz(b).
__host__ __device__ constexpr int swz(int i) {
  return i ^ ((((i >> 5) ^ (((i >> 8) & 1) * 3) ^ (((i >> 9) & 1) * 5)) & 7)
              << 2);
}

// Flat index of register 0 of thread t in a stage holding flat bits
// [P, P + B): t's bits below P stay, t's bits from P up move above P + B.
// Register j adds j << P (disjoint bits).
template <int B, int P>
__device__ __forceinline__ int flat0(int t) {
  return ((t >> P) << (P + B)) | (t & ((1 << P) - 1));
}

// The radix-2 passes of register bits [LO, HI), ascending.
template <int B, int LO, int HI>
__device__ __forceinline__ void passes(float (&v)[1 << B]) {
#pragma unroll
  for (int m = LO; m < HI; ++m) {
#pragma unroll
    for (int j = 0; j < (1 << B); ++j) {
      if (j & (1 << m)) continue;
      const float a = v[j], b = v[j | (1 << m)];
      v[j] = a + b;
      v[j | (1 << m)] = a - b;
    }
  }
}

// Stage 1's registers from the buffer: R contiguous elements, 16 bytes a read.
template <int B>
__device__ __forceinline__ void read_first(float (&v)[1 << B],
                                           const float* buf, int t) {
  const int base = swz(t << B);
#pragma unroll
  for (int k = 0; k < (1 << B); k += 4) {
    const float4 q = *reinterpret_cast<const float4*>(buf + (base ^ swz(k)));
    v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
  }
}

// Registers of a stage holding bits from FROM to those of a stage holding
// bits from TO. The buffer region a warp writes is the one it last read
// (both stages of exchange 1, and stage 2, cover the warp's own flat bits
// [0, 10)), so one __syncwarp orders the write after the warp's reads.
template <int B, int FROM, int TO, bool BLOCK_WIDE>
__device__ __forceinline__ void exchange(float (&v)[1 << B], float* buf,
                                         int t) {
  __syncwarp();
  if constexpr (FROM == 0) {
    const int base = swz(t << B);
#pragma unroll
    for (int k = 0; k < (1 << B); k += 4)
      *reinterpret_cast<float4*>(buf + (base ^ swz(k))) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
    const int base = swz(flat0<B, FROM>(t));
#pragma unroll
    for (int j = 0; j < (1 << B); ++j) buf[base ^ swz(j << FROM)] = v[j];
  }
  if constexpr (BLOCK_WIDE) __syncthreads(); else __syncwarp();
  const int base = swz(flat0<B, TO>(t));
#pragma unroll
  for (int j = 0; j < (1 << B); ++j) v[j] = buf[base ^ swz(j << TO)];
}

// The whole transform of the rows whose stage-1 elements v holds; register
// j of thread t then holds flat element flat0<B, Stages<N>::LAST>(t) +
// (j << LAST).
template <int N>
__device__ __forceinline__ void transform(float (&v)[Stages<N>::R],
                                          float* buf, int t) {
  using S = Stages<N>;
  constexpr int B = S::B;
  passes<B, 0, (N < B ? N : B)>(v);
  if constexpr (S::P2 >= 0) {
    exchange<B, 0, S::P2, false>(v, buf, t);
    passes<B, B - S::P2, (N < 2 * B ? N : 2 * B) - S::P2>(v);
  }
  if constexpr (S::P3 >= 0) {
    exchange<B, S::P2, S::P3, true>(v, buf, t);
    passes<B, 2 * B - S::P3, N - S::P3>(v);
  }
}

// The plan a wrapper passed (log2 regs, p2, p3) against the stages compiled
// for N; a mismatch is a wrapper out of step with this header.
template <int N>
__host__ bool plan_matches(int log2_regs, int p2, int p3) {
  return log2_regs == Stages<N>::B && p2 == Stages<N>::P2 &&
         p3 == Stages<N>::P3;
}

// A kernel's dynamic shared memory above 48 KB needs an opt-in; raise it once
// per kernel and size (never while a CUDA graph is being captured: every size
// is first launched eagerly).
template <typename Kernel>
__host__ cudaError_t opt_in(Kernel kernel, size_t smem, size_t& opted_in) {
  if (smem <= opted_in) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) opted_in = smem;
  return e;
}

// Calls f(std::integral_constant<int, N>()) for the runtime n in [0, 15].
template <typename F>
__host__ cudaError_t dispatch(int n, F&& f) {
  using std::integral_constant;
  switch (n) {
    case 0: return f(integral_constant<int, 0>());
    case 1: return f(integral_constant<int, 1>());
    case 2: return f(integral_constant<int, 2>());
    case 3: return f(integral_constant<int, 3>());
    case 4: return f(integral_constant<int, 4>());
    case 5: return f(integral_constant<int, 5>());
    case 6: return f(integral_constant<int, 6>());
    case 7: return f(integral_constant<int, 7>());
    case 8: return f(integral_constant<int, 8>());
    case 9: return f(integral_constant<int, 9>());
    case 10: return f(integral_constant<int, 10>());
    case 11: return f(integral_constant<int, 11>());
    case 12: return f(integral_constant<int, 12>());
    case 13: return f(integral_constant<int, 13>());
    case 14: return f(integral_constant<int, 14>());
    case 15: return f(integral_constant<int, 15>());
  }
  return cudaErrorInvalidValue;
}

}  // namespace wht
