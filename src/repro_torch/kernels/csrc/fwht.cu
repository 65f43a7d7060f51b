// Unnormalised fast Walsh-Hadamard transform for Hopper (sm_90a) along the
// last axis of a row-major (M, L) array, L a power of two:
//   y[m, :] = x[m, :] @ H_L,
// with H_L the Sylvester-Hadamard matrix. Arithmetic is fp32; the output
// takes x's type (fp32 or bf16).
//
// Replaces the Pallas TPU kernel repro/kernels/fwht.py:fwht_pallas
// (_fwht_kernel). The spectral path runs it on the zero-padded activations
// of an OVSF GEMM over monolithic codes (repro/kernels/ops.py:
// spectral_transform), which is every OVSF conv of a CNN in matrix mode
// whose plan names `spectral`. The TPU kernel writes H_L as H_La (x) H_Lb
// and runs two MXU matmuls, since the MXU is its fast unit; here the
// transform is the radix-2 butterfly network, L log2 L additions per row,
// with no Hadamard factor in memory.
//
// What bounds it on the H100: the bytes, each row read once and written
// once (2 * M * L * sizeof(T)): at ResNet-50 batch 8 in fp32, 103 MB per s1
// call (6272 x 2048: 30.7 us at 3.35 TB/s), 51 MB per s2 (1568 x 4096) and
// 26 MB per s3 call (392 x 8192: 7.7 us); the additions take a fifteenth of
// that at 67 TFLOP/s. The first, radix-2 kernel was bound by shared memory
// instead: log2 L radix-2 passes over a row in shared memory, each reading
// and writing every element (16 B an element in fp32) and ending in a block
// barrier: 11 x 2048 x 16 B = 360 KB of shared traffic for an 8 KB row at
// L = 2048, about 65 us for the s1 call at ~128 B a clock per SM (it took
// 64 us).
//
// This kernel runs the shared register-radix body of wht.cuh (design there):
// 5 passes per stage in registers and at most two trips through shared
// memory (8 B an element each) instead of log2 L, one warp-local and, from
// L = 2048, one with a block barrier. The block shape comes from
// kernels/fwht.py:wht_plan. Loads: fp32 rows that take an exchange reach
// shared memory by 16-byte cp.async, neighbouring lanes on neighbouring
// chunks, and stage 1 reads them back 16 bytes at a time; bf16 rows and
// rows of L <= 64 load each thread's stage-1 elements straight into
// registers with 16-byte loads. A block issues every load before its first
// pass. Stores: the last stage gives 32 lanes 32 neighbouring elements per
// register (L >= 1024; 16 + 16 at L = 512), so stores coalesce; a stage-1
// layout (L <= 64) stores 16 bytes at a time.
#include "wht.cuh"

namespace {

using wht::from_f;
using wht::to_f;

__device__ __forceinline__ void unpack(const uint4& q, float* v, float*) {
  const float4 f = reinterpret_cast<const float4&>(q);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void unpack(const uint4& q, float* v,
                                       __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* v, float*) {
  const float4 f = make_float4(v[0], v[1], v[2], v[3]);
  return reinterpret_cast<const uint4&>(f);
}
__device__ __forceinline__ uint4 pack(const float* v, __nv_bfloat16*) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return q;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// x, y: the (M, L) arrays, L = 2^N, 16-byte aligned; total = M * L. rows
// as in wht_plan.
template <typename T, int N>
__global__ void __launch_bounds__(N == 6 ? 256 : 1024)
fwht_kernel(const T* x, T* y, long long total, int rows) {
  extern __shared__ __align__(16) float buf[];
  using S = wht::Stages<N>;
  constexpr int B = S::B, R = S::R;
  constexpr int VEC = 16 / sizeof(T);        // elements of a 16-byte load
  const int t = threadIdx.x;
  const long long base = ((long long)blockIdx.x * rows) << N;
  float v[R];

  if constexpr (sizeof(T) == 4 && S::P2 >= 0) {
    // staged (wht_plan's `staged`): the warp's stage-1 region, 32 * R
    // elements, chunk by chunk (rows are whole chunks: L >= 128 here); past
    // the last row, zeros. Direct fp32 loads, lanes 128 B apart, were 8-35%
    // slower from L = 2048 (PERF.md, the staged-vs-direct measurement).
    const int region = (t >> 5) << (B + 5);
    const int lane = 4 * (t & 31);
    const int word = wht::swz(region + lane);
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const long long g = base + region + lane + 128 * q;
      const bool in = g < total;
      cp_async16(buf + (word ^ wht::swz(128 * q)), x + (in ? g : 0),
                 in ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    wht::read_first<B>(v, buf, t);
  } else {
    const long long g = base + ((long long)t << B);
    if (g + R <= total) {
      uint4 q[R / VEC];
#pragma unroll
      for (int k = 0; k < R / VEC; ++k)
        q[k] = *reinterpret_cast<const uint4*>(x + g + k * VEC);
#pragma unroll
      for (int k = 0; k < R / VEC; ++k)
        unpack(q[k], v + k * VEC, static_cast<T*>(nullptr));
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = g + j < total ? to_f(x[g + j]) : 0.f;
    }
  }

  wht::transform<N>(v, buf, t);

  if constexpr (S::LAST == 0) {
    const long long g = base + ((long long)t << B);
    if (g + R <= total) {
#pragma unroll
      for (int k = 0; k < R / VEC; ++k)
        *reinterpret_cast<uint4*>(y + g + k * VEC) =
            pack(v + k * VEC, static_cast<T*>(nullptr));
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (g + j < total) from_f(v[j], y + g + j);
    }
  } else {
    // a thread's registers lie in one row (LAST > 0 only for L >= 128)
    T* row = y + base + wht::flat0<B, S::LAST>(t);
    if (row < y + total) {
#pragma unroll
      for (int j = 0; j < R; ++j) from_f(v[j], row + (j << S::LAST));
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* x, void* y, int M, int rows, int threads,
                   int smem, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  cudaError_t e = wht::opt_in(fwht_kernel<T, N>, smem, opted_in);
  if (e != cudaSuccess) return e;
  fwht_kernel<T, N><<<(M + rows - 1) / rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), (long long)M << N, rows);
  return cudaGetLastError();
}

}  // namespace

// x, y (M, L) row-major float32 or bfloat16 (bf16 != 0), 16-byte aligned,
// distinct or the same buffer (a block reads its rows whole before it writes
// them); 1 <= L <= 32768 a power of two, M >= 1. The block shape (log2 regs,
// rows, threads, shared bytes, p2, p3) is kernels/fwht.py:wht_plan's.
// Returns the cudaError_t of the launch.
extern "C" int fwht_launch(const void* x, void* y, int M, int L, int bf16,
                           int log2_regs, int rows, int threads, int smem,
                           int p2, int p3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0 || (L & (L - 1)) || L > (1 << 15) || M <= 0 || rows <= 0 ||
      threads <= 0 || threads % 32)
    return cudaErrorInvalidValue;
  return wht::dispatch(__builtin_ctz(L), [&](auto nc) -> cudaError_t {
    constexpr int N = decltype(nc)::value;
    if (!wht::plan_matches<N>(log2_regs, p2, p3) ||
        threads > (N == 6 ? 256 : 1024))
      return cudaErrorInvalidValue;
    if (bf16)
      return launch<__nv_bfloat16, N>(x, y, M, rows, threads, smem, s);
    return launch<float, N>(x, y, M, rows, threads, smem, s);
  });
}
