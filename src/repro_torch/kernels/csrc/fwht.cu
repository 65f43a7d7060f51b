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
// transform is the plain radix-2 butterfly network, L log2 L additions per
// row, with no Hadamard factor in memory.
//
// A block owns R = max(1, 2048 / L) consecutive rows (one row from L = 2048
// up), the last block fewer where M is ragged:
//   1. load the rows into shared memory as fp32 (L floats a row: 32 KB at
//      L = 8192, 128 KB at the limit L = 32768);
//   2. log2 L butterfly passes in shared memory, one barrier each; pass h
//      pairs i and i + h. Pairs never cross rows (2h divides L), so the
//      pass runs over the block's R rows as one flat array;
//   3. write the rows back in x's type.
//
// What bounds it on the H100: the bytes, each row read once and written
// once (2 * M * L * sizeof(T)): at ResNet-50 batch 8 in fp32, 103 MB per s1
// call (31 us at 3.35 TB/s), 51 MB per s2 and 26 MB per s3 call; the
// additions (M * L * log2 L) take a fifteenth of that at 67 TFLOP/s. This
// first kernel is the simple form: each pass reads and writes the whole
// row in shared memory (16 B per element and pass in fp32), and passes with
// h < 32 see two-way bank conflicts. Register-resident early passes,
// vectorised global loads, and folding the pad and the code gather of the
// spectral path into the kernel belong to later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCK_ELEMS = 2048;            // rows of small L share a block
constexpr int MAX_L = 1 << 15;               // L fp32 in 227 KB of smem

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fwht_kernel(const T* __restrict__ x, T* __restrict__ y, int M, int L,
            int R) {
  extern __shared__ float buf[];             // [R * L]
  const int r0 = blockIdx.x * R;
  const int n = min(R, M - r0) * L;
  const size_t base = (size_t)r0 * L;
  for (int i = threadIdx.x; i < n; i += THREADS) buf[i] = to_f(x[base + i]);
  __syncthreads();

  // Butterfly pass h pairs i and i + h, where i has bit h clear: pair q of
  // the n / 2 pairs sits at ((q & ~(h - 1)) << 1) | (q & (h - 1)).
  const int half = n >> 1;
  for (int h = 1; h < L; h <<= 1) {
    for (int q = threadIdx.x; q < half; q += THREADS) {
      const int i = ((q & ~(h - 1)) << 1) | (q & (h - 1));
      const float a = buf[i];
      const float b = buf[i + h];
      buf[i] = a + b;
      buf[i + h] = a - b;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += THREADS) from_f(buf[i], y + base + i);
}

template <typename T>
cudaError_t launch(const void* x, void* y, int M, int L,
                   cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory needs an opt-in; raise it
  // once per size (never while a CUDA graph is being captured: every size is
  // first launched eagerly).
  static size_t opted_in = 48 * 1024;
  const int R = L >= BLOCK_ELEMS ? 1 : BLOCK_ELEMS / L;
  const size_t smem = (size_t)R * L * sizeof(float);
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        fwht_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  const int blocks = (M + R - 1) / R;
  fwht_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), M, L, R);
  return cudaGetLastError();
}

}  // namespace

// x, y (M, L) row-major float32 or bfloat16 (bf16 != 0), distinct or the
// same buffer (a block reads its rows whole before it writes them);
// 1 <= L <= 32768 a power of two, M >= 1. Returns the cudaError_t of the
// launch.
extern "C" int fwht_launch(const void* x, void* y, int M, int L, int bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0 || (L & (L - 1)) || L > MAX_L || M <= 0)
    return cudaErrorInvalidValue;
  if (bf16) return launch<__nv_bfloat16>(x, y, M, L, s);
  return launch<float>(x, y, M, L, s);
}
