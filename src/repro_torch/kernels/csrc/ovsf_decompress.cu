// OVSF weight generation for Hopper (sm_90a): dense W (d_in, d_out) from
// (J, d_out) alphas and J monolithic code ids,
//   W[k, n] = sum_j H_L[idx[j], k] * alphas[j, n],  k < d_in,
// with H_L the Sylvester-Hadamard matrix, L = next_pow2(d_in).
//
// Replaces the Pallas TPU kernel repro/kernels/ovsf_gemm.py:ovsf_decompress
// (_decompress_kernel, _gen_w_tile) for monolithic codes and fp32/bf16
// alphas: the im2col GEMMs of the CNNs in matrix mode generate their filters
// through it (repro/models/cnn.py:conv_apply -> kernels/ops.py:decompress).
// The TPU kernel forms each W tile as S^T @ alphas on the MXU, J * d_in
// sign-MACs per column. Here a column is a length-L spectrum that holds
// alphas[j, n] at position idx[j], and W[:, n] is its unnormalised
// Walsh-Hadamard transform cropped to d_in: L log2 L additions per column.
//
// One block per output column n:
//   1. zero the spectrum in shared memory (L floats: 32 KB at L = 8192);
//   2. scatter-ADD alphas[:, n] into it (shared-memory atomics: repeated ids
//      sum, as the Pallas kernel's sum over j does);
//   3. log2 L butterfly passes in shared memory, one barrier each;
//   4. write the first d_in entries as row n of W^T (d_out, d_in): the
//      writes of a block are contiguous. The wrapper returns the transposed
//      view, which torch.matmul takes without a copy.
// Arithmetic is fp32 and the output takes the alphas' type.
//
// What bounds it on the H100: the bytes, alphas read once and W written once
// (J * d_out + d_in * d_out values): at the ResNet-50 shapes 1.1 to 17.8 MB,
// 0.33 to 5.3 us at 3.35 TB/s; the transform is d_out * L * log2 L fp32
// additions, under 1 us at 67 TFLOP/s. This first kernel is the simple form:
// a block reads its alpha column with a stride of d_out (neighbouring blocks
// read the neighbouring columns of the same rows, which L2 serves), and the
// butterflies run one pass per barrier. Register-resident early passes,
// several columns per block and vectorised loads belong to later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;

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
ovsf_decompress_kernel(const T* __restrict__ alphas,
                       const int* __restrict__ idx, T* __restrict__ wt,
                       int J, int N, int d_in, int L) {
  extern __shared__ float spec[];            // [L]
  const int n = blockIdx.x;
  for (int i = threadIdx.x; i < L; i += THREADS) spec[i] = 0.f;
  __syncthreads();

  for (int j = threadIdx.x; j < J; j += THREADS) {
    const int code = idx[j];
    if (code < 0 || code >= L) __trap();     // the wrapper checks the range
    atomicAdd(&spec[code], to_f(alphas[(size_t)j * N + n]));
  }
  __syncthreads();

  // Butterfly pass h pairs i and i + h, where i has bit h clear: pair q of
  // the L / 2 pairs sits at ((q & ~(h - 1)) << 1) | (q & (h - 1)).
  const int half = L >> 1;
  for (int h = 1; h < L; h <<= 1) {
    for (int q = threadIdx.x; q < half; q += THREADS) {
      const int i = ((q & ~(h - 1)) << 1) | (q & (h - 1));
      const float a = spec[i];
      const float b = spec[i + h];
      spec[i] = a + b;
      spec[i + h] = a - b;
    }
    __syncthreads();
  }

  T* row = wt + (size_t)n * d_in;
  for (int k = threadIdx.x; k < d_in; k += THREADS) from_f(spec[k], row + k);
}

template <typename T>
cudaError_t launch(const void* alphas, const void* idx, void* wt, int J,
                   int N, int d_in, int L, cudaStream_t stream) {
  // Above 48 KB a block's dynamic shared memory needs an opt-in; raise it
  // once per size (never while a CUDA graph is being captured: every size is
  // first launched eagerly).
  static size_t opted_in = 48 * 1024;
  const size_t smem = (size_t)L * sizeof(float);
  if (smem > opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        ovsf_decompress_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  ovsf_decompress_kernel<T><<<N, THREADS, smem, stream>>>(
      static_cast<const T*>(alphas), static_cast<const int*>(idx),
      static_cast<T*>(wt), J, N, d_in, L);
  return cudaGetLastError();
}

}  // namespace

// alphas (J, N) float32 or bfloat16 (bf16 != 0), idx (J,) int32 in [0, L),
// L = next_pow2(d_in) a power of two; writes W^T as wt (N, d_in) in the
// alphas' type. Returns the cudaError_t of the launch.
extern "C" int ovsf_decompress_launch(const void* alphas, const void* idx,
                                      void* wt, int J, int N, int d_in,
                                      int L, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0 || (L & (L - 1)) || d_in > L || N <= 0)
    return cudaErrorInvalidValue;
  if (bf16)
    return launch<__nv_bfloat16>(alphas, idx, wt, J, N, d_in, L, s);
  return launch<float>(alphas, idx, wt, J, N, d_in, L, s);
}
