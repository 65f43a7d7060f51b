// Fused on-the-fly OVSF GEMM for Hopper (sm_90a): y = x @ W(alphas, idx).
//
// Replaces the Pallas TPU kernel repro/kernels/ovsf_gemm.py:ovsf_gemm
// (_ovsf_gemm_kernel, _gen_w_tile, _sign_tile). W is never stored: each
// block regenerates the (BK, BN) weight tile it is about to consume,
//   W[k, n] = sum_j (-1)^popcount(idx[j] & k') * alphas[j, n],
// with k' = k (monolithic codes, idx (J,)) or k' = k mod L0 restricted to
// the j of k's own segment (segmented codes, idx (n_seg, n_keep)). The sign
// comes from __popc in registers; only the alphas stream from device memory.
//
// What bounds it on the H100: at decode (M = 4 tokens) the alpha bytes,
// J * d_out * 2 in bf16 (rho of the dense weight bytes), and the
// generation arithmetic, d_in * d_out * n_keep sign-MACs, are of the same
// order; at mixed steps (M = 128) the x @ W product dominates. This first
// kernel is the simple, exact form:
//   * the j-loop of a k-block is bounded to that block's own segments,
//     rows [k0/L0 * n_keep, (k0+BK)/L0 * n_keep): the Pallas generator walks
//     all J rows and masks the off-segment terms, which are exact zeros, so
//     skipping them changes no sum (monolithic codes walk all J rows);
//   * alphas stage through shared memory in BJ-row chunks, the W tile is
//     built in shared memory, and x @ W runs on the fp32 CUDA cores;
//   * decode M is 4 and the output 2048 or 5632 wide, so 64-wide column
//     tiles give only 32-88 blocks: the K range is split across blocks
//     (split-K) until about two blocks per SM are in flight, each writing an
//     fp32 partial, and a second small kernel sums the partials in a fixed
//     order (deterministic) and casts to the output type.
// wgmma/TMA tiles and tensor-core generation belong to later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BN = 64;        // output columns per block
constexpr int BK = 64;        // k rows per k-block (a multiple of L0 = 16)
constexpr int BJ = 32;        // alpha rows per shared-memory chunk
constexpr int THREADS = 256;  // 4 row groups x 64 columns
constexpr int KROWS = BK / (THREADS / BN);   // W rows generated per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

template <int BM, typename T>
__global__ void __launch_bounds__(THREADS)
ovsf_gemm_kernel(const T* __restrict__ x, const T* __restrict__ alphas,
                 const int* __restrict__ idx, float* __restrict__ partial,
                 int M, int K, int N, int J, int seg, int n_keep,
                 int kb_per_split) {
  constexpr int MR = BM / 4;                 // output rows per thread
  __shared__ float xs[BM][BK];
  __shared__ float wt[BK][BN];
  __shared__ float as[BJ][BN];
  __shared__ int is[BJ];

  const int tid = threadIdx.x;
  const int col = tid % BN;                  // column within the tile
  const int grp = tid / BN;                  // 0..3
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int nkb = (K + BK - 1) / BK;
  const int kb_begin = blockIdx.z * kb_per_split;
  const int kb_end = min(nkb, kb_begin + kb_per_split);

  float acc[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) acc[i] = 0.f;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * BK;
    const int klast = min(k0 + BK, K) - 1;
    int jlo = 0, jhi = J;
    if (seg) {                               // this k-block's segments only
      jlo = (k0 / seg) * n_keep;
      jhi = min((klast / seg + 1) * n_keep, J);
    }
    float w[KROWS];
#pragma unroll
    for (int i = 0; i < KROWS; ++i) w[i] = 0.f;

    for (int c0 = jlo; c0 < jhi; c0 += BJ) {
      __syncthreads();                       // last chunk's readers are done
      for (int e = tid; e < BJ * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        const int j = c0 + r, n = n0 + c;
        as[r][c] = (j < jhi && n < N) ? to_f(alphas[(size_t)j * N + n]) : 0.f;
      }
      if (tid < BJ) is[tid] = (c0 + tid < jhi) ? idx[c0 + tid] : 0;
      __syncthreads();
      const int cend = min(c0 + BJ, jhi);
#pragma unroll
      for (int i = 0; i < KROWS; ++i) {
        const int k = k0 + grp * KROWS + i;
        int jb = c0, je = cend, code = k;
        if (seg) {
          const int s = k / seg;
          jb = max(c0, s * n_keep);
          je = min(cend, (s + 1) * n_keep);
          code = k % seg;
        }
        float sum = 0.f;
        for (int j = jb; j < je; ++j) {
          const float a = as[j - c0][col];
          sum += (__popc(is[j - c0] & code) & 1) ? -a : a;
        }
        w[i] += sum;
      }
    }

    // The first chunk's barrier has already seen every thread leave the
    // previous k-block's product, so the tiles may be overwritten now.
#pragma unroll
    for (int i = 0; i < KROWS; ++i) {
      const int r = grp * KROWS + i;
      wt[r][col] = (k0 + r < K) ? w[i] : 0.f;
    }
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int m = m0 + r, k = k0 + c;
      xs[r][c] = (m < M && k < K) ? to_f(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float wv = wt[kk][col];
#pragma unroll
      for (int i = 0; i < MR; ++i) acc[i] += xs[grp + 4 * i][kk] * wv;
    }
  }

  const int n = n0 + col;
  if (n < N) {
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const int m = m0 + grp + 4 * i;
      if (m < M) partial[((size_t)blockIdx.z * M + m) * N + n] = acc[i];
    }
  }
}

template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  T* __restrict__ out, int MN, int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * MN + e];
  from_f(s, out + e);
}

template <int BM, typename T>
cudaError_t launch(const void* x, const void* alphas, const void* idx,
                   void* out, void* partial, int M, int K, int N, int J,
                   int seg, int n_keep, int splits, int kb_per_split,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  ovsf_gemm_kernel<BM, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(alphas),
      static_cast<const int*>(idx), static_cast<float*>(partial), M, K, N, J,
      seg, n_keep, kb_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int MN = M * N;
  sum_splits_kernel<T><<<(MN + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), MN, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int bm, const void* x, const void* alphas,
                     const void* idx, void* out, void* partial, int M, int K,
                     int N, int J, int seg, int n_keep, int splits,
                     int kb_per_split, cudaStream_t stream) {
  switch (bm) {
    case 4:
      return launch<4, T>(x, alphas, idx, out, partial, M, K, N, J, seg,
                          n_keep, splits, kb_per_split, stream);
    case 16:
      return launch<16, T>(x, alphas, idx, out, partial, M, K, N, J, seg,
                           n_keep, splits, kb_per_split, stream);
    case 64:
      return launch<64, T>(x, alphas, idx, out, partial, M, K, N, J, seg,
                           n_keep, splits, kb_per_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) and alphas (J, N) in one type (bf16 != 0 -> bfloat16, else
// float32), idx (J,) int32 (row-major (n_seg, n_keep) when seg > 0), out
// (M, N) in the same type, partial (splits, M, N) float32 scratch. Returns
// the cudaError_t of the launches.
extern "C" int ovsf_gemm_launch(const void* x, const void* alphas,
                                const void* idx, void* out, void* partial,
                                int M, int K, int N, int J, int seg,
                                int n_keep, int bm, int splits,
                                int kb_per_split, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(bm, x, alphas, idx, out, partial, M, K, N,
                                   J, seg, n_keep, splits, kb_per_split, s);
  return dispatch<float>(bm, x, alphas, idx, out, partial, M, K, N, J, seg,
                         n_keep, splits, kb_per_split, s);
}
