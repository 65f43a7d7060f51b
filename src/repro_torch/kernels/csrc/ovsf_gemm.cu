// Fused on-the-fly OVSF GEMM for Hopper (sm_90a): y = x @ W(alphas, idx).
//
// Replaces the Pallas TPU kernel repro/kernels/ovsf_gemm.py:ovsf_gemm
// (_ovsf_gemm_kernel, _gen_w_tile, _sign_tile) and its quantised-alpha
// epilogue (_dequant_tile, _row_scales). W is never stored: each block
// regenerates the (BK, BN) weight tile it is about to consume,
//   W[k, n] = sum_j (-1)^popcount(idx[j] & k') * alphas[j, n],
// with k' = k (monolithic codes, idx (J,)) or k' = k mod L0 restricted to
// the j of k's own segment (segmented codes, idx (n_seg, n_keep)). The sign
// comes from __popc in registers; only the alphas stream from device memory.
//
// Alpha storage (QUANT): 0 = the type of x (fp32 or bf16); 1 = int8 (J, N);
// 2 = int4, two nibbles per byte (J, N/2), the low nibble the even column,
// both sign-extended. Quantised alphas are dequantised as the chunk is
// staged into shared memory, alpha * scale[j / rows_per_scale] with one
// fp32 scale per code segment: the chunk's BJ row scales are expanded into
// shared memory once per chunk, as _row_scales expands them per row, so the
// staging loop does no division; int4 is staged a packed byte (two columns)
// per thread and step. Generation and the product stay fp32 and the output
// takes x's type.
//
// What bounds it on the H100: at decode (M = 4 tokens) the alpha bytes,
// J * d_out * 2 in bf16, J * d_out for int8 and J * d_out / 2 for int4 (plus
// x, y and the n_seg fp32 scales), and the generation arithmetic,
// d_in * d_out * n_keep sign-MACs, are of the same order; at mixed steps
// (M = 128) the x @ W product dominates. This first kernel is the simple,
// exact form:
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
// wgmma/TMA tiles, tensor-core generation and vectorised int8/int4 loads
// belong to later work.
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

// One stored alpha as fp32, before its scale: (j, n) of a (J, N) array of
// T (QUANT 0) or of int8 (QUANT 1).
template <typename T, int QUANT>
__device__ __forceinline__ float load_alpha(const void* alphas, int j, int n,
                                            int N) {
  if constexpr (QUANT == 0)
    return to_f(static_cast<const T*>(alphas)[(size_t)j * N + n]);
  return (float)static_cast<const signed char*>(alphas)[(size_t)j * N + n];
}

// Both alphas of one packed byte of a (J, N/2) int4 array, columns n and
// n + 1 (n even): the low nibble is the even column; both sign-extended.
__device__ __forceinline__ void load_int4_pair(const void* alphas, int j,
                                               int n, int N, float* lo,
                                               float* hi) {
  const int b =
      static_cast<const signed char*>(alphas)[(size_t)j * (N / 2) + n / 2];
  const int q = b & 0xF;
  *lo = (float)(q - ((q & 8) << 1));                // 8..15 -> -8..-1
  *hi = (float)(b >> 4);                            // arithmetic shift
}

template <int BM, typename T, int QUANT>
__global__ void __launch_bounds__(THREADS)
ovsf_gemm_kernel(const T* __restrict__ x, const void* __restrict__ alphas,
                 const float* __restrict__ scale, const int* __restrict__ idx,
                 float* __restrict__ partial, int M, int K, int N, int J,
                 int seg, int n_keep, int rows_per_scale, int kb_per_split) {
  constexpr int MR = BM / 4;                 // output rows per thread
  __shared__ float xs[BM][BK];
  __shared__ float wt[BK][BN];
  __shared__ float as[BJ][BN];
  __shared__ float ss[BJ];                   // the chunk's row scales
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
      // ss is read only while staging, which the previous chunk finished
      // before its second barrier, so it may be written before the first
      if (QUANT && tid < BJ)
        ss[tid] = (c0 + tid < jhi) ? scale[(c0 + tid) / rows_per_scale] : 0.f;
      __syncthreads();                       // last chunk's readers are done
      if constexpr (QUANT == 2) {
        // one packed byte per thread and step, two columns of the tile
        // (n0 and N are even, so both columns are in range or neither)
        for (int e = tid; e < BJ * BN / 2; e += THREADS) {
          const int r = e / (BN / 2), c = 2 * (e % (BN / 2));
          const int j = c0 + r, n = n0 + c;
          float lo = 0.f, hi = 0.f;
          if (j < jhi && n < N) {
            load_int4_pair(alphas, j, n, N, &lo, &hi);
            lo *= ss[r];
            hi *= ss[r];
          }
          as[r][c] = lo;
          as[r][c + 1] = hi;
        }
      } else {
        for (int e = tid; e < BJ * BN; e += THREADS) {
          const int r = e / BN, c = e % BN;
          const int j = c0 + r, n = n0 + c;
          float a = 0.f;
          if (j < jhi && n < N) {
            a = load_alpha<T, QUANT>(alphas, j, n, N);
            if (QUANT) a *= ss[r];
          }
          as[r][c] = a;
        }
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

template <int BM, typename T, int QUANT>
cudaError_t launch(const void* x, const void* alphas, const void* scale,
                   const void* idx, void* out, void* partial, int M, int K,
                   int N, int J, int seg, int n_keep, int rows_per_scale,
                   int splits, int kb_per_split, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  ovsf_gemm_kernel<BM, T, QUANT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), alphas, static_cast<const float*>(scale),
      static_cast<const int*>(idx), static_cast<float*>(partial), M, K, N, J,
      seg, n_keep, rows_per_scale, kb_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int MN = M * N;
  sum_splits_kernel<T><<<(MN + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<T*>(out), MN, splits);
  return cudaGetLastError();
}

template <typename T, int QUANT>
cudaError_t dispatch_bm(int bm, const void* x, const void* alphas,
                        const void* scale, const void* idx, void* out,
                        void* partial, int M, int K, int N, int J, int seg,
                        int n_keep, int rows_per_scale, int splits,
                        int kb_per_split, cudaStream_t stream) {
  switch (bm) {
    case 4:
      return launch<4, T, QUANT>(x, alphas, scale, idx, out, partial, M, K,
                                 N, J, seg, n_keep, rows_per_scale, splits,
                                 kb_per_split, stream);
    case 16:
      return launch<16, T, QUANT>(x, alphas, scale, idx, out, partial, M, K,
                                  N, J, seg, n_keep, rows_per_scale, splits,
                                  kb_per_split, stream);
    case 64:
      return launch<64, T, QUANT>(x, alphas, scale, idx, out, partial, M, K,
                                  N, J, seg, n_keep, rows_per_scale, splits,
                                  kb_per_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(int quant, int bm, const void* x, const void* alphas,
                     const void* scale, const void* idx, void* out,
                     void* partial, int M, int K, int N, int J, int seg,
                     int n_keep, int rows_per_scale, int splits,
                     int kb_per_split, cudaStream_t stream) {
  switch (quant) {
    case 0:
      return dispatch_bm<T, 0>(bm, x, alphas, scale, idx, out, partial, M, K,
                               N, J, seg, n_keep, rows_per_scale, splits,
                               kb_per_split, stream);
    case 1:
      return dispatch_bm<T, 1>(bm, x, alphas, scale, idx, out, partial, M, K,
                               N, J, seg, n_keep, rows_per_scale, splits,
                               kb_per_split, stream);
    case 2:
      return dispatch_bm<T, 2>(bm, x, alphas, scale, idx, out, partial, M, K,
                               N, J, seg, n_keep, rows_per_scale, splits,
                               kb_per_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (M, K) in float32 or bfloat16 (bf16 != 0), out (M, N) in the same type.
// alphas: quant 0 -> (J, N) in x's type; quant 1 -> int8 (J, N); quant 2 ->
// int8 (J, N/2), two nibbles per byte. scale: float32, one per
// rows_per_scale alpha rows (quant 1 and 2; unread for quant 0). idx (J,)
// int32 (row-major (n_seg, n_keep) when seg > 0); partial (splits, M, N)
// float32 scratch. Returns the cudaError_t of the launches.
extern "C" int ovsf_gemm_launch(const void* x, const void* alphas,
                                const void* scale, const void* idx,
                                void* out, void* partial, int M, int K,
                                int N, int J, int seg, int n_keep,
                                int rows_per_scale, int bm, int splits,
                                int kb_per_split, int bf16, int quant,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(quant, bm, x, alphas, scale, idx, out,
                                   partial, M, K, N, J, seg, n_keep,
                                   rows_per_scale, splits, kb_per_split, s);
  return dispatch<float>(quant, bm, x, alphas, scale, idx, out, partial, M, K,
                         N, J, seg, n_keep, rows_per_scale, splits,
                         kb_per_split, s);
}
