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
// Walsh-Hadamard transform cropped to d_in: L log2 L additions per column,
// the same transform as fwht.cu on another input.
//
// What bounds it on the H100: the bytes, alphas read once and W written once
// (J * d_out + d_in * d_out values): at the ResNet-50 shapes in fp32 1.1,
// 4.5 and 17.8 MB (d_in 1152 / 2304 / 4608), 0.33, 1.33 and 5.33 us at
// 3.35 TB/s; the transform is d_out * L * log2 L fp32 additions, under 1 us
// at 67 TFLOP/s. The first, radix-2 kernel was bound by shared memory
// instead: log2 L radix-2 passes over the spectrum in shared memory, one
// block barrier each (13 passes x 8192 x 16 B for each of 512 columns at
// d_in 4608: 870 MB, about 29 us of its 45 us), a block per column (128
// blocks at d_in 1152, under one wave), and one 4-byte alpha word read per
// N-stride row.
//
// This kernel takes a tile of `rows` >= 4 adjacent columns per block
// (kernels/fwht.py:wht_plan with tile = ovsf_gemm.DEC_TILE) and runs the
// shared register-radix body of wht.cuh on their spectra:
//   1. issue the first alpha loads: work item (j, column group) reads one id
//      and one vector of adjacent columns of row j, 16 bytes (8 where a
//      tile is 4 bf16 columns), all of a thread's items in flight at once;
//   2. meanwhile zero the tile's spectra in shared memory (rows * L fp32,
//      swizzled as wht.cuh's exchange buffer), then scatter the alphas:
//      shared-memory atomic adds, so repeated ids sum, as the Pallas
//      kernel's sum over j does, or plain stores of 0 + alpha where the
//      wrapper has checked that no id repeats (fp32 atomicAdd to shared
//      memory is a compare-and-swap loop on sm_90a); an id out of [0, L)
//      traps;
//   3. stage 1 reads each thread's 32 contiguous elements with 16-byte reads,
//      then the same stages as fwht (one warp-local exchange up to L = 1024,
//      a second one with a block barrier above);
//   4. the last stage writes W^T (d_out, d_in) row by row, only k < d_in,
//      32 lanes on neighbouring k; the wrapper returns the transposed view,
//      which torch.matmul takes without a copy.
// With distinct ids each spectrum entry is 0 + alpha, exactly the plain
// version's index_add, so W equals the plain version bit for bit.
//
// The int8 / int4 epilogue (Q = 1 / 2; the Pallas kernel's _dequant_tile and
// _row_scales, repro/kernels/ovsf_gemm.py:64, :110): alphas stored as int8
// (J, d_out), or as packed int8 (J, d_out / 2) with two nibbles a byte (the
// low nibble the even column), with one fp32 scale per rows_per_scale rows.
// Step 1 loads a work item's quantised bytes (one 4- or 8-byte word where
// the tile is aligned), widens each value to fp32 and multiplies it by its
// row's scale: the one fp32 multiply of core.ovsf.dequantize_alphas, so the
// spectrum holds the plain version's values and W (fp32, as the Pallas
// kernel's output) still equals it bit for bit. The quantised bytes are
// what the kernel reads: J * d_out (int8) or J * d_out / 2 (int4) bytes
// against the 4 * d_in * d_out bytes of W it writes.
#include "wht.cuh"

namespace {

using wht::from_f;
using wht::to_f;

constexpr int U = 4;                         // work items in flight a thread
constexpr int MAX_W = 8;                     // columns of a 16-byte bf16 load

// `w` adjacent alphas from p (w * sizeof(T) bytes, aligned to that size when
// `vec`) into out.
template <typename T>
__device__ __forceinline__ void load_cols(const T* p, int w, bool vec,
                                          float* out) {
  const int bytes = w * (int)sizeof(T);
  if (vec && bytes == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i) out[i] = to_f(e[i]);
  } else if (vec && bytes == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int i = 0; i < 8 / (int)sizeof(T); ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < MAX_W; ++i)
      if (i < w) out[i] = to_f(p[i]);
  }
}

// A nibble of byte b, sign-extended: the high one (b's arithmetic shift) or
// the low one (the even column).
__device__ __forceinline__ int nibble(int b, int hi) {
  return hi ? (b >> 4) : (((b & 0xF) ^ 8) - 8);
}

// Signed value of column c of a quantised row: an int8 byte (Q = 1), or a
// nibble of a packed byte (Q = 2).
template <int Q>
__device__ __forceinline__ int quant_at(const signed char* row, int c) {
  if constexpr (Q == 1) return row[c];
  return nibble(row[c >> 1], c & 1);
}

// `w` adjacent quantised alphas from column c of `row`, widened and scaled:
// out[i] = float(q) * s, the plain version's one fp32 multiply. Where the
// tile is aligned (`vec`: c a multiple of w, even) the w values' bytes (w
// for int8, w / 2 for int4) come in one 2-, 4- or 8-byte load.
template <int Q>
__device__ __forceinline__ void load_quant(const signed char* row, int c,
                                           int w, bool vec, float s,
                                           float* out) {
  const int bytes = Q == 1 ? w : w / 2;
  const signed char* p = row + (Q == 1 ? c : c >> 1);
  if (vec && (bytes == 8 || bytes == 4 || bytes == 2)) {
    unsigned word[2] = {0u, 0u};
    if (bytes == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      word[0] = q.x;
      word[1] = q.y;
    } else if (bytes == 4) {
      word[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      word[0] = *reinterpret_cast<const unsigned short*>(p);
    }
#pragma unroll
    for (int i = 0; i < MAX_W; ++i) {
      if (i >= w) break;
      const int k = Q == 1 ? i : i >> 1;              // the value's byte
      const int b = (signed char)(word[k >> 2] >> (8 * (k & 3)));
      out[i] = (float)(Q == 1 ? b : nibble(b, i & 1)) * s;
    }
  } else {
#pragma unroll
    for (int i = 0; i < MAX_W; ++i)
      if (i < w) out[i] = (float)quant_at<Q>(row, c + i) * s;
  }
}

// alphas (J, N) of T (Q = 0), or quantised (Q = 1: int8 (J, N); Q = 2:
// packed (J, N / 2)) with scale[j / rows_per_scale]; idx (J,), wt (N, d_in);
// L = 2^LOG_L; rows as in wht_plan. Block b takes columns
// [b * rows, b * rows + rows).
template <typename T, int Q, int LOG_L>
__global__ void __launch_bounds__(LOG_L == 6 ? 256 : 1024)
ovsf_decompress_kernel(const void* alphas, const float* scale,
                       const int* idx, T* wt, int J, int N, int d_in,
                       int rows, int rows_per_scale, int distinct) {
  extern __shared__ __align__(16) float buf[];    // [rows * L], swizzled
  using S = wht::Stages<LOG_L>;
  constexpr int B = S::B, R = S::R, L = 1 << LOG_L;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int c0 = blockIdx.x * rows;
  const int cols = min(rows, N - c0);

  // Columns per load: 16 bytes (or the whole tile; quantised, at most
  // MAX_W columns), when every row's tile starts on such a boundary; else
  // one column at a time.
  int w = min(rows, Q ? MAX_W : 16 / (int)sizeof(T));
  const bool vec = N % w == 0;
  if (!vec) w = 1;
  const int groups = (cols + w - 1) / w;
  const int items = J * groups;
  int code[U];
  float a[U][MAX_W];
  auto load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int item = i0 + u * nt;
      if (item >= items) break;
      const int j = item / groups;
      const int c = (item - j * groups) * w;
      code[u] = idx[j];
      if constexpr (Q == 0) {
        load_cols(static_cast<const T*>(alphas) + (size_t)j * N + c0 + c,
                  min(w, cols - c), vec, a[u]);
      } else {
        const signed char* row = static_cast<const signed char*>(alphas) +
                                 (size_t)j * (Q == 1 ? N : N / 2);
        load_quant<Q>(row, c0 + c, min(w, cols - c), vec,
                      scale[j / rows_per_scale], a[u]);
      }
    }
  };
  // the first U items are in flight while the spectra are zeroed
  load(t);
  for (int e = 4 * t; e < rows * L; e += 4 * nt)
    *reinterpret_cast<float4*>(buf + e) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int i0 = t; i0 < items; i0 += U * nt) {
    if (i0 != t) load(i0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int item = i0 + u * nt;
      if (item >= items) break;
      if (code[u] < 0 || code[u] >= L) __trap();   // the wrapper checks too
      const int c = (item - (item / groups) * groups) * w;
#pragma unroll
      for (int i = 0; i < MAX_W; ++i) {
        if (i >= min(w, cols - c)) break;
        float* slot = buf + wht::swz(((c + i) << LOG_L) | code[u]);
        if (distinct)
          *slot = 0.f + a[u][i];    // the one add the plain version makes
        else
          atomicAdd(slot, a[u][i]);
      }
    }
  }
  __syncthreads();

  float v[R];
  wht::read_first<B>(v, buf, t);
  wht::transform<LOG_L>(v, buf, t);

  const int f0 = wht::flat0<B, S::LAST>(t);
  if constexpr (LOG_L < B) {
    // short columns: a thread's registers span R / L whole columns
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = (f0 + j) >> LOG_L, k = (f0 + j) & (L - 1);
      if (c < cols && k < d_in)
        from_f(v[j], wt + (size_t)(c0 + c) * d_in + k);
    }
  } else {
    // register j holds element k0 + (j << LAST) of column c
    const int c = f0 >> LOG_L, k0 = f0 & (L - 1);
    if (c < cols) {
      T* row = wt + (size_t)(c0 + c) * d_in + k0;
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (k0 + (j << S::LAST) < d_in) from_f(v[j], row + (j << S::LAST));
    }
  }
}

template <typename T, int Q, int LOG_L>
cudaError_t launch(const void* alphas, const float* scale, const void* idx,
                   void* wt, int J, int N, int d_in, int rows, int threads,
                   int smem, int rows_per_scale, int distinct,
                   cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  cudaError_t e =
      wht::opt_in(ovsf_decompress_kernel<T, Q, LOG_L>, smem, opted_in);
  if (e != cudaSuccess) return e;
  ovsf_decompress_kernel<T, Q, LOG_L><<<(N + rows - 1) / rows, threads, smem,
                                        stream>>>(
      alphas, scale, static_cast<const int*>(idx), static_cast<T*>(wt), J, N,
      d_in, rows, rows_per_scale, distinct);
  return cudaGetLastError();
}

}  // namespace

// alphas (J, N) float32 or bfloat16 (bf16 != 0), or with quant = 1 int8
// (J, N) and quant = 2 packed int4 (J, N / 2), 16-byte aligned; scale: one
// fp32 a rows_per_scale rows (read for quant > 0 only); idx (J,) int32 in
// [0, L), L = next_pow2(d_in) <= 32768; writes W^T as wt (N, d_in) in the
// alphas' type, fp32 for quantised alphas. The block shape (log2 regs,
// rows, threads, shared bytes, p2, p3) is kernels/fwht.py:wht_plan(L, elem
// bytes, tile)'s. distinct != 0: the caller has checked that no id repeats,
// so the scatter stores instead of adding atomically (the same sums: one add
// to zero). Returns the cudaError_t of the launch.
extern "C" int ovsf_decompress_launch(const void* alphas, const void* scale,
                                      const void* idx, void* wt, int J, int N,
                                      int d_in, int L, int bf16, int quant,
                                      int rows_per_scale, int log2_regs,
                                      int rows, int threads, int smem,
                                      int p2, int p3, int distinct,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0 || (L & (L - 1)) || L > (1 << 15) || d_in > L || N <= 0 ||
      rows <= 0 || threads <= 0 || threads % 32 || smem < 4 * rows * L ||
      quant < 0 || quant > 2 || (quant && (bf16 || rows_per_scale <= 0)) ||
      (quant == 2 && (N % 2 || rows % 2)))
    return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  return wht::dispatch(__builtin_ctz(L), [&](auto nc) -> cudaError_t {
    constexpr int LOG_L = decltype(nc)::value;
    if (!wht::plan_matches<LOG_L>(log2_regs, p2, p3) ||
        threads > (LOG_L == 6 ? 256 : 1024))
      return cudaErrorInvalidValue;
    if (quant == 1)
      return launch<float, 1, LOG_L>(alphas, sc, idx, wt, J, N, d_in, rows,
                                     threads, smem, rows_per_scale, distinct,
                                     s);
    if (quant == 2)
      return launch<float, 2, LOG_L>(alphas, sc, idx, wt, J, N, d_in, rows,
                                     threads, smem, rows_per_scale, distinct,
                                     s);
    if (bf16)
      return launch<__nv_bfloat16, 0, LOG_L>(alphas, sc, idx, wt, J, N, d_in,
                                             rows, threads, smem,
                                             rows_per_scale, distinct, s);
    return launch<float, 0, LOG_L>(alphas, sc, idx, wt, J, N, d_in, rows,
                                   threads, smem, rows_per_scale, distinct,
                                   s);
  });
}
