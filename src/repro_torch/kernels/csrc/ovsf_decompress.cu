// OVSF weight generation for Hopper (sm_90a): dense W (d_in, d_out) from
// (J, d_out) alphas and J monolithic code ids,
//   W[k, n] = sum_j H_L[idx[j], k] * alphas[j, n],  k < d_in,
// with H_L the Sylvester-Hadamard matrix, L = next_pow2(d_in); and, in
// its own kernel at the end of this file, from (n_seg, n_keep) segmented
// code ids (ovsf_decompress_seg_kernel).
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

// ---------------------------------------------------------------------------
// The segmented layout (the paper's Alg. 1): idx (n_seg, n_keep), each
// segment's codes of length L0 = d_in / n_seg touching only its own L0 rows,
//   W[e, s L0 + r, n] = sum_k (-1)^popc(idx[s, k] & r) * alphas[e, s n_keep + k, n],
// over a batch of E alpha sets sharing idx (an MoE expert bank; a dense
// linear is the batch of 1). Replaces the segmented branch of the same
// Pallas kernel (_gen_w_tile with seg / n_keep, _sign_tile:
// repro/kernels/ovsf_gemm.py:77), and with it the reference's jnp
// _segmented_decompress (repro/kernels/ops.py:76), which its LMs run for
// every linear under materialize and vmap over the experts of a bank under
// every plan (repro/models/moe.py:89-99): every LM config builds these codes
// (L0 16, n_keep 8).
//
// What bounds it on the H100: the bytes, alphas read once and W written once.
// TinyLlama-1.1B's five W of a layer in bf16: 86.0 MB of W and 43.0 MB of
// alphas, 0.0385 ms at 3.35 TB/s; OLMoE-1B-7B's three expert banks of a
// layer (64 experts): 805 MB of bf16 W and 403 MB of alphas, 0.361 ms. The
// transform is L0 log2 L0 fp32 adds a (segment, column), 4 an element of W
// at L0 16, about 2.6 us a TinyLlama layer at 67 TFLOP/s.
//
// Design. W is written as it is laid out, (E, d_in, N) row-major, straight
// from registers: the alphas and W are both contiguous along n, so a thread
// that takes C adjacent columns (C = 4; 2 at L0 32, the spectra's registers)
// reads C alphas of a row in one load (16 bytes fp32, 8 bf16, 4 int8, 2
// int4) and writes C values of a W row in one store (16 bytes fp32, 8
// bf16), and a warp's 32 lanes cover 32 C neighbouring columns: 256-512
// contiguous bytes a row on both sides, no shared memory, no barrier. Work
// item (e, s, column tile of 32 C) is one warp's; a persistent grid of
// seg_plan's blocks (MIN_BLOCKS an SM, the grid's size from the wrapper,
// which reads the SM count once) walks the items, column tiles fastest, a
// warp every blocks * WARPS items. A lane
//   1. loads the item's n_keep ids (the same address across the warp: one
//      broadcast load each; no host read and no id check before the launch,
//      so a step being captured needs none: an id outside [0, L0) traps)
//      and its C alphas of each of the segment's n_keep rows, all in flight
//      at once, as raw words (bytes in columns' order);
//   2. widens them to fp32 (int8 / int4 times the row's scale: the one fp32
//      multiply of core.ovsf.dequantize_alphas, as the monolithic epilogue)
//      and adds each into its id's slot of its C columns' L0-long spectra in
//      registers: the id is warp-uniform, so a binary tree of uniform
//      branches reaches a constant register index, without divergence;
//      repeated ids sum in k order, as the reference's einsum sums them,
//      with no atomics, so W is deterministic;
//   3. issues the loads of its next item (step 1), which stay in flight
//      while this item's transform and stores run;
//   4. runs each spectrum's log2 L0 radix-2 passes in core.ovsf.fwht's
//      order (wht::passes), fp32, and stores its C columns of the L0 rows,
//      one rounding to the output type.
// Ragged N (N % C != 0) loads the alphas a byte at a time and stores W a
// value at a time, masked past N, the same words and the same arithmetic.
// With fp32 or quantised alphas and distinct ids every spectrum slot is 0 +
// alpha and the passes are the plain version's adds in its order: W equals
// it bit for bit. bf16 alphas: W rounded to bf16 once, where the plain
// version (the reference's jnp) rounds after each pass.
namespace {
namespace seg {

constexpr int WARPS = 8;          // a block's warps (ovsf_gemm.py SEG_WARPS)
constexpr int MIN_BLOCKS = 2;     // blocks an SM holds (SEG_BLOCKS_PER_SM)

// adjacent columns a lane takes (ovsf_gemm.py seg_cols): C x L0 fp32
// spectra in registers
template <int L0>
constexpr int COLS = L0 >= 32 ? 2 : 4;

// A lane's C stored alphas of one row: BYTES bytes in WORDS 32-bit words,
// the first column's bytes lowest.
template <typename T, int Q, int C>
struct Raw {
  static constexpr int BYTES =
      Q == 0 ? C * (int)sizeof(T) : (Q == 1 ? C : C / 2);
  static constexpr int WORDS = (BYTES + 3) / 4;
};

// BYTES bytes from p, aligned to their size, in one load.
template <int BYTES, int WORDS>
__device__ __forceinline__ void load_vec(const unsigned char* p,
                                         unsigned (&w)[WORDS]) {
  if constexpr (BYTES == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else if constexpr (BYTES == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = q.x; w[1] = q.y;
  } else if constexpr (BYTES == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (BYTES == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(p);
  }
}

// Column c of a lane's raw words in fp32: a float, a bf16 (exact), or an
// int8 / a nibble of a packed byte (the low one the even column) times s.
template <typename T, int Q, int WORDS>
__device__ __forceinline__ float widen(const unsigned (&w)[WORDS], int c,
                                       float s) {
  if constexpr (Q == 0 && sizeof(T) == 4) {
    return __uint_as_float(w[c]);
  } else if constexpr (Q == 0) {
    return __uint_as_float(((w[c >> 1] >> (16 * (c & 1))) & 0xFFFFu) << 16);
  } else if constexpr (Q == 1) {
    return (float)(signed char)(w[c >> 2] >> (8 * (c & 3))) * s;
  } else {
    const int b = (signed char)(w[c >> 3] >> (8 * ((c >> 1) & 3)));
    return (float)nibble(b, c & 1) * s;
  }
}

// v[c][id] += a[c] for every column c, id warp-uniform in [LO, HI): uniform
// branches halve the range down to one constant index.
template <int LO, int HI, int C, int L0>
__device__ __forceinline__ void add_at(float (&v)[C][L0], int id,
                                       const float (&a)[C]) {
  if constexpr (HI - LO == 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c][LO] += a[c];
  } else {
    constexpr int MID = (LO + HI) / 2;
    if (id < MID)
      add_at<LO, MID>(v, id, a);
    else
      add_at<MID, HI>(v, id, a);
  }
}

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Row r of a lane's C columns to p (aligned to the C values) in one store:
// fp32, or bf16 rounded to nearest even (as __float2bfloat16).
template <int C, int L0>
__device__ __forceinline__ void store_row(float* p, const float (&v)[C][L0],
                                          int r) {
  if constexpr (C == 4)
    *reinterpret_cast<float4*>(p) =
        make_float4(v[0][r], v[1][r], v[2][r], v[3][r]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0][r], v[1][r]);
}
template <int C, int L0>
__device__ __forceinline__ void store_row(__nv_bfloat16* p,
                                          const float (&v)[C][L0], int r) {
  if constexpr (C == 4)
    *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0][r], v[1][r]),
                                              bf16_pair(v[2][r], v[3][r]));
  else
    *reinterpret_cast<unsigned*>(p) = bf16_pair(v[0][r], v[1][r]);
}

// alphas (E, J = n_seg n_keep, N) of T (Q = 0), or quantised (Q = 1: int8
// (E, J, N); Q = 2: packed (E, J, N / 2)) with scale[j / rows_per_scale];
// idx (n_seg, n_keep) in [0, L0), n_keep <= KMAX; w (E, n_seg L0, N). The
// grid walks items = E n_seg tiles, tiles = ceil(N / (32 C)): item i is
// (e, s, t) = (i / (n_seg tiles), i / tiles % n_seg, i % tiles), warp g of
// the grid takes items g, g + gridDim.x WARPS, ...; lane l of item (e, s, t)
// takes columns [n0, n0 + C), n0 = 32 C t + C l (none past N).
template <typename T, int Q, int LOG_L0, int KMAX>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS)
ovsf_decompress_seg_kernel(const void* alphas, const float* scale,
                           const int* idx, T* w, int E, int n_seg,
                           int n_keep, int N, int rows_per_scale) {
  constexpr int L0 = 1 << LOG_L0, C = COLS<L0>, TILE = 32 * C;
  using R = Raw<T, Q, C>;
  const int lane = threadIdx.x & 31;
  const int tiles = (N + TILE - 1) / TILE;
  const int items = E * n_seg * tiles;          // < 2^31: the launcher
  const int stride = gridDim.x * WARPS;
  const bool vec = N % C == 0;                  // rows on C-column words
  const size_t row_bytes =
      Q == 0 ? (size_t)N * sizeof(T) : (Q == 1 ? (size_t)N : (size_t)N / 2);
  // quantised alphas: one scale for the segment's rows where a scale
  // segment holds whole code segments (every LM config), else a row's
  const bool one_scale = Q && rows_per_scale % max(n_keep, 1) == 0;
  const unsigned char* base = static_cast<const unsigned char*>(alphas);

  unsigned raw[KMAX][R::WORDS];
  int code[KMAX];
  float sc = 0.f;
  // step 1 for item i: its ids, its scale, this lane's raw alphas
  auto fetch = [&](int i) {
    const int t = i % tiles, es = i / tiles;
    const int s = es % n_seg, e = es / n_seg;
    const int n0 = t * TILE + lane * C, j0 = s * n_keep;
    if constexpr (Q != 0)
      if (one_scale) sc = __ldg(scale + j0 / rows_per_scale);
    const unsigned char* p =
        base + ((size_t)e * n_seg * n_keep + j0) * row_bytes +
        (size_t)n0 * R::BYTES / C;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= n_keep) break;
      code[k] = __ldg(idx + j0 + k);
#pragma unroll
      for (int q = 0; q < R::WORDS; ++q) raw[k][q] = 0u;
      if (n0 >= N) continue;
      const unsigned char* row = p + k * row_bytes;
      if (vec) {
        load_vec<R::BYTES>(row, raw[k]);
      } else {
        // ragged N: byte b holds (part of) column n0 + b C / BYTES
#pragma unroll
        for (int b = 0; b < R::BYTES; ++b)
          if (n0 + b * C / R::BYTES < N)
            raw[k][b >> 2] |= (unsigned)__ldg(row + b) << (8 * (b & 3));
      }
    }
  };

  int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (i < items) fetch(i);
  for (; i < items; i += stride) {
    const int t = i % tiles, es = i / tiles;
    const int s = es % n_seg, e = es / n_seg;
    const int n0 = t * TILE + lane * C, j0 = s * n_keep;
    float v[C][L0];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < L0; ++r) v[c][r] = 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k >= n_keep) break;
      if ((unsigned)code[k] >= (unsigned)L0) __trap();  // no host check
      const float s_k =
          Q == 0 ? 0.f
                 : (one_scale ? sc
                              : __ldg(scale + (j0 + k) / rows_per_scale));
      float a[C];
#pragma unroll
      for (int c = 0; c < C; ++c) a[c] = widen<T, Q>(raw[k], c, s_k);
      add_at<0, L0>(v, code[k], a);
    }
    // the next item's loads fly while this one's transform and stores run
    if (i + stride < items) fetch(i + stride);
#pragma unroll
    for (int c = 0; c < C; ++c) wht::passes<LOG_L0, 0, LOG_L0>(v[c]);
    if (n0 < N) {
      T* out = w + ((size_t)e * n_seg + s) * L0 * (size_t)N + n0;
#pragma unroll
      for (int r = 0; r < L0; ++r) {
        T* row = out + (size_t)r * N;
        if (vec) {
          store_row<C, L0>(row, v, r);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (n0 + c < N) from_f(v[c][r], row + c);
        }
      }
    }
  }
}

template <typename T, int Q, int LOG_L0, int KMAX>
cudaError_t launch(const void* alphas, const float* scale, const void* idx,
                   void* w, int E, int n_seg, int n_keep, int N,
                   int rows_per_scale, int blocks, cudaStream_t stream) {
  ovsf_decompress_seg_kernel<T, Q, LOG_L0, KMAX><<<blocks, 32 * WARPS, 0,
                                                   stream>>>(
      alphas, scale, static_cast<const int*>(idx), static_cast<T*>(w), E,
      n_seg, n_keep, N, rows_per_scale);
  return cudaGetLastError();
}

// n_keep <= L0 / 2 (every LM config: 8 of 16) holds half the ids and raw
// words in registers
template <typename T, int Q, int LOG_L0>
cudaError_t launch_keep(const void* alphas, const float* scale,
                        const void* idx, void* w, int E, int n_seg,
                        int n_keep, int N, int rows_per_scale, int blocks,
                        cudaStream_t stream) {
  constexpr int L0 = 1 << LOG_L0;
  if constexpr (L0 > 1) {
    if (2 * n_keep <= L0)
      return launch<T, Q, LOG_L0, L0 / 2>(alphas, scale, idx, w, E, n_seg,
                                          n_keep, N, rows_per_scale, blocks,
                                          stream);
  }
  return launch<T, Q, LOG_L0, L0>(alphas, scale, idx, w, E, n_seg, n_keep,
                                  N, rows_per_scale, blocks, stream);
}

}  // namespace seg
}  // namespace

// The segmented layout over a batch of E alpha sets sharing idx: alphas
// (E, n_seg * n_keep, N) float32 or bfloat16 (bf16 != 0), or with quant = 1
// int8 (E, J, N) and quant = 2 packed int4 (E, J, N / 2) with one fp32
// scale a rows_per_scale rows (the same for every batch entry), 16-byte
// aligned; idx (n_seg, n_keep) int32 in [0, L0), L0 = d_in / n_seg a power
// of two up to 32, n_keep <= L0; writes W as w (E, d_in, N), 16-byte
// aligned, in the alphas' type (fp32 for quantised alphas), over a grid of
// `blocks` blocks (kernels/ovsf_gemm.py:seg_plan). Returns the cudaError_t
// of the launch.
extern "C" int ovsf_decompress_seg_launch(const void* alphas,
                                          const void* scale, const void* idx,
                                          void* w, int E, int n_seg,
                                          int n_keep, int N, int d_in,
                                          int bf16, int quant,
                                          int rows_per_scale, int blocks,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || n_seg <= 0 || N <= 0 || d_in <= 0 || d_in % n_seg ||
      blocks <= 0)
    return cudaErrorInvalidValue;
  const int L0 = d_in / n_seg;
  if ((L0 & (L0 - 1)) || L0 > 32 || n_keep < 0 || n_keep > L0 || quant < 0 ||
      quant > 2 || (quant && (bf16 || rows_per_scale <= 0)) ||
      (quant == 2 && N % 2))
    return cudaErrorInvalidValue;
  const long long tile = 32LL * (L0 >= 32 ? 2 : 4);   // 32 COLS<L0>
  if ((long long)E * n_seg * ((N + tile - 1) / tile) >= (1LL << 31))
    return cudaErrorInvalidValue;
  const float* sc = static_cast<const float*>(scale);
  const int log_l0 = __builtin_ctz(L0);
  return wht::dispatch(log_l0, [&](auto nc) -> cudaError_t {
    constexpr int LOG_L0 = decltype(nc)::value;
    if constexpr (LOG_L0 > 5) {
      return cudaErrorInvalidValue;
    } else {
      if (quant == 1)
        return seg::launch_keep<float, 1, LOG_L0>(
            alphas, sc, idx, w, E, n_seg, n_keep, N, rows_per_scale, blocks,
            s);
      if (quant == 2)
        return seg::launch_keep<float, 2, LOG_L0>(
            alphas, sc, idx, w, E, n_seg, n_keep, N, rows_per_scale, blocks,
            s);
      if (bf16)
        return seg::launch_keep<__nv_bfloat16, 0, LOG_L0>(
            alphas, sc, idx, w, E, n_seg, n_keep, N, rows_per_scale, blocks,
            s);
      return seg::launch_keep<float, 0, LOG_L0>(
          alphas, sc, idx, w, E, n_seg, n_keep, N, rows_per_scale, blocks,
          s);
    }
  });
}
