// Fused on-the-fly OVSF GEMM for Hopper (sm_90a): y = x @ W(alphas, idx).
//
// Replaces the Pallas TPU kernel repro/kernels/ovsf_gemm.py:ovsf_gemm
// (_ovsf_gemm_kernel, _gen_w_tile, _sign_tile) and its quantised-alpha
// epilogue (_dequant_tile, _row_scales). W is never stored: a block
// regenerates each weight tile it is about to consume,
//   W[k, n] = sum_j (-1)^popcount(idx[j] & k') * alphas[j, n],
// with k' = k (monolithic codes, idx (J,)) or k' = k mod L0 restricted to
// the j of k's own segment (segmented codes, idx (n_seg, n_keep)). Alpha
// storage (QUANT): 0 = the type of x; 1 = int8 (J, N); 2 = int4, two
// nibbles per byte (J, N/2), the low nibble the even column, both
// sign-extended; quantised alphas carry one fp32 scale per rows_per_scale
// rows. Two kernels live here; the wrapper (kernels/ovsf_gemm.py, route)
// picks one per call from (x dtype, code layout, alpha storage).
//
// 1. ovsf_gemm_tc_kernel, on the tensor cores: bf16 x, segmented codes
//    with L0 = 16 and n_keep <= 16, all three storages (N a multiple of
//    8 / 16 / 32 for bf16 / int8 / int4, so a tile row is whole 16-byte
//    words; quantised: a scale segment holds whole code segments). Every
//    bf16-x call of the serving path takes it: TinyLlama's q, o, gate, up
//    and down at M = 4 (decode), 128 (mixed bucket) and 256 (paged window).
//
//    What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16): the stored
//    alpha bytes, J * N * (2 | 1 | 1/2), plus x, y, idx and the scales; a
//    decode layer moves 43 / 22 / 11 MB (12.9 / 6.5 / 3.3 us). Operations:
//    2 * M * K * N for the product and 2 * K * N * n_keep for generation,
//    0.34 + 0.69 GFLOP per decode layer (about 1 us): decode is bound by
//    bytes. At M = 256 the product is 22 GFLOP a layer (22 us at the peak
//    rate), above the bf16 alphas' 12.9 us: bound by operations. What the
//    design does about it:
//
//    * An asynchronous alpha stream. A block owns BN = 64 output columns,
//      all M rows (up to 256; more go to grid.z chunks of 256) and a run of
//      k-blocks of BK = 128 rows (8 code segments). Each k-block's alpha
//      rows (8 segments x n_keep rows padded to PK = 8 or 16, the stored
//      bytes as they are), its x slice (M x 128 bf16: x reaches shared
//      memory once per block) and its ids and scales land in one stage of
//      a ring of 2-8 stages in shared memory by 16-byte cp.async,
//      neighbouring threads on neighbouring words; padding rows and ragged
//      edges are zero-filled by the copy itself. Up to stages - 1 k-blocks
//      are in flight (72 KB a block up to M = 64, three blocks an SM); the
//      one barrier per k-block guards only the slot about to be refilled.
//    * Generation on the tensor cores. Each of the 4 warps owns 16 output
//      columns. For a segment s (16 rows of W) it computes
//        W_s^T (16 n x 16 k) = alphas_s^T (16 n x PK j) . S_s^T (PK j x 16 k)
//      as two mma.sync m16n8k8 (PK = 8) or m16n8k16 (PK = 16). Segmented W
//      is block-diagonal, so only the segment's own rows enter. bf16
//      alphas come by ldmatrix.trans; int8 / int4 ones are widened from the
//      stored bytes to fp16 (exact: a byte permute to 1024 + u and one
//      half2 subtraction per two values; a warp's rows are ordered so that
//      a thread's two rows are neighbouring stored columns) and generate in
//      fp16, exact in fp32. The +-1 signs are built in registers from the
//      ids and a per-thread parity mask. The segment's scale multiplies the
//      fp32 sum, after the +-1 contraction.
//    * The product on the tensor cores, A and B swapped:
//        Y^T (16 n x 8 m) += W_s^T (16 n x 16 k) . x_s^T (16 k x 8 m)
//      by mma.sync m16n8k16. The generation's two fp32 accumulator
//      fragments are, element for element, the product's A fragment once
//      rounded to bf16: W goes from the tensor cores to bf16 registers and
//      back without touching shared memory. The output width fills the
//      16-row side, the tokens the 8-wide side (M = 4 pads to 8), and each
//      W_s^T fragment is generated once and applied to all M rows of the
//      block. mma.sync rather than wgmma: wgmma takes A from registers only
//      as 64-row warpgroup tiles and B from shared memory, which would
//      stage the generated W through shared memory for a product that does
//      not bound decode; mma.sync keeps M = 128 and 256 inside their
//      targets (PERF.md).
//    * Split-K with a bounded cost (kernels/ovsf_gemm.py, tc_plan). Decode
//      has 32-88 column tiles for 132 SMs, so the k-blocks are split over
//      up to 16 blocks, as far as one wave holds them, and only while the
//      fp32 partials (written and read once) stay within 4x the stored
//      alpha bytes: at decode they move 6-13% of the bf16 alphas' bytes
//      (at most half of the int4 ones'); at M = 128 and 256 the splits drop
//      to 1-4. Each split writes its
//      partial; the tile's last split to take an integer ticket sums them
//      in split order and writes y, then resets the ticket: one launch, no
//      floating-point atomics, deterministic. Its loads are all in flight
//      at once: every split's at M <= 16 (a value a thread), eight float4
//      columns' above. One split writes y directly.
//
// 2. ovsf_gemm_kernel, the first kernel, on the CUDA cores, kept as it was
//    for every other case: fp32 x (held to 2e-3 against the plain version,
//    which bf16 or TF32 operands would not meet), monolithic codes (a conv
//    planned fused; no plan does so at batch 8), L0 != 16, n_keep > 16,
//    N off the word multiple, and quantised alphas whose scale segments
//    cut through a code segment. Alphas stage through shared memory in
//    BJ-row chunks (quantised ones dequantised while staged), the W tile is
//    built in shared memory with fp32 sign-MACs, x @ W runs on the fp32
//    CUDA cores, and split-K partials are summed in a fixed order by a
//    second small kernel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

// ---------------------------------------------------------------------------
// 1. The tensor-core kernel (bf16 x, segmented codes with L0 = 16).
// ---------------------------------------------------------------------------
namespace {
namespace tc {

constexpr int COL_WARPS = 4;        // warps across a block's columns
constexpr int BN = 16 * COL_WARPS;  // output columns per block, 16 a warp
constexpr int SEG = 16;             // code segment length L0
constexpr int BK = 128;             // k rows per k-block
constexpr int SEGS = BK / SEG;      // code segments per k-block
constexpr int MMAX = 256;           // rows of M per block (grid.z beyond)
constexpr int PAD = 16;             // bytes after each shared-memory row:
                                    // ldmatrix's 8 rows hit 8 bank groups
constexpr int MAX_STAGES = 8;
constexpr int MAX_SPLITS = 16;
constexpr int THREADS = 32 * COL_WARPS;
// the ring's shared memory: three blocks an SM up to M = 64, two up to
// M = 128, one above (kernels/ovsf_gemm.py, tc_blocks_per_sm)
template <int MT>
constexpr int ring_bytes() {
  return MT <= 8 ? 72 * 1024 : MT <= 16 ? 110 * 1024 : 200 * 1024;
}

// bytes of one stored alpha row of the tile, and its shared-memory pitch
template <int QUANT>
__host__ __device__ constexpr int alpha_row_bytes() {
  return QUANT == 0 ? BN * 2 : QUANT == 1 ? BN : BN / 2;
}
template <int QUANT>
__host__ __device__ constexpr int alpha_pitch() {
  return alpha_row_bytes<QUANT>() + PAD;
}
constexpr int WPITCH = BN * 2 + PAD;        // a bf16 alpha row
constexpr int XPITCH = BK * 2 + PAD;        // one x row of a k-block

// One ring stage: the k-block's alpha rows (segment s at rows s * PK), its
// x slice, its code ids and its segments' scales.
template <int MT, int PK, int QUANT>
struct Layout {
  static constexpr int R = SEGS * PK;
  static constexpr int ALPHA = R * alpha_pitch<QUANT>();
  static constexpr int X = MT * 8 * XPITCH;
  static constexpr int IDX = SEGS * 16 * 4;             // up to 16 ids a seg
  static constexpr int SCALE = QUANT ? SEGS * 4 : 0;
  static constexpr int STAGE = ALPHA + X + IDX + SCALE;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared, asynchronously; the first src_bytes are
// copied and the rest zero-filled (src_bytes = 0: zeros, nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most n groups of this thread are still in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

__device__ __forceinline__ void ldsm_x2(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d = a (16x8, row) . b (8x8, col), bf16 in, fp32 out
__device__ __forceinline__ void mma_k8(float* d, const unsigned* a,
                                       unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b), "f"(0.f));
}
// the same in fp16: int8 / int4 alphas and the signs are exact there
__device__ __forceinline__ void mma_k8_f16(float* d, const unsigned* a,
                                           unsigned b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b), "f"(0.f));
}
__device__ __forceinline__ void mma_k16_f16(float* d, const unsigned* a,
                                            unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = a (16x16, row) . b (16x8, col) + d, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_k16(float* d, const unsigned* a,
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Bit v of parity_mask(c): popcount(v & c) odd, for the 16 code ids v < 16.
__device__ __forceinline__ unsigned parity_mask(int code) {
  unsigned m = 0u;
#pragma unroll
  for (int v = 0; v < SEG; ++v) m |= (unsigned)(__popc(v & code) & 1) << v;
  return m;
}

// The bf16 (ONE = 0x3F80) or fp16 (0x3C00) bits of the signs
// (-1)^popcount(id & code) of rows j and j + 1 of a segment (low half j),
// from the code's parity mask. A padding row (j >= n_keep) reads a
// neighbour's id: its alphas are zero, so any sign gives the same sum.
template <unsigned ONE>
__device__ __forceinline__ unsigned sign_pair(const int* ids, int j,
                                              unsigned mask) {
  return (ONE | ONE << 16) | (((mask >> ids[j]) & 1u) << 15) |
         (((mask >> ids[j + 1]) & 1u) << 31);
}

// Stage one k-block. Padding rows, columns past N, rows past M, columns
// past K, ids past J and segments past K are zero-filled, so every k-block
// is computed as a whole 8 segments.
template <int MT, int PK, int QUANT>
__device__ __forceinline__ void load_stage(
    char* st, const __nv_bfloat16* __restrict__ x, const char* __restrict__ al,
    const int* __restrict__ idx, const float* __restrict__ scale, int kb,
    int m0, int n0, int M, int K, int N, int J, int n_keep,
    int segs_per_scale) {
  using L = Layout<MT, PK, QUANT>;
  constexpr int CH = alpha_row_bytes<QUANT>() / 16;      // words a row
  constexpr int COLS = QUANT == 0 ? 8 : QUANT == 1 ? 16 : 32;
  const int tid = threadIdx.x;
  const int s0 = kb * SEGS;
  const int nseg = K / SEG;
  const size_t gpitch = (size_t)N * alpha_row_bytes<QUANT>() / BN;
  const size_t gcol = (size_t)n0 * alpha_row_bytes<QUANT>() / BN;
  for (int e = tid; e < L::R * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const int sl = r / PK, jj = r % PK;
    const bool ok = s0 + sl < nseg && jj < n_keep && n0 + c * COLS < N;
    const char* src =
        ok ? al + (size_t)((s0 + sl) * n_keep + jj) * gpitch + gcol + c * 16
           : al;
    cp_async16(st + r * alpha_pitch<QUANT>() + c * 16, src, ok ? 16 : 0);
  }
  char* xs = st + L::ALPHA;
  const int k0 = kb * BK;
  for (int e = tid; e < MT * 8 * (BK / 8); e += THREADS) {
    const int r = e / (BK / 8), c = e % (BK / 8);
    const int m = m0 + r, k = k0 + c * 8;
    const bool ok = m < M && k < K;
    const __nv_bfloat16* src = ok ? x + (size_t)m * K + k : x;
    cp_async16(xs + r * XPITCH + c * 16, src, ok ? 16 : 0);
  }
  char* is = xs + L::X;
  const int i0 = s0 * n_keep;                // 16-byte aligned: 8 | SEGS
  for (int e = tid; e * 4 < SEGS * n_keep; e += THREADS) {
    const int left = J - (i0 + e * 4);
    const int bytes = left <= 0 ? 0 : left >= 4 ? 16 : left * 4;
    cp_async16(is + e * 16, bytes ? idx + i0 + e * 4 : idx, bytes);
  }
  if constexpr (QUANT != 0) {
    if (tid < SEGS) {
      const bool ok = s0 + tid < nseg;
      cp_async4(is + L::IDX + tid * 4,
                ok ? scale + (s0 + tid) / segs_per_scale : scale,
                ok ? 4 : 0);
    }
  }
}

// The output column of row g + 8 h (g < 8) of a warp's 16-row fragments.
// int8 / int4 tiles order the rows so that a thread's two rows are two
// neighbouring stored columns (one 2-byte or 1-byte load per alpha row).
template <int QUANT>
__device__ __forceinline__ int frag_col(int g, int h) {
  return QUANT == 0 ? g + 8 * h : 2 * g + h;
}

// A fragment rows 2 tig + 8 i, 2 tig + 8 i + 1 of a segment's int8 / int4
// alphas (raw: the stage's alpha row r0 = 2 tig + 8 i, at the warp's first
// stored byte), as {columns 2 g, 2 g + 1} x {rows r0, r0 + 1} in fp16,
// exact: a byte or nibble u (biased to unsigned) becomes the fp16 1024 + u
// by one byte permute, less the bias by one half2 subtraction.
template <int QUANT>
__device__ __forceinline__ void stored_pair(const char* raw, int g,
                                            unsigned* a_lo, unsigned* a_hi) {
  constexpr int P = alpha_pitch<QUANT>();
  unsigned lo, hi;                     // u of (r0, c), (r0 + 1, c) per half
  if constexpr (QUANT == 1) {
    // bytes (r0, 2g), (r0, 2g + 1), (r0 + 1, 2g), (r0 + 1, 2g + 1), + 128
    const unsigned w =
        ((unsigned)*reinterpret_cast<const unsigned short*>(raw + 2 * g) |
         (unsigned)*reinterpret_cast<const unsigned short*>(raw + P + 2 * g)
             << 16) ^ 0x80808080u;
    lo = __byte_perm(w, 0x64u, 0x4240);
    hi = __byte_perm(w, 0x64u, 0x4341);
  } else {
    // nibbles (r0, 2g), (r0, 2g + 1) | (r0 + 1, ...) << 8, + 8
    const unsigned w = ((unsigned)(unsigned char)raw[g] |
                        (unsigned)(unsigned char)raw[P + g] << 8) ^ 0x8888u;
    lo = __byte_perm(w & 0x0F0Fu, 0x64u, 0x4140);
    hi = __byte_perm((w >> 4) & 0x0F0Fu, 0x64u, 0x4140);
  }
  const __half2 bias = QUANT == 1 ? __halves2half2(__float2half(1152.f),
                                                   __float2half(1152.f))
                                  : __halves2half2(__float2half(1032.f),
                                                   __float2half(1032.f));
  __half2 l = __hsub2(*reinterpret_cast<__half2*>(&lo), bias);
  __half2 h = __hsub2(*reinterpret_cast<__half2*>(&hi), bias);
  *a_lo = *reinterpret_cast<unsigned*>(&l);   // column 2 g
  *a_hi = *reinterpret_cast<unsigned*>(&h);   // column 2 g + 1
}

// One warp, segments [s0, s0 + SG) of a stage: generate each W_s^T
// fragment (16 columns x 16 k) on the tensor cores, scale it, round it to
// bf16 and apply it to every 8 rows of M.
template <int MT, int PK, int QUANT, int SG>
__device__ __forceinline__ void segments(float (*acc)[4], const char* st,
                                         const char* xs, const int* ids,
                                         const float* scl, int s0, int n_keep,
                                         unsigned mask0, unsigned mask1,
                                         int warp, int lane) {
  const int g = lane / 4, tig = lane % 4;
  const unsigned mask[2] = {mask0, mask1};
  unsigned aw[SG][4];
  {
    // alphas^T fragments (rows n, columns j): bf16 by ldmatrix.trans, int8
    // and int4 widened to fp16 from the stored bytes
    unsigned af[SG][PK / 4];
#pragma unroll
    for (int s = 0; s < SG; ++s) {
      if constexpr (QUANT == 0) {
        const char* p = st + warp * 32 + ((lane / 8) % 2) * 16;
        if constexpr (PK == 8)
          ldsm_x2_trans(af[s], p + ((s0 + s) * PK + lane % 8) * WPITCH);
        else
          ldsm_x4_trans(af[s], p + ((s0 + s) * PK + (lane / 16) * 8 +
                                    lane % 8) * WPITCH);
      } else {
        const char* raw = st + warp * alpha_row_bytes<QUANT>() / COL_WARPS +
                          ((s0 + s) * PK + 2 * tig) * alpha_pitch<QUANT>();
#pragma unroll
        for (int i = 0; i < PK / 8; ++i)
          stored_pair<QUANT>(raw + 8 * i * alpha_pitch<QUANT>(), g,
                             &af[s][2 * i], &af[s][2 * i + 1]);
      }
    }
#pragma unroll
    for (int s = 0; s < SG; ++s) {
      const int* sid = ids + (s0 + s) * n_keep;
      float w[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {        // W rows 8 h + g of the segment
        constexpr unsigned ONE = QUANT == 0 ? 0x3F80u : 0x3C00u;
        const unsigned b0 = sign_pair<ONE>(sid, 2 * tig, mask[h]);
        if constexpr (PK == 8) {
          if constexpr (QUANT == 0) mma_k8(w[h], af[s], b0);
          else mma_k8_f16(w[h], af[s], b0);
        } else {
          const unsigned b1 = sign_pair<ONE>(sid, 2 * tig + 8, mask[h]);
          w[h][0] = w[h][1] = w[h][2] = w[h][3] = 0.f;
          if constexpr (QUANT == 0) mma_k16(w[h], af[s], b0, b1);
          else mma_k16_f16(w[h], af[s], b0, b1);
        }
      }
      if constexpr (QUANT != 0) {      // the segment's scale, after the sum
        const float sc = scl[s0 + s];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q) w[h][q] *= sc;
      }
      // the two accumulator fragments are the product's A fragment
      aw[s][0] = pack_bf16(w[0][0], w[0][1]);
      aw[s][1] = pack_bf16(w[0][2], w[0][3]);
      aw[s][2] = pack_bf16(w[1][0], w[1][1]);
      aw[s][3] = pack_bf16(w[1][2], w[1][3]);
    }
  }
  // x^T fragments (b0, b1) of 8 rows of M and one segment's 16 k; the
  // loads of a batch are issued before its products
  const char* xp = xs + (lane % 8) * XPITCH + ((lane / 8) % 2) * 16;
  if constexpr (MT == 1) {
    unsigned bx[SG][2];
#pragma unroll
    for (int s = 0; s < SG; ++s) ldsm_x2(bx[s], xp + (s0 + s) * SEG * 2);
#pragma unroll
    for (int s = 0; s < SG; ++s) mma_k16(acc[0], aw[s], bx[s][0], bx[s][1]);
  } else {
    constexpr int TB = MT < 8 ? MT : 8;
    // ldmatrix.x4: matrices 0-1 rows t, matrices 2-3 rows t + 1
    const char* xq = xp + (lane / 16) * 8 * XPITCH;
#pragma unroll
    for (int s = 0; s < SG; ++s)
#pragma unroll
      for (int t0 = 0; t0 < MT; t0 += TB) {
        unsigned bx[TB][2];
#pragma unroll
        for (int t = 0; t < TB; t += 2)
          ldsm_x4(&bx[t][0], xq + (t0 + t) * 8 * XPITCH + (s0 + s) * SEG * 2);
#pragma unroll
        for (int t = 0; t < TB; ++t)
          mma_k16(acc[t0 + t], aw[s], bx[t][0], bx[t][1]);
      }
  }
}

// grid (N tiles, splits, M chunks of MMAX), THREADS threads, dynamic shared
// memory stages * STAGE. partial (splits, M, N) fp32 and tickets
// (one zeroed uint32 per (M chunk, N tile)) are used when splits > 1.
template <int MT, int PK, int QUANT>
__global__ void __launch_bounds__(THREADS)
ovsf_gemm_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const void* __restrict__ alphas,
                    const float* __restrict__ scale,
                    const int* __restrict__ idx,
                    __nv_bfloat16* __restrict__ out, float* partial,
                    unsigned* tickets, int M, int K, int N, int J,
                    int n_keep, int segs_per_scale, int kb_per_split,
                    int stages) {
  using L = Layout<MT, PK, QUANT>;
  // generation keeps the fragments of all 8 segments live at small M, of
  // two at a time at large M (the accumulators need the registers)
  constexpr int SG = MT >= 16 ? 2 : SEGS;
  extern __shared__ __align__(128) char smem[];
  __shared__ int last_block;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.z * MMAX;
  const int nkb = (K + BK - 1) / BK;
  const int kb0 = blockIdx.y * kb_per_split;
  const int nloc = min(nkb, kb0 + kb_per_split) - kb0;
  const char* al = static_cast<const char*>(alphas);

  // the ring: stages - 1 k-blocks in flight before the first is consumed;
  // every thread commits one group per k-block, empty past the range
  for (int i = 0; i < stages - 1; ++i) {
    if (i < nloc)
      load_stage<MT, PK, QUANT>(smem + i * L::STAGE, x, al, idx, scale,
                                kb0 + i, m0, n0, M, K, N, J, n_keep,
                                segs_per_scale);
    cp_async_commit();
  }
  // the sign bits of this thread's two W rows of a segment, by code id
  const unsigned mask0 = parity_mask(lane / 4);
  const unsigned mask1 = parity_mask(8 + lane / 4);
  float acc[MT][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  for (int i = 0; i < nloc; ++i) {
    cp_async_wait(stages - 2);         // this thread's copies of k-block i
    __syncthreads();                   // everyone's; slot of i - 1 is free
    {
      const int nxt = i + stages - 1;
      if (nxt < nloc)
        load_stage<MT, PK, QUANT>(smem + (nxt % stages) * L::STAGE, x, al,
                                  idx, scale, kb0 + nxt, m0, n0, M, K, N, J,
                                  n_keep, segs_per_scale);
      cp_async_commit();
    }
    const char* st = smem + (i % stages) * L::STAGE;
    const char* xs = st + L::ALPHA;
    const int* ids = reinterpret_cast<const int*>(xs + L::X);
    const float* scl = reinterpret_cast<const float*>(xs + L::X + L::IDX);
#pragma unroll
    for (int s0 = 0; s0 < SEGS; s0 += SG)
      segments<MT, PK, QUANT, SG>(acc, st, xs, ids, scl, s0, n_keep, mask0,
                                  mask1, warp, lane);
  }
  cp_async_wait(0);

  // acc[t]: (n g, m 2 tig), (n g, m 2 tig + 1), (n g + 8, ...), (...)
  const int splits = gridDim.y;
  {
    const int g = lane / 4, tig = lane % 4;
    float* part = partial + (size_t)blockIdx.y * M * N;
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + t * 8 + 2 * tig + (q & 1);
        const int n = n0 + warp * 16 + frag_col<QUANT>(g, q >> 1);
        if (m < M && n < N) {
          if (splits == 1)
            out[(size_t)m * N + n] = __float2bfloat16(acc[t][q]);
          else
            part[(size_t)m * N + n] = acc[t][q];
        }
      }
  }
  if (splits == 1) return;
  // split-K: the last of the tile's splits to take a ticket sums the fp32
  // partials in split order (deterministic), writes y and resets the
  // ticket
  __syncthreads();                     // the block's partials, then release
  unsigned* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) {
    __threadfence();
    last_block = atomicAdd(ticket, 1u) == (unsigned)splits - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if constexpr (MT <= 2) {
    // a few rows: a value a thread, every split's load in flight
    const int rows = min(MT * 8, M - m0);
    for (int e = tid; e < rows * BN; e += THREADS) {
      const int m = m0 + e / BN, n = n0 + e % BN;
      if (n >= N) continue;
      const float* p = partial + (size_t)m * N + n;
      float v[MAX_SPLITS];
#pragma unroll
      for (int z = 0; z < MAX_SPLITS; ++z)
        v[z] = z < splits ? __ldcg(p + (size_t)z * M * N) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int z = 0; z < MAX_SPLITS; ++z) sum += v[z];   // split order
      out[(size_t)m * N + n] = __float2bfloat16(sum);
    }
    if (tid == 0) *ticket = 0u;
    return;
  }
  // many rows: 4 columns a thread, U of them with their loads in flight
  const int quads = min(MT * 8, M - m0) * (BN / 4);   // N is a multiple of 8
  constexpr int U = 8;
  for (int e0 = tid; e0 < quads; e0 += U * THREADS) {
    float4 sum[U];
#pragma unroll
    for (int u = 0; u < U; ++u) sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < splits; ++z) {     // split order
      float4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS;
        const int m = m0 + e / (BN / 4), n = n0 + (e % (BN / 4)) * 4;
        v[u] = e < quads && n < N
                   ? __ldcg(reinterpret_cast<const float4*>(
                         partial + ((size_t)z * M + m) * N + n))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sum[u].x += v[u].x;
        sum[u].y += v[u].y;
        sum[u].z += v[u].z;
        sum[u].w += v[u].w;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      const int m = m0 + e / (BN / 4), n = n0 + (e % (BN / 4)) * 4;
      if (e < quads && n < N) {
        uint2 o;
        o.x = pack_bf16(sum[u].x, sum[u].y);
        o.y = pack_bf16(sum[u].z, sum[u].w);
        *reinterpret_cast<uint2*>(out + (size_t)m * N + n) = o;
      }
    }
  }
  if (tid == 0) *ticket = 0u;
}

template <int MT, int PK, int QUANT>
cudaError_t launch(const void* x, const void* alphas, const void* scale,
                   const void* idx, void* out, void* partial, void* tickets,
                   int M, int K, int N, int J, int n_keep, int segs_per_scale,
                   int kb_per_split, int splits, cudaStream_t stream) {
  using L = Layout<MT, PK, QUANT>;
  auto kern = ovsf_gemm_tc_kernel<MT, PK, QUANT>;
  const int stages = max(2, min(MAX_STAGES, ring_bytes<MT>() / L::STAGE));
  const int smem = stages * L::STAGE;
  static int smem_set = 0;               // per instantiation
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  dim3 grid((N + BN - 1) / BN, splits, (M + MMAX - 1) / MMAX);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), alphas,
      static_cast<const float*>(scale), static_cast<const int*>(idx),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial),
      static_cast<unsigned*>(tickets), M, K, N, J, n_keep, segs_per_scale,
      kb_per_split, stages);
  return cudaGetLastError();
}

template <int PK, int QUANT>
cudaError_t dispatch_mt(const void* x, const void* alphas, const void* scale,
                        const void* idx, void* out, void* partial,
                        void* tickets, int M, int K, int N, int J, int n_keep,
                        int segs_per_scale, int kb_per_split, int splits,
                        cudaStream_t s) {
  const int rows = M < MMAX ? M : MMAX;
#define OVSF_TC_MT(mt)                                                       \
  if (rows <= (mt) * 8)                                                      \
    return launch<mt, PK, QUANT>(x, alphas, scale, idx, out, partial,        \
                                 tickets, M, K, N, J, n_keep,                \
                                 segs_per_scale, kb_per_split, splits, s);
  OVSF_TC_MT(1) OVSF_TC_MT(2) OVSF_TC_MT(4) OVSF_TC_MT(8) OVSF_TC_MT(16)
  OVSF_TC_MT(32)
#undef OVSF_TC_MT
  return cudaErrorInvalidValue;
}

template <int PK>
cudaError_t dispatch_quant(int quant, const void* x, const void* alphas,
                           const void* scale, const void* idx, void* out,
                           void* partial, void* tickets, int M, int K, int N,
                           int J, int n_keep, int segs_per_scale,
                           int kb_per_split, int splits, cudaStream_t s) {
  switch (quant) {
    case 0:
      return dispatch_mt<PK, 0>(x, alphas, scale, idx, out, partial,
                                tickets, M, K, N, J, n_keep, segs_per_scale,
                                kb_per_split, splits, s);
    case 1:
      return dispatch_mt<PK, 1>(x, alphas, scale, idx, out, partial,
                                tickets, M, K, N, J, n_keep, segs_per_scale,
                                kb_per_split, splits, s);
    case 2:
      return dispatch_mt<PK, 2>(x, alphas, scale, idx, out, partial,
                                tickets, M, K, N, J, n_keep, segs_per_scale,
                                kb_per_split, splits, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace

// x (M, K) bfloat16, out (M, N) bfloat16; alphas as for ovsf_gemm_launch;
// scale: float32, one per segs_per_scale code segments (quant 1 and 2;
// unread for quant 0); idx (K / 16, n_keep) int32, n_keep <= 16; splits of
// kb_per_split 128-row k-blocks each; partial (splits, M, N) float32 and
// tickets (one uint32 per (M chunk of 256, 64-column tile), zero between
// launches; the kernel leaves them zero) are read when splits > 1. Returns
// the cudaError_t of the launch.
extern "C" int ovsf_gemm_tc_launch(const void* x, const void* alphas,
                                   const void* scale, const void* idx,
                                   void* out, void* partial, void* tickets,
                                   int M, int K, int N, int J, int n_keep,
                                   int segs_per_scale, int kb_per_split,
                                   int splits, int quant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % tc::SEG || n_keep < 1 || n_keep > 16 ||
      J != K / tc::SEG * n_keep || splits < 1 || splits > tc::MAX_SPLITS ||
      segs_per_scale < 1)
    return cudaErrorInvalidValue;
  if (n_keep <= 8)
    return tc::dispatch_quant<8>(quant, x, alphas, scale, idx, out, partial,
                                 tickets, M, K, N, J, n_keep, segs_per_scale,
                                 kb_per_split, splits, s);
  return tc::dispatch_quant<16>(quant, x, alphas, scale, idx, out, partial,
                                tickets, M, K, N, J, n_keep, segs_per_scale,
                                kb_per_split, splits, s);
}

// ---------------------------------------------------------------------------
// 2. The CUDA-core kernel (every other case).
// ---------------------------------------------------------------------------
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
