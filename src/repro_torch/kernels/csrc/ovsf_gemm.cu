// Fused on-the-fly OVSF GEMM for Hopper (sm_90a): y = x @ W(alphas, idx).
//
// Replaces the Pallas TPU kernel repro/kernels/ovsf_gemm.py:ovsf_gemm
// (_ovsf_gemm_kernel, _gen_w_tile, _sign_tile) and its quantised-alpha
// epilogue (_dequant_tile, _row_scales). W is never stored in device memory:
// a block regenerates the weights it is about to consume,
//   W[k, n] = sum_j (-1)^popcount(idx[j] & k') * alphas[j, n],
// with k' = k (monolithic codes, idx (J,)) or k' = k mod L0 restricted to
// the j of k's own segment (segmented codes, idx (n_seg, n_keep)). Alpha
// storage (QUANT): 0 = the type of x; 1 = int8 (J, N); 2 = int4, two
// nibbles per byte (J, N/2), the low nibble the even column, both
// sign-extended; quantised alphas carry one fp32 scale per rows_per_scale
// rows. Three kernels live here; the wrapper (kernels/ovsf_gemm.py, route)
// picks one per call from (x dtype, code layout, alpha storage, K, J).
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
//    for every case the other two do not take: fp32 x over segmented codes
//    (the parity phases), bf16 x over monolithic codes, quantised alphas
//    over monolithic codes, fp32 monolithic GEMMs whose stripe does not
//    fit (max(K, J) above about 4600), L0 != 16, n_keep > 16, N off the
//    word multiple, and quantised alphas whose scale segments cut through
//    a code segment. Alphas stage through shared memory in BJ-row chunks
//    (quantised ones dequantised while staged), the W tile is built in
//    shared memory with fp32 sign-MACs, x @ W runs on the fp32 CUDA cores,
//    and split-K partials are summed in a fixed order by a second small
//    kernel.
//
// 3. ovsf_gemm_mono_kernel, on the tensor cores: fp32 x and fp32 alphas
//    over monolithic codes, the CNN `fused` path (every OVSF conv of
//    ResNet-18/34/50 and SqueezeNet-1.1 in matrix mode), where a stripe of
//    8 columns fits a block (kernels/ovsf_gemm.py, mono_fits: K = 4608
//    does; max(K, J) above about 4600 does not). It replaced, for that
//    case, the CUDA-core kernel, which rebuilt every 64-row W tile as a
//    J-term sum for every 64-row M tile (K * N * J * M / 64 sign-adds:
//    14.8 G, 30.2 G and 67.6 G at ResNet-50's s1, s2 and s3 convs; 7.0,
//    17.9 and 40.3 ms) and ran the product on the fp32 CUDA cores.
//
//    What bounds it on the H100 (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s
//    fp32 on the CUDA cores): x read once, y written once, the alphas and
//    ids read once, against three bf16 products (6 M K N) on the tensor
//    cores plus one L-point WHT a column (N L log2 L fp32 adds). At
//    ResNet-50's s1 / s2 / s3 convs (M, K -> N: 6272, 1152 -> 128; 1568,
//    2304 -> 256; 392, 4608 -> 512) that is 9.7 / 5.8 / 6.4 us, bound by
//    the bytes at s1 and by the operations at s2 and s3. What binds it in
//    fact is L2: every stripe reads all its rows of x, so x leaves L2 N / bn
//    times, 115.6 / 231.2 / 462.4 MB at s1 / s2 / s3 and 14.5 / 8.1 / 14.5 MB
//    at SqueezeNet-1.1's fires 2-3 / 4-5 / 6-7 (x itself, 7.2-28.9 MB, fits
//    the 50 MB L2, and the stripes of one M range run in the same wave). The
//    product phase moves it at 3.6 TB/s at s1 and 5.6 TB/s at s3 (PERF.md).
//    A cluster whose blocks share each x tile (TMA multicast) is the route
//    to cut it (ROADMAP A0.4). The design:
//
//    * Each W stripe generated once a cluster, at its cheapest. A cluster
//      of two blocks (kernels/ovsf_gemm.py, mono_plan) owns a stripe of bn
//      (8-64) output columns over all K; each block takes its own run of M
//      rows. Each block generates half the stripe's columns: it stashes
//      their J alphas in shared memory (16-byte loads, column c's at the
//      head of the stripe's row c, rotated by c so a warp's stores hit
//      distinct banks), then, a batch of THREADS * 32 / L columns at a time
//      (two at L = 8192), scatters each column's alphas into a length-L
//      spectrum (plain stores of 0 + alpha where the wrapper has checked
//      that no id repeats, shared-memory atomic adds otherwise; an id out
//      of [0, L) traps) and runs the register-radix WHT body of
//      ovsf_decompress (wht.cuh) on the batch: the plain version's passes
//      in its order, so W equals ovsf_decompress's bit for bit. Each W
//      value of k < K goes back into the stripe row, over the stash the
//      batch has consumed, as a pair of bf16, hi = bf16(w) and lo =
//      bf16(w - hi), four k to a 16-byte word [hi x 4 | lo x 4]; a row's
//      pitch is 64 mod 128 bytes, so a quarter-warp's 16-byte fragment loads
//      (two rows, 64 bytes each) meet no bank conflict. Then each block
//      copies its peer's half of the stripe through distributed shared
//      memory (16-byte loads, four in flight), between two cluster
//      barriers: W never leaves the chip. The stripe takes bn * max(K, J)
//      * 4 bytes: bn is 32 at s1, 16 at s2, 8 at s3 and 64 at SqueezeNet's
//      fires, beside a 64 KB spectrum and the ids. Clusters of two: the
//      card holds 66 of them at these sizes (30 of four, 15 of eight).
//    * The product on the tensor cores in split bf16 ("bf16x3"). A warp
//      takes a 16-row group of M over all of K; where a block has fewer
//      groups than its 16 warps, the warps of a group split K among them
//      and add their accumulators through shared memory afterwards, in part
//      order. x reaches registers through a four-stage ring in the spectrum
//      buffer (idle by then): each thread copies (cp.async, 16 bytes a row)
//      exactly the values it reads, so the ring needs no barrier and holds
//      no registers (register prefetch was sunk to its use by the compiler
//      at 127 registers, and every k16 step waited on L2). The k order
//      within a 16-step is permuted the same way in x and in W, so that a
//      thread's four x values and four W values of a step are neighbours.
//      Each x pair is split into hi and lo in registers, and hi.hi + hi.lo
//      + lo.hi accumulate in fp32 by mma.sync m16n8k16 against the stripe's
//      fragments (one 16-byte shared load gives both halves); for a stripe
//      of at most 16 columns the three products go to their own
//      accumulators, so no two mma of a step wait on each other. The
//      dropped lo.lo term and the two splits leave about 2^-16 relative a
//      term, far inside the fp32 tolerance (2e-3); plain TF32 (2^-11)
//      would not be. Integers below 2^16 split exactly (hi + lo), so
//      integer inputs give exact sums.
//    * One launch, one wave, deterministic: 132 blocks (66 clusters) at
//      every CNN conv, one an SM. K is not split across blocks, so each
//      block writes its own y tile: no partials in device memory, no atomics
//      on the output. With distinct ids a second launch equals the first
//      bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cooperative_groups.h>

#include "wht.cuh"

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

// ---------------------------------------------------------------------------
// 3. The monolithic tensor-core kernel (fp32 x and alphas, monolithic codes).
// ---------------------------------------------------------------------------
namespace {
namespace mono {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 16;         // rows of M a warp takes at a time
constexpr int MAX_NT = 8;         // n8 tiles a stripe: bn <= 64
constexpr int PF = 4;             // k16 steps of x in flight a thread
// the x ring (PF stages of two 16-byte rows a thread) in the spectrum buffer
static_assert(PF * 2 * 16 <= 32 * 4, "the x ring outgrows the spectra");
static_assert(MAX_NT >= 6, "a narrow stripe takes 3 accumulators a tile");
constexpr int MAX_LOG_L = 13;     // a batch is THREADS * 32 elements

// One stripe element w = W[k, column]: the bf16 pair hi = bf16(w), lo =
// bf16(w - hi) at the quad word of k, [hi x 4 | lo x 4].
__device__ __forceinline__ void store_pair(char* row, int k, float w) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(w);
  const __nv_bfloat16 lo = __float2bfloat16_rn(w - __bfloat162float(hi));
  __nv_bfloat16* q =
      reinterpret_cast<__nv_bfloat16*>(row + (k >> 2) * 16) + (k & 3);
  q[0] = hi;
  q[4] = lo;
}

// The word of alpha j in column c's stash: j rotated by c mod 32 (J >= 32).
__device__ __forceinline__ int stash_at(int j, int c, int J) {
  const int w = J >= 32 ? j + (c & 31) : j;
  return w >= J ? w - J : w;
}

// The thread-block cluster's barrier, in two halves: arrive releases this
// thread's shared-memory writes to the cluster, wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Two fp32 values as the bf16 pairs hi and lo (the low half the first).
__device__ __forceinline__ void split2(float a, float b, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// p[0 .. 3] of a row of x whose column k the pointer is at into dst,
// asynchronously: zeros past K, and zeros where ok is false (then nothing
// is read; `base` is a valid address to name).
__device__ __forceinline__ void copy_x(float4* dst, const float* p,
                                       const float* base, bool ok, int k,
                                       int K, bool vec) {
  if (vec) {
    ok = ok && k < K;
    tc::cp_async16(dst, ok ? p : base, ok ? 16 : 0);
  } else {
    float* d = reinterpret_cast<float*>(dst);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = ok && k + e < K;
      tc::cp_async4(d + e, in ? p + e : base, in ? 4 : 0);
    }
  }
}

// grid (blocks), THREADS threads, clusters of `cluster` blocks, dynamic
// shared memory smem >= bn * pitch (the stripe) + THREADS * R * 4 (the
// spectra of a batch) + J * 4 (the ids). Cluster q takes stripe q %
// stripes, columns [n0, n0 + bn); its block of rank r generates the r-th
// share of the stripe's columns and copies the others from its peers; each
// block takes an even share of the stripe's 16-row groups
// (kernels/ovsf_gemm.py, mono_block_rows).
template <int LOG_L>
__global__ void __launch_bounds__(THREADS, 1)
ovsf_gemm_mono_kernel(const float* __restrict__ x,
                      const float* __restrict__ alphas,
                      const int* __restrict__ idx, float* __restrict__ out,
                      int M, int K, int N, int J, int bn, int pitch,
                      int cluster, int distinct) {
  using S = wht::Stages<LOG_L>;
  constexpr int B = S::B, R = S::R, L = 1 << LOG_L;
  constexpr int BATCH = (THREADS * R) >> LOG_L;   // columns a batch
  extern __shared__ __align__(16) char smem[];
  char* stripe = smem;
  float* buf = reinterpret_cast<float*>(smem + bn * pitch);
  int* ids = reinterpret_cast<int*>(buf + THREADS * R);
  const int t = threadIdx.x;
  const int stripes = (N + bn - 1) / bn;
  const int q = blockIdx.x / cluster, rank = blockIdx.x % cluster;
  const int sid = q % stripes;
  const int n0 = sid * bn;
  const int cols = min(bn, N - n0);
  const int Kp = (K + 15) & ~15;
  // the columns this block generates: its rank's share of the stripe
  const int share = (cols + cluster - 1) / cluster;
  const int c_lo = min(cols, rank * share), c_hi = min(cols, c_lo + share);
  const int gc = c_hi - c_lo;

  // 1. The ids, and the stash: column c's J alphas at the head of stripe
  // row c, rotated by c mod 32 (the word of alpha j is stash_at(j, c)), so
  // that a warp's copies of one row's columns land in distinct banks.
  // 16-byte loads where the columns allow, else asynchronous 4-byte
  // copies.
  for (int j = t; j < J; j += THREADS) tc::cp_async4(ids + j, idx + j, 4);
  tc::cp_async_commit();
  auto zero_spectra = [&]() {
    for (int e = 4 * t; e < THREADS * R; e += 4 * THREADS)
      *reinterpret_cast<float4*>(buf + e) = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  zero_spectra();             // while the ids are in flight
  if (N % 4 == 0 && gc % 4 == 0 && c_lo % 4 == 0) {
    // 16 bytes (four columns of a row) a load, four loads in flight
    const int cq = gc / 4;
    for (int e0 = t; e0 < J * cq; e0 += 4 * THREADS) {
      float4 a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS, j = e / cq;
        if (e < J * cq)
          a[u] = __ldg(reinterpret_cast<const float4*>(
              alphas + (size_t)j * N + n0 + c_lo + 4 * (e - j * cq)));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS, j = e / cq;
        if (e >= J * cq) break;
        const int c = c_lo + 4 * (e - j * cq);
        const float v[4] = {a[u].x, a[u].y, a[u].z, a[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          reinterpret_cast<float*>(stripe + (c + i) * pitch)[stash_at(
              j, c + i, J)] = v[i];
      }
    }
  } else {
    for (int e = t; e < J * gc; e += THREADS) {
      const int j = e / gc, c = c_lo + e - j * gc;
      tc::cp_async4(
          reinterpret_cast<float*>(stripe + c * pitch) + stash_at(j, c, J),
          alphas + (size_t)j * N + n0 + c, 4);
    }
  }
  tc::cp_async_commit();
  tc::cp_async_wait(0);

  // 2. The stripe, BATCH columns at a time: scatter, WHT, bf16 pairs.
  for (int cb = c_lo; cb < c_hi; cb += BATCH) {
    const int nb = min(BATCH, c_hi - cb);
    if (cb != c_lo) {
      __syncthreads();        // the last batch's transform is done with buf
      zero_spectra();
    }
    __syncthreads();          // the stash and the zeros are in
    const float* stash = reinterpret_cast<const float*>(stripe + cb * pitch);
    for (int j = t; j < J; j += THREADS) {
      const int code = ids[j];
      if (code < 0 || code >= L) __trap();     // the wrapper checks too
#pragma unroll 4
      for (int c = 0; c < nb; ++c) {
        const float a = stash[c * (pitch / 4) + stash_at(j, cb + c, J)];
        float* slot = buf + wht::swz((c << LOG_L) | code);
        if (distinct)
          *slot = 0.f + a;           // the one add the plain version makes
        else
          atomicAdd(slot, a);
      }
    }
    __syncthreads();          // the batch's stash rows are free from here
    float v[R];
    wht::read_first<B>(v, buf, t);
    wht::transform<LOG_L>(v, buf, t);
    const int f0 = wht::flat0<B, S::LAST>(t);
    if constexpr (LOG_L < B) {
      // short columns: a thread's registers span R / L whole columns
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = (f0 + j) >> LOG_L, k = (f0 + j) & (L - 1);
        if (c < nb && k < K) store_pair(stripe + (cb + c) * pitch, k, v[j]);
      }
    } else {
      // register j holds element k0 + (j << LAST) of one column c
      const int c = f0 >> LOG_L, k0 = f0 & (L - 1);
      if (c < nb) {
        char* row = stripe + (cb + c) * pitch;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int k = k0 + (j << S::LAST);
          if (k < K) store_pair(row, k, v[j]);
        }
      }
    }
  }
  // rows K..Kp of the stripe are zero (x is zero there too: 0 * 0)
  for (int e = t; e < gc * (Kp - K); e += THREADS) {
    const int c = e / (Kp - K);
    store_pair(stripe + (c_lo + c) * pitch, K + e - c * (Kp - K), 0.f);
  }
  // the peers' columns, 16 bytes at a time through distributed shared memory
  if (cluster > 1) {
    cluster_arrive();
    cluster_wait();           // every block of the cluster has its share
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    const int quads = Kp / 4;
    for (int r = 0; r < cluster; ++r) {
      if (r == rank) continue;
      const int lo = min(cols, r * share), hi = min(cols, lo + share);
      const char* peer = cl.map_shared_rank(stripe, r);
      const int total = (hi - lo) * quads;
      for (int e0 = t; e0 < total; e0 += 4 * THREADS) {
        uint4 v[4];                // four remote loads in flight
        int off[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * THREADS, c = e / quads;
          off[u] = (lo + c) * pitch + (e - c * quads) * 16;
          if (e < total) v[u] = *reinterpret_cast<const uint4*>(peer + off[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e0 + u * THREADS < total)
            *reinterpret_cast<uint4*>(stripe + off[u]) = v[u];
      }
    }
    cluster_arrive();         // done reading the peers' shared memory
  }
  __syncthreads();

  // 3. The product: a warp takes a 16-row group over all of K (or a part).
  const int groups = (M + GROUP - 1) / GROUP;
  const int clusters = gridDim.x / cluster;
  const int mine = cluster * ((clusters - 1 - sid) / stripes + 1);
  const int chunk = q / stripes * cluster + rank;
  const int g_lo = (int)((long long)chunk * groups / mine);
  const int g_hi = (int)((long long)(chunk + 1) * groups / mine);
  const int warp = t / 32, lane = t % 32, g = lane / 4, tq = lane % 4;
  const int nt_n = (cols + 7) / 8;
  const int nsteps = Kp / 16;
  const bool vec = K % 4 == 0;
  const char* wq = stripe + g * pitch + tq * 16;
  // x reaches registers through a ring in the spectrum buffer, idle from
  // here: slot (stage p, row half h) of thread t is ring[(2 p + h) THREADS
  // + t]. Each thread copies (cp.async, 16 bytes a row) exactly what it
  // reads, so the ring needs no barrier, and the copies hold no registers.
  float4* ring = reinterpret_cast<float4*>(buf);
  // A block with fewer row groups than warps splits K among the warps of a
  // group (kparts of them, one unit a warp) and sums their accumulators
  // through shared memory afterwards, in part order.
  const int gb = g_hi - g_lo;
  const int kparts = gb >= WARPS ? 1 : WARPS / max(gb, 1);
  float acc[MAX_NT][4];
  auto store = [&](int grp) {
    // acc[n]: (row g, columns 2tq, 2tq+1), (row g + 8, the same)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = grp * GROUP + g + 8 * h;
      if (r >= M) continue;
      float* yr = out + (size_t)r * N;
#pragma unroll
      for (int n = 0; n < MAX_NT; ++n) {
        if (n >= nt_n) break;
        const int col = n0 + n * 8 + 2 * tq;
        const float a = acc[n][2 * h], b2 = acc[n][2 * h + 1];
        if (col + 1 < n0 + cols && N % 2 == 0) {
          *reinterpret_cast<float2*>(yr + col) = make_float2(a, b2);
        } else {
          if (col < n0 + cols) yr[col] = a;
          if (col + 1 < n0 + cols) yr[col + 1] = b2;
        }
      }
    }
  };
  for (int u = warp; u < gb * kparts; u += WARPS) {
    const int grp = g_lo + u / kparts, part = u % kparts;
    const int s_lo = part * nsteps / kparts;
    const int s_hi = (part + 1) * nsteps / kparts;
    const int r0 = grp * GROUP + g, r1 = r0 + 8;
    const bool v0 = r0 < M, v1 = r1 < M;
    const float* x0 = x + (size_t)(v0 ? r0 : 0) * K + 4 * tq;
    const float* x1 = x + (size_t)(v1 ? r1 : 0) * K + 4 * tq;
#pragma unroll
    for (int n = 0; n < MAX_NT; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    auto fetch = [&](int s, int slot) {
      const bool in = s < s_hi;
      copy_x(ring + (2 * slot) * THREADS + t, x0 + s * 16, x, v0 && in,
             s * 16 + 4 * tq, K, vec);
      copy_x(ring + (2 * slot + 1) * THREADS + t, x1 + s * 16, x, v1 && in,
             s * 16 + 4 * tq, K, vec);
      tc::cp_async_commit();
    };
#pragma unroll
    for (int p = 0; p < PF - 1; ++p) fetch(s_lo + p, p);
    for (int s0 = s_lo; s0 < s_hi; s0 += PF) {
#pragma unroll
      for (int p = 0; p < PF; ++p) {
        const int s = s0 + p;
        if (s >= s_hi) break;
        tc::cp_async_wait(PF - 2);           // this thread's step s is in
        const float4 xa = ring[(2 * p) * THREADS + t];
        const float4 xb = ring[(2 * p + 1) * THREADS + t];
        fetch(s + PF - 1, (p + PF - 1) % PF);  // the slot read at step s - 1
        // A fragments: logical k (2tq, 2tq+1 | 2tq+8, 2tq+9) are the
        // thread's k 16 s + 4 tq + (0, 1 | 2, 3), as in the stripe's words
        unsigned ah[4], al[4];
        split2(xa.x, xa.y, ah[0], al[0]);
        split2(xb.x, xb.y, ah[1], al[1]);
        split2(xa.z, xa.w, ah[2], al[2]);
        split2(xb.z, xb.w, ah[3], al[3]);
        const char* ws = wq + s * 64;
        if (nt_n <= 2) {
          // a narrow stripe: the three products into their own
          // accumulators, so that no two mma of a step wait on each other
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            if (n >= nt_n) break;
            const uint4 b =
                *reinterpret_cast<const uint4*>(ws + n * 8 * pitch);
            tc::mma_k16(acc[n], ah, b.x, b.y);        // hi . hi
            tc::mma_k16(acc[n + 2], ah, b.z, b.w);    // hi . lo
            tc::mma_k16(acc[n + 4], al, b.x, b.y);    // lo . hi
          }
        } else {
#pragma unroll
          for (int n = 0; n < MAX_NT; ++n) {
            if (n >= nt_n) break;
            const uint4 b =
                *reinterpret_cast<const uint4*>(ws + n * 8 * pitch);
            tc::mma_k16(acc[n], ah, b.x, b.y);
            tc::mma_k16(acc[n], ah, b.z, b.w);
            tc::mma_k16(acc[n], al, b.x, b.y);
          }
        }
      }
    }
    tc::cp_async_wait(0);     // the tail's copies, before the ring is reused
    if (nt_n <= 2) {          // (hi . hi + hi . lo) + lo . hi
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = (acc[n][e] + acc[n + 2][e]) + acc[n + 4][e];
    }
    if (kparts == 1) store(grp);
  }
  if (kparts > 1) {
    // one unit a warp: parts 1.. leave their sums in the (idle) ring, part
    // 0 adds them in part order and writes y
    float* red = buf;
    const bool has = warp < gb * kparts;
    const int part = warp % kparts;
    __syncthreads();          // every warp is done with the ring
    if (has && part > 0)
#pragma unroll
      for (int n = 0; n < MAX_NT; ++n) {
        if (n >= nt_n) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) red[(4 * n + e) * THREADS + t] = acc[n][e];
      }
    __syncthreads();
    if (has && part == 0) {
      for (int q = 1; q < kparts; ++q)
#pragma unroll
        for (int n = 0; n < MAX_NT; ++n) {
          if (n >= nt_n) break;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] += red[(4 * n + e) * THREADS + t + 32 * q];
        }
      store(g_lo + warp / kparts);
    }
  }
  if (cluster > 1) cluster_wait();   // no block leaves while a peer reads it
}

inline cudaLaunchConfig_t config(int blocks, int smem, int cluster,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int LOG_L>
cudaError_t launch(const void* x, const void* alphas, const void* idx,
                   void* out, int M, int K, int N, int J, int bn, int pitch,
                   int blocks, int smem, int cluster, int distinct,
                   cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  auto kern = ovsf_gemm_mono_kernel<LOG_L>;
  cudaError_t e = wht::opt_in(kern, smem, opted_in);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(blocks, smem, cluster, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(x),
                         static_cast<const float*>(alphas),
                         static_cast<const int*>(idx),
                         static_cast<float*>(out), M, K, N, J, bn, pitch,
                         cluster, distinct);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace mono
}  // namespace

// x (M, K) float32, 16-byte aligned; alphas (J, N) float32, 16-byte aligned;
// idx (J,) int32 in [0, L), L = next_pow2(K) <= 8192; out (M, N) float32.
// The plan (kernels/ovsf_gemm.py, mono_plan): bn output columns a stripe (a
// multiple of 8, at most 64), the stripe row pitch in bytes (64 mod 128, at
// least max(K rounded up to 16, J) * 4), `blocks` blocks, `smem` bytes of
// dynamic shared memory (bn * pitch + the batch's spectra + the ids), and
// the WHT
// body's stages (log2 regs, p2, p3) from kernels/fwht.py:wht_plan(L, 4),
// checked against wht.cuh's. distinct != 0: the caller has checked that no
// id repeats, so the scatter stores instead of adding atomically. Returns
// the cudaError_t of the launch.
extern "C" int ovsf_gemm_mono_launch(const void* x, const void* alphas,
                                     const void* idx, void* out, int M, int K,
                                     int N, int J, int L, int bn, int pitch,
                                     int blocks, int smem, int cluster,
                                     int log2_regs, int p2, int p3,
                                     int distinct, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Kp = (K + 15) & ~15;
  if (M < 1 || K < 1 || N < 1 || J < 1 || L <= 0 || (L & (L - 1)) ||
      L > (1 << mono::MAX_LOG_L) || K > L || bn < 8 || bn % 8 ||
      bn > 8 * mono::MAX_NT || pitch % 128 != 64 ||
      pitch < 4 * (Kp > J ? Kp : J) || cluster < 1 || cluster > 8 ||
      blocks % cluster || blocks / cluster < (N + bn - 1) / bn)
    return cudaErrorInvalidValue;
  return wht::dispatch(__builtin_ctz(L), [&](auto nc) -> cudaError_t {
    constexpr int LOG_L = decltype(nc)::value;
    if constexpr (LOG_L > mono::MAX_LOG_L) {
      return cudaErrorInvalidValue;
    } else {
      if (!wht::plan_matches<LOG_L>(log2_regs, p2, p3) ||
          smem < bn * pitch + mono::THREADS * wht::Stages<LOG_L>::R * 4 +
                     4 * J)
        return cudaErrorInvalidValue;
      return mono::launch<LOG_L>(x, alphas, idx, out, M, K, N, J, bn, pitch,
                                 blocks, smem, cluster, distinct, s);
    }
  });
}

