// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn.py:
// paged_flash_decode (_paged_kernel). Packed query tokens (T, H, hd) attend
// over paged K/V pools (P, ps, Hkv, hd): token t reads its slot's page list,
// page_table[slot_ids[t], j] (sentinel P clamped to P-1; slot ids clamped to
// the table), and masks virtual columns > positions[t] (inclusive; a
// position past the table reads every page, a negative one, outside the
// contract, weighs all npg * ps columns alike, as the plain version does).
// GQA: H = G * Hkv, any G; hd <= 256; any page size. The pools are of q's
// type or int8 (the int8 KV cache: each element dequantised on load as the
// reference's _dequant, decode_attn.cuh). fp32 softmax state; the output is
// written once in q's type.
//
// What bounds it on the H100: bytes, and at decode the latency of a few
// dependent DRAM round trips. Each token needs (positions[t] + 1) K and V
// rows of each kv-head; the arithmetic, 4 * G * hd flops per row (8 flops
// a byte in bf16, 16 over int8 pools), is far below the card's ratio of
// operations to bytes.
// At decode (T = 4, Hkv = 4) there are only 16 (token, kv-head) pairs for
// 132 SMs. Design (the block body is decode_attn.cuh, which says more):
//   * the grid is (token, kv-head x head chunk, split): a token's pages are
//     split across blocks, pages_per_split of them each, the count from the
//     shapes alone (kernels/decode_attn.py, split_plan: about one wave at
//     decode, 16 pairs x 16 splits; one split when the pairs fill the card,
//     T = 128), so a launch needs no host sync; a block loads its own slot
//     id, position and page ids, and a split wholly past the position reads
//     nothing;
//   * K and V rows move by 16-byte cp.async through a ring of 4-row tiles
//     per warp, 3 in flight, with no block barrier in the loop; q (scaled
//     once), the softmax state and the (G, hd) accumulator stay in
//     registers; scores reduce by warp shuffles;
//   * the warps merge once at the end of a split; the splits merge in the
//     same launch, in split order, by the last split to take an integer
//     ticket (tickets are zero before and after a launch).
#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

template <typename T, typename KV, int NCH, bool VEC>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ slot_ids,
                    const int* __restrict__ positions, T* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    unsigned* __restrict__ tickets, int H, int Hkv, int hd,
                    int P, int ps, int npg, int n_rows, int cps,
                    float qscale) {
  const int t = blockIdx.x;
  const int n_hc = gridDim.y / Hkv;
  const int h = blockIdx.y / n_hc, hc = blockIdx.y - h * n_hc;
  const int G = H / Hkv;
  const int sid = min(max(slot_ids[t], 0), n_rows - 1);
  const int pos = positions[t];
  const int cols = npg * ps;
  const bool all_masked = pos < 0;
  const int n =
      all_masked ? cols : (int)min((long long)pos + 1, (long long)cols);
  const PagedRows rows{page_table + (size_t)sid * npg, P, ps, Hkv, h};
  decode_block<T, KV, NCH, VEC>(
      q, k_pool, v_pool, out, part_acc, part_ml,
      tickets + (size_t)t * gridDim.y + blockIdx.y, rows,
      (size_t)t * H + (size_t)h * G + (size_t)hc * GC, min(GC, G - hc * GC),
      hd, n, all_masked, cps, qscale);
}

template <typename T, typename KV, bool VEC>
cudaError_t launch_vec(int nch, dim3 grid, cudaStream_t s, const T* q,
                       const KV* k_pool, const KV* v_pool,
                       const int* page_table, const int* slot_ids,
                       const int* positions, T* out, float* part_acc,
                       float* part_ml, unsigned* tickets, int H, int Hkv,
                       int hd, int P, int ps, int npg, int n_rows, int cps,
                       float qscale) {
#define PAGED_LAUNCH(N)                                                   \
  return launch_kernel<T, KV, N, VEC>(paged_decode_kernel<T, KV, N, VEC>, \
                                      grid, s, q, k_pool, v_pool,         \
                                      page_table, slot_ids, positions,    \
                                      out, part_acc, part_ml, tickets, H, \
                                      Hkv, hd, P, ps, npg, n_rows, cps,   \
                                      qscale)
  switch (nch) {
    case 1: PAGED_LAUNCH(1);
    case 2: PAGED_LAUNCH(2);
    case 3: PAGED_LAUNCH(3);
    case 4: PAGED_LAUNCH(4);
    default: PAGED_LAUNCH(8);
  }
#undef PAGED_LAUNCH
}

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* slot_ids,
                   const void* positions, void* out, void* part_acc,
                   void* part_ml, void* tickets, int T_, int H, int Hkv,
                   int hd, int P, int ps, int npg, int n_rows, int cps,
                   int splits, cudaStream_t s) {
  if (!shape_ok(hd, splits)) return cudaErrorInvalidValue;
  auto go = vec_rows<KV>(hd, k_pool, v_pool) ? launch_vec<T, KV, true>
                                             : launch_vec<T, KV, false>;
  return go(nch_of(hd), grid_of(T_, H, Hkv, splits), s,
            static_cast<const T*>(q), static_cast<const KV*>(k_pool),
            static_cast<const KV*>(v_pool),
            static_cast<const int*>(page_table),
            static_cast<const int*>(slot_ids),
            static_cast<const int*>(positions), static_cast<T*>(out),
            static_cast<float*>(part_acc), static_cast<float*>(part_ml),
            static_cast<unsigned*>(tickets), H, Hkv, hd, P, ps, npg, n_rows,
            cps, qscale_of(hd));
}

}  // namespace

// q (T, H, hd) and out (T, H, hd) in one type (bf16 != 0 -> bfloat16, else
// float32), k_pool/v_pool (P, ps, Hkv, hd) in that type or, kv_int8 != 0,
// int8, contiguous; page_table
// (n_rows, npg), slot_ids (T,) and positions (T,) int32. The grid's split
// z covers virtual columns [z * cols_per_split, (z + 1) * cols_per_split);
// with splits > 1, part_acc (T * H * splits * hdp fp32, hdp = hd rounded up
// to 4), part_ml (T * H * splits * 2 fp32) and tickets (T * Hkv *
// ceil(G / 8) uint32, zero) are scratch. Returns the cudaError_t of the
// launch.
extern "C" int paged_decode_attn_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* slot_ids, const void* positions,
    void* out, void* part_acc, void* part_ml, void* tickets, int T_, int H,
    int Hkv, int hd, int P, int ps, int npg, int n_rows, int cols_per_split,
    int splits, int bf16, int kv_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = bf16 ? (kv_int8 ? launch<__nv_bfloat16, signed char>
                            : launch<__nv_bfloat16, __nv_bfloat16>)
                 : (kv_int8 ? launch<float, signed char>
                            : launch<float, float>);
  return go(q, k_pool, v_pool, page_table, slot_ids, positions, out, part_acc,
            part_ml, tickets, T_, H, Hkv, hd, P, ps, npg, n_rows,
            cols_per_split, splits, s);
}
