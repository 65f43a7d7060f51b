// Single-token flash-decode attention over a contiguous KV cache for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn.py:
// flash_decode_attn (_kernel). One query token per row b, q (B, H, hd),
// attends over its row of the cache, k/v (B, T, Hkv, hd), under the
// exclusive mask col < pos[b]; GQA: H = G * Hkv, any G; hd <= 256. K/V are
// of q's type or int8 (the int8 KV cache: each element dequantised on load
// as the reference's _dequant, decode_attn.cuh). Scores, the online-softmax
// state (m, l) and the accumulator are fp32; q is upcast and scaled by
// 1/sqrt(hd) in fp32, and the output is written once in q's type.
//
// Edge cases, as the Pallas kernel and the plain version give them:
//   * pos[b] >= T reads all T rows;
//   * pos[b] <= 0 masks every column: each weighs exp(0) = 1, so the output
//     is the mean of V over all T rows (never 0/0), across splits too.
// There is no T % tile restriction: the last tile is ragged.
//
// What bounds it on the H100: bytes, and at decode the latency of a few
// dependent DRAM round trips. A row needs min(pos, T) K and V rows of each
// kv-head; the arithmetic, 4 * G * hd flops per K/V row (8 flops a byte in
// bf16, 16 over an int8 cache), is far below the card's ratio of operations
// to bytes. At the
// window decode (B = 4, Hkv = 4) there are 16 (row, kv-head) pairs for 132
// SMs. Design (the block body is decode_attn.cuh, which says more):
//   * the grid is (row b, kv-head x head chunk, split): a row's T columns
//     are split across blocks, rows_per_split (a multiple of 16) each, the
//     count from the shapes alone (kernels/decode_attn.py, split_plan: about
//     one wave at decode, 16 pairs x 10 splits of 32 rows at T = 320; one
//     split when the pairs fill the card, B = 128); pos is read on the
//     device, so a launch needs no host sync and can be captured in a CUDA
//     graph; rows at or past pos are never read;
//   * K and V rows move by 16-byte cp.async through a ring of 4-row tiles
//     per warp, 3 in flight, with no block barrier in the loop (rows that
//     are not whole 16-byte words, such as hd 36 in bf16, take a scalar
//     copy); q (scaled once), the softmax state and the (G, hd) accumulator
//     stay in registers; scores reduce by warp shuffles;
//   * the warps merge once at the end of a split; the splits merge in the
//     same launch, in split order, by the last split to take an integer
//     ticket (tickets are zero before and after a launch).
#include "decode_attn.cuh"

namespace {

using namespace decode_attn;

template <typename T, typename KV, int NCH, bool VEC>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const int* __restrict__ pos,
                    T* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml,
                    unsigned* __restrict__ tickets, int T_, int H, int Hkv,
                    int hd, int cps, float qscale) {
  const int b = blockIdx.x;
  const int n_hc = gridDim.y / Hkv;
  const int h = blockIdx.y / n_hc, hc = blockIdx.y - h * n_hc;
  const int G = H / Hkv;
  const int p = pos[b];
  const bool all_masked = p <= 0;          // every column weighs the same
  const int n = all_masked ? T_ : min(p, T_);
  const ContigRows rows{(size_t)b * T_ * Hkv + h, Hkv};
  decode_block<T, KV, NCH, VEC>(
      q, k, v, out, part_acc, part_ml,
      tickets + (size_t)b * gridDim.y + blockIdx.y, rows,
      (size_t)b * H + (size_t)h * G + (size_t)hc * GC, min(GC, G - hc * GC),
      hd, n, all_masked, cps, qscale);
}

template <typename T, typename KV, bool VEC>
cudaError_t launch_vec(int nch, dim3 grid, cudaStream_t s, const T* q,
                       const KV* k, const KV* v, const int* pos, T* out,
                       float* part_acc, float* part_ml, unsigned* tickets,
                       int T_, int H, int Hkv, int hd, int cps,
                       float qscale) {
#define FLASH_LAUNCH(N)                                                   \
  return launch_kernel<T, KV, N, VEC>(flash_decode_kernel<T, KV, N, VEC>, \
                                      grid, s, q, k, v, pos, out,         \
                                      part_acc, part_ml, tickets, T_, H,  \
                                      Hkv, hd, cps, qscale)
  switch (nch) {
    case 1: FLASH_LAUNCH(1);
    case 2: FLASH_LAUNCH(2);
    case 3: FLASH_LAUNCH(3);
    case 4: FLASH_LAUNCH(4);
    default: FLASH_LAUNCH(8);
  }
#undef FLASH_LAUNCH
}

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, void* out, void* part_acc, void* part_ml,
                   void* tickets, int B, int T_, int H, int Hkv, int hd,
                   int cps, int splits, cudaStream_t s) {
  if (!shape_ok(hd, splits)) return cudaErrorInvalidValue;
  auto go = vec_rows<KV>(hd, k, v) ? launch_vec<T, KV, true>
                                   : launch_vec<T, KV, false>;
  return go(nch_of(hd), grid_of(B, H, Hkv, splits), s,
            static_cast<const T*>(q), static_cast<const KV*>(k),
            static_cast<const KV*>(v), static_cast<const int*>(pos),
            static_cast<T*>(out), static_cast<float*>(part_acc),
            static_cast<float*>(part_ml), static_cast<unsigned*>(tickets), T_,
            H, Hkv, hd, cps, qscale_of(hd));
}

}  // namespace

// q (B, H, hd) and out (B, H, hd) in one type (bf16 != 0 -> bfloat16, else
// float32), k/v (B, T, Hkv, hd) in that type or, kv_int8 != 0, int8, all
// contiguous; pos (B,) int32 on the device. The grid's split z covers rows
// [z * rows_per_split, (z + 1) * rows_per_split); with splits > 1, part_acc
// (B * H * splits * hdp fp32, hdp = hd rounded up to 4), part_ml (B * H *
// splits * 2 fp32) and tickets (B * Hkv * ceil(G / 8) uint32, zero) are
// scratch. Returns the cudaError_t of the launch.
extern "C" int flash_decode_attn_launch(const void* q, const void* k,
                                        const void* v, const void* pos,
                                        void* out, void* part_acc,
                                        void* part_ml, void* tickets, int B,
                                        int T_, int H, int Hkv, int hd,
                                        int rows_per_split, int splits,
                                        int bf16, int kv_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = bf16 ? (kv_int8 ? launch<__nv_bfloat16, signed char>
                            : launch<__nv_bfloat16, __nv_bfloat16>)
                 : (kv_int8 ? launch<float, signed char>
                            : launch<float, float>);
  return go(q, k, v, pos, out, part_acc, part_ml, tickets, B, T_, H, Hkv, hd,
            rows_per_split, splits, s);
}
