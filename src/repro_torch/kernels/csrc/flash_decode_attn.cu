// Single-token flash-decode attention over a contiguous KV cache for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn.py:
// flash_decode_attn (_kernel). One query token per row b, q (B, H, hd),
// attends over its row of the cache, k/v (B, T, Hkv, hd), under the
// exclusive mask col < pos[b]; GQA: H = G * Hkv. Scores, the online-softmax
// state (m, l) and the accumulator are fp32; q is upcast and scaled by
// 1/sqrt(hd) in fp32, and the output is written once in q's type.
//
// Edge cases, as the Pallas kernel and the plain version give them:
//   * pos[b] >= T reads all T rows;
//   * pos[b] <= 0 masks every column: each weighs exp(0) = 1, so the output
//     is the mean of V over all T rows (never 0/0).
// There is no T % tile restriction: the last tile is ragged.
//
// What bounds it on the H100: bytes. A row needs min(pos, T) K and V rows
// of each kv-head; the arithmetic is 4 * G * hd flops per K/V row, far
// below the card's ratio of operations to bytes. Design:
//   * one block per (row b, kv-head): the G query heads that share a
//     kv-head read each K/V row once for all G of them;
//   * K/V rows below min(pos, T) are staged through shared memory one tile
//     of BT rows at a time (K rows padded by one float against bank
//     conflicts); rows at or past pos are never read;
//   * scores, (m, l), the per-tile rescale and the (G, hd) accumulator stay
//     in shared memory; the softmax of a tile runs one warp per query head.
// pos is read on the device, so a launch needs no host sync and can be
// captured in a CUDA graph. Loads are not yet vectorised or double-buffered,
// and a row's tiles run in one block (no split over T); that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_floats(int G, int hd, int bt) {
  return (size_t)G * hd                // qs
         + (size_t)bt * (hd + 1)       // ks
         + (size_t)bt * hd             // vs
         + (size_t)G * bt              // sc
         + (size_t)G * hd              // acc
         + 3 * (size_t)G;              // m, l, rescale
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    T* __restrict__ out, int T_, int H, int Hkv, int hd,
                    int bt, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int kst = hd + 1;                  // padded K row stride
  float* qs = smem;                        // (G, hd) scaled queries
  float* ks = qs + G * hd;                 // (bt, hd + 1)
  float* vs = ks + bt * kst;               // (bt, hd)
  float* sc = vs + bt * hd;                // (G, bt) scores, then probs
  float* acc = sc + G * bt;                // (G, hd)
  float* mrow = acc + G * hd;              // (G,) running max
  float* lrow = mrow + G;                  // (G,) running denominator
  float* arow = lrow + G;                  // (G,) rescale of this tile

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  const bool all_masked = p <= 0;          // every column weighs the same
  const int n = all_masked ? T_ : min(p, T_);
  const size_t qbase = ((size_t)b * H + (size_t)h * G) * hd;
  const size_t row0 = (size_t)b * T_;

  for (int e = tid; e < G * hd; e += THREADS) {
    qs[e] = to_f(q[qbase + e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    mrow[g] = -1e30f;
    lrow[g] = 0.f;
  }

  for (int t0 = 0; t0 < n; t0 += bt) {
    const int rows = min(bt, n - t0);
    __syncthreads();                       // previous tile fully consumed
    for (int e = tid; e < rows * hd; e += THREADS) {
      const int i = e / hd, d = e % hd;
      const size_t off = ((row0 + t0 + i) * Hkv + h) * hd + d;
      ks[i * kst + d] = to_f(k[off]);
      vs[e] = to_f(v[off]);
    }
    __syncthreads();
    for (int e = tid; e < G * rows; e += THREADS) {
      const int g = e / rows, i = e % rows;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qs[g * hd + d] * ks[i * kst + d];
      sc[g * bt + i] = all_masked ? -1e30f : dot;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NWARPS) {
      const float m_prev = mrow[g];
      float mx = m_prev;
      for (int i = lane; i < rows; i += 32) mx = fmaxf(mx, sc[g * bt + i]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int i = lane; i < rows; i += 32) {
        const float e = __expf(sc[g * bt + i] - mx);
        sc[g * bt + i] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = __expf(m_prev - mx);
        lrow[g] = lrow[g] * a + sum;
        mrow[g] = mx;
        arow[g] = a;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += THREADS) {
      const int g = e / hd, d = e % hd;
      float o = acc[e] * arow[g];
      for (int i = 0; i < rows; ++i) o += sc[g * bt + i] * vs[i * hd + d];
      acc[e] = o;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * hd; e += THREADS) {
    from_f(acc[e] / fmaxf(lrow[e / hd], 1e-30f), out + qbase + e);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* pos, void* out, int B, int T_, int H, int Hkv,
                   int hd, cudaStream_t stream) {
  const int G = H / Hkv;
  int bt = 64;                             // largest tile that fits
  while (bt > 8 && smem_floats(G, hd, bt) * sizeof(float) > MAX_SMEM) bt /= 2;
  const size_t smem = smem_floats(G, hd, bt) * sizeof(float);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  dim3 grid(B, Hkv);
  flash_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<T*>(out), T_, H, Hkv, hd, bt, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, H, hd), k/v (B, T, Hkv, hd) and out (B, H, hd) in one type
// (bf16 != 0 -> bfloat16, else float32), all contiguous; pos (B,) int32 on
// the device. Returns the cudaError_t of the launch.
extern "C" int flash_decode_attn_launch(const void* q, const void* k,
                                        const void* v, const void* pos,
                                        void* out, int B, int T_, int H,
                                        int Hkv, int hd, int bf16,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, pos, out, B, T_, H, Hkv, hd, s);
  return launch<float>(q, k, v, pos, out, B, T_, H, Hkv, hd, s);
}
