// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn.py:
// paged_flash_decode (_paged_kernel). Packed query tokens (T, H, hd) attend
// over paged K/V pools (P, ps, Hkv, hd): token t reads its slot's page list,
// page_table[slot_ids[t], j] (sentinel P clamped to P-1), and masks virtual
// columns > positions[t] (inclusive). GQA: H = G * Hkv.
//
// What bounds it on the H100: bytes. Each token needs (positions[t] + 1)
// K and V rows of its kv-head; the arithmetic is 4 * G * hd flops per row,
// far below the card's ratio of operations to bytes. Design:
//   * one block per (token, kv-head): the G query heads that share a kv-head
//     read each K/V row once for all G of them;
//   * the block loads its own slot id, position and page ids (no host-side
//     gather of the pages), and stops at page positions[t] / ps — pages
//     wholly past the position are never read;
//   * one page of K and V at a time is staged in shared memory (K rows
//     padded by one float against bank conflicts), scores and the
//     online-softmax state (m, l) and the (G, hd) accumulator stay in shared
//     memory, all in fp32; the output is cast to the query type once.
// Loads are not yet vectorised or double-buffered; that is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 128;

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
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ page_table,
                    const int* __restrict__ slot_ids,
                    const int* __restrict__ positions, T* __restrict__ out,
                    int H, int Hkv, int hd, int P, int ps, int npg,
                    int n_rows, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int kst = hd + 1;                  // padded K row stride
  float* qs = smem;                        // (G, hd) scaled queries
  float* ks = qs + G * hd;                 // (ps, hd + 1)
  float* vs = ks + ps * kst;               // (ps, hd)
  float* sc = vs + ps * hd;                // (G, ps) scores, then probs
  float* acc = sc + G * ps;                // (G, hd)
  float* mrow = acc + G * hd;              // (G,) running max
  float* lrow = mrow + G;                  // (G,) running denominator
  float* arow = lrow + G;                  // (G,) rescale of this page

  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int sid = min(max(slot_ids[t], 0), n_rows - 1);
  const int pos = positions[t];
  const int last_page = min(pos / ps, npg - 1);
  const size_t qbase = ((size_t)t * H + (size_t)h * G) * hd;

  for (int e = tid; e < G * hd; e += THREADS) {
    qs[e] = to_f(q[qbase + e]) * scale;
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    mrow[g] = -1e30f;
    lrow[g] = 0.f;
  }

  for (int j = 0; j <= last_page; ++j) {
    const int page = min(max(page_table[(size_t)sid * npg + j], 0), P - 1);
    __syncthreads();                       // previous page fully consumed
    for (int e = tid; e < ps * hd; e += THREADS) {
      const int i = e / hd, d = e % hd;
      const size_t off = (((size_t)page * ps + i) * Hkv + h) * hd + d;
      ks[i * kst + d] = to_f(k_pool[off]);
      vs[e] = to_f(v_pool[off]);
    }
    __syncthreads();
    for (int e = tid; e < G * ps; e += THREADS) {
      const int g = e / ps, i = e % ps;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += qs[g * hd + d] * ks[i * kst + d];
      sc[e] = (j * ps + i <= pos) ? dot : -1e30f;
    }
    __syncthreads();
    for (int g = tid; g < G; g += THREADS) {
      const float m_prev = mrow[g];
      float mx = m_prev;
      for (int i = 0; i < ps; ++i) mx = fmaxf(mx, sc[g * ps + i]);
      float sum = 0.f;
      for (int i = 0; i < ps; ++i) {
        const float p = __expf(sc[g * ps + i] - mx);
        sc[g * ps + i] = p;
        sum += p;
      }
      const float a = __expf(m_prev - mx);
      lrow[g] = lrow[g] * a + sum;
      mrow[g] = mx;
      arow[g] = a;
    }
    __syncthreads();
    for (int e = tid; e < G * hd; e += THREADS) {
      const int g = e / hd, d = e % hd;
      float o = acc[e] * arow[g];
      for (int i = 0; i < ps; ++i) o += sc[g * ps + i] * vs[i * hd + d];
      acc[e] = o;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * hd; e += THREADS) {
    from_f(acc[e] / fmaxf(lrow[e / hd], 1e-30f), out + qbase + e);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* slot_ids,
                   const void* positions, void* out, int T_, int H, int Hkv,
                   int hd, int P, int ps, int npg, int n_rows,
                   cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem = sizeof(float) *
      ((size_t)G * hd + (size_t)ps * (hd + 1) + (size_t)ps * hd +
       (size_t)G * ps + (size_t)G * hd + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  dim3 grid(T_, Hkv);
  paged_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(page_table),
      static_cast<const int*>(slot_ids), static_cast<const int*>(positions),
      static_cast<T*>(out), H, Hkv, hd, P, ps, npg, n_rows, scale);
  return cudaGetLastError();
}

}  // namespace

// q (T, H, hd), k_pool/v_pool (P, ps, Hkv, hd) and out (T, H, hd) in one
// type (bf16 != 0 -> bfloat16, else float32); page_table (n_rows, npg),
// slot_ids (T,) and positions (T,) int32. Returns the cudaError_t of the
// launch.
extern "C" int paged_decode_attn_launch(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* page_table,
                                        const void* slot_ids,
                                        const void* positions, void* out,
                                        int T_, int H, int Hkv, int hd, int P,
                                        int ps, int npg, int n_rows, int bf16,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, slot_ids,
                                 positions, out, T_, H, Hkv, hd, P, ps, npg,
                                 n_rows, s);
  return launch<float>(q, k_pool, v_pool, page_table, slot_ids, positions,
                       out, T_, H, Hkv, hd, P, ps, npg, n_rows, s);
}
