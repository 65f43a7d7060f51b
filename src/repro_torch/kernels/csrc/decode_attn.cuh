// Split-KV flash-decode attention for Hopper (sm_90a): the block body shared
// by paged_decode_attn.cu and flash_decode_attn.cu (each source's header
// note says what it replaces and bounds it). One query token attends over
// n columns of its own K/V rows; the two sources differ only in where
// column `col` of a (token, kv-head) lives (a Rows functor) and in their
// mask, which each turns into (n, all_masked) before calling decode_block.
//
// Grid (token or row, kv-head x head chunk, split), 128 threads a block:
//   * Head chunks. A block holds GC = 8 query heads of one kv-head; G > 8
//     takes ceil(G / 8) chunks (each reads the kv-head's rows once), G < 8
//     leaves lanes idle. Lane = 4 * g + c: head g, and the 8-element chunks
//     j of hd at (4 j + c) * 8, for j < NCH = ceil(hd / 32) (hd <= 256).
//     The lane's slice of q (scaled by log2(e) / sqrt(hd) once) and of the
//     (G, hd) accumulator, and its head's online-softmax state (m, l), live
//     in registers, in fp32.
//   * Splits. Split z covers columns [z * cps, min((z + 1) * cps, n)); the
//     plan (kernels/decode_attn.py, split_plan) comes from the shapes alone.
//     Inside a split, warp w takes the 4-row warp tiles w, w + 4, ...: it
//     stages each through its own ring of NSTAGE tiles in shared memory by
//     16-byte cp.async (K and V rows as stored, bf16 stays bf16, widened in
//     registers) with NSTAGE - 1 tiles in flight, and waits on its own
//     copies only (cp.async.wait_group + __syncwarp): no block barrier in
//     the loop. Rows whose hd * sizeof(KV) is not whole 16-byte words, or
//     pools not 16-byte aligned, take a scalar copy (VEC = false).
//   * K/V storage. KV is q's type T, or int8 (the int8 KV cache of
//     repro/models/attention.py: _quant_like / _dequant, static scale
//     127 / 8). The ring holds the bytes as stored, so an int8 cache moves
//     half the bf16 cache's bytes. Each int8 tile is dequantised once,
//     as the reference dequantises the cache before its attention: int8
//     -> fp32, the correctly rounded quotient by 15.875 (a product with
//     the reciprocal plus one fma correction, equal to the true division
//     for all 255 int8 values; a product alone would round otherwise),
//     rounded to T; the warp converts the tile into a T tile of its own
//     (each element once, not once per head of the block), and the fp32
//     score, softmax and accumulator path reads that as it reads a cache
//     of q's type.
//   * A tile: 4 scores per head, each a dot product over the lane's slice
//     reduced over the 4 lanes of the head by two shuffles; one max, one
//     rescale of (l, acc) and 4 FMAs of V rows per element.
//   * At the end of the split the 4 warps' (m, l, acc) are merged once,
//     through shared memory, in warp order. One split: the output, in q's
//     type. Several: the block writes its fp32 partial (m, l and the
//     unnormalised acc) to scratch; the last block of the (token, kv-head,
//     head chunk) to take an integer ticket merges all partials in split
//     order, writes the output and resets the ticket: one launch, no
//     floating-point atomics, the same bits every run.
//   * A split with no column (wholly past the position) still takes its
//     ticket, with l = 0; a partial with l = 0 weighs zero in a merge and
//     its acc is never read (never 0/0). all_masked columns score -1e30
//     each, so every column weighs alike: the mean of V over the n columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace decode_attn {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GC = 8;             // query heads a block holds
constexpr int R = 4;              // rows of a warp tile
constexpr int NSTAGE = 4;         // warp tiles in a warp's ring
constexpr int MAX_SPLITS = 64;    // the plan keeps splits below this
constexpr float MASKED = -1e30f;  // score of an all_masked column
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float KV_SCALE = 15.875f;  // 127 / 8, the int8 cache's static scale
constexpr float KV_RCP = 0x1.020408p-4f;  // 8 / 127 rounded to fp32

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void from_f(float x, signed char* p) {
  *p = static_cast<signed char>(x);   // only zero is stored this way
}

// int8 x / 15.875, correctly rounded in fp32: q0 = x * (8/127), then one
// fma correction of its residual (checked against the true division for
// every x in [-127, 127], tests/test_torch_kv_int8.py). The division
// itself (__fdiv_rn) ran the int8 kernels at 1.2-2.4x the float-cache
// kernels' time on an H100, this form at 1.0-1.2x.
__device__ __forceinline__ float dequant_i8(int x) {
  const float xf = static_cast<float>(x);
  const float q0 = __fmul_rn(xf, KV_RCP);
  return __fmaf_rn(__fmaf_rn(-q0, KV_SCALE, xf), KV_RCP, q0);
}

// 16 dequantised values stored in T (round to nearest even)
__device__ __forceinline__ void store16(const float (&f)[16], float* dst) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(dst)[i] =
        make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
}
__device__ __forceinline__ void store16(const float (&f)[16],
                                        __nv_bfloat16* dst) {
  unsigned w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// The tile a warp reads: a ring slot of q's type as it is; an int8 slot of
// N elements converted by the warp into its T tile `cvt` (16 elements a
// lane per pass), ordered before the reads by a __syncwarp.
template <int N, typename T>
__device__ __forceinline__ const T* tile_of(const T* st, T*, int) {
  return st;
}
template <int N, typename T>
__device__ __forceinline__ const T* tile_of(const signed char* st, T* cvt,
                                            int lane) {
  for (int e = lane * 16; e < N; e += 32 * 16) {
    const int4 u = *reinterpret_cast<const int4*>(st + e);
    const int w[4] = {u.x, u.y, u.z, u.w};
    float f[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      f[i] = dequant_i8(static_cast<signed char>(w[i / 4] >> (8 * (i % 4))));
    store16(f, cvt + e);
  }
  __syncwarp();
  return cvt;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8 elements from shared memory, widened to fp32
__device__ __forceinline__ void widen8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row index (in units of hd elements) of column col of a contiguous cache
// (B, T, Hkv, hd): ((b * T + col) * Hkv + h).
struct ContigRows {
  size_t base;                    // b * T * Hkv + h
  int Hkv;
  __device__ __forceinline__ size_t operator()(int col) const {
    return base + (size_t)col * Hkv;
  }
};

// Row index of virtual column col of a slot over paged pools
// (P, ps, Hkv, hd): page table entries clamped to [0, P - 1].
struct PagedRows {
  const int* table;               // the slot's row of the page table
  int P, ps, Hkv, h;
  __device__ __forceinline__ size_t operator()(int col) const {
    const int page = min(max(__ldg(table + col / ps), 0), P - 1);
    return ((size_t)page * ps + col % ps) * Hkv + h;
  }
};

// Bytes of dynamic shared memory a block takes: every warp's ring of KV
// elements, then (int8 K/V) every warp's T tile; the end-of-split merge
// (GC x STRIDE fp32 a warp: an int8 ring is exactly that size) and the
// combine ((2 MAX_SPLITS + 1) GC fp32) reuse the rings.
template <typename T, typename KV, int NCH>
constexpr int smem_bytes() {
  constexpr int ring = WARPS * NSTAGE * 2 * R * NCH * 32 * (int)sizeof(KV);
  constexpr int tile = sizeof(T) == sizeof(KV)
                           ? 0 : WARPS * 2 * R * NCH * 32 * (int)sizeof(T);
  constexpr int combine = (2 * MAX_SPLITS + 1) * GC * (int)sizeof(float);
  return ring + tile > combine ? ring + tile : combine;
}

// Stage rows [cb, cb + nr) of K and V into one ring slot (K rows 0..R-1,
// V rows R..2R-1, row stride STRIDE elements).
template <typename KV, int STRIDE, bool VEC, class Rows>
__device__ __forceinline__ void stage_rows(KV* st, const KV* __restrict__ k,
                                           const KV* __restrict__ v,
                                           const Rows& rows, int cb, int nr,
                                           int hd, int lane) {
  if constexpr (VEC) {
    constexpr int EPC = 16 / sizeof(KV);  // elements of a 16-byte word
    const int cpr = hd / EPC;
    for (int e = lane; e < nr * cpr; e += 32) {
      const int r = e / cpr, ch = e - r * cpr;
      const size_t off = rows(cb + r) * hd + ch * EPC;
      cp_async16(st + r * STRIDE + ch * EPC, k + off);
      cp_async16(st + (R + r) * STRIDE + ch * EPC, v + off);
    }
  } else {
    for (int e = lane; e < nr * hd; e += 32) {
      const int r = e / hd, d = e - r * hd;
      const size_t off = rows(cb + r) * hd + d;
      st[r * STRIDE + d] = k[off];
      st[(R + r) * STRIDE + d] = v[off];
    }
  }
}

// One block: query heads qrow0 .. qrow0 + heads - 1 (rows of q and out, hd
// elements each, type T) over columns [z * cps, min((z + 1) * cps, n)) of
// the K/V rows (type KV) that `rows` maps. Partials go to part_acc
// ((T * H, splits, hdp) fp32, hdp = hd rounded up to 4) and part_ml
// ((T * H, splits, 2)); `ticket` is this (token, kv-head, head chunk)'s,
// zero before and after.
template <typename T, typename KV, int NCH, bool VEC, class Rows>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q, const KV* __restrict__ k,
    const KV* __restrict__ v, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    unsigned* __restrict__ ticket,
    const Rows& rows, size_t qrow0, int heads, int hd, int n, bool all_masked,
    int cps, float qscale) {
  constexpr int STRIDE = NCH * 32;          // shared-memory row, elements
  constexpr int RING = NSTAGE * 2 * R * STRIDE;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_m[WARPS][GC], red_l[WARPS][GC];
  __shared__ int last_block;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int z = blockIdx.z, splits = gridDim.z;
  const int c0 = z * cps, c1 = min(c0 + cps, n);
  KV* ring = reinterpret_cast<KV*>(smem) + (size_t)warp * RING;
  T* cvt = reinterpret_cast<T*>(reinterpret_cast<KV*>(smem) + WARPS * RING) +
           (size_t)warp * 2 * R * STRIDE;   // int8 K/V: the warp's T tile

  float qf[NCH][8], acc[NCH][8];
  {
    const T* qr = q + (qrow0 + min(g, heads - 1)) * hd;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int d = (j * 4 + c) * 8 + e;
        qf[j][e] = g < heads && d < hd ? to_f(qr[d]) * qscale : 0.f;
        acc[j][e] = 0.f;
      }
  }
  float m = -INFINITY, l = 0.f;

  const int ntiles = c1 > c0 ? (c1 - c0 + R - 1) / R : 0;
  const int mine = ntiles > warp ? (ntiles - warp + WARPS - 1) / WARPS : 0;
  if (mine > 0) {
    if (STRIDE != hd)                       // K's pad columns meet q's zeros
      for (int e = lane; e < NSTAGE * R * (STRIDE - hd); e += 32) {
        const int r = e / (STRIDE - hd), d = hd + e % (STRIDE - hd);
        from_f(0.f, ring + (r / R) * 2 * R * STRIDE + (r % R) * STRIDE + d);
      }
    auto issue = [&](int i) {
      if (i < mine) {
        const int cb = c0 + (warp + i * WARPS) * R;
        stage_rows<KV, STRIDE, VEC>(ring + (i % NSTAGE) * 2 * R * STRIDE, k,
                                   v, rows, cb, min(R, c1 - cb), hd, lane);
      }
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < NSTAGE - 1; ++i) issue(i);
    for (int i = 0; i < mine; ++i) {
      cp_async_wait<NSTAGE - 2>();          // this lane's copies of tile i
      __syncwarp();                         // everyone's; slot i-1 is free
      issue(i + NSTAGE - 1);
      const int cb = c0 + (warp + i * WARPS) * R;
      const int nr = min(R, c1 - cb);
      const T* st = tile_of<2 * R * STRIDE>(
          ring + (i % NSTAGE) * 2 * R * STRIDE, cvt, lane);
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = -INFINITY;
        if (r < nr) {
          if (all_masked) {
            s[r] = MASKED;
          } else {
            float dot = 0.f;
#pragma unroll
            for (int j = 0; j < NCH; ++j) {
              float kf[8];
              widen8(st + r * STRIDE + (j * 4 + c) * 8, kf);
#pragma unroll
              for (int e = 0; e < 8; ++e) dot = fmaf(qf[j][e], kf[e], dot);
            }
            dot += __shfl_xor_sync(FULL, dot, 1);
            dot += __shfl_xor_sync(FULL, dot, 2);
            s[r] = dot;
          }
        }
      }
      float mx = m;
#pragma unroll
      for (int r = 0; r < R; ++r) mx = fmaxf(mx, s[r]);
      const float alpha = fast_exp2(m - mx);
      float p[R], sum = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        p[r] = fast_exp2(s[r] - mx);
        sum += p[r];
      }
      l = l * alpha + sum;
      m = mx;
#pragma unroll
      for (int j = 0; j < NCH; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
#pragma unroll
          for (int j = 0; j < NCH; ++j) {
            float vf[8];
            widen8(st + (R + r) * STRIDE + (j * 4 + c) * 8, vf);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[j][e] = fmaf(p[r], vf[e], acc[j][e]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();                           // the ring is the warp's again
  }

  // merge the 4 warps' states, in warp order
  float* red = reinterpret_cast<float*>(ring);         // (GC, STRIDE)
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    float* dst = red + g * STRIDE + (j * 4 + c) * 8;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
  }
  if (c == 0) {
    red_m[warp][g] = m;
    red_l[warp][g] = l;
  }
  __syncthreads();
  const int hq = (hd + 3) / 4;              // 4-element quads of a head
  const int hdp = 4 * hq;
  for (int it = tid; it < heads * hq; it += THREADS) {
    const int hg = it / hq, qd = it - hg * hq;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (red_l[w][hg] > 0.f) M = fmaxf(M, red_m[w][hg]);
    float L = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (red_l[w][hg] > 0.f) {
        const float wt = fast_exp2(red_m[w][hg] - M);
        const float4 x = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(
                reinterpret_cast<const KV*>(smem) + (size_t)w * RING) +
            hg * STRIDE + qd * 4);
        L += wt * red_l[w][hg];
        a.x += wt * x.x;
        a.y += wt * x.y;
        a.z += wt * x.z;
        a.w += wt * x.w;
      }
    }
    const size_t prow = (qrow0 + hg) * splits + z;
    if (splits == 1) {
      const float inv = L > 0.f ? 1.f / L : 0.f;
      const float o[4] = {a.x * inv, a.y * inv, a.z * inv, a.w * inv};
      T* dst = out + (qrow0 + hg) * hd;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (qd * 4 + e < hd) from_f(o[e], dst + qd * 4 + e);
    } else {
      if (L > 0.f)
        __stcg(reinterpret_cast<float4*>(part_acc + prow * hdp + qd * 4), a);
      if (qd == 0) {
        __stcg(part_ml + 2 * prow, M);
        __stcg(part_ml + 2 * prow + 1, L);
      }
    }
  }
  if (splits == 1) return;

  // the last split to take the ticket merges all partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(ticket, 1u) == (unsigned)splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  float* wts = reinterpret_cast<float*>(smem);         // (heads, splits)
  float* lz = wts + GC * MAX_SPLITS;                    // (heads, splits)
  float* Ls = lz + GC * MAX_SPLITS;                     // (heads,)
  for (int e = tid; e < heads * splits; e += THREADS) {
    const size_t prow = (qrow0 + e / splits) * splits + e % splits;
    wts[e] = __ldcg(part_ml + 2 * prow);
    lz[e] = __ldcg(part_ml + 2 * prow + 1);
  }
  __syncthreads();
  if (tid < heads) {
    float* w = wts + tid * splits;
    const float* lt = lz + tid * splits;
    float M = -INFINITY;
    for (int s = 0; s < splits; ++s)
      if (lt[s] > 0.f) M = fmaxf(M, w[s]);
    float L = 0.f;
    for (int s = 0; s < splits; ++s) {
      w[s] = lt[s] > 0.f ? fast_exp2(w[s] - M) : 0.f;
      L += w[s] * lt[s];
    }
    Ls[tid] = L;
  }
  __syncthreads();
  for (int it = tid; it < heads * hq; it += THREADS) {
    const int hg = it / hq, qd = it - hg * hq;
    const float* w = wts + hg * splits;
    const float* src = part_acc + (qrow0 + hg) * splits * hdp + qd * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float ws = w[s];
      const float4 x = ws != 0.f
          ? __ldcg(reinterpret_cast<const float4*>(src + (size_t)s * hdp))
          : make_float4(0.f, 0.f, 0.f, 0.f);
      a.x += ws * x.x;
      a.y += ws * x.y;
      a.z += ws * x.z;
      a.w += ws * x.w;
    }
    const float L = Ls[hg];
    const float inv = L > 0.f ? 1.f / L : 0.f;
    const float o[4] = {a.x * inv, a.y * inv, a.z * inv, a.w * inv};
    T* dst = out + (qrow0 + hg) * hd;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (qd * 4 + e < hd) from_f(o[e], dst + qd * 4 + e);
  }
  if (tid == 0) *ticket = 0u;
}

// ---- host side --------------------------------------------------------

// hd -> chunks of 32 elements a lane group covers (NCH)
inline int nch_of(int hd) {
  return hd <= 32 ? 1 : hd <= 64 ? 2 : hd <= 96 ? 3 : hd <= 128 ? 4 : 8;
}

// What every launch checks: hd within the lanes' reach, splits within the
// combine's shared memory.
inline bool shape_ok(int hd, int splits) {
  return hd >= 1 && hd <= 256 && splits >= 1 && splits < MAX_SPLITS;
}

// The grid: (token or row, kv-head x head chunk, split).
inline dim3 grid_of(int rows, int H, int Hkv, int splits) {
  return dim3(rows, Hkv * ((H / Hkv + GC - 1) / GC), splits);
}

// Q-scale for the base-2 softmax: log2(e) / sqrt(hd).
inline float qscale_of(int hd) { return LOG2E / sqrtf((float)hd); }

// K/V rows that are whole 16-byte words at 16-byte addresses take the
// cp.async path (VEC); the rest the scalar copy.
template <typename KV>
bool vec_rows(int hd, const void* k, const void* v) {
  return (hd * sizeof(KV)) % 16 == 0 &&
         reinterpret_cast<size_t>(k) % 16 == 0 &&
         reinterpret_cast<size_t>(v) % 16 == 0;
}

// Launch one (T, KV, NCH, VEC) instantiation with the dynamic shared memory
// it takes; the opt-in attribute is set at its first launch (a 48 KB ring
// plus the 272 static bytes already needs it). The template arguments,
// with the kernel's parameter types, key the flag to one kernel.
template <typename T, typename KV, int NCH, bool VEC, typename... Params,
          typename... Args>
cudaError_t launch_kernel(void (*kern)(Params...), dim3 grid,
                          cudaStream_t stream, Args... args) {
  constexpr int smem = smem_bytes<T, KV, NCH>();
  static bool set = false;
  if (!set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set = true;
  }
  kern<<<grid, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace decode_attn
