// Shared device code of the two paged-attention kernels
// (paged_decode.cu, paged_prefill.cu): the block-table walk over the paged
// KV pool with a base-2 online softmax, for a tile of R query rows that all
// attend ONE kv head of ONE sequence.
//
// Pool layout (one layer): [num_blocks, block_size, n_kv_head, head_dim],
// row-major, so one token's head_dim values of one kv head are contiguous
// (head_dim * sizeof(T) bytes) and tokens of a block sit Hkv * head_dim
// elements apart.
//
// Per kv block the tile does four phases, each closed by __syncthreads():
//   1. wait for the block's K and V tiles (cp.async, 16-byte copies, issued
//      one block ahead into a two-stage shared-memory ring);
//   2. scores s[r, t] = q[r] . k[t] (q pre-scaled by scale * log2(e)),
//      masked to t <= pos[r] (and t > pos[r] - window);
//   3. per row, one warp: running max, p = exp2(s - m), running sum;
//   4. acc[r, :] = acc[r, :] * alpha[r] + sum_t p[r, t] * v[t, :].
// bf16 inputs round (s - m) and exp2 to bf16 and f32 inputs stay f32, as
// the TPU kernels do; max, sum and accumulator are f32 either way.
//
// Three types are separate: KV, the pool's storage type (f32, bf16, or a
// quantized int8 / fp8-e4m3); P, the type the softmax rounds through; O,
// the output type (q's). Unquantized, all three are q's type. Quantized
// (the TPU kernels' `quantized=True` branch), K/V arrive as 1-byte tiles
// with one f32 scale per (slot, kv head), staged beside them, and are
// dequantized in registers, k = float(data) * scale, one f32 multiply as
// in JAX; the TPU branch runs its softmax on an f32 q, so P is f32 and the
// bf16 exp2 rule never fires.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace paged {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// elements of T in one 16-byte copy
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };
// a 1-byte pool type is quantized: it carries a scale plane
template <typename T> constexpr bool kQuantized = sizeof(T) == 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);  // exact: every e4m3 value is an f32
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// Round through T: identity for f32, bf16 rounding for bf16.
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f32(from_f32<T>(x));
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

// f32 words of a tile's state: q, acc, scores, m, l, alpha, and the scale
// ring [2 stages][K, V][bs] (used by quantized pools only)
__host__ __device__ inline size_t state_floats(int R, int hd, int bs) {
  size_t nf = (size_t)2 * R * hd + (size_t)R * bs + 3 * R + 4 * bs;
  return nf + (nf & 1);  // keeps the long long offsets 8-byte aligned
}

// Shared-memory bytes for a tile of R rows. The K/V ring comes first (its
// rows are padded by one 16-byte vector, so the 16-byte reads of the score
// phase spread over all banks); f32 state and int positions follow.
__host__ __device__ inline size_t smem_bytes(int R, int hd, int bs,
                                             int tsize) {
  const int vec = 16 / tsize;
  size_t ring = (size_t)4 * bs * (hd + vec) * tsize;
  size_t extra = (size_t)R * (sizeof(int) + sizeof(long long));
  return ring + state_floats(R, hd, bs) * sizeof(float) + extra;
}

template <typename T> struct Tile {
  T* ring;          // [2 stages][K, V][bs][hd + vec]
  float* sring;     // [2 stages][K, V][bs] scales (quantized pools)
  float* q;         // [R][hd] pre-scaled queries
  float* acc;       // [R][hd]
  float* sc;        // [R][bs] scores, then probabilities
  float* m;         // [R] running max
  float* l;         // [R] running sum
  float* alpha;     // [R] this block's rescale factor
  long long* orow;  // [R] output element offset of each row, -1 = padding
  int* pos;         // [R] true position of each row

  __device__ static Tile carve(unsigned char* base, int R, int hd, int bs) {
    constexpr int vec = Vec<T>::n;
    Tile t;
    t.ring = reinterpret_cast<T*>(base);
    float* f = reinterpret_cast<float*>(base + (size_t)4 * bs * (hd + vec) *
                                                   sizeof(T));
    t.q = f;
    t.acc = t.q + R * hd;
    t.sc = t.acc + R * hd;
    t.m = t.sc + R * bs;
    t.l = t.m + R;
    t.alpha = t.l + R;
    t.sring = t.alpha + R;
    t.orow = reinterpret_cast<long long*>(t.q + state_floats(R, hd, bs));
    t.pos = reinterpret_cast<int*>(t.orow + R);
    return t;
  }
};

// Walk kv blocks i_lo..i_hi (inclusive) of one sequence's table for one kv
// head and write the R rows' outputs. The caller has filled t.q, t.pos and
// t.orow and synchronised. window <= 0 means no sliding window. kscale /
// vscale are the pool's [num_blocks, bs, Hkv] f32 planes when KV is
// quantized, unused otherwise.
template <typename KV, typename P, typename O>
__device__ void attend_tile(const KV* __restrict__ kpool,
                            const KV* __restrict__ vpool,
                            const float* __restrict__ kscale,
                            const float* __restrict__ vscale,
                            const int* __restrict__ table, int i_lo, int i_hi,
                            int R, int hd, int bs, int Hkv, int kvh,
                            int window, Tile<KV>& t, O* __restrict__ out) {
  using T = KV;
  constexpr int vec = Vec<T>::n;
  constexpr bool quant = kQuantized<KV>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = hd + vec;
  const size_t tok_stride = (size_t)Hkv * hd;

  for (int e = tid; e < R * hd; e += kThreads) t.acc[e] = 0.f;
  for (int r = tid; r < R; r += kThreads) {
    t.m[r] = kNegInf;
    t.l[r] = 0.f;
  }

  // threads that share one (row, token) score: as many as keep all
  // threads busy, at most a warp and at most one per 16-byte vector
  const int npairs = R * bs;
  int tpp = 1;
  while (tpp < 32 && tpp * 2 * npairs <= kThreads && tpp * 2 * vec <= hd)
    tpp *= 2;
  const int groups = kThreads / tpp;
  const int sub = tid % tpp;

  auto load = [&](int stage, int i) {
    const size_t row0 = (size_t)table[i] * bs * Hkv + kvh;  // (blk, 0, kvh)
    const T* kb = kpool + row0 * hd;
    const T* vb = vpool + row0 * hd;
    T* ks = t.ring + (size_t)stage * 2 * bs * ld;
    T* vs = ks + (size_t)bs * ld;
    const int vpr = hd / vec;
    for (int x = tid; x < bs * vpr; x += kThreads) {
      const int tok = x / vpr, c = (x % vpr) * vec;
      __pipeline_memcpy_async(ks + tok * ld + c, kb + tok * tok_stride + c, 16);
      __pipeline_memcpy_async(vs + tok * ld + c, vb + tok * tok_stride + c, 16);
    }
    if constexpr (quant) {
      // one head's bs scales lie Hkv floats apart: 4-byte copies
      float* kss = t.sring + (size_t)stage * 2 * bs;
      for (int tok = tid; tok < bs; tok += kThreads) {
        __pipeline_memcpy_async(kss + tok, kscale + row0 + (size_t)tok * Hkv,
                                4);
        __pipeline_memcpy_async(kss + bs + tok,
                                vscale + row0 + (size_t)tok * Hkv, 4);
      }
    }
    __pipeline_commit();
  };

  __syncthreads();
  if (i_lo <= i_hi) load(0, i_lo);
  for (int i = i_lo; i <= i_hi; ++i) {
    const int stage = (i - i_lo) & 1;
    if (i < i_hi) {
      load(stage ^ 1, i + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const T* ks = t.ring + (size_t)stage * 2 * bs * ld;
    const T* vs = ks + (size_t)bs * ld;
    const float* kss = t.sring + (size_t)stage * 2 * bs;  // quantized only
    const float* vss = kss + bs;

    // 2. scores
    for (int base = 0; base < npairs; base += groups) {
      const int p = base + tid / tpp;
      float s = 0.f;
      if (p < npairs) {
        const int r = p / bs, tok = p % bs;
        const float* qr = t.q + r * hd;
        const T* kr = ks + tok * ld;
        float ksc = 1.f;
        if constexpr (quant) ksc = kss[tok];
        for (int d = sub * vec; d < hd; d += tpp * vec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + d);
          const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < vec; ++e) {
            if constexpr (quant)
              s += qr[d + e] * (to_f32(kv[e]) * ksc);
            else
              s += qr[d + e] * to_f32(kv[e]);
          }
        }
      }
      for (int o = tpp >> 1; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (p < npairs && sub == 0) {
        const int r = p / bs, tok = p % bs;
        const int ta = i * bs + tok;
        const int pr = t.pos[r];
        const bool ok = ta <= pr && (window <= 0 || ta > pr - window);
        t.sc[p] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per row
    for (int r = warp; r < R; r += kWarps) {
      float* sr = t.sc + r * bs;
      float mx = kNegInf;
      for (int k = lane; k < bs; k += 32) mx = fmaxf(mx, sr[k]);
      mx = warp_max(mx);
      const float m_prev = t.m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int k = lane; k < bs; k += 32) {
        const float p = round_t<P>(exp2f(round_t<P>(sr[k] - m_new)));
        sr[k] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = exp2f(m_prev - m_new);
        t.alpha[r] = a;
        t.l[r] = a * t.l[r] + sum;
        t.m[r] = m_new;
      }
    }
    __syncthreads();

    // 4. rescale and accumulate p @ v
    for (int e = tid; e < R * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const float* pr = t.sc + r * bs;
      float a = t.acc[e] * t.alpha[r];
      for (int k = 0; k < bs; ++k) {
        if constexpr (quant)
          a += pr[k] * (to_f32(vs[k * ld + d]) * vss[k]);
        else
          a += pr[k] * to_f32(vs[k * ld + d]);
      }
      t.acc[e] = a;
    }
    __syncthreads();  // the next load reuses this stage's buffers
  }

  for (int e = tid; e < R * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    if (t.orow[r] < 0) continue;
    const float l = t.l[r];
    out[t.orow[r] + d] = from_f32<O>(t.acc[e] / (l == 0.f ? 1.f : l));
  }
}

}  // namespace paged
