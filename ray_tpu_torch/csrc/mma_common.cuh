// Shared device code of the tensor-core attention kernels (flash_fwd.cu:
// B1 with bf16 inputs; paged_prefill.cu: B5 and its quantized variant with
// a bf16 q). Both are forward attention with a base-2 online softmax over
// a pre-scaled q, FlashAttention-2 style on mma.sync:
//
// - a block of 4 warps owns 64 query rows, 16 per warp; each warp keeps
//   its rows' m, l and output accumulator in f32 registers, and its Q
//   fragments (16 rows x HD, bf16) in registers for the whole kv walk;
// - kv tiles of 64 keys arrive in shared memory as 16-bit tiles (rows
//   padded by 8 elements, so the 8 row addresses of an ldmatrix fall on 8
//   different 4-bank groups);
// - S = Q K^T and O += P V are mma.sync.m16n8k16 with f32 accumulation,
//   B operands from ldmatrix (.trans for V);
// - the softmax runs on the S accumulator fragment: a row lives in the 4
//   threads of a quad (2 shuffles per reduction), and the P fragment
//   becomes the A operand of P V without leaving registers.
//
// Fragment layout of m16n8k16 (g = lane / 4, c = lane % 4): accumulator
// d[0..1] is row g, columns 2c, 2c+1 of the n-tile, d[2..3] row g + 8. An
// S accumulator s[j] (keys 8j .. 8j+7) therefore holds keys 8j + 2c + {0,1}
// of rows g and g + 8, and s[2k], s[2k+1] packed in pairs are exactly the
// A fragment of k-step k (keys 16k .. 16k+15) of P V.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

constexpr int kThreads = 128;
constexpr int kRows = 64;    // query rows of a block, 16 per warp
constexpr int kKeys = 64;    // keys of a kv tile
constexpr int kPad = 8;      // 16-bit elements padding each shared row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (or 4-byte) asynchronous copy global -> shared; !pred copies
// nothing and zero-fills the destination (src must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a b, m16n8k16, f32 accumulation; F16 picks fp16 operands, else bf16
template <bool F16>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (F16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two floats -> one register of two 16-bit values (lo in the low half)
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (F16) {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Stage 64 rows of CH 16-byte chunks each into dst [64][ld] (ld in units
// of T): chunk c of row r comes from src(r, c), or is zero-filled where
// src(r, c) is null (the copy then names the valid global address any,
// and reads nothing). The commit is the caller's.
template <int CH, typename T, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const void* any,
                                           Src src) {
  static_assert(kThreads % CH == 0, "chunks per row must divide 128");
  constexpr int kEl = 16 / sizeof(T);
  const int c = threadIdx.x % CH;
#pragma unroll
  for (int r = threadIdx.x / CH; r < kRows; r += kThreads / CH) {
    const void* p = src(r, c);
    cp_async16(dst + r * ld + c * kEl, p ? p : any, p != nullptr);
  }
}

// The warp's Q fragments from its 16 rows of a bf16 tile [16][ld], each
// multiplied by c and rounded to bf16 (the TPU kernels' pre-scaled q).
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qf)[HD / 16][4],
                                       const uint16_t* qs, int ld, float c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    ldsm_x4(qf[kk], qs + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&qf[kk][i]));
      qf[kk][i] = pack2<false>(f.x * c, f.y * c);
    }
  }
}

// s[j] = Q K^T for keys 8j .. 8j+7 of a bf16 K tile [64][ld].
template <int HD>
__device__ __forceinline__ void qk(float (&s)[8][4],
                                   const uint32_t (&qf)[HD / 16][4],
                                   const uint16_t* ks, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // matrices of one x4 load: keys +0..7 and +8..15, dims +0..7 and +8..15
  const uint16_t* base =
      ks + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int np = 0; np < 4; ++np)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, base + np * 16 * ld + kk * 16);
      mma16816<false>(s[2 * np], qf[kk], b[0], b[1]);
      mma16816<false>(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
}

// acc[n] += P V for dims 8n .. 8n+7 of a 16-bit V tile [64][ld]; pa[k] is
// the A fragment of keys 16k .. 16k+15.
template <int HD, bool F16>
__device__ __forceinline__ void pv(float (&acc)[HD / 8][4],
                                   const uint32_t (&pa)[4][4],
                                   const uint16_t* vs, int ld) {
  const int lane = threadIdx.x & 31;
  // matrices of one x4 .trans load: keys +0..7 and +8..15 (B's two
  // registers), dims +0..7 and +8..15 (two n-tiles)
  const uint16_t* base =
      vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, base + kk * 16 * ld + dp * 16);
      mma16816<F16>(acc[2 * dp], pa[kk], b[0], b[1]);
      mma16816<F16>(acc[2 * dp + 1], pa[kk], b[2], b[3]);
    }
}

// One online-softmax step on the score fragment, in place: s becomes p.
// Rows h = 0 (g) and 1 (g + 8); m is the row max (equal across the quad),
// l this thread's partial row sum (the quad's four are summed once, in
// finish). ROUND: bf16 inputs round s - m and exp2 to bf16 (the TPU
// kernels' rule); the sum is f32 over the rounded p. acc is rescaled by
// alpha times acc_factor (1 except where the caller rescales its own units).
template <bool ROUND, int NT>
__device__ __forceinline__ void softmax_step(float (&s)[8][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&acc)[NT][4],
                                             float acc_factor) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = exp2f(m[h] - mx);
    m[h] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        float p;
        if constexpr (ROUND)
          p = round_bf16(exp2f(round_bf16(s[j][e] - mx)));
        else
          p = exp2f(s[j][e] - mx);
        s[j][e] = p;
        sum += p;
      }
    l[h] = l[h] * alpha + sum;
    const float a = alpha * acc_factor;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][2 * h] *= a;
      acc[n][2 * h + 1] *= a;
    }
  }
}

// p (the softmax'd s) -> A fragments of P V, each key t's column times
// f[t] * fs (f == nullptr: 1); f is indexed by the key within the tile.
template <bool F16>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4],
                                       const float (&s)[8][4],
                                       const float* f, float fs) {
  const int c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      float2 w = make_float2(1.f, 1.f);
      if (f != nullptr) {
        w = *reinterpret_cast<const float2*>(f + 8 * j + c2);
        w.x *= fs;
        w.y *= fs;
      }
      pa[kk][2 * half] = pack2<F16>(s[j][0] * w.x, s[j][1] * w.y);
      pa[kk][2 * half + 1] = pack2<F16>(s[j][2] * w.x, s[j][3] * w.y);
    }
}

// The quad's full row sums from each thread's partial ones.
__device__ __forceinline__ void finish(float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// Dynamic shared memory above 48 KB needs the attribute set first.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace mma
