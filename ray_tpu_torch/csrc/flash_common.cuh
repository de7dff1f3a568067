// Shared device code of the flash-attention kernels on the CUDA cores, the
// f32 instantiations of B1 (flash_fwd.cu), B2 and B3 (flash_bwd.cu). Their
// bf16 instantiations run on the tensor cores (mma_common.cuh): the f32
// tensor-core form would be TF32, which rounds the inputs.
//
// Layout: q, k, v, o and their gradients are [B*H, S, D] row-major (the
// [B, H, S, D] tensors of the wrapper, contiguous); the base-2 log-sum-exp
// and delta = rowsum(dO * O) are [B*H, S] f32.
//
// Every kernel works on 64-row tiles of queries and 64-key tiles of keys
// with 128 threads. Tiles are staged in shared memory as f32 (bf16 inputs
// are exact in f32), each row padded by one float so that both row-wise
// and column-wise reads of a tile spread over all 32 banks. Products of
// two tiles run on the CUDA cores: thread (ty, tx) = (tid / 16, tid % 16)
// owns output rows ty + 8 i (i < 8) and columns tx + 16 j and keeps their
// f32 sums in registers, so the 16 threads of one row form a half-warp and
// row reductions are four shuffles.
//
// Numerics follow the TPU kernels: q is scaled by round_T(scale * log2 e)
// and rounded to T; scores, max, sums and accumulators are f32; with bf16
// inputs (s - m) and exp2 are rounded to bf16, and p and ds are rounded to
// T before their products. f32 inputs stay f32 throughout.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace flash {

constexpr int kThreads = 128;
constexpr int kTile = 64;           // query rows, and keys, per tile
constexpr int kLdP = kTile + 1;     // row stride of a [64][64] score tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// Reductions over the 16 lanes of a half-warp (the threads of one row).
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows row0 .. row0 + 63 of a [S, D] slice into dst [64][D + 1] as
// f32; rows past S are zero. SCALED multiplies by c and rounds to T (the
// pre-scaled q of the TPU kernels).
template <typename T, int D, bool SCALED>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int row0,
                                          int S, float c) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D, row = row0 + r;
    float x = row < S ? to_f32(src[(size_t)row * D + d]) : 0.f;
    if (SCALED) x = round_t<T>(x * c);
    dst[r * (D + 1) + d] = x;
  }
}

// Stage 64 entries of a [S] f32 row vector; entries past S are zero.
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < S ? src[row0 + r] : 0.f;
}

// acc[i][j] += sum_k A(r, k) * B(c, k) for r = ty + 8 i, c = tx + 16 j,
// k < K. A(r, k) is A[r * lda + k], or A[k * lda + r] when AT; B(c, k) is
// B[c * ldb + k], or B[k * ldb + c] when BT.
template <int N, int K, bool AT, bool BT>
__device__ __forceinline__ void tile_mma(float (&acc)[8][N / 16],
                                         const float* __restrict__ A, int lda,
                                         const float* __restrict__ B,
                                         int ldb) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[8], b[N / 16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      a[i] = AT ? A[k * lda + r] : A[r * lda + k];
    }
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      const int c = tx + 16 * j;
      b[j] = BT ? B[k * ldb + c] : B[c * ldb + k];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[8][N / 16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < N / 16; ++j) acc[i][j] = 0.f;
}

using mma::allow_smem;  // dynamic shared memory above 48 KB

// Whether the key at kpos is visible from the query at qpos.
__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int causal) {
  return qpos < S && kpos < S && (!causal || kpos <= qpos);
}

}  // namespace flash
