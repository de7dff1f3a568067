// Flash-attention forward (kernel B1 of the port) for Hopper, sm_90a.
//
// Replaces ray_tpu/ops/attention.py::_flash_fwd_kernel (wrapper
// _flash_forward): causal or full attention over [B*H, S, D] with a base-2
// online softmax, q pre-scaled by scale * log2(e); writes o and, when asked,
// the base-2 log-sum-exp m + log2(l) per row (l == 0 -> 1).
//
// Bound on this card: 4 * D flops per attended (query, key) pair against
// q, k, v and o moved once. GPT-2 (S 1024, D 64) does about 2 * 64 * S / 2
// / 4 ~ 16 k flops per kv byte, far above the H100's ~295: the kernel is
// operations-bound. This first version does the flops on the CUDA cores in
// f32 from shared memory, not on the tensor cores, and that is what holds
// it back; mma/wgmma tiles are the later fix.
//
// Design: the TPU kernel carries m, l and acc in VMEM scratch across the
// sequential kv axis of its grid. Here one block of 128 threads owns one
// (b*h, 64-row q tile), keeps m, l and its share of acc in registers, and
// loops over kv tiles itself. The causal skip is the loop bound (tiles
// above the diagonal are never loaded), and only the diagonal tile and a
// ragged last tile (S not a multiple of 64) are masked. Blocks of the
// longest causal rows start first.
#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)3 * kTile * (D + 1) + (size_t)kTile * kLdP);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, float qscale,
                     int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 1;
  float* Qs = smem;             // [64][LD] pre-scaled queries
  float* Ks = Qs + kTile * LD;  // [64][LD]
  float* Vs = Ks + kTile * LD;  // [64][LD]
  float* Ps = Vs + kTile * LD;  // [64][kLdP] probabilities
  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int q0 = qt * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D, true>(Qs, q + base, q0, S, round_t<T>(qscale));
  float m[8], l[8], acc[8][D / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero<D>(acc);

  const int kt_end = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * kTile;
    load_tile<T, D, false>(Ks, k + base, k0, S, 0.f);
    load_tile<T, D, false>(Vs, v + base, k0, S, 0.f);
    __syncthreads();

    float s[8][kTile / 16];
    zero<kTile>(s);
    tile_mma<kTile, D, false, false>(s, Qs, LD, Ks, LD);
    const bool masked = (causal && kt == qt) || k0 + kTile > S;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        // rows past S (never written) are masked like any other row, and
        // key 0 of tile 0 keeps every row's maximum finite
        const int kpos = k0 + tx + 16 * j;
        if (masked && (kpos >= S || (causal && kpos > q0 + r)))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTile / 16; ++j) {
        const float p = round_t<T>(exp2f(round_t<T>(s[i][j] - m_new)));
        Ps[r * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = exp2f(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_mma<D, kTile, false, true>(acc, Ps, kLdP, Vs, LD);
    __syncthreads();  // the next tile overwrites Ks, Vs and Ps
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + ty + 8 * i;
    if (qpos >= S) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      o[base + (size_t)qpos * D + tx + 16 * j] = from_f32<T>(acc[i][j] / ls);
    if (lse != nullptr && tx == 0)
      lse[(size_t)blockIdx.y * S + qpos] = m[i] + log2f(ls);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int S, float qscale, int causal, cudaStream_t stream) {
  const size_t bytes = fwd_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, qscale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int by_dim(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int S, int D, float qscale, int causal,
           cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, BH, S, qscale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, BH, S, qscale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, BH, S, qscale, causal, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {32, 64, 128}; lse may be null
// (not written). Returns a cudaError_t (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int BH, int S, int D, float qscale,
                         int causal, int dtype, void* stream) {
  if (BH <= 0 || BH > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return by_dim<float>(q, k, v, o, l, BH, S, D, qscale, causal, s);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(q, k, v, o, l, BH, S, D, qscale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
