// Flash-attention backward (kernels B2 and B3 of the port) for Hopper,
// sm_90a: the two-pass schedule of the TPU backward.
//
// Replaces ray_tpu/ops/attention.py::_flash_bwd_dkv_kernel (B2, entry
// flash_bwd_dkv) and ::_flash_bwd_dq_kernel (B3, entry flash_bwd_dq),
// wrapper _flash_backward. Both recompute p = exp2(s - lse) from q, k and
// the forward's base-2 log-sum-exp, with
//   dp = dO v^T,   ds = p * (dp - delta) * ln2,   delta = rowsum(dO * O);
// B2 accumulates dV += p^T dO and dK += ds^T q_scaled over the q tiles that
// see one kv tile; B3 accumulates dQ += ds k over the kv tiles one q tile
// sees and stores dQ in T times round_T(scale * log2 e), the chain rule back
// from the pre-scaled q (the TPU wrapper's final rescale, done here in the
// epilogue). The gradient is taken with respect to the rounded pre-scaled
// q, as on the TPU.
//
// Bound on this card: B2 does 4 products of 2 * D flops per visible pair,
// B3 three, against a handful of [S, D] tensors moved once: both are
// operations-bound by far. Like B1, this first version runs them on the
// CUDA cores from shared memory; tensor-core tiles are the later fix.
//
// Design: the TPU kernels keep dK/dV (B2) or dQ (B3) in VMEM scratch across
// the sequential inner grid axis. Here one block of 128 threads owns one
// (b*h, 64-row output tile), keeps those sums in registers and loops over
// the other axis itself; the causal skip is the loop bound and only the
// diagonal and ragged tiles are masked. The TPU kernel's fused mode (dQ
// partials written by B2 when there are at most 4 kv blocks) is not taken:
// at 64-row tiles S = 1024 already has 16 kv tiles, where the TPU code also
// runs two passes.
#include "flash_common.cuh"

namespace {

using namespace flash;

// p and ds of one [64 q][64 kv] tile pair into Ps / dSs (either may be
// null), from the staged Qs, Ks, dOs, Vs and the rows' lse (Ls) and delta
// (Ds).
template <typename T, int D>
__device__ __forceinline__ void probs_and_ds(
    const float* Qs, const float* Ks, const float* dOs, const float* Vs,
    const float* Ls, const float* Ds, float* Ps, float* dSs, int q0, int k0,
    int S, int causal) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[8][kTile / 16], dp[8][kTile / 16];
  zero<kTile>(s);
  zero<kTile>(dp);
  tile_mma<kTile, D, false, false>(s, Qs, LD, Ks, LD);
  tile_mma<kTile, D, false, false>(dp, dOs, LD, Vs, LD);
  const bool masked =
      (causal && q0 == k0) || q0 + kTile > S || k0 + kTile > S;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    const float lse = Ls[r], delta = Ds[r];
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      const int c = tx + 16 * j;
      float p = 0.f;
      if (!masked || visible(q0 + r, k0 + c, S, causal))
        p = round_t<T>(exp2f(round_t<T>(s[i][j] - lse)));
      if (Ps != nullptr) Ps[r * kLdP + c] = p;
      dSs[r * kLdP + c] = round_t<T>(p * (dp[i][j] - delta) * kLn2);
    }
  }
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((size_t)4 * kTile * (D + 1) +
                          (size_t)2 * kTile * kLdP + 2 * kTile);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)4 * kTile * (D + 1) +
                          (size_t)kTile * kLdP + 2 * kTile);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, float qscale,
                         int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 1;
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Ps = dOs + kTile * LD;
  float* dSs = Ps + kTile * kLdP;
  float* Ls = dSs + kTile * kLdP;
  float* Ds = Ls + kTile;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.x;  // causal: tile 0 sees the most q tiles
  const int k0 = kt * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const float* lse_b = lse + (size_t)blockIdx.y * S;
  const float* delta_b = delta + (size_t)blockIdx.y * S;
  const float c = round_t<T>(qscale);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D, false>(Ks, k + base, k0, S, 0.f);
  load_tile<T, D, false>(Vs, v + base, k0, S, 0.f);
  float acc_dk[8][D / 16], acc_dv[8][D / 16];
  zero<D>(acc_dk);
  zero<D>(acc_dv);

  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    load_tile<T, D, true>(Qs, q + base, q0, S, c);
    load_tile<T, D, false>(dOs, dout + base, q0, S, 0.f);
    load_rows(Ls, lse_b, q0, S);
    load_rows(Ds, delta_b, q0, S);
    __syncthreads();
    probs_and_ds<T, D>(Qs, Ks, dOs, Vs, Ls, Ds, Ps, dSs, q0, k0, S, causal);
    __syncthreads();
    // rows kv, columns d, summed over the tile's q rows
    tile_mma<D, kTile, true, true>(acc_dv, Ps, kLdP, dOs, LD);
    tile_mma<D, kTile, true, true>(acc_dk, dSs, kLdP, Qs, LD);
    __syncthreads();  // the next q tile overwrites Qs, dOs, Ps and dSs
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kpos = k0 + ty + 8 * i;
    if (kpos >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const size_t at = base + (size_t)kpos * D + tx + 16 * j;
      dk[at] = from_f32<T>(acc_dk[i][j]);
      dv[at] = from_f32<T>(acc_dv[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int S, float qscale, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 1;
  float* Qs = smem;
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;
  float* Ls = dSs + kTile * kLdP;
  float* Ds = Ls + kTile;
  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qt * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const float c = round_t<T>(qscale);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D, true>(Qs, q + base, q0, S, c);
  load_tile<T, D, false>(dOs, dout + base, q0, S, 0.f);
  load_rows(Ls, lse + (size_t)blockIdx.y * S, q0, S);
  load_rows(Ds, delta + (size_t)blockIdx.y * S, q0, S);
  float acc[8][D / 16];
  zero<D>(acc);

  const int kt_end = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * kTile;
    load_tile<T, D, false>(Ks, k + base, k0, S, 0.f);
    load_tile<T, D, false>(Vs, v + base, k0, S, 0.f);
    __syncthreads();
    probs_and_ds<T, D>(Qs, Ks, dOs, Vs, Ls, Ds, nullptr, dSs, q0, k0, S,
                       causal);
    __syncthreads();
    // rows q, columns d, summed over the tile's keys
    tile_mma<D, kTile, false, true>(acc, dSs, kLdP, Ks, LD);
    __syncthreads();  // the next kv tile overwrites Ks, Vs and dSs
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + ty + 8 * i;
    if (qpos >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[base + (size_t)qpos * D + tx + 16 * j] =
          from_f32<T>(round_t<T>(acc[i][j]) * c);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int BH, S;
  float qscale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t bytes = dkv_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + kTile - 1) / kTile, a.BH);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.qscale,
      a.causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t bytes = dq_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.S + kTile - 1) / kTile, a.BH);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.S, a.qscale, a.causal);
  return (int)cudaGetLastError();
}

// Dispatch one of the two launchers on dtype (0 = float32, 1 = bfloat16)
// and head dim D in {32, 64, 128}.
template <bool DKV>
int dispatch(const Args& a, int D, int dtype) {
  if (a.BH <= 0 || a.BH > 65535 || a.S <= 0) return (int)cudaErrorInvalidValue;
#define FLASH_BWD_CASE(T, DIM)                                  \
  if (D == DIM) return DKV ? launch_dkv<T, DIM>(a) : launch_dq<T, DIM>(a);
  if (dtype == 0) {
    FLASH_BWD_CASE(float, 32)
    FLASH_BWD_CASE(float, 64)
    FLASH_BWD_CASE(float, 128)
  } else if (dtype == 1) {
    FLASH_BWD_CASE(__nv_bfloat16, 32)
    FLASH_BWD_CASE(__nv_bfloat16, 64)
    FLASH_BWD_CASE(__nv_bfloat16, 128)
  }
#undef FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// B2: dk, dv from q, k, v, dO, lse, delta. Returns a cudaError_t.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int BH,
                             int S, int D, float qscale, int causal,
                             int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, dk, dv, BH, S, qscale,
         causal, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, D, dtype);
}

// B3: dq (already multiplied by round_T(qscale)). Returns a cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int BH, int S, int D,
                            float qscale, int causal, int dtype,
                            void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr, BH, S,
         qscale, causal, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, D, dtype);
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
