// Flash-attention forward (kernel B1 of the port) for Hopper, sm_90a.
//
// Replaces ray_tpu/ops/attention.py::_flash_fwd_kernel (wrapper
// _flash_forward): causal or full attention over [B*H, S, D] with a base-2
// online softmax, q pre-scaled by scale * log2(e); writes o and, when asked,
// the base-2 log-sum-exp m + log2(l) per row (l == 0 -> 1).
//
// Bound on this card: 4 * D flops per attended (query, key) pair against
// q, k, v and o moved once. GPT-2 training (B 16, H 12, S 1024, D 64,
// causal) does 25.8 GFLOP over 25 MB, about 1,000 flops a byte against
// the H100's ~295: the kernel is operations-bound, 0.026 ms at the bf16
// tensor-core peak.
//
// What held the first version back: every product was an f32 FMA on the
// CUDA cores from f32 tiles in shared memory, staged by scalar loads, with
// three barriers per kv tile (about 21 TFLOP/s).
//
// bf16 inputs (the training path) take the tensor cores (mma_common.cuh):
// one block of 4 warps owns one (b*h, 64-row q tile), each warp 16 rows
// with m, l and the output accumulator in registers and its pre-scaled Q
// fragments loaded once; K and V tiles of 64 keys arrive by 16-byte
// cp.async into a two-stage ring, the next tile in flight while this one
// is used, one barrier per tile; S = Q K^T and O += P V are
// mma.sync.m16n8k16 (bf16 in, f32 accumulation) and the softmax runs on
// the accumulator fragment, P going straight to the A operand of P V.
// The causal skip is the loop bound (tiles above the diagonal are never
// loaded), and only the diagonal tile and a ragged last tile (S not a
// multiple of 64) are masked; K/V rows past S are zero-filled. Blocks of
// the longest causal rows start first. bf16 rounding as the TPU kernel:
// q * round(scale * log2 e) rounded to bf16, s - m and exp2 rounded to
// bf16, the row sum f32 over the rounded p.
//
// f32 inputs keep the first version's CUDA-core tiles (flash_common.cuh,
// shared with flash_bwd.cu): their tensor-core form would be TF32, which
// rounds the inputs. Head dim 256 (any wider head up to 256, zero-padded
// by the wrapper) runs those tiles for bf16 inputs too, 32 rows a tile,
// with the same bf16 rounding of s - m and exp2: the tensor-core tiles
// hold a warp's output accumulator for 16 rows in registers, which at 256
// columns would not fit beside the Q fragments.
#include "flash_common.cuh"

#include <type_traits>

namespace {

using namespace flash;

template <int D>
constexpr size_t fwd_smem() {
  constexpr int BM = tile_rows<D>();
  return sizeof(float) * ((size_t)3 * BM * (D + 1) + (size_t)BM * (BM + 1));
}

// ---- f32 (and bf16 at head dim 256): the CUDA-core tiles of
// flash_common.cuh

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int S, float qscale,
                     int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 1;
  constexpr int BM = tile_rows<D>();  // query rows, and keys, per tile
  constexpr int RI = BM / 8;          // rows per thread
  constexpr int LDP = BM + 1;
  float* Qs = smem;             // [BM][LD] pre-scaled queries
  float* Ks = Qs + BM * LD;     // [BM][LD]
  float* Vs = Ks + BM * LD;     // [BM][LD]
  float* Ps = Vs + BM * LD;     // [BM][LDP] probabilities
  const int n_tiles = (S + BM - 1) / BM;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int q0 = qt * BM;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<T, D, true, BM>(Qs, q + base, q0, S, round_t<T>(qscale));
  float m[RI], l[RI], acc[RI][D / 16];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero<BM, D>(acc);

  const int kt_end = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * BM;
    load_tile<T, D, false, BM>(Ks, k + base, k0, S, 0.f);
    load_tile<T, D, false, BM>(Vs, v + base, k0, S, 0.f);
    __syncthreads();

    float s[RI][BM / 16];
    zero<BM, BM>(s);
    tile_mma<BM, BM, D, false, false>(s, Qs, LD, Ks, LD);
    const bool masked = (causal && kt == qt) || k0 + BM > S;
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 8 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) {
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
      for (int j = 0; j < BM / 16; ++j) {
        const float p = round_t<T>(exp2f(round_t<T>(s[i][j] - m_new)));
        Ps[r * LDP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = exp2f(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_mma<BM, D, BM, false, true>(acc, Ps, LDP, Vs, LD);
    __syncthreads();  // the next tile overwrites Ks, Vs and Ps
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
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

// ---- bf16: tensor cores

template <int D>
constexpr size_t mma_smem() {  // Q tile and the [2][K, V] ring, bf16
  return sizeof(uint16_t) * (size_t)5 * mma::kRows * (D + mma::kPad);
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int S, float qscale,
                         int causal) {
  constexpr int LD = D + mma::kPad;
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  constexpr int NT = D / 8;  // n-tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);  // [64][LD]
  uint16_t* ring = Qs + mma::kRows * LD;                 // [2][K, V][64][LD]
  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int q0 = qt * kTile;
  const size_t base = (size_t)blockIdx.y * S * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  // rows row0 .. row0 + 63 of a [S, D] slice, zero past S
  auto stage = [&](uint16_t* dst, const __nv_bfloat16* src, int row0) {
    mma::stage_rows<CH>(dst, LD, src, [&](int r, int c) -> const void* {
      return row0 + r < S ? src + (size_t)(row0 + r) * D + c * 8 : nullptr;
    });
  };
  auto load_kv = [&](int kt) {
    uint16_t* ks = ring + (kt & 1) * 2 * mma::kKeys * LD;
    stage(ks, k + base, kt * kTile);
    stage(ks + mma::kKeys * LD, v + base, kt * kTile);
    mma::cp_commit();
  };
  stage(Qs, q + base, q0);
  load_kv(0);  // one group with Q
  mma::cp_wait_all();
  __syncthreads();
  uint32_t qf[D / 16][4];
  mma::load_q<D>(qf, Qs + warp * 16 * LD, LD, round_t<__nv_bfloat16>(qscale));

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0, r0 + 8

  const int kt_end = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    if (kt > 0) {
      mma::cp_wait_all();
      __syncthreads();  // tile kt landed; every warp is done with kt - 1
    }
    if (kt < kt_end) load_kv(kt + 1);  // into the stage kt - 1 used
    const uint16_t* ks = ring + (kt & 1) * 2 * mma::kKeys * LD;
    const int k0 = kt * kTile;

    float s[8][4];
    mma::qk<D>(s, qf, ks, LD);
    if ((causal && kt == qt) || k0 + kTile > S) {
      // rows past S (never written) are masked like any other row, and
      // key 0 of tile 0 keeps every row's maximum finite
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + c2 + (e & 1);
          const int qpos = r0 + 8 * (e >> 1);
          if (kpos >= S || (causal && kpos > qpos)) s[j][e] = kNegInf;
        }
    }
    mma::softmax_step<true>(s, m, l, acc, 1.f);
    uint32_t pa[4][4];
    mma::pack_p<false>(pa, s, nullptr, 1.f);
    mma::pv<D, false>(acc, pa, ks + mma::kKeys * LD, LD);
  }

  mma::finish(l);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = r0 + 8 * h;
    if (qpos >= S) continue;
    const float ls = l[h] == 0.f ? 1.f : l[h];
    __nv_bfloat16* orow = o + base + (size_t)qpos * D + c2;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) = mma::pack2<false>(
          acc[n][2 * h] / ls, acc[n][2 * h + 1] / ls);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)blockIdx.y * S + qpos] = m[h] + log2f(ls);
  }
}

// ---- launches: bf16 up to head dim 128 on the tensor cores, f32 (and bf16
// at 256) on the CUDA-core tiles

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int S, float qscale, int causal, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D <= 128) {
    dim3 grid((S + kTile - 1) / kTile, BH);
    const size_t bytes = mma_smem<D>();
    cudaError_t err = allow_smem(flash_fwd_mma_kernel<D>, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_mma_kernel<D><<<grid, mma::kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, S, qscale,
        causal);
  } else {
    dim3 grid((S + tile_rows<D>() - 1) / tile_rows<D>(), BH);
    const size_t bytes = fwd_smem<D>();
    cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, bytes);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, S, qscale,
        causal);
  }
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
    case 256:
      return launch<T, 256>(q, k, v, o, lse, BH, S, qscale, causal, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D in {32, 64, 128, 256}; lse may be null
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
