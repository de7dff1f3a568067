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
// q, as on the TPU. bf16 rounding as the TPU kernels: q * round(scale *
// log2 e) rounded to bf16, s - lse and exp2 rounded to bf16, ds rounded to
// bf16 before its products, dK and dV stored once from f32 sums, dQ as
// round(round(sum) * c).
//
// Bound on this card: B2 does 4 products of 2 * D flops per visible pair,
// B3 three, against a handful of [S, D] tensors moved once: both are
// operations-bound by far (GPT-2 training, B 16, H 12, S 1024, D 64,
// causal: 0.052 and 0.039 ms at an H100 SXM's 989 TFLOP/s bf16 peak).
//
// The CUDA-core walk (kept for f32 inputs) runs every product as an f32
// FMA from f32 tiles in shared memory, staged by scalar loads, with three
// barriers per tile: about 20 TFLOP/s in bf16, 45-50x the bound, on an
// NVIDIA H100 80GB HBM3 at 700.00 W.
//
// bf16 inputs (the training path) take the tensor cores (mma_common.cuh),
// one block of 4 warps per (b*h, 64-row output tile), each warp 16 rows:
// - B3 (dQ) has the forward's shape: the warp's pre-scaled Q and its dO
//   fragments stay in registers with its rows' lse and delta; K and V
//   tiles of 64 keys stream through a two-stage cp.async ring, one barrier
//   a tile; S = Q K^T and dP = dO V^T are mma.sync.m16n8k16, p and ds are
//   computed on the accumulator fragment, and dQ += dS K takes the bf16
//   ds fragment as its A operand and the K tile as the .trans B operand
//   (as P V takes V in the forward).
// - B2 (dK, dV) computes the transposed scores, so both of its products
//   take their A operand from registers too: the warp's K and V fragments
//   are the A operands of S^T = K Q_s^T and dP^T = V dO^T; the q-side tiles
//   (pre-scaled Q, dO, and their rows' lse and delta) stream through the
//   ring; lse and delta are indexed by the fragment's column; dV += P^T dO
//   and dK += dS^T Q_s take the Q and dO tiles as .trans B operands. Each
//   thread pre-scales the 16-byte Q chunks it copied itself, after its
//   copies land and before the tile's barrier (no extra barrier).
// - At head dim 128 the K/V (B2) or Q/dO (B3) fragments would not fit
//   beside the accumulators in 255 registers, so they stay in shared
//   memory and are read per tile (qk_smem).
// The causal skip is the loop bound; only the diagonal tile and ragged
// tiles (S not a multiple of 64) are masked, where a pair is visible iff
// qpos < S, kpos < S and (full or kpos <= qpos): rows past S are
// zero-filled and their staged lse is 0, so p is zeroed explicitly. Blocks
// are ordered so that the longest (causal) walks start first on the whole
// grid: B2's first kv tiles, B3's last q tiles. Both kernels stay separate
// and deterministic (no atomics); the TPU kernel's fused mode (dQ partials
// written by B2 when there are at most 4 kv blocks) is not taken: at
// 64-row tiles S = 1024 already has 16 kv tiles, where the TPU code also
// runs two passes.
//
// f32 inputs keep the CUDA-core tiles (flash_common.cuh): their
// tensor-core form would be TF32, which rounds the inputs. Head dim 256
// (wider heads up to 256, zero-padded by the wrapper) runs those tiles for
// bf16 inputs too, 32 rows a tile (four [32][257] f32 tiles and the p and
// ds tiles fit in shared memory; 64 rows would not), with the TPU's bf16
// rounding of s - lse, exp2 and ds: at D 256 the tensor-core kernels'
// accumulators would not fit in a thread's 255 registers. Heads above 256
// run those tiles in column chunks of 256 (flash_common.cuh kWideCols):
// grid z is the chunk; per tile pair, s = Q_s K^T and dP = dO V^T stream
// over the whole head in slices of 256 columns through the four tiles
// (wide_scores), and the chunk's own columns of Q_s and dO (B2) or K (B3)
// are staged again for its products.
#include "flash_common.cuh"

#include <type_traits>

namespace {

using namespace flash;

// ---- f32 (and bf16 at head dim 256): the CUDA-core tiles of
// flash_common.cuh

// p and ds of one [BM q][BM kv] tile pair into Ps / dSs (Ps may be null),
// from its scores s and dP and the rows' lse (Ls) and delta (Ds).
template <typename T, int D>
__device__ __forceinline__ void finish_probs(
    const float (&s)[tile_rows<D>() / 8][tile_rows<D>() / 16],
    const float (&dp)[tile_rows<D>() / 8][tile_rows<D>() / 16],
    const float* Ls, const float* Ds, float* Ps, float* dSs, int q0, int k0,
    int S, int causal) {
  constexpr int BM = tile_rows<D>();
  constexpr int LDP = BM + 1;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool masked =
      (causal && q0 == k0) || q0 + BM > S || k0 + BM > S;
#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
    const int r = ty + 8 * i;
    const float lse = Ls[r], delta = Ds[r];
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) {
      const int c = tx + 16 * j;
      float p = 0.f;
      if (!masked || visible(q0 + r, k0 + c, S, causal))
        p = round_t<T>(exp2f(round_t<T>(s[i][j] - lse)));
      if (Ps != nullptr) Ps[r * LDP + c] = p;
      dSs[r * LDP + c] = round_t<T>(p * (dp[i][j] - delta) * kLn2);
    }
  }
}

// p and ds of one tile pair from the staged Qs, Ks, dOs and Vs (the whole
// head: D columns).
template <typename T, int D>
__device__ __forceinline__ void probs_and_ds(
    const float* Qs, const float* Ks, const float* dOs, const float* Vs,
    const float* Ls, const float* Ds, float* Ps, float* dSs, int q0, int k0,
    int S, int causal) {
  constexpr int LD = D + 1;
  constexpr int BM = tile_rows<D>();
  float s[BM / 8][BM / 16], dp[BM / 8][BM / 16];
  zero<BM, BM>(s);
  zero<BM, BM>(dp);
  tile_mma<BM, BM, D, false, false>(s, Qs, LD, Ks, LD);
  tile_mma<BM, BM, D, false, false>(dp, dOs, LD, Vs, LD);
  finish_probs<T, D>(s, dp, Ls, Ds, Ps, dSs, q0, k0, S, causal);
}

// p and ds of one tile pair of a head wider than D: s = Q_s K^T and
// dP = dO V^T summed over slices of D columns of the whole head (Dfull),
// each staged through Qs, Ks, dOs and Vs. Starts and ends on a barrier;
// the tiles hold the last slice afterwards.
template <typename T, int D>
__device__ __forceinline__ void wide_probs_and_ds(
    float* Qs, float* Ks, float* dOs, float* Vs, const T* q, const T* k,
    const T* v, const T* dout, const float* Ls, const float* Ds, float* Ps,
    float* dSs, int q0, int k0, int S, int Dfull, float c, int causal) {
  constexpr int LD = D + 1;
  constexpr int BM = tile_rows<D>();
  float s[BM / 8][BM / 16], dp[BM / 8][BM / 16];
  zero<BM, BM>(s);
  zero<BM, BM>(dp);
  for (int c0 = 0; c0 < Dfull; c0 += D) {
    __syncthreads();  // the tiles' last readers are done
    load_tile<T, D, true, BM>(Qs, q, q0, S, c, Dfull, c0);
    load_tile<T, D, false, BM>(Ks, k, k0, S, 0.f, Dfull, c0);
    load_tile<T, D, false, BM>(dOs, dout, q0, S, 0.f, Dfull, c0);
    load_tile<T, D, false, BM>(Vs, v, k0, S, 0.f, Dfull, c0);
    __syncthreads();
    tile_mma<BM, BM, D, false, false>(s, Qs, LD, Ks, LD);
    tile_mma<BM, BM, D, false, false>(dp, dOs, LD, Vs, LD);
  }
  finish_probs<T, D>(s, dp, Ls, Ds, Ps, dSs, q0, k0, S, causal);
  __syncthreads();
}

template <int D>
constexpr size_t dkv_smem() {
  constexpr int BM = tile_rows<D>();
  return sizeof(float) * ((size_t)4 * BM * (D + 1) +
                          (size_t)2 * BM * (BM + 1) + 2 * BM);
}

template <int D>
constexpr size_t dq_smem() {
  constexpr int BM = tile_rows<D>();
  return sizeof(float) * ((size_t)4 * BM * (D + 1) +
                          (size_t)BM * (BM + 1) + 2 * BM);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int S, int Dfull,
                         float qscale, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 1;
  constexpr int BM = tile_rows<D>();
  constexpr int LDP = BM + 1;
  float* Ks = smem;
  float* Vs = Ks + BM * LD;
  float* Qs = Vs + BM * LD;
  float* dOs = Qs + BM * LD;
  float* Ps = dOs + BM * LD;
  float* dSs = Ps + BM * LDP;
  float* Ls = dSs + BM * LDP;
  float* Ds = Ls + BM;
  const int n_tiles = (S + BM - 1) / BM;
  const int kt = blockIdx.x;  // causal: tile 0 sees the most q tiles
  const int k0 = kt * BM;
  const size_t base = (size_t)blockIdx.y * S * Dfull;
  const float* lse_b = lse + (size_t)blockIdx.y * S;
  const float* delta_b = delta + (size_t)blockIdx.y * S;
  const float c = round_t<T>(qscale);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool wide = Dfull > D;
  const int col0 = blockIdx.z * D;  // this chunk's output columns

  if (!wide) {
    load_tile<T, D, false, BM>(Ks, k + base, k0, S, 0.f);
    load_tile<T, D, false, BM>(Vs, v + base, k0, S, 0.f);
  }
  float acc_dk[BM / 8][D / 16], acc_dv[BM / 8][D / 16];
  zero<BM, D>(acc_dk);
  zero<BM, D>(acc_dv);

  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BM;
    load_rows<BM>(Ls, lse_b, q0, S);
    load_rows<BM>(Ds, delta_b, q0, S);
    if (!wide) {
      load_tile<T, D, true, BM>(Qs, q + base, q0, S, c);
      load_tile<T, D, false, BM>(dOs, dout + base, q0, S, 0.f);
      __syncthreads();
      probs_and_ds<T, D>(Qs, Ks, dOs, Vs, Ls, Ds, Ps, dSs, q0, k0, S,
                         causal);
    } else {
      wide_probs_and_ds<T, D>(Qs, Ks, dOs, Vs, q + base, k + base, v + base,
                              dout + base, Ls, Ds, Ps, dSs, q0, k0, S, Dfull,
                              c, causal);
      // this chunk's columns of Q_s and dO for the two products
      load_tile<T, D, true, BM>(Qs, q + base, q0, S, c, Dfull, col0);
      load_tile<T, D, false, BM>(dOs, dout + base, q0, S, 0.f, Dfull, col0);
    }
    __syncthreads();
    // rows kv, columns d, summed over the tile's q rows
    tile_mma<BM, D, BM, true, true>(acc_dv, Ps, LDP, dOs, LD);
    tile_mma<BM, D, BM, true, true>(acc_dk, dSs, LDP, Qs, LD);
    __syncthreads();  // the next q tile overwrites Qs, dOs, Ps and dSs
  }

#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
    const int kpos = k0 + ty + 8 * i;
    if (kpos >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= Dfull) continue;
      const size_t at = base + (size_t)kpos * Dfull + col;
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
                        int S, int Dfull, float qscale, int causal) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LD = D + 1;
  constexpr int BM = tile_rows<D>();
  constexpr int LDP = BM + 1;
  float* Qs = smem;
  float* dOs = Qs + BM * LD;
  float* Ks = dOs + BM * LD;
  float* Vs = Ks + BM * LD;
  float* dSs = Vs + BM * LD;
  float* Ls = dSs + BM * LDP;
  float* Ds = Ls + BM;
  const int n_tiles = (S + BM - 1) / BM;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qt * BM;
  const size_t base = (size_t)blockIdx.y * S * Dfull;
  const float c = round_t<T>(qscale);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool wide = Dfull > D;
  const int col0 = blockIdx.z * D;  // this chunk's output columns

  if (!wide) {
    load_tile<T, D, true, BM>(Qs, q + base, q0, S, c);
    load_tile<T, D, false, BM>(dOs, dout + base, q0, S, 0.f);
  }
  load_rows<BM>(Ls, lse + (size_t)blockIdx.y * S, q0, S);
  load_rows<BM>(Ds, delta + (size_t)blockIdx.y * S, q0, S);
  float acc[BM / 8][D / 16];
  zero<BM, D>(acc);

  const int kt_end = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    const int k0 = kt * BM;
    if (!wide) {
      load_tile<T, D, false, BM>(Ks, k + base, k0, S, 0.f);
      load_tile<T, D, false, BM>(Vs, v + base, k0, S, 0.f);
      __syncthreads();
      probs_and_ds<T, D>(Qs, Ks, dOs, Vs, Ls, Ds, nullptr, dSs, q0, k0, S,
                         causal);
    } else {
      wide_probs_and_ds<T, D>(Qs, Ks, dOs, Vs, q + base, k + base, v + base,
                              dout + base, Ls, Ds, nullptr, dSs, q0, k0, S,
                              Dfull, c, causal);
      // this chunk's columns of K for dS K
      load_tile<T, D, false, BM>(Ks, k + base, k0, S, 0.f, Dfull, col0);
    }
    __syncthreads();
    // rows q, columns d, summed over the tile's keys
    tile_mma<BM, D, BM, false, true>(acc, dSs, LDP, Ks, LD);
    __syncthreads();  // the next kv tile overwrites Ks, Vs and dSs
  }

#pragma unroll
  for (int i = 0; i < BM / 8; ++i) {
    const int qpos = q0 + ty + 8 * i;
    if (qpos >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < Dfull)
        dq[base + (size_t)qpos * Dfull + col] =
            from_f32<T>(round_t<T>(acc[i][j]) * c);
    }
  }
}

// ---- bf16: tensor cores

// K and V (B2) or Q and dO (B3) fragments held in registers for the whole
// walk, or read from shared memory per tile at head dim 128
template <int D>
constexpr bool kRegA = D <= 64;

// S (or S^T) of the warp's 16 rows against a 64-row bf16 tile: A from the
// register fragments af or, at wide heads, from the shared tile as
template <int D>
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const uint32_t (&af)[D / 16][4],
                                       const uint16_t* as,
                                       const uint16_t* bs) {
  constexpr int LD = D + mma::kPad;
  if constexpr (kRegA<D>)
    mma::qk<D>(s, af, bs, LD);
  else
    mma::qk_smem<D>(s, as, LD, bs, LD);
}

template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&af)[D / 16][4],
                                           const uint16_t* as) {
  if constexpr (kRegA<D>) mma::load_q<D>(af, as, D + mma::kPad, 1.f);
}

// two resident bf16 tiles, a two-stage ring of two more, and (B2) the
// ring's [lse, delta] rows
template <int D>
constexpr size_t mma_smem(bool dkv) {
  return sizeof(uint16_t) * (size_t)6 * mma::kRows * (D + mma::kPad) +
         (dkv ? sizeof(float) * 4 * kTile : 0);
}

// rows row0 .. row0 + 63 of a [S, D] bf16 slice into a [64][D + 8] tile,
// zero past S (the commit is the caller's)
template <int D>
__device__ __forceinline__ void stage(uint16_t* dst,
                                      const __nv_bfloat16* src, int row0,
                                      int S) {
  mma::stage_rows<D / 8>(dst, D + mma::kPad, src,
                         [&](int r, int c) -> const void* {
                           return row0 + r < S
                                      ? src + (size_t)(row0 + r) * D + c * 8
                                      : nullptr;
                         });
}

// Store the warp's rows r0, r0 + 8 (those below S) of an f32 accumulator
// fragment as bf16, each value times c and rounded first when RESCALE.
template <int D, bool RESCALE>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[D / 8][4],
                                           int r0, int S, float c) {
  const int c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= S) continue;
    __nv_bfloat16* out = dst + (size_t)row * D + c2;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      float x = acc[n][2 * h], y = acc[n][2 * h + 1];
      if (RESCALE) {
        x = mma::round_bf16(x) * c;
        y = mma::round_bf16(y) * c;
      }
      *reinterpret_cast<uint32_t*>(out + 8 * n) = mma::pack2<false>(x, y);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
    flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv, int S,
                             float qscale, int causal) {
  constexpr int LD = D + mma::kPad;
  constexpr int TILE = mma::kRows * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem_raw);  // [64][LD]
  uint16_t* Vs = Ks + TILE;                              // [64][LD]
  uint16_t* ring = Vs + TILE;           // [2][Q_s, dO][64][LD]
  float* rows = reinterpret_cast<float*>(ring + 4 * TILE);  // [2][lse, delta][64]
  const int n_tiles = (S + kTile - 1) / kTile;
  const int kt = blockIdx.y;  // causal: tile 0 sees the most q tiles
  const int k0 = kt * kTile;
  const size_t base = (size_t)blockIdx.x * S * D;
  const float* lse_b = lse + (size_t)blockIdx.x * S;
  const float* delta_b = delta + (size_t)blockIdx.x * S;
  const float c = mma::round_bf16(qscale);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  // q tile qt into stage qt & 1: Q (scaled later), dO, and the rows'
  // lse (threads 0..63) and delta (64..127), zero past S
  auto load_q_tile = [&](int qt) {
    uint16_t* qs = ring + (qt & 1) * 2 * TILE;
    stage<D>(qs, q + base, qt * kTile, S);
    stage<D>(qs + TILE, dout + base, qt * kTile, S);
    const int row = qt * kTile + (threadIdx.x & (kTile - 1));
    const float* src = threadIdx.x < kTile ? lse_b : delta_b;
    mma::cp_async4(rows + (qt & 1) * 2 * kTile + threadIdx.x,
                   row < S ? src + row : src, row < S);
    mma::cp_commit();
  };
  const int qt0 = causal ? kt : 0;
  stage<D>(Ks, k + base, k0, S);
  stage<D>(Vs, v + base, k0, S);
  load_q_tile(qt0);  // one group with K and V
  mma::cp_wait_all();
  mma::scale_rows<D / 8>(ring + (qt0 & 1) * 2 * TILE, LD, c);
  __syncthreads();
  const uint16_t* kw = Ks + warp * 16 * LD;  // the warp's 16 kv rows
  const uint16_t* vw = Vs + warp * 16 * LD;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_frags<D>(kf, kw);
  load_frags<D>(vf, vw);

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;
  const int r0 = k0 + warp * 16 + g;  // this thread's kv rows r0, r0 + 8

  for (int qt = qt0; qt < n_tiles; ++qt) {
    uint16_t* qs = ring + (qt & 1) * 2 * TILE;
    if (qt > qt0) {
      mma::cp_wait_all();
      mma::scale_rows<D / 8>(qs, LD, c);
      __syncthreads();  // tile qt landed; every warp is done with qt - 1
    }
    if (qt + 1 < n_tiles) load_q_tile(qt + 1);  // into the stage qt - 1 used
    const uint16_t* dos = qs + TILE;
    const float* ls = rows + (qt & 1) * 2 * kTile;  // lse, then delta
    const int q0 = qt * kTile;
    const bool masked =
        (causal && qt == kt) || q0 + kTile > S || k0 + kTile > S;

    // S^T: rows kv (r0, r0 + 8), columns q 8j + c2 + {0,1}
    float s[8][4];
    scores<D>(s, kf, kw, qs);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * j + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = mma::round_bf16(
            exp2f(mma::round_bf16(s[j][e] - ((e & 1) ? l.y : l.x))));
        if (masked && !visible(q0 + 8 * j + c2 + (e & 1), r0 + 8 * (e >> 1),
                               S, causal))
          p = 0.f;
        s[j][e] = p;
      }
    }
    uint32_t pa[4][4];
    mma::pack_p<false>(pa, s, nullptr, 1.f);
    mma::pv<D, false>(acc_dv, pa, dos, LD);  // dV += P^T dO

    float dp[8][4];  // dP^T, then dS^T
    scores<D>(dp, vf, vw, dos);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dl =
          *reinterpret_cast<const float2*>(ls + kTile + 8 * j + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = mma::round_bf16(mma::unpack_p(pa, j, e) *
                                   (dp[j][e] - ((e & 1) ? dl.y : dl.x)) *
                                   kLn2);
    }
    mma::pack_p<false>(pa, dp, nullptr, 1.f);
    mma::pv<D, false>(acc_dk, pa, qs, LD);  // dK += dS^T Q_s
  }

  store_rows<D, false>(dk + base, acc_dk, r0, S, 1.f);
  store_rows<D, false>(dv + base, acc_dv, r0, S, 1.f);
}

template <int D>
__global__ void __launch_bounds__(mma::kThreads)
    flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int S,
                            float qscale, int causal) {
  constexpr int LD = D + mma::kPad;
  constexpr int TILE = mma::kRows * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);  // [64][LD] Q_s
  uint16_t* dOs = Qs + TILE;                             // [64][LD]
  uint16_t* ring = dOs + TILE;                           // [2][K, V][64][LD]
  const int n_tiles = (S + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * kTile;
  const size_t base = (size_t)blockIdx.x * S * D;
  const float c = mma::round_bf16(qscale);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);

  auto load_kv = [&](int kt) {
    uint16_t* ks = ring + (kt & 1) * 2 * TILE;
    stage<D>(ks, k + base, kt * kTile, S);
    stage<D>(ks + TILE, v + base, kt * kTile, S);
    mma::cp_commit();
  };
  stage<D>(Qs, q + base, q0, S);
  stage<D>(dOs, dout + base, q0, S);
  load_kv(0);  // one group with Q and dO
  mma::cp_wait_all();
  mma::scale_rows<D / 8>(Qs, LD, c);
  __syncthreads();
  const uint16_t* qw = Qs + warp * 16 * LD;  // the warp's 16 q rows
  const uint16_t* ow = dOs + warp * 16 * LD;
  uint32_t qf[D / 16][4], of[D / 16][4];
  load_frags<D>(qf, qw);
  load_frags<D>(of, ow);

  const int r0 = q0 + warp * 16 + g;  // this thread's rows r0, r0 + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = (size_t)blockIdx.x * S + r0 + 8 * h;
    lse_r[h] = r0 + 8 * h < S ? lse[at] : 0.f;
    delta_r[h] = r0 + 8 * h < S ? delta[at] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int kt_end = causal ? qt : n_tiles - 1;
  for (int kt = 0; kt <= kt_end; ++kt) {
    if (kt > 0) {
      mma::cp_wait_all();
      __syncthreads();  // tile kt landed; every warp is done with kt - 1
    }
    if (kt < kt_end) load_kv(kt + 1);  // into the stage kt - 1 used
    const uint16_t* ks = ring + (kt & 1) * 2 * TILE;
    const int k0 = kt * kTile;
    const bool masked =
        (causal && kt == qt) || q0 + kTile > S || k0 + kTile > S;

    float s[8][4], dp[8][4];  // s becomes p, then ds
    scores<D>(s, qf, qw, ks);
    scores<D>(dp, of, ow, ks + TILE);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = mma::round_bf16(exp2f(mma::round_bf16(s[j][e] - lse_r[h])));
        if (masked && !visible(r0 + 8 * h, k0 + 8 * j + c2 + (e & 1), S,
                               causal))
          p = 0.f;
        s[j][e] = mma::round_bf16(p * (dp[j][e] - delta_r[h]) * kLn2);
      }
    uint32_t pa[4][4];
    mma::pack_p<false>(pa, s, nullptr, 1.f);
    mma::pv<D, false>(acc, pa, ks, LD);  // dQ += dS K
  }

  store_rows<D, true>(dq + base, acc, r0, S, c);
}

// ---- launches: bf16 on the tensor cores, f32 on the CUDA-core tiles

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int BH, S;
  int Dfull;  // the head dim (above 256: column chunks of kWideCols)
  float qscale;
  int causal;
  cudaStream_t stream;
};

// bf16 up to head dim 128 takes the tensor cores
template <typename T, int D>
constexpr bool kOnMma = std::is_same_v<T, __nv_bfloat16> && D <= 128;

template <bool DKV, typename T, int D>
auto kernel_of() {
  if constexpr (kOnMma<T, D>) {
    if constexpr (DKV)
      return &flash_bwd_dkv_mma_kernel<D>;
    else
      return &flash_bwd_dq_mma_kernel<D>;
  } else if constexpr (DKV) {
    return &flash_bwd_dkv_kernel<T, D>;
  } else {
    return &flash_bwd_dq_kernel<T, D>;
  }
}

template <bool DKV, typename T, int D>
int launch(const Args& a) {
  constexpr bool kMma = kOnMma<T, D>;
  const auto kernel = kernel_of<DKV, T, D>();
  const size_t bytes =
      kMma ? mma_smem<D>(DKV) : (DKV ? dkv_smem<D>() : dq_smem<D>());
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  constexpr int rows = kMma ? kTile : tile_rows<D>();
  const int n_tiles = (a.S + rows - 1) / rows;
  // tensor-core grid: tile order on y, so the longest walks of every
  // (b, h) start first; CUDA-core grid: column chunks on z
  const dim3 grid = kMma ? dim3(a.BH, n_tiles)
                         : dim3(n_tiles, a.BH, (a.Dfull + D - 1) / D);
  const T* in[4] = {static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                    static_cast<const T*>(a.v), static_cast<const T*>(a.dout)};
  if constexpr (kMma && DKV)
    kernel<<<grid, kThreads, bytes, a.stream>>>(
        in[0], in[1], in[2], in[3], a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.S, a.qscale, a.causal);
  else if constexpr (kMma)
    kernel<<<grid, kThreads, bytes, a.stream>>>(
        in[0], in[1], in[2], in[3], a.lse, a.delta, static_cast<T*>(a.dq),
        a.S, a.qscale, a.causal);
  else if constexpr (DKV)
    kernel<<<grid, kThreads, bytes, a.stream>>>(
        in[0], in[1], in[2], in[3], a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.S, a.Dfull, a.qscale, a.causal);
  else
    kernel<<<grid, kThreads, bytes, a.stream>>>(
        in[0], in[1], in[2], in[3], a.lse, a.delta, static_cast<T*>(a.dq),
        a.S, a.Dfull, a.qscale, a.causal);
  return (int)cudaGetLastError();
}

template <typename T_, int D_>
struct Inst {
  using T = T_;
  static constexpr int D = D_;
};

// fn(Inst<T, D>{}) for dtype (0 = float32, 1 = bfloat16) and head dim D
// in {32, 64, 128, 256}, or any D above 256 as Inst<T, kWideCols> (its
// column chunks); any other pair is cudaErrorInvalidValue.
template <typename Fn>
int dispatch(int D, int dtype, Fn fn) {
  if (D > kWideCols) {
    if ((D + kWideCols - 1) / kWideCols > 65535)
      return (int)cudaErrorInvalidValue;
    D = kWideCols;
  }
#define FLASH_BWD_CASE(T, DIM) \
  if (D == DIM) return fn(Inst<T, DIM>{});
  if (dtype == 0) {
    FLASH_BWD_CASE(float, 32)
    FLASH_BWD_CASE(float, 64)
    FLASH_BWD_CASE(float, 128)
    FLASH_BWD_CASE(float, 256)
  } else if (dtype == 1) {
    FLASH_BWD_CASE(__nv_bfloat16, 32)
    FLASH_BWD_CASE(__nv_bfloat16, 64)
    FLASH_BWD_CASE(__nv_bfloat16, 128)
    FLASH_BWD_CASE(__nv_bfloat16, 256)
  }
#undef FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

template <bool DKV>
int run(const Args& a, int D, int dtype) {
  // a.Dfull is D: dispatch maps heads above 256 to the chunked tiles
  if (a.BH <= 0 || a.BH > 65535 || a.S <= 0) return (int)cudaErrorInvalidValue;
  return dispatch(D, dtype, [&](auto inst) {
    using I = decltype(inst);
    return launch<DKV, typename I::T, I::D>(a);
  });
}

}  // namespace

// B2: dk, dv from q, k, v, dO, lse, delta. Returns a cudaError_t.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int BH,
                             int S, int D, float qscale, int causal,
                             int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), nullptr, dk, dv, BH, S, D,
         qscale, causal, static_cast<cudaStream_t>(stream)};
  return run<true>(a, D, dtype);
}

// B3: dq (already multiplied by round_T(qscale)). Returns a cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int BH, int S, int D,
                            float qscale, int causal, int dtype,
                            void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr, nullptr, BH, S, D,
         qscale, causal, static_cast<cudaStream_t>(stream)};
  return run<false>(a, D, dtype);
}

// Registers (out[0]) and local memory bytes, spills included (out[1]), per
// thread of B2's (dkv != 0) or B3's instantiation for dtype and D; launches
// nothing. Returns a cudaError_t.
extern "C" int flash_bwd_attributes(int dkv, int D, int dtype, int* out) {
  return dispatch(D, dtype, [&](auto inst) {
    using I = decltype(inst);
    cudaFuncAttributes fa;
    const cudaError_t err =
        dkv ? cudaFuncGetAttributes(&fa, kernel_of<true, typename I::T, I::D>())
            : cudaFuncGetAttributes(&fa,
                                    kernel_of<false, typename I::T, I::D>());
    if (err == cudaSuccess) {
      out[0] = fa.numRegs;
      out[1] = (int)fa.localSizeBytes;
    }
    return (int)err;
  });
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
