// Paged prefill attention (kernel B5 of the port) for Hopper, sm_90a.
//
// Replaces ray_tpu/ops/paged_attention.py::_paged_prefill_kernel (wrapper
// paged_prefill_attention_pallas): a chunk of queries at their TRUE
// positions attends the sequence's paged context (earlier chunks plus the
// causal part of its own, already written to the pool), per-row mask
// t <= pos_row, optional sliding window t > pos_row - W, GQA rows laid out
// (query, group) s-major so one tile shares one kv head.
//
// Bound on this card: 4 * hd flops per attended (query head, token) pair
// against q, out and the K/V context read once per sequence and head. A
// fresh bf16 chunk of S queries does about S / 4 flops per byte (128 at
// S = 512, under the H100's ~295), so it is bytes-bound: 0.0038 ms for
// the serving shapes' fresh case, 0.0046 ms ragged.
//
// What held the first version back: every product was an f32 FMA on the
// CUDA cores from shared memory, 32 rows x one 16-token pool block per
// step, four barriers a step, q and the accumulator in shared memory as
// f32 (about 2.9 TFLOP/s).
//
// bf16 q (the serving path) takes the tensor cores (mma_common.cuh): one
// block of 4 warps per (64-row tile, kv head, sequence), each warp 16
// (query, group) rows with m, l and the output accumulator in registers
// and its pre-scaled Q fragments loaded once. A kv tile is 64 tokens
// gathered through the block table, token by token, so every block size
// works (the engine's 16: four table entries a tile); tiles arrive by
// 16-byte cp.async into a two-stage ring, the next in flight while this
// one is used. The block reads its rows' true positions and reduces them
// in-kernel to the frontier qmax and floor qmin, which replace the TPU
// kernel's scalar prefetch: kv tiles run from the window floor's tile (0
// without a window) to qmax's, tokens outside [floor, qmax] are
// zero-filled instead of read, a warp skips a tile none of its rows can
// see, and only tiles that straddle a row's position, the window edge or
// the table's end are masked. Rows past the chunk (tile padding) carry
// position 0 and are never written, as the TPU wrapper's padded rows are
// sliced off. Head dims up to 128 pad to the next of 32, 64, 128 with
// zero-filled columns.
//
// Quantized pools (the TPU kernel's `quantized=True` branch) with a bf16
// q: int8 and fp8-e4m3 codes are exact in bf16 and in fp16, so the
// products run on codes and the per-(slot, head) f32 scales act outside
// the tensor cores. The 1-byte tiles and their scales ride the same ring;
// after they land, the block widens the codes once into 16-bit tiles (K
// bf16, V fp16: one more barrier a tile). s[r, t] = kscale[t] * (q_r .
// kcode_t), the scale applied to the f32 score column after the product;
// the softmax is f32 (the TPU branch widens q to f32, so its bf16 exp2
// rule does not fire); P V folds vscale[t] into P's column, A =
// fp16(p * vscale[t] / vref), with vref the largest V scale the warp has
// seen (the accumulator is kept in units of vref and rescaled when it
// grows), so A stays in [0, 1] whatever the scales' magnitude. Against
// the f32 dequantize-then-multiply order that costs fp16's 2^-11 relative
// rounding of each p * vscale, under the bf16 tolerance.
//
// f32 q keeps the first version's CUDA-core walk (paged_common.cuh); the
// f32 attention it computes has no tensor-core form short of TF32, which
// would round the inputs. A bf16 q with a head wider than 128 (up to 256)
// takes the same walk instantiated for bf16, with the TPU's bf16 rounding
// of s - m and exp2 (f32 softmax under a quantized pool): the tensor-core
// tiles keep a row's whole head in registers, which 256 columns of
// accumulator and Q fragments would overflow.
#include "mma_common.cuh"
#include "paged_common.cuh"

namespace {

// ---- f32 q, and bf16 q with hd > 128: the CUDA-core walk of
// paged_common.cuh

constexpr int kRows = 32;

// Q: q and output type; KV: pool storage type (Q, or int8 / fp8 quantized)
template <typename Q, typename KV>
__global__ void __launch_bounds__(paged::kThreads)
    paged_prefill_kernel(const Q* __restrict__ q, const KV* __restrict__ kpool,
                         const KV* __restrict__ vpool,
                         const float* __restrict__ kscale,
                         const float* __restrict__ vscale,
                         const int* __restrict__ tables,
                         const int* __restrict__ positions,
                         Q* __restrict__ out, int S, int Hq, int Hkv, int hd,
                         int bs, int NB, float qscale, int window) {
  // softmax rounding: q's type, f32 under a quantized pool
  using P = std::conditional_t<paged::kQuantized<KV>, float, Q>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  paged::Tile<KV> t = paged::Tile<KV>::carve(smem, kRows, hd, bs);
  const float c = paged::round_t<Q>(qscale);
  // tile row r is (query, group) row rho = j * kRows + r: query rho / G,
  // query head kvh * G + rho % G
  for (int e = threadIdx.x; e < kRows * hd; e += paged::kThreads) {
    const int r = e / hd, d = e % hd;
    const int rho = j * kRows + r, s = rho / G, g = rho % G;
    float x = 0.f;
    if (s < S)
      x = paged::to_f32(q[(((size_t)b * S + s) * Hq + (size_t)kvh * G + g) *
                            hd + d]);
    t.q[e] = paged::round_t<Q>(x * c);
  }
  for (int r = threadIdx.x; r < kRows; r += paged::kThreads) {
    const int rho = j * kRows + r, s = rho / G, g = rho % G;
    const bool valid = s < S;
    t.pos[r] = valid ? positions[(size_t)b * S + s] : 0;
    t.orow[r] = valid ? (((long long)b * S + s) * Hq + (long long)kvh * G + g) *
                            hd
                      : -1;
  }
  __syncthreads();
  int qmax = t.pos[0], qmin = t.pos[0];
  for (int r = 1; r < kRows; ++r) {
    qmax = max(qmax, t.pos[r]);
    qmin = min(qmin, t.pos[r]);
  }
  const int i_hi = min(qmax / bs, NB - 1);
  int i_lo = 0;
  if (window > 0 && qmin - window + 1 > 0) i_lo = (qmin - window + 1) / bs;
  paged::attend_tile<KV, P, Q>(kpool, vpool, kscale, vscale,
                               tables + (size_t)b * NB, i_lo, i_hi, kRows, hd,
                               bs, Hkv, kvh, window, t, out);
}

// Q: q's type (float, or __nv_bfloat16 for heads wider than 128)
template <typename Q, typename KV>
int launch_walk(const void* q, const void* k, const void* v, const float* ks,
                const float* vs, const int* tables, const int* positions,
                void* out, int B, int S, int Hq, int Hkv, int hd, int bs,
                int NB, float qscale, int window, cudaStream_t stream) {
  const size_t bytes = paged::smem_bytes(kRows, hd, bs, sizeof(KV));
  cudaError_t err = mma::allow_smem(paged_prefill_kernel<Q, KV>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = S * (Hq / Hkv);
  dim3 grid((rows + kRows - 1) / kRows, Hkv, B);
  paged_prefill_kernel<Q, KV><<<grid, paged::kThreads, bytes, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, tables, positions,
      static_cast<Q*>(out), S, Hq, Hkv, hd, bs, NB, qscale, window);
  return (int)cudaGetLastError();
}

// ---- bf16 q: tensor cores

// Shared memory of the tensor-core kernel, in bytes, in this order: the Q
// tile [64][LD] bf16; the ring [2 stages][K, V][64 tokens][row] (16-bit
// rows of LD elements, or 1-byte rows of LDB bytes for a quantized pool);
// quantized only, the widened tiles [K bf16, V fp16][64][LD] and the scale
// ring [2][K, V][64] f32; the rows' positions [64] int.
template <int HD, typename KV>
struct Smem {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int LD = HD + mma::kPad;  // 16-bit elements a row
  static constexpr int LDB = HD + 16;        // bytes a 1-byte row
  static constexpr size_t q = 2 * mma::kRows * LD;
  static constexpr size_t ring =
      kQuant ? 4 * mma::kKeys * LDB : 4 * mma::kKeys * LD * 2;
  static constexpr size_t wide = kQuant ? 2 * mma::kKeys * LD * 2 : 0;
  static constexpr size_t scales = kQuant ? 4 * mma::kKeys * 4 : 0;
  static constexpr size_t pos = q + ring + wide + scales;
  static constexpr size_t bytes = pos + mma::kRows * 4;
};

__device__ __forceinline__ float code_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float code_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// 16 one-byte codes -> 16 values of 16 bits (fp16 if F16, else bf16),
// exact either way
template <typename KV, bool F16>
__device__ __forceinline__ void widen16(const unsigned char* src,
                                        uint16_t* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const KV* x = reinterpret_cast<const KV*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = mma::pack2<F16>(code_f32(x[2 * i]), code_f32(x[2 * i + 1]));
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// KV: the pool's type, __nv_bfloat16 or a quantized int8_t / __nv_fp8_e4m3
template <int HD, typename KV>
__global__ void __launch_bounds__(mma::kThreads)
    paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                             const KV* __restrict__ kpool,
                             const KV* __restrict__ vpool,
                             const float* __restrict__ kscale,
                             const float* __restrict__ vscale,
                             const int* __restrict__ tables,
                             const int* __restrict__ positions,
                             __nv_bfloat16* __restrict__ out, int S, int Hq,
                             int Hkv, int hd, int bs, int NB, float qscale,
                             int window) {
  using L = Smem<HD, KV>;
  constexpr bool quant = L::kQuant;
  constexpr int LD = L::LD;
  // the ring's rows: 16-bit elements, or bytes for a quantized pool
  using R = std::conditional_t<quant, unsigned char, uint16_t>;
  constexpr int LDR = quant ? L::LDB : LD;
  constexpr int CH = HD * (int)sizeof(KV) / 16;  // 16-byte chunks a row
  constexpr int EPC = 16 / (int)sizeof(KV);      // elements a chunk
  constexpr int NT = HD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  R* ring = reinterpret_cast<R*>(smem + L::q);
  uint16_t* wide = reinterpret_cast<uint16_t*>(smem + L::q + L::ring);
  float* sring = reinterpret_cast<float*>(smem + L::q + L::ring + L::wide);
  int* pos = reinterpret_cast<int*>(smem + L::pos);

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  // tile row r is (query, group) row rho0 + r: query rho / G, query head
  // kvh * G + rho % G; the tiles of the latest rows start first
  const int rho0 = (gridDim.x - 1 - blockIdx.x) * mma::kRows;

  mma::stage_rows<HD / 8>(Qs, LD, q, [&](int r, int c) -> const void* {
    const int rho = rho0 + r, s = rho / G;
    if (s >= S || c * 8 >= hd) return nullptr;
    return q + (((size_t)b * S + s) * Hq + (size_t)kvh * G + rho % G) * hd +
           c * 8;
  });
  mma::cp_commit();
  if (threadIdx.x < mma::kRows) {
    const int s = (rho0 + threadIdx.x) / G;
    pos[threadIdx.x] = s < S ? positions[(size_t)b * S + s] : 0;
  }
  __syncthreads();
  // the frontier and window floor of the tile, and of this warp's rows
  const int qmax =
      __reduce_max_sync(0xffffffffu, max(pos[lane], pos[lane + 32]));
  const int qmin =
      __reduce_min_sync(0xffffffffu, min(pos[lane], pos[lane + 32]));
  const int pr[2] = {pos[warp * 16 + g], pos[warp * 16 + g + 8]};
  const int wmax = __reduce_max_sync(0xffffffffu, max(pr[0], pr[1]));
  const int wmin = __reduce_min_sync(0xffffffffu, min(pr[0], pr[1]));
  const int ctx = NB * bs;  // tokens the table covers
  const int t_hi = min(qmax, ctx - 1);
  const int t_lo = window > 0 ? max(0, qmin - window + 1) : 0;
  const int* table = tables + (size_t)b * NB;

  // tokens it * 64 .. + 63 into ring stage st; tokens no row of the tile
  // can see are zero-filled, not read
  auto load = [&](int st, int it) {
    R* kd = ring + st * 2 * mma::kKeys * LDR;
    R* vd = kd + mma::kKeys * LDR;
    const int c = threadIdx.x % CH;
    for (int r = threadIdx.x / CH; r < mma::kKeys; r += mma::kThreads / CH) {
      const int t = it * mma::kKeys + r;
      const bool ok = t >= t_lo && t <= t_hi && c * EPC < hd;
      size_t off = 0;
      if (ok)
        off = (((size_t)table[t / bs] * bs + t % bs) * Hkv + kvh) * hd +
              c * EPC;
      mma::cp_async16(kd + r * LDR + c * 16 / (int)sizeof(R), kpool + off,
                      ok);
      mma::cp_async16(vd + r * LDR + c * 16 / (int)sizeof(R), vpool + off,
                      ok);
    }
    if constexpr (quant) {
      if (threadIdx.x < mma::kKeys) {
        const int t = it * mma::kKeys + threadIdx.x;
        const bool ok = t >= t_lo && t <= t_hi;
        size_t off = 0;
        if (ok) off = ((size_t)table[t / bs] * bs + t % bs) * Hkv + kvh;
        float* ss = sring + st * 2 * mma::kKeys;
        mma::cp_async4(ss + threadIdx.x, kscale + off, ok);
        mma::cp_async4(ss + mma::kKeys + threadIdx.x, vscale + off, ok);
      }
    }
    mma::cp_commit();
  };

  const int it_lo = t_lo / mma::kKeys, it_hi = t_hi / mma::kKeys;
  if (it_lo <= it_hi) load(0, it_lo);
  mma::cp_wait_all();
  __syncthreads();
  uint32_t qf[HD / 16][4];
  mma::load_q<HD>(qf, Qs + warp * 16 * LD, LD, mma::round_bf16(qscale));

  float m[2] = {mma::kNegInf, mma::kNegInf}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float vref = 0.f;  // quantized: the accumulator's unit

  for (int it = it_lo; it <= it_hi; ++it) {
    const int st = (it - it_lo) & 1;
    if (it > it_lo) {
      mma::cp_wait_all();
      __syncthreads();  // tile it landed; every warp is done with it - 1
    }
    if (it < it_hi) load(st ^ 1, it + 1);  // into the stage it - 1 used
    const uint16_t* ks;
    const uint16_t* vs;
    const float* kss = nullptr;  // quantized: this tile's scales
    const float* vss = nullptr;
    if constexpr (quant) {
      const R* kb = ring + st * 2 * mma::kKeys * LDR;
      const R* vb = kb + mma::kKeys * LDR;
      constexpr int CW = HD / 16;
      for (int x = threadIdx.x; x < mma::kKeys * CW; x += mma::kThreads) {
        const int r = x / CW, c = x % CW;
        widen16<KV, false>(kb + r * LDR + c * 16, wide + r * LD + c * 16);
        widen16<KV, true>(vb + r * LDR + c * 16,
                          wide + (mma::kKeys + r) * LD + c * 16);
      }
      __syncthreads();  // the widened tiles are whole
      ks = wide;
      vs = wide + mma::kKeys * LD;
      kss = sring + st * 2 * mma::kKeys;
      vss = kss + mma::kKeys;
    } else {
      ks = ring + st * 2 * mma::kKeys * LD;
      vs = ks + mma::kKeys * LD;
    }
    const int t0 = it * mma::kKeys;
    // no key of this tile is visible to any of the warp's rows
    if (t0 > wmax || (window > 0 && t0 + mma::kKeys - 1 <= wmin - window))
      continue;

    float s[8][4];
    mma::qk<HD>(s, qf, ks, LD);
    if constexpr (quant) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(kss + 8 * j + c2);
        s[j][0] *= w.x;
        s[j][1] *= w.y;
        s[j][2] *= w.x;
        s[j][3] *= w.y;
      }
    }
    if (t0 + mma::kKeys - 1 > wmin || t0 + mma::kKeys > ctx ||
        (window > 0 && t0 <= wmax - window)) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + 8 * j + c2 + (e & 1);
          const int p = pr[e >> 1];
          if (t > p || t >= ctx || (window > 0 && t <= p - window))
            s[j][e] = mma::kNegInf;
        }
    }
    float acc_factor = 1.f, inv = 1.f;
    if constexpr (quant) {
      const float vm = fmaxf(vss[lane], vss[lane + 32]);
      float vnew = fmaxf(vref, vm);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        vnew = fmaxf(vnew, __shfl_xor_sync(0xffffffffu, vnew, o));
      vnew = fmaxf(vnew, 1e-30f);  // an all-zero tile divides nothing
      acc_factor = vref / vnew;
      inv = 1.f / vnew;
      vref = vnew;
    }
    mma::softmax_step<!quant>(s, m, l, acc, acc_factor);
    uint32_t pa[4][4];
    mma::pack_p<quant>(pa, s, vss, inv);
    mma::pv<HD, quant>(acc, pa, vs, LD);
  }

  mma::finish(l);
  const float unit = quant ? vref : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = rho0 + warp * 16 + g + 8 * h, s = rho / G;
    if (s >= S) continue;
    const float ls = l[h] == 0.f ? 1.f : l[h];
    __nv_bfloat16* orow =
        out + (((size_t)b * S + s) * Hq + (size_t)kvh * G + rho % G) * hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + c2;
      if (col < hd)
        *reinterpret_cast<uint32_t*>(orow + col) = mma::pack2<false>(
            acc[n][2 * h] * unit / ls, acc[n][2 * h + 1] * unit / ls);
    }
  }
}

template <int HD, typename KV>
int launch_mma(const void* q, const void* k, const void* v, const float* ks,
               const float* vs, const int* tables, const int* positions,
               void* out, int B, int S, int Hq, int Hkv, int hd, int bs,
               int NB, float qscale, int window, cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD, KV>::bytes;
  cudaError_t err =
      mma::allow_smem(paged_prefill_mma_kernel<HD, KV>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = S * (Hq / Hkv);
  dim3 grid((rows + mma::kRows - 1) / mma::kRows, Hkv, B);
  paged_prefill_mma_kernel<HD, KV><<<grid, mma::kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, tables, positions,
      static_cast<__nv_bfloat16*>(out), S, Hq, Hkv, hd, bs, NB, qscale,
      window);
  return (int)cudaGetLastError();
}

// head dims up to 128 pad to the next instantiated tile width; wider
// heads take the CUDA-core walk
template <typename KV>
int launch_bf16(const void* q, const void* k, const void* v, const float* ks,
                const float* vs, const int* tables, const int* positions,
                void* out, int B, int S, int Hq, int Hkv, int hd, int bs,
                int NB, float qscale, int window, cudaStream_t s) {
  if (hd <= 32)
    return launch_mma<32, KV>(q, k, v, ks, vs, tables, positions, out, B, S,
                              Hq, Hkv, hd, bs, NB, qscale, window, s);
  if (hd <= 64)
    return launch_mma<64, KV>(q, k, v, ks, vs, tables, positions, out, B, S,
                              Hq, Hkv, hd, bs, NB, qscale, window, s);
  if (hd <= 128)
    return launch_mma<128, KV>(q, k, v, ks, vs, tables, positions, out, B,
                               S, Hq, Hkv, hd, bs, NB, qscale, window, s);
  return launch_walk<__nv_bfloat16, KV>(q, k, v, ks, vs, tables, positions,
                                        out, B, S, Hq, Hkv, hd, bs, NB,
                                        qscale, window, s);
}

}  // namespace

// dtype (q, out): 0 = float32, 1 = bfloat16. kvtype (pool): 0 = q's type,
// 1 = int8, 2 = fp8-e4m3; a quantized pool needs its two scale planes and
// hd % 16 == 0. hd: a multiple of 8 up to 256 (a bf16 q takes the tensor
// cores up to 128 and the CUDA-core walk above). window <= 0 = none.
// Returns a cudaError_t (0 = launched).
extern "C" int paged_prefill(const void* q, const void* k, const void* v,
                             const float* kscale, const float* vscale,
                             const int* tables, const int* positions,
                             void* out, int B, int S, int Hq, int Hkv, int hd,
                             int bs, int NB, float qscale, int window,
                             int dtype, int kvtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv || hd % 8 || hd > 256 ||
      bs <= 0 || NB <= 0)
    return (int)cudaErrorInvalidValue;
  if (kvtype != 0 && (hd % 16 || kscale == nullptr || vscale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (kvtype) {
      case 0:
        return launch_walk<float, float>(q, k, v, kscale, vscale, tables,
                                         positions, out, B, S, Hq, Hkv, hd,
                                         bs, NB, qscale, window, s);
      case 1:
        return launch_walk<float, int8_t>(q, k, v, kscale, vscale, tables,
                                          positions, out, B, S, Hq, Hkv, hd,
                                          bs, NB, qscale, window, s);
      case 2:
        return launch_walk<float, __nv_fp8_e4m3>(
            q, k, v, kscale, vscale, tables, positions, out, B, S, Hq, Hkv,
            hd, bs, NB, qscale, window, s);
    }
  } else if (dtype == 1) {
    switch (kvtype) {
      case 0:
        return launch_bf16<__nv_bfloat16>(q, k, v, kscale, vscale, tables,
                                          positions, out, B, S, Hq, Hkv, hd,
                                          bs, NB, qscale, window, s);
      case 1:
        return launch_bf16<int8_t>(q, k, v, kscale, vscale, tables,
                                   positions, out, B, S, Hq, Hkv, hd, bs, NB,
                                   qscale, window, s);
      case 2:
        return launch_bf16<__nv_fp8_e4m3>(q, k, v, kscale, vscale, tables,
                                          positions, out, B, S, Hq, Hkv, hd,
                                          bs, NB, qscale, window, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
