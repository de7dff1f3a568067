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
// fresh bf16 chunk of S queries does about S / 4 flops per byte — 128 at
// S = 512, under the H100's ~295 — so it is bytes-bound, as decode is.
// This first version does the flops on the CUDA cores (f32 FMAs from
// shared memory), not the tensor cores, and that, not bandwidth, is what
// holds it back; wgmma tiles are the later fix.
//
// Design: one block of 128 threads per (tile of 32 rows, kv head,
// sequence). The block reads its rows' true positions and reduces them
// in-kernel to the frontier qmax and floor qmin, which replace the TPU
// kernel's scalar prefetch: kv blocks run from the window floor's block
// (0 without a window) to qmax / block_size inclusive, so blocks no row
// can attend cost nothing. Rows past the chunk (tile padding) carry
// position 0 and are never written, as the TPU wrapper's padded rows are
// sliced off.
//
// Quantized variant (the TPU kernel's `quantized=True` branch), as in
// paged_decode.cu: int8 / fp8-e4m3 tiles and their per-(slot, head) f32
// scales ride the same ring and are dequantized in registers; q is
// pre-scaled in its own type, the softmax runs in f32, the output is q's
// type.
#include "paged_common.cuh"

namespace {

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

template <typename Q, typename KV>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* tables, const int* positions,
           void* out, int B, int S, int Hq, int Hkv, int hd, int bs, int NB,
           float qscale, int window, cudaStream_t stream) {
  const size_t bytes = paged::smem_bytes(kRows, hd, bs, sizeof(KV));
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_prefill_kernel<Q, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int rows = S * (Hq / Hkv);
  dim3 grid((rows + kRows - 1) / kRows, Hkv, B);
  paged_prefill_kernel<Q, KV><<<grid, paged::kThreads, bytes, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, tables, positions,
      static_cast<Q*>(out), S, Hq, Hkv, hd, bs, NB, qscale, window);
  return (int)cudaGetLastError();
}

template <typename Q>
int launch_kv(int kvtype, const void* q, const void* k, const void* v,
              const float* ks, const float* vs, const int* tables,
              const int* positions, void* out, int B, int S, int Hq, int Hkv,
              int hd, int bs, int NB, float qscale, int window,
              cudaStream_t s) {
  switch (kvtype) {
    case 0:
      return launch<Q, Q>(q, k, v, ks, vs, tables, positions, out, B, S, Hq,
                          Hkv, hd, bs, NB, qscale, window, s);
    case 1:
      return launch<Q, int8_t>(q, k, v, ks, vs, tables, positions, out, B, S,
                               Hq, Hkv, hd, bs, NB, qscale, window, s);
    case 2:
      return launch<Q, __nv_fp8_e4m3>(q, k, v, ks, vs, tables, positions,
                                      out, B, S, Hq, Hkv, hd, bs, NB, qscale,
                                      window, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (q, out): 0 = float32, 1 = bfloat16. kvtype (pool): 0 = q's type,
// 1 = int8, 2 = fp8-e4m3; a quantized pool needs its two scale planes and
// hd % 16 == 0. window <= 0 = none. Returns a cudaError_t (0 = launched).
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
  if (dtype == 0)
    return launch_kv<float>(kvtype, q, k, v, kscale, vscale, tables,
                            positions, out, B, S, Hq, Hkv, hd, bs, NB, qscale,
                            window, s);
  if (dtype == 1)
    return launch_kv<__nv_bfloat16>(kvtype, q, k, v, kscale, vscale, tables,
                                    positions, out, B, S, Hq, Hkv, hd, bs, NB,
                                    qscale, window, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
