// Paged decode attention (kernel B4 of the port) for Hopper, sm_90a.
//
// Replaces ray_tpu/ops/paged_attention.py::_paged_decode_kernel (wrapper
// paged_attention_pallas): one query token per sequence attends its whole
// cached context straight off the paged KV pool through its block table,
// mask t <= pos, GQA query group compacted onto its shared kv head.
//
// Bound on this card: bytes. Each (b, kv head) reads (pos+1) * hd K and V
// values once and does 4 flops per value pair, far below the ~295 flops
// per byte where the H100 turns compute-bound.
//
// Design: one block of 128 threads per (kv head, sequence). The query
// group [G, hd] is scaled by scale * log2(e) once into shared memory. The
// loop runs over table entries 0 .. pos / block_size inclusive — that
// bound replaces the TPU kernel's DMA dedupe, so padding entries cost
// neither loads nor compute. K/V tiles arrive by 16-byte cp.async copies,
// one block ahead of the compute (paged_common.cuh). Known weak spot: at
// B = 8 and 12 kv heads the grid is 96 blocks on 132 SMs, one sequence's
// whole context on one SM; flash-decoding split-K is the later fix.
//
// Quantized variant (the TPU kernel's `quantized=True` branch): the pool
// is int8 or fp8-e4m3 with [num_blocks, bs, Hkv] f32 scales. Each token
// then costs hd + 4 bytes per side instead of 2 * hd in bf16, so the
// bound halves; K/V tiles and their scales ride the same cp.async ring
// and are dequantized in registers (paged_common.cuh). q is pre-scaled in
// its own type (bf16 in serving) and the softmax runs in f32; the output
// is q's type.
#include "paged_common.cuh"

namespace {

// Q: q and output type; KV: pool storage type (Q, or int8 / fp8 quantized)
template <typename Q, typename KV>
__global__ void __launch_bounds__(paged::kThreads)
    paged_decode_kernel(const Q* __restrict__ q, const KV* __restrict__ kpool,
                        const KV* __restrict__ vpool,
                        const float* __restrict__ kscale,
                        const float* __restrict__ vscale,
                        const int* __restrict__ tables,
                        const int* __restrict__ positions, Q* __restrict__ out,
                        int Hq, int Hkv, int hd, int bs, int NB, float qscale) {
  // softmax rounding: q's type, f32 under a quantized pool
  using P = std::conditional_t<paged::kQuantized<KV>, float, Q>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  paged::Tile<KV> t = paged::Tile<KV>::carve(smem, G, hd, bs);
  const int pos = positions[b];
  // query head kvh * G + g serves kv head kvh: the group is contiguous
  const Q* qb = q + ((size_t)b * Hq + (size_t)kvh * G) * hd;
  const float c = paged::round_t<Q>(qscale);
  for (int e = threadIdx.x; e < G * hd; e += paged::kThreads)
    t.q[e] = paged::round_t<Q>(paged::to_f32(qb[e]) * c);
  for (int r = threadIdx.x; r < G; r += paged::kThreads) {
    t.pos[r] = pos;
    t.orow[r] = ((long long)b * Hq + (long long)kvh * G + r) * hd;
  }
  const int i_hi = min(pos / bs, NB - 1);
  paged::attend_tile<KV, P, Q>(kpool, vpool, kscale, vscale,
                               tables + (size_t)b * NB, 0, i_hi, G, hd, bs,
                               Hkv, kvh, 0, t, out);
}

template <typename Q, typename KV>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* tables, const int* positions,
           void* out, int B, int Hq, int Hkv, int hd, int bs, int NB,
           float qscale, cudaStream_t stream) {
  const size_t bytes = paged::smem_bytes(Hq / Hkv, hd, bs, sizeof(KV));
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<Q, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(Hkv, B);
  paged_decode_kernel<Q, KV><<<grid, paged::kThreads, bytes, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, tables, positions,
      static_cast<Q*>(out), Hq, Hkv, hd, bs, NB, qscale);
  return (int)cudaGetLastError();
}

template <typename Q>
int launch_kv(int kvtype, const void* q, const void* k, const void* v,
              const float* ks, const float* vs, const int* tables,
              const int* positions, void* out, int B, int Hq, int Hkv, int hd,
              int bs, int NB, float qscale, cudaStream_t s) {
  switch (kvtype) {
    case 0:
      return launch<Q, Q>(q, k, v, ks, vs, tables, positions, out, B, Hq,
                          Hkv, hd, bs, NB, qscale, s);
    case 1:
      return launch<Q, int8_t>(q, k, v, ks, vs, tables, positions, out, B,
                               Hq, Hkv, hd, bs, NB, qscale, s);
    case 2:
      return launch<Q, __nv_fp8_e4m3>(q, k, v, ks, vs, tables, positions,
                                      out, B, Hq, Hkv, hd, bs, NB, qscale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (q, out): 0 = float32, 1 = bfloat16. kvtype (pool): 0 = q's type,
// 1 = int8, 2 = fp8-e4m3; a quantized pool needs its two scale planes and
// hd % 16 == 0 (one 16-byte copy carries 16 elements). Returns a
// cudaError_t (0 = launched).
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const float* kscale, const float* vscale,
                            const int* tables, const int* positions, void* out,
                            int B, int Hq, int Hkv, int hd, int bs, int NB,
                            float qscale, int dtype, int kvtype,
                            void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || hd % 8 || hd > 256 || bs <= 0 ||
      NB <= 0)
    return (int)cudaErrorInvalidValue;
  if (kvtype != 0 && (hd % 16 || kscale == nullptr || vscale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_kv<float>(kvtype, q, k, v, kscale, vscale, tables,
                            positions, out, B, Hq, Hkv, hd, bs, NB, qscale, s);
  if (dtype == 1)
    return launch_kv<__nv_bfloat16>(kvtype, q, k, v, kscale, vscale, tables,
                                    positions, out, B, Hq, Hkv, hd, bs, NB,
                                    qscale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
