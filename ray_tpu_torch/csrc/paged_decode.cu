// Paged decode attention (kernel B4 of the port, and its quantized variant
// B4q) for Hopper, sm_90a: split-K flash-decoding in one launch.
//
// Replaces ray_tpu/ops/paged_attention.py::_paged_decode_kernel (wrapper
// paged_attention_pallas): one query token per sequence attends its whole
// cached context straight off the paged KV pool through its block table,
// mask t <= pos, the GQA group of G query heads packed onto its shared kv
// head, base-2 online softmax over q pre-scaled by scale * log2(e) in q's
// type, f32 max, sum and accumulator. A bf16 q rounds s - m and exp2 to
// bf16 (the TPU rule); a quantized pool (int8 or fp8-e4m3 data, one f32
// scale per (slot, kv head)) dequantizes in registers, float(code) *
// scale, and runs the softmax in f32. The pool blocks of table entries
// past pos / bs are never read, nor are the slots past pos in the last
// one.
//
// Bound on this card: bytes. Each (sequence, kv head) reads (pos + 1)
// rows of K and V once and does 4 flops per (query row, value pair):
// about 1 flop per byte at G = 1 in bf16, against the ~295 where the H100
// turns compute-bound. So the tensor cores would idle: the products run
// as f32 FMAs on the CUDA cores, and what the design buys is bytes in
// flight on every SM.
//
// The first version of this kernel gave each (kv head, sequence) one
// block, which walked the whole context a 16-token page at a time, four
// barriers a page: at the serving shape 96 blocks on 132 SMs, and the
// longest sequence's 64 serial pages set the time. Here:
//
// - Split-K. The wrapper splits each sequence's table into nsplit ranges
//   of entries (from shapes only: B, Hkv, NB, bs; never from positions,
//   which would cost a device sync). One block per (range, kv head,
//   sequence); the nsplit blocks of one (kv head, sequence) form a thread
//   block cluster (runtime cluster dimension nsplit <= 8, portable). A
//   range past the sequence's length loads nothing.
// - Loads straight into registers, many pages in flight. A token row is
//   read by a group of tpt lanes, 8 head columns (one 16-byte load of
//   bf16) each, so every lane is busy at G = 1; a group scores two tokens
//   a step (their products and shuffle trees overlap), a warp 64 / tpt.
//   Each lane keeps the loads of its next D steps in flight in a register
//   ring (D = 2 at G <= 2 in bf16); the block stages its range's table
//   entries in shared memory once, while the sequence's position is
//   read. No barrier until the walk ends. (A first version gathered each
//   range into a shared-memory tile by cp.async: 32 KB a block at the
//   serving shape, so the 768 blocks of its 96 clusters did not all fit
//   on the card at once, and a range with no tokens cost nearly as much
//   as a full one.)
// - Warps merge in shared memory. Each lane group keeps its own sum and
//   accumulator for the G rows under a running max shared by the warp;
//   at the end the groups sum across the warp and the four warps merge.
// - Combine in the same launch. After cluster.sync(), rank 0 reads every
//   live rank's (m, l, acc[G, hd]) through distributed shared memory and
//   combines them in rank order, in f32: m = max m_i, l = sum l_i *
//   exp2(m_i - m), acc = sum acc_i * exp2(m_i - m); it writes acc / l (l
//   == 0 -> 1, as the TPU finalize does). A second cluster.sync() keeps
//   the other ranks' shared memory alive until the read is done. No
//   workspace, no counter, no second launch; the fixed order makes the
//   result deterministic. One launch per call, no allocation and no host
//   sync: a CUDA graph can capture it.
//
// G rows are handled GR (1, 2, 4 or 8) at a time, in registers; a larger
// group walks its range again per chunk of 8 rows (from L2).
#include <cooperative_groups.h>

#include <algorithm>

#include "paged_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;       // head columns one lane reads of a row
constexpr int kMaxSplits = 8;  // portable cluster size

template <typename Q, typename KV>
struct Args {
  const Q* q;
  const KV* k;
  const KV* v;
  const float* ks;  // quantized pools: [num_blocks, bs, Hkv] scales
  const float* vs;
  const int* tables;
  const int* positions;
  Q* out;
  int Hq, Hkv, hd, bs, NB;
  int entries;  // table entries of one split's range
  int tpt;      // lanes reading one token row, a power of two
  float qscale;
};

// One lane's kCols values of one pool row, as loaded: 32 bytes of f32, 16
// of bf16, 8 of 1-byte codes.
template <typename KV>
struct Raw {
  static constexpr int kWords = kCols * (int)sizeof(KV) / 4;
  uint32_t w[kWords];
};

template <typename KV>
__device__ __forceinline__ void load_raw(const KV* p, Raw<KV>& r) {
  if constexpr (Raw<KV>::kWords == 8) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    r.w[0] = a.x, r.w[1] = a.y, r.w[2] = a.z, r.w[3] = a.w;
    r.w[4] = b.x, r.w[5] = b.y, r.w[6] = b.z, r.w[7] = b.w;
  } else if constexpr (Raw<KV>::kWords == 4) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = a.x, r.w[1] = a.y, r.w[2] = a.z, r.w[3] = a.w;
  } else {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = a.x, r.w[1] = a.y;
  }
}

// element e of a row, widened to f32 (exact for every type)
template <typename KV>
__device__ __forceinline__ float elem(const Raw<KV>& r, int e) {
  if constexpr (sizeof(KV) == 4) {
    return __uint_as_float(r.w[e]);
  } else if constexpr (sizeof(KV) == 2) {  // bf16: the high half of an f32
    const uint32_t w = r.w[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    const uint32_t x = (r.w[e >> 2] >> (8 * (e & 3))) & 0xffu;
    if constexpr (std::is_same_v<KV, int8_t>) {
      return (float)(int8_t)x;
    } else {
      KV c;
      c.__x = (__nv_fp8_storage_t)x;
      return static_cast<float>(c);
    }
  }
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// four consecutive outputs at p (16-byte aligned for f32, 8 for bf16)
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// Tokens a lane group scores in one step (independent chains, so their
// products and shuffles overlap), and steps of loads each lane keeps in
// flight: about 32 registers of K, V (and scales) at GR <= 2, fewer as
// the rows' q and accumulators take the registers.
constexpr int kTok = 2;
template <typename KV, int GR>
constexpr int kDepth = std::max(
    1, (GR <= 2 ? 32 : GR == 4 ? 16 : 8) /
           (kTok * (2 * Raw<KV>::kWords + (paged::kQuantized<KV> ? 2 : 0))));
// Blocks an SM should hold: caps the registers (GR = 1: 72 a thread) so
// that the 768 blocks of the serving shape are resident at once.
template <int GR>
constexpr int kMinBlocks = GR == 1 ? 7 : GR == 2 ? 5 : 2;

// Shared memory: [entries] table entries (rounded to 16 bytes); the warps'
// partials [kWarps][GR][hd] acc, [kWarps][GR] m, [kWarps][GR] l; this
// block's result, read by rank 0: [G][hd] acc, [G] m, [G] l; rank 0's
// combine factors [kMaxSplits][G] and [G] l.
__host__ __device__ inline size_t table_bytes(int entries) {
  return ((size_t)entries * 4 + 15) / 16 * 16;
}
__host__ __device__ inline size_t smem_bytes(int entries, int GR, int G,
                                             int hd) {
  return table_bytes(entries) + (size_t)kWarps * GR * (hd + 2) * 4 +
         ((size_t)G * (hd + 2) + (size_t)(kMaxSplits + 1) * G) * 4;
}

// Q: q and output type; KV: pool storage type (Q, or int8 / fp8 quantized);
// GR: query rows held in registers at a time
template <typename Q, typename KV, int GR>
__global__ void __launch_bounds__(kThreads, kMinBlocks<GR>)
    paged_decode_kernel(const Args<Q, KV> a) {
  // softmax rounding: q's type, f32 under a quantized pool
  using P = std::conditional_t<paged::kQuantized<KV>, float, Q>;
  constexpr bool quant = paged::kQuantized<KV>;
  constexpr int D = kDepth<KV, GR>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // the cluster spans grid x: one block per range of this (kvh, b)
  const int rank = blockIdx.x, nsplit = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv, hd = a.hd, bs = a.bs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tpt = a.tpt, grp = lane / tpt, sub = lane % tpt;
  const int ngrp = 32 / tpt;
  const int warp_step = ngrp * kTok;         // tokens a warp takes a step
  const int per_step = kWarps * warp_step;   // tokens a block takes a step
  const bool active = sub * kCols < hd;

  int* tab = reinterpret_cast<int*>(smem);
  float* wacc = reinterpret_cast<float*>(smem + table_bytes(a.entries));
  float* wm = wacc + kWarps * GR * hd;
  float* wl = wm + kWarps * GR;
  float* res = wl + kWarps * GR;
  float* fac = res + (size_t)G * (hd + 2);

  // this range's table entries, read while the position is in flight
  const int e0 = rank * a.entries;
  const int* table = a.tables + (size_t)b * a.NB;
  for (int i = tid; i < a.entries; i += kThreads)
    tab[i] = e0 + i < a.NB ? table[e0 + i] : 0;
  const int pos = a.positions[b];
  const int t_end = min(pos, a.NB * bs - 1);  // the last token to read
  const int t_lo = e0 * bs;
  const int t_hi = min(t_end, t_lo + a.entries * bs - 1);
  const int nsteps = t_lo <= t_hi ? (t_hi - t_lo) / per_step + 1 : 0;
  const size_t kv_col = (size_t)kvh * hd + sub * kCols;
  const size_t row_stride = (size_t)a.Hkv * hd;

  // Step u of this warp takes tokens base(u) + k * ngrp + grp, k < kTok:
  // the K/V rows (and scales) of this lane's kTok tokens into ring slot j.
  // Past t_hi nothing is read and the slot is zero.
  Raw<KV> kr[D][kTok], vr[D][kTok];
  float ksc[D][kTok], vsc[D][kTok];
  auto base = [&](int u) { return t_lo + u * per_step + warp * warp_step; };
  auto issue = [&](int j, int u) {
#pragma unroll
    for (int k = 0; k < kTok; ++k) {
      const int t = base(u) + k * ngrp + grp;
      kr[j][k] = Raw<KV>{};
      vr[j][k] = Raw<KV>{};
      ksc[j][k] = vsc[j][k] = 0.f;
      if (t <= t_hi) {
        const size_t row =
            (size_t)tab[(t - t_lo) / bs] * bs + (t - t_lo) % bs;
        if (active) {
          load_raw(a.k + row * row_stride + kv_col, kr[j][k]);
          load_raw(a.v + row * row_stride + kv_col, vr[j][k]);
        }
        if constexpr (quant) {
          ksc[j][k] = __ldg(a.ks + row * a.Hkv + kvh);
          vsc[j][k] = __ldg(a.vs + row * a.Hkv + kvh);
        }
      }
    }
  };

  const float c = paged::round_t<Q>(a.qscale);
  for (int g0 = 0; g0 < G && nsteps > 0; g0 += GR) {
    // this lane's columns of the GR rows, pre-scaled in q's type
    float q[GR][kCols];
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      const bool row = g0 + i < G && active;
      const Q* qr = a.q + ((size_t)b * a.Hq + (size_t)kvh * G + g0 + i) * hd +
                    sub * kCols;
#pragma unroll
      for (int e = 0; e < kCols; ++e)
        q[i][e] = row ? paged::round_t<Q>(load_f32(qr + e) * c) : 0.f;
    }
    if (g0 == 0) __syncthreads();  // the table entries are staged
#pragma unroll
    for (int j = 0; j < D; ++j) issue(j, j);
    // m: the warp's running max (the same in every lane); l, acc: this
    // lane group's share of the sum and of its columns' accumulator
    float m[GR], l[GR], acc[GR][kCols];
#pragma unroll
    for (int i = 0; i < GR; ++i) {
      m[i] = paged::kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[i][e] = 0.f;
    }

    for (int u0 = 0; u0 < nsteps; u0 += D) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const int u = u0 + j;
        if (u < nsteps && base(u) <= t_hi) {  // the same in the whole warp
          bool valid[kTok];
          float s[GR][kTok];
#pragma unroll
          for (int k = 0; k < kTok; ++k) {
            valid[k] = base(u) + k * ngrp + grp <= t_hi;
            float kx[kCols];
#pragma unroll
            for (int e = 0; e < kCols; ++e) {
              kx[e] = elem(kr[j][k], e);
              if constexpr (quant) kx[e] *= ksc[j][k];
            }
#pragma unroll
            for (int i = 0; i < GR; ++i) {
              s[i][k] = 0.f;
#pragma unroll
              for (int e = 0; e < kCols; ++e) s[i][k] += q[i][e] * kx[e];
            }
          }
          // the scores summed over the group's lanes, then the step's max
          // over its tokens and the warp's groups
          for (int o = tpt >> 1; o > 0; o >>= 1)
#pragma unroll
            for (int i = 0; i < GR; ++i)
#pragma unroll
              for (int k = 0; k < kTok; ++k)
                s[i][k] += __shfl_xor_sync(0xffffffffu, s[i][k], o);
          float mx[GR];
#pragma unroll
          for (int i = 0; i < GR; ++i) {
            mx[i] = paged::kNegInf;
#pragma unroll
            for (int k = 0; k < kTok; ++k)
              if (valid[k]) mx[i] = fmaxf(mx[i], s[i][k]);
          }
          for (int o = tpt; o < 32; o <<= 1)
#pragma unroll
            for (int i = 0; i < GR; ++i)
              mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
#pragma unroll
          for (int i = 0; i < GR; ++i) {
            const float mn = fmaxf(m[i], mx[i]);
            const float alpha = exp2f(m[i] - mn);
            m[i] = mn;
            l[i] *= alpha;
#pragma unroll
            for (int e = 0; e < kCols; ++e) acc[i][e] *= alpha;
#pragma unroll
            for (int k = 0; k < kTok; ++k) {
              const float p = valid[k] ? paged::round_t<P>(exp2f(
                                             paged::round_t<P>(s[i][k] - mn)))
                                       : 0.f;
              l[i] += p;
#pragma unroll
              for (int e = 0; e < kCols; ++e) {
                float v = elem(vr[j][k], e);
                if constexpr (quant) v *= vsc[j][k];
                acc[i][e] += p * v;
              }
            }
          }
        }
        issue(j, u + D);  // refill the slot
      }
    }

    // the warp's groups share m: sum their l and acc across the warp
#pragma unroll
    for (int i = 0; i < GR; ++i)
      for (int o = tpt; o < 32; o <<= 1) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
      }
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < GR; ++i) {
        if (active) {
          float* w = wacc + (size_t)(warp * GR + i) * hd + sub * kCols;
          store4(w, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
          store4(w + 4,
                 make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
        }
        if (sub == 0) {
          wm[warp * GR + i] = m[i];
          wl[warp * GR + i] = l[i];
        }
      }
    }
    __syncthreads();
    // merge the warps in warp order into this block's result rows
    for (int x = tid; x < GR * hd; x += kThreads) {
      const int i = x / hd, d = x % hd, g = g0 + i;
      if (g >= G) continue;
      float mb = paged::kNegInf;
      for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, wm[w * GR + i]);
      float ab = 0.f, lb = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float f = exp2f(wm[w * GR + i] - mb);
        ab += wacc[(size_t)(w * GR + i) * hd + d] * f;
        lb += wl[w * GR + i] * f;
      }
      res[(size_t)g * hd + d] = ab;
      if (d == 0) {
        res[(size_t)G * hd + g] = mb;
        res[(size_t)G * hd + G + g] = lb;
      }
    }
    __syncthreads();  // the next chunk's warps reuse the merge area
  }

  cluster.sync();  // every rank's result is written
  if (rank == 0) {
    // ranks whose range holds a token (rank 0's always does); the remote
    // reads are unrolled over ranks, so they are in flight together
    const int nlive =
        t_end < 0 ? 0 : min(nsplit, t_end / (a.entries * bs) + 1);
    for (int g = tid; g < G; g += kThreads) {
      float mr[kMaxSplits], lr[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        mr[r] = paged::kNegInf;
        lr[r] = 0.f;
        if (r < nlive) {
          const float* rr = cluster.map_shared_rank(res, r);
          mr[r] = rr[(size_t)G * hd + g];
          lr[r] = rr[(size_t)G * hd + G + g];
        }
      }
      float mc = paged::kNegInf;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) mc = fmaxf(mc, mr[r]);
      float lc = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        const float f = r < nlive ? exp2f(mr[r] - mc) : 0.f;
        fac[r * G + g] = f;
        lc += lr[r] * f;
      }
      fac[kMaxSplits * G + g] = lc == 0.f ? 1.f : lc;
    }
    __syncthreads();
    Q* ob = a.out + ((size_t)b * a.Hq + (size_t)kvh * G) * hd;
    for (int x = 4 * tid; x < G * hd; x += 4 * kThreads) {
      const int g = x / hd;
      float4 v[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        v[r] = r < nlive ? reinterpret_cast<const float4*>(
                               cluster.map_shared_rank(res, r))[x / 4]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        const float f = fac[r * G + g];
        s.x += v[r].x * f;
        s.y += v[r].y * f;
        s.z += v[r].z * f;
        s.w += v[r].w * f;
      }
      const float lc = fac[kMaxSplits * G + g];
      store4(ob + x, make_float4(s.x / lc, s.y / lc, s.z / lc, s.w / lc));
    }
  }
  cluster.sync();  // rank 0's reads of the other ranks are done
}

template <typename Q, typename KV, int GR>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* tables, const int* positions,
           void* out, int B, int Hq, int Hkv, int hd, int bs, int NB,
           int nsplit, float qscale, cudaStream_t stream) {
  Args<Q, KV> a{static_cast<const Q*>(q), static_cast<const KV*>(k),
                static_cast<const KV*>(v), ks, vs, tables, positions,
                static_cast<Q*>(out), Hq, Hkv, hd, bs, NB};
  a.entries = (NB + nsplit - 1) / nsplit;
  a.tpt = 1;
  while (a.tpt * kCols < hd) a.tpt *= 2;
  a.qscale = qscale;
  const size_t bytes = smem_bytes(a.entries, GR, Hq / Hkv, hd);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<Q, KV, GR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = nsplit;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, paged_decode_kernel<Q, KV, GR>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// GR: 1, 2, 4 or 8 rows in registers, the smallest that holds the group
// (larger groups go 8 rows at a time)
template <typename Q, typename KV>
int launch_rows(const void* q, const void* k, const void* v, const float* ks,
                const float* vs, const int* tables, const int* positions,
                void* out, int B, int Hq, int Hkv, int hd, int bs, int NB,
                int nsplit, float qscale, cudaStream_t s) {
  const int G = Hq / Hkv;
  if (G == 1)
    return launch<Q, KV, 1>(q, k, v, ks, vs, tables, positions, out, B, Hq,
                            Hkv, hd, bs, NB, nsplit, qscale, s);
  if (G == 2)
    return launch<Q, KV, 2>(q, k, v, ks, vs, tables, positions, out, B, Hq,
                            Hkv, hd, bs, NB, nsplit, qscale, s);
  if (G <= 4)
    return launch<Q, KV, 4>(q, k, v, ks, vs, tables, positions, out, B, Hq,
                            Hkv, hd, bs, NB, nsplit, qscale, s);
  return launch<Q, KV, 8>(q, k, v, ks, vs, tables, positions, out, B, Hq,
                          Hkv, hd, bs, NB, nsplit, qscale, s);
}

template <typename Q>
int launch_kv(int kvtype, const void* q, const void* k, const void* v,
              const float* ks, const float* vs, const int* tables,
              const int* positions, void* out, int B, int Hq, int Hkv, int hd,
              int bs, int NB, int nsplit, float qscale, cudaStream_t s) {
  switch (kvtype) {
    case 0:
      return launch_rows<Q, Q>(q, k, v, ks, vs, tables, positions, out, B,
                               Hq, Hkv, hd, bs, NB, nsplit, qscale, s);
    case 1:
      return launch_rows<Q, int8_t>(q, k, v, ks, vs, tables, positions, out,
                                    B, Hq, Hkv, hd, bs, NB, nsplit, qscale,
                                    s);
    case 2:
      return launch_rows<Q, __nv_fp8_e4m3>(q, k, v, ks, vs, tables,
                                           positions, out, B, Hq, Hkv, hd, bs,
                                           NB, nsplit, qscale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (q, out): 0 = float32, 1 = bfloat16. kvtype (pool): 0 = q's type,
// 1 = int8, 2 = fp8-e4m3; a quantized pool needs its two scale planes and
// hd % 16 == 0 (the rule of both paged kernels: B5 copies 16 codes a
// piece). nsplit: ranges of table entries per (sequence, kv head), 1..8,
// the cluster size. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const float* kscale, const float* vscale,
                            const int* tables, const int* positions, void* out,
                            int B, int Hq, int Hkv, int hd, int bs, int NB,
                            int nsplit, float qscale, int dtype, int kvtype,
                            void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || hd <= 0 || hd % 8 || hd > 256 ||
      bs <= 0 || NB <= 0 || nsplit < 1 || nsplit > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  if (kvtype != 0 && (hd % 16 || kscale == nullptr || vscale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_kv<float>(kvtype, q, k, v, kscale, vscale, tables,
                            positions, out, B, Hq, Hkv, hd, bs, NB, nsplit,
                            qscale, s);
  if (dtype == 1)
    return launch_kv<__nv_bfloat16>(kvtype, q, k, v, kscale, vscale, tables,
                                    positions, out, B, Hq, Hkv, hd, bs, NB,
                                    nsplit, qscale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
