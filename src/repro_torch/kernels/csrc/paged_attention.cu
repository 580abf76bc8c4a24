// Fused paged decode attention over a (quantized) page pool, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (kernel body _decode_kernel, dequant _dequant): one decode token per slot
// attends over the pages its block table names, with the int8 / int4 KV
// dequantized in the loop and an online softmax, so neither the contiguous
// KV view nor an f32 copy of the cache is ever written to memory.
//
// Semantics carried over exactly: scores * 1/sqrt(dh), then the optional
// softcap * tanh(s / softcap); valid positions are pos < kv_len and, when
// window > 0, pos >= kv_len - window; masked scores are -2e38; the output is
// divided by max(l, 1e-30); the G query heads of a group share one KV head;
// page 0 is the trash page and is only ever reached by masked positions.
//
// Bound on an H100 SXM: the KV bytes the slots actually fill,
// B * kv_len * KV * (2 * dh * bits / 8 + 8), over 3.35 TB/s; at decode sizes
// of a few hundred tokens that is microseconds, so launch overhead and the
// serial walk over pages dominate.
//
// Design, simple first.  One block of 128 threads per (slot, KV head).  The
// block reads its own kv_len and table entries (no scalar prefetch) and walks
// the slot's blocks in order, stopping at ceil(kv_len / page) and starting at
// the first block the window reaches: a block with every position masked
// adds exp(-2e38 - m) = 0 to the sums, so skipping it gives the same result.
// Per page: (1) one warp per position computes the G dot products, its lanes
// striding over dh (any dh up to 256: phi3's 96 is three 32-lane steps, an
// int4 row of 48 bytes is read a byte per lane pair); (2) one warp per query
// head updates the running max and denominator; (3) one thread per head
// dimension rescales its accumulators and adds p * v.  Any page size works,
// so the contiguous cache's identity-table pages (any divisor of T up to
// 128) and the paged pool's 16-token pages take the same code.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;       // query heads per KV head
constexpr int kDimSlots = 2;   // head dimensions per thread: dh <= 256
constexpr float kNegInf = -2.0e38f;

// element d of pool row ``row`` = (page_id * page + t) * KV + head, before
// the per-token scale.  BITS: 8 int8, 4 nibble pairs, 16 bf16, 32 f32.
template <int BITS>
__device__ __forceinline__ float load_elem(const void* p, size_t row, int dh,
                                           int d) {
  if constexpr (BITS == 8) {
    return static_cast<float>(static_cast<const int8_t*>(p)[row * dh + d]);
  } else if constexpr (BITS == 4) {
    // pack_int4 puts even head positions in the low nibble
    const int b = static_cast<const uint8_t*>(p)[row * (dh / 2) + (d >> 1)];
    const int v = (b >> ((d & 1) * 4)) & 0xF;
    return static_cast<float>(v >= 8 ? v - 16 : v);
  } else if constexpr (BITS == 16) {
    return __bfloat162float(
        static_cast<const __nv_bfloat16*>(p)[row * dh + d]);
  } else {
    return static_cast<const float*>(p)[row * dh + d];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q, const void* __restrict__ kp,
                       const void* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table, int nb,
                       const int* __restrict__ kv_len, int window, int kvh,
                       int g, int dh, int page, float sm_scale, float softcap,
                       float* __restrict__ out) {
  constexpr bool kQuant = BITS == 8 || BITS == 4;
  extern __shared__ float smem[];
  float* qs = smem;            // [g][dh] queries
  float* ps = smem + g * dh;   // [g][page] scores, then probabilities
  __shared__ float m_s[kMaxG], l_s[kMaxG], c_s[kMaxG];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* qb = q + (static_cast<size_t>(b) * kvh + h) * g * dh;
  for (int i = tid; i < g * dh; i += kThreads) qs[i] = qb[i];
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int len = kv_len[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int j_begin = lo / page;
  const int j_end = min(nb, (len + page - 1) / page);

  float acc[kMaxG][kDimSlots];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
    for (int u = 0; u < kDimSlots; ++u) acc[gi][u] = 0.f;
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    const size_t pid = static_cast<size_t>(table[static_cast<size_t>(b) * nb + j]);
    // (1) scores: one warp per position, lanes stride over dh
    for (int t = warp; t < page; t += kWarps) {
      const size_t row = (pid * page + t) * kvh + h;
      float ksc = 1.f;
      if constexpr (kQuant) ksc = ks[row];
      float part[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) part[gi] = 0.f;
      for (int d = lane; d < dh; d += 32) {
        float kval = load_elem<BITS>(kp, row, dh, d);
        if constexpr (kQuant) kval *= ksc;
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi)
          if (gi < g) part[gi] = fmaf(qs[gi * dh + d], kval, part[gi]);
      }
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) part[gi] = warp_sum(part[gi]);
      if (lane == 0) {
        const int pos = j * page + t;
        const bool valid = pos < len && (window <= 0 || pos >= len - window);
        for (int gi = 0; gi < g; ++gi) {
          float s = part[gi] * sm_scale;
          if (softcap != 0.f) s = softcap * tanhf(s / softcap);
          ps[gi * page + t] = valid ? s : kNegInf;
        }
      }
    }
    __syncthreads();
    // (2) online softmax: one warp per query head of the group
    for (int gi = warp; gi < g; gi += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, ps[gi * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(ps[gi * page + t] - m_new);
        ps[gi * page + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[gi] = corr;
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();
    // (3) acc = acc * corr + p @ v: one thread per head dimension
#pragma unroll
    for (int u = 0; u < kDimSlots; ++u) {
      const int d = tid + u * kThreads;
      if (d < dh) {
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi)
          if (gi < g) acc[gi][u] *= c_s[gi];
        for (int t = 0; t < page; ++t) {
          const size_t row = (pid * page + t) * kvh + h;
          float vval = load_elem<BITS>(vp, row, dh, d);
          if constexpr (kQuant) vval *= vs[row];
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi)
            if (gi < g) acc[gi][u] = fmaf(ps[gi * page + t], vval, acc[gi][u]);
        }
      }
    }
    __syncthreads();
  }

  float* ob = out + (static_cast<size_t>(b) * kvh + h) * g * dh;
#pragma unroll
  for (int u = 0; u < kDimSlots; ++u) {
    const int d = tid + u * kThreads;
    if (d < dh) {
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi)
        if (gi < g) ob[gi * dh + d] = acc[gi][u] / fmaxf(l_s[gi], 1e-30f);
    }
  }
}

template <int BITS>
void launch(const void* q, const void* kp, const void* vp, const void* ks,
            const void* vs, const void* table, int nb, const void* kv_len,
            int window, int b, int kvh, int g, int dh, int page,
            float sm_scale, float softcap, void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(g) * (dh + page) * sizeof(float);
  paged_attention_kernel<BITS><<<dim3(kvh, b), kThreads, smem, stream>>>(
      static_cast<const float*>(q), kp, vp, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table), nb,
      static_cast<const int*>(kv_len), window, kvh, g, dh, page, sm_scale,
      softcap, static_cast<float*>(out));
}

}  // namespace

// q: f32 (b, kvh, g, dh); k/v pools (P, page, kvh, dh) int8 / bf16 / f32 or
// (P, page, kvh, dh/2) uint8 (bits = 8 / 16 / 32 / 4); ks/vs: f32
// (P, page, kvh) for bits 8 and 4, else unused; table: int32 (b, nb);
// kv_len: int32 (b,); out: f32 (b, kvh, g, dh).  Needs g <= 8, dh <= 256 and
// g * (dh + page) * 4 bytes of shared memory <= 48 KB.  Launches on
// ``stream``, does not synchronise, returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      int nb, const void* kv_len, int window,
                                      int b, int kvh, int g, int dh, int page,
                                      int bits, float sm_scale, float softcap,
                                      void* out, void* stream) {
  if (g < 1 || g > kMaxG || dh < 1 || dh > kThreads * kDimSlots || page < 1 ||
      static_cast<size_t>(g) * (dh + page) * sizeof(float) > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b <= 0 || kvh <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8:
      launch<8>(q, kp, vp, ks, vs, table, nb, kv_len, window, b, kvh, g, dh,
                page, sm_scale, softcap, out, st);
      break;
    case 4:
      launch<4>(q, kp, vp, ks, vs, table, nb, kv_len, window, b, kvh, g, dh,
                page, sm_scale, softcap, out, st);
      break;
    case 16:
      launch<16>(q, kp, vp, ks, vs, table, nb, kv_len, window, b, kvh, g, dh,
                 page, sm_scale, softcap, out, st);
      break;
    case 32:
      launch<32>(q, kp, vp, ks, vs, table, nb, kv_len, window, b, kvh, g, dh,
                 page, sm_scale, softcap, out, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
