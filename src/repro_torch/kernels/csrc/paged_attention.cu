// Split-KV ("flash-decoding") paged decode attention over a (quantized) page
// pool, for Hopper (sm_90a), CUDA C++.
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
// When no position of a slot is valid the output is 0.
//
// Bound on an H100 SXM: the KV bytes the slots fill,
// B * kv_len * KV * (2 * dh * bits / 8 + 8), over 3.35 TB/s: 1.1 us at
// B = 4, KV = 32, dh = 96, kv_len 144, int8, and 31 us at kv_len 4096.
// At the short end launch and memory latency decide; at the long end the
// bytes, fetched from a position-major pool ((P, page, KV, dh): one KV
// head's rows lie KV * dh * bits / 8 bytes apart, its scales 4 * KV), and
// the math, whose shared-memory and shuffle latencies need warps in flight
// to hide them.
//
// Design.  The wrapper's plan (kernels/tiling.py::attention_plan, from host
// shapes only: kv_len is never read on the host) picks one of two regimes
// by the table capacity nb * page:
//
// * short (decode at a few hundred positions): one CTA per (KV head,
//   slot), no split, the longest sub-chunk that fits, so the walk takes the
//   fewest steps and nothing is combined across CTAs;
// * long: the capacity cut into ``splits`` ranges of ``split_len``
//   positions, ``heads`` (4, 2 or 1) neighbouring KV heads a CTA, enough
//   CTAs for one wave of two an SM.
//
// One CTA of 8 warps per (split, head group, slot):
//
// * It loads its queries, kv_len and its split's table entries, then keeps
//   only the positions that are valid (its range cut by kv_len and the
//   window; an empty range skips the walk).  Masked positions are never
//   read, so stale pages and the trash page cannot reach the sums.
// * It streams them through a two-stage ring of ``chunk``-position
//   sub-chunks in shared memory with cp.async: per position the group's K
//   rows (contiguous in the pool: heads * dh * bits / 8 bytes), V rows and
//   scales (heads * 4 bytes), 16-byte copies where the rows allow (else 8
//   or 4, else plain byte loads).  The next sub-chunk is in flight while
//   one is used; one CTA barrier a sub-chunk.
// * Each warp owns one head of the group and a share of every sub-chunk's
//   positions, with its own online softmax (m, l and acc in registers),
//   max and sum by warp shuffles.  Scores: a team of 32 / positions lanes a
//   position reads 16-byte units of the K row.  For int8 and int4 pools the
//   queries are split once into three int8 parts (q ~ a0 s0 + a1 s1 +
//   a2 s2, each scale 1/254 of the last: error ~6e-8 of max |q|) and the
//   dot products are exact dp4a sums over the stored integers (int4 nibbles
//   in offset binary, less 8 * sum(a)); float pools take f32 FMAs.  The K
//   scale and 1/sqrt(dh) multiply once a score.  P.V: lanes own 4 or 8 head
//   dimensions; for integer pools with G <= 2, p times the V scale is split
//   the same way per sub-chunk and four positions' V bytes of a dimension,
//   gathered by a byte transpose, meet it in dp4a; otherwise f32 FMAs.
// * Combine, in the same launch: the warps of a head, in order, in shared
//   memory; then the splits.  Each CTA writes its (m, l, acc) to a
//   workspace slice; the last CTA of a (slot, head group) to arrive (an
//   atomic counter, which it resets to 0) adds the slices in split order,
//   weighted by exp(m_i - max m) (0 for an empty split, whose l is 0), and
//   writes the output.  No float atomics: two launches give identical bits.
//   (A thread-block cluster combining through distributed shared memory
//   was measured first: a cluster of 8 CTAs of this size is not all
//   resident at once, which left part of the grid to a second wave.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The launch's fixed geometry, built once per call shape by the wrapper
// (kernels/paged_attention.py::_Args mirrors it field for field).
struct AttentionArgs {
  int b, kvh, g, dh, page, nb, bits, window, splits, split_len, heads, chunk,
      n_tab, smem;
  float sm_scale, softcap;
  void* ws;   // f32, >= b * kvh * splits * g * (dh + 2) when splits > 1
  void* cnt;  // int32 zeros, >= b * kvh / heads; left at zero
};

// Measurement switches, at their defaults in the port's build.
// scripts/attention_probe.py builds variants: -DPA_PROBE=1 skips the math
// (copies and waits only), 2 skips the copies (math on whatever shared
// memory holds), 4 skips P.V, 8 skips the scores' dot products;
// -DPA_STAGES and -DPA_WARPS change the ring depth and the warps of a CTA
// (the plan's shared memory figure must be given the same).  A variant's
// results are timed, never used.
#ifndef PA_PROBE
#define PA_PROBE 0
#endif
#ifndef PA_STAGES
#define PA_STAGES 2
#endif
#ifndef PA_WARPS
#define PA_WARPS 8
#endif


namespace {

constexpr int kProbe = PA_PROBE;
constexpr int kWarps = PA_WARPS;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;          // query heads per KV head
constexpr int kMaxDh = 256;
constexpr int kMaxHeads = 4;      // KV heads a CTA
constexpr int kMaxSplits = 32;
constexpr int kStages = PA_STAGES;
constexpr int kPPitch = 8;        // floats a position in a warp's p buffer
constexpr int kMaxSmem = 232448;  // H100: 227 KB of dynamic shared memory
constexpr float kNegInf = -2.0e38f;
constexpr float kMagic = 8388608.f;  // 2^23

__host__ __device__ constexpr int dims_per_lane(int bits) {
  return bits == 4 ? 8 : 4;
}

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Row and buffer geometry shared by the launch check and the kernel; the
// wrapper's plan computes the same (kernels/tiling.py::attention_layout).
struct Layout {
  int row_bytes, units, rpitch, kpitch, qp, ndg, ng, pw, stage, ring, red;
  int off_q, off_p, off_acc, off_st, off_tab, total;
};

__host__ __device__ inline Layout layout(int g, int dh, int bits, int heads,
                                         int chunk, int n_tab) {
  Layout l;
  l.row_bytes = dh * bits / 8;
  l.units = (l.row_bytes + 15) / 16;
  l.rpitch = l.units * 16;  // one head's row, whole 16-byte units
  // a position's rows: an odd number of units, so that 8 consecutive
  // positions hit 8 bank groups
  const int pos_units = heads * l.units;
  l.kpitch = (pos_units + (pos_units % 2 == 0 ? 1 : 0)) * 16;
  l.qp = l.units * (128 / bits);
  const int dpl = dims_per_lane(bits);
  l.ndg = (dh + dpl - 1) / dpl;              // dim groups of a row
  l.ng = l.ndg <= 32 ? 32 / l.ndg : 1;        // position groups of P.V
  l.pw = chunk * heads / kWarps;             // a warp's positions a stage
  l.stage = 2 * chunk * l.kpitch + 2 * chunk * heads * 4;
  l.ring = kStages * l.stage;
  l.red = kWarps * l.ng * g * dh * 4;
  // the ring also holds the last CTA's split weights once the walk is over
  const int weights = kMaxHeads * kMaxG * kMaxSplits * 4;
  const int r0 = l.ring > l.red ? l.ring : l.red;
  l.off_q = round16(r0 > weights ? r0 : weights);
  l.off_p = l.off_q + heads * g * l.qp * 4;
  // a warp's p: three int8 parts a (position, query head) for the integer
  // P.V (int8 / int4 pools, G <= 2), else kPPitch floats a position
  const bool int_pv = (bits == 8 || bits == 4) && g <= 2;
  l.off_acc = l.off_p + kWarps * round16(int_pv ? 3 * g * l.pw
                                                : l.pw * kPPitch * 4);
  l.off_st = l.off_acc + round16(heads * g * dh * 4);
  // per warp m, l; per (head, query head) m, l, total l, the query parts'
  // scales and offsets
  l.off_tab = l.off_st + (2 * kWarps * kMaxG + kMaxHeads * kMaxG * 9) * 4;
  l.total = l.off_tab + n_tab * 4;
  return l;
}

struct Params {
  const float* q;
  const uint8_t* kp;
  const uint8_t* vp;
  const float* ks;
  const float* vs;
  const int* table;
  const int* kv_len;
  float* out;
  float* ws;
  int* cnt;
  int kvh, g, dh, page, nb, window, splits, split_len, heads, chunk;
  int row_bytes, units, rpitch, kpitch, qp, ndg, ng, stage;
  int vec, vec_s;  // copy widths of row runs and of scale runs (0: bytes)
  int off_q, off_p, off_acc, off_st, off_tab;  // byte offsets
  float sm_scale, softcap;
};

// ---------------------------------------------------------------- formats

template <int BITS>
struct Fmt;

template <>
struct Fmt<8> {  // int8, per-token scale
  static constexpr bool kQuant = true;
  static constexpr int kEPU = 16;   // elements per 16-byte unit
  static constexpr int kDPL = 4;    // dims per P.V lane
  __device__ static float cvt(uint32_t w, int i) {  // w already ^0x80808080
    return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | i)) -
           (kMagic + 128.f);
  }
  __device__ static void unit(const uint4& r, float* v) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                           r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) v[j * 4 + i] = cvt(w[j], i);
  }
  __device__ static void pv(const uint8_t* row, int dg, float* v) {
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(row + dg * 4) ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = cvt(w, i);
  }
};

template <>
struct Fmt<4> {  // nibble pairs, even position in the low nibble
  static constexpr bool kQuant = true;
  static constexpr int kEPU = 32;
  static constexpr int kDPL = 8;
  __device__ static float cvt(uint32_t w, int i) {  // w already ^0x88888888
    return __uint_as_float(((w >> (4 * i)) & 0xFu) | 0x4B000000u) -
           (kMagic + 8.f);
  }
  __device__ static void word(uint32_t w, float* v) {
    w ^= 0x88888888u;
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = cvt(w, i);
  }
  __device__ static void unit(const uint4& r, float* v) {
    word(r.x, v);
    word(r.y, v + 8);
    word(r.z, v + 16);
    word(r.w, v + 24);
  }
  __device__ static void pv(const uint8_t* row, int dg, float* v) {
    word(*reinterpret_cast<const uint32_t*>(row + dg * 4), v);
  }
};

template <>
struct Fmt<16> {  // bf16
  static constexpr bool kQuant = false;
  static constexpr int kEPU = 8;
  static constexpr int kDPL = 4;
  __device__ static void word(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xFFFF0000u);
  }
  __device__ static void unit(const uint4& r, float* v) {
    word(r.x, v);
    word(r.y, v + 2);
    word(r.z, v + 4);
    word(r.w, v + 6);
  }
  __device__ static void pv(const uint8_t* row, int dg, float* v) {
    const uint2 r = *reinterpret_cast<const uint2*>(row + dg * 8);
    word(r.x, v);
    word(r.y, v + 2);
  }
};

template <>
struct Fmt<32> {  // f32
  static constexpr bool kQuant = false;
  static constexpr int kEPU = 4;
  static constexpr int kDPL = 4;
  __device__ static void unit(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static void pv(const uint8_t* row, int dg, float* v) {
    unit(*reinterpret_cast<const uint4*>(row + dg * 16), v);
  }
};

// ---------------------------------------------------------------- helpers

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

__device__ __forceinline__ void copy_piece(void* dst, const void* src,
                                           int vec) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                 "l"(src)
                 : "memory");
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sa),
                 "l"(src)
                 : "memory");
  } else if (vec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa),
                 "l"(src)
                 : "memory");
  } else {
    *static_cast<uint8_t*>(dst) = *static_cast<const uint8_t*>(src);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Exact integer dot products of 4 bytes: signed x signed, and unsigned
// (offset-binary nibbles) x signed.
__device__ __forceinline__ int dp4a_ss(uint32_t a, uint32_t b, int c) {
  return __dp4a(static_cast<int>(a), static_cast<int>(b), c);
}

__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// 4 x 4 byte transpose: w[i] holds bytes 0..3 of position i; x[d] gets
// byte d of positions 0..3.
__device__ __forceinline__ void transpose4(const uint32_t w[4],
                                           uint32_t x[4]) {
  const uint32_t u0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t u1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t u2 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t u3 = __byte_perm(w[2], w[3], 0x7362);
  x[0] = __byte_perm(u0, u1, 0x5410);
  x[1] = __byte_perm(u0, u1, 0x7632);
  x[2] = __byte_perm(u2, u3, 0x5410);
  x[3] = __byte_perm(u2, u3, 0x7632);
}

// x as three int8 parts, x ~ a0 * s[0] + a1 * s[1] + a2 * s[2] (s[0] =
// max |x| / 127, each next scale 1/254 of the last: |error| <= max |x| *
// 6e-8); returns the parts packed in bytes 0..2.
__device__ __forceinline__ uint32_t split3(float x, const float s[3]) {
  uint32_t out = 0;
  float r = x;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = fminf(fmaxf(rintf(r / s[k]), -127.f), 127.f);
    r = fmaf(-a, s[k], r);
    out |= (static_cast<uint32_t>(static_cast<int>(a)) & 0xFFu) << (8 * k);
  }
  return out;
}

__device__ __forceinline__ void part_scales(float amax, float s[3]) {
  s[0] = amax > 0.f ? amax * (1.f / 127.f) : 1.f;
  s[1] = s[0] * (1.f / 254.f);
  s[2] = s[1] * (1.f / 254.f);
}

__device__ __forceinline__ int warp_sum_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pool row of position ``pos`` and KV head ``h`` (in rows of row_bytes, or
// in scales), through this split's table entries.
__device__ __forceinline__ size_t pool_row(const Params& p, const int* tab,
                                           int j0, int pos, int h) {
  const int j = pos / p.page;
  return (static_cast<size_t>(tab[j - j0]) * p.page + (pos - j * p.page)) *
             p.kvh + h;
}

// Issue the copies of positions [start, start + n) of this CTA's slot and
// head group (KV heads h0 ..) into ring stage ``st``: K and V rows and, for
// a quantized pool, their scales.
template <bool QUANT>
__device__ __forceinline__ void issue_chunk(const Params& p, uint8_t* ring,
                                            const int* tab, int j0, int h0,
                                            int st, int start, int n) {
  const int tid = threadIdx.x;
  const int C = p.chunk, H = p.heads;
  uint8_t* kst = ring + st * p.stage;
  uint8_t* vst = kst + C * p.kpitch;
  float* kss = reinterpret_cast<float*>(vst + C * p.kpitch);
  float* vss = kss + C * H;
  const int vec = p.vec ? p.vec : 1;
  // a position's rows are one run in the pool; in shared memory too when
  // rows are whole units, else one run a head
  const bool whole = p.rpitch == p.row_bytes;
  const int runs = whole ? 1 : H;                 // runs a position
  const int run_bytes = whole ? H * p.row_bytes : p.row_bytes;
  const int pieces = run_bytes / vec;
  const int tpr = pieces < kThreads ? pieces : kThreads;  // threads a run
  const int rpp = kThreads / tpr;                         // runs a pass
  const int r0 = tid / tpr, pc0 = tid % tpr;
  if (r0 < rpp) {
    for (int r = r0; r < n * runs; r += rpp) {
      const int t = whole ? r : r / H;
      const int hx = whole ? 0 : r - t * H;
      const size_t row = pool_row(p, tab, j0, start + t, h0 + hx);
      const uint8_t* ksrc = p.kp + row * p.row_bytes;
      const uint8_t* vsrc = p.vp + row * p.row_bytes;
      uint8_t* kd = kst + t * p.kpitch + hx * p.rpitch;
      uint8_t* vd = vst + t * p.kpitch + hx * p.rpitch;
      for (int pc = pc0; pc < pieces; pc += tpr) {
        copy_piece(kd + pc * vec, ksrc + pc * vec, p.vec);
        copy_piece(vd + pc * vec, vsrc + pc * vec, p.vec);
      }
    }
  }
  if constexpr (QUANT) {
    // a position's H scales: one run of vec_s bytes, or H single floats
    const int per = p.vec_s == 4 * H ? 1 : H;
    const int width = per == 1 ? p.vec_s : 4;
    for (int i = tid; i < 2 * n * per; i += kThreads) {
      const bool v = i >= n * per;
      const int k = v ? i - n * per : i;
      const int t = k / per, hx = k - t * per;
      const size_t row = pool_row(p, tab, j0, start + t, h0 + hx);
      copy_piece((v ? vss : kss) + t * H + hx, (v ? p.vs : p.ks) + row,
                 width);
    }
  }
}

// ----------------------------------------------------------------- kernel

template <int BITS, int GM>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
  using F = Fmt<BITS>;
  constexpr int EPU = F::kEPU;
  constexpr int DPL = F::kDPL;
  constexpr int NDL = BITS == 4 ? 1 : 2;  // dim groups a lane (dh <= 256)
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + p.off_q);
  float* pbuf = reinterpret_cast<float*>(smem + p.off_p);
  float* cacc = reinterpret_cast<float*>(smem + p.off_acc);
  float* wm = reinterpret_cast<float*>(smem + p.off_st);  // [warp][head]
  float* wl = wm + kWarps * kMaxG;
  float* cm = wl + kWarps * kMaxG;                 // [head][query head]
  float* cl = cm + kMaxHeads * kMaxG;
  float* lt = cl + kMaxHeads * kMaxG;
  float* ws = reinterpret_cast<float*>(ring);      // [..][split] weights
  float* qsc = lt + kMaxHeads * kMaxG;               // [..][part] scales
  int* qof = reinterpret_cast<int*>(qsc + kMaxHeads * kMaxG * 3);
  int* tab = reinterpret_cast<int*>(smem + p.off_tab);
  // integer pools: the queries as three int8 parts (p.qp bytes a part, in
  // the K row's byte order), scores by dp4a; P.V too where G <= 2
  constexpr bool kIntPV = F::kQuant && GM <= 2;

  const int split = blockIdx.x;
  const int bi = blockIdx.z;
  const int H = p.heads;
  const int h0 = blockIdx.y * H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = p.g, dh = p.dh, C = p.chunk;
  const int cap = p.nb * p.page;
  const int p0 = split * p.split_len;
  const int p1 = min(p0 + p.split_len, cap);
  const int j0 = p0 / p.page;

  // queries of the group (zero-padded to whole units), the split's table
  // entries, the K rows' tail bytes
  const float* qb = p.q + (static_cast<size_t>(bi) * p.kvh + h0) * g * dh;
  if constexpr (F::kQuant) {
    // a warp a query vector: int4 parts hold the even dims of each 8 in
    // bytes 0..15 of a unit and the odd dims in bytes 16..31, as the K
    // nibbles split into low and high bytes
    const int lane0 = tid & 31;
    for (int r = tid >> 5; r < H * g; r += kWarps) {
      const float* qv = qb + r * dh;
      float mx = 0.f;
      for (int d = lane0; d < dh; d += 32) mx = fmaxf(mx, fabsf(qv[d]));
      float sc[3];
      part_scales(warp_max(mx), sc);
      int8_t* dst = reinterpret_cast<int8_t*>(qs) + r * 3 * p.qp;
      int sum[3] = {0, 0, 0};
      for (int d = lane0; d < p.qp; d += 32) {
        const uint32_t a = split3(d < dh ? qv[d] : 0.f, sc);
        int off = d;
        if constexpr (BITS == 4) {
          const int e = d & 31, nn = e & 7;
          off = (d & ~31) + (nn & 1) * 16 + (e >> 3) * 4 + (nn >> 1);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int8_t v = static_cast<int8_t>((a >> (8 * k)) & 0xFF);
          dst[k * p.qp + off] = v;
          sum[k] += v;
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sum[k] = warp_sum_i(sum[k]);
        if (lane0 == 0) {
          qsc[r * 3 + k] = sc[k];
          qof[r * 3 + k] = BITS == 4 ? 8 * sum[k] : 0;
        }
      }
    }
  } else {
    for (int i = tid; i < H * g * p.qp; i += kThreads) {
      const int r = i / p.qp, d = i - r * p.qp;
      qs[i] = d < dh ? qb[r * dh + d] : 0.f;
    }
  }
  if (p1 > p0) {
    const int n_here = (p1 - 1) / p.page - j0 + 1;
    const int* trow = p.table + static_cast<size_t>(bi) * p.nb + j0;
    for (int i = tid; i < n_here; i += kThreads) tab[i] = trow[i];
  }
  if (p.rpitch != p.row_bytes) {
    // zero, so that the padded queries' zeros never meet a NaN pattern of
    // a float pool
    const int tail = p.rpitch - p.row_bytes;
    for (int i = tid; i < kStages * C * H * tail; i += kThreads) {
      const int r = i / tail, st = r / (C * H), k = r - st * C * H;
      const int t = k / H, hx = k - t * H;
      ring[st * p.stage + t * p.kpitch + hx * p.rpitch + p.row_bytes +
           (i - r * tail)] = 0;
    }
  }
  const int len = p.kv_len[bi];
  const int lo = p.window > 0 ? max(0, len - p.window) : 0;
  const int a = max(p0, lo);
  const int e = min(p1, len);
  const int nchunks = e > a ? (e - a + C - 1) / C : 0;
  __syncthreads();

  // this warp: head hh of the group, positions [part * pw, +pw) of every
  // sub-chunk; scores by teams of lp lanes a position
  const int hh = warp % H;
  const int part = warp / H;
  const int pw = C * H / kWarps;
  const int lp = 32 / pw;
  const int tt = lane / lp, sub = lane - tt * lp;
  // P.V: lane owns dim groups dg0 (+ 32) of positions grp, grp + ng, ..
  const int ndg = p.ndg, ng = p.ng;
  const int dg0 = ndg <= 32 ? lane % ndg : lane;
  const int grp = ndg <= 32 ? lane / ndg : 0;
  const bool pv_lane = grp < ng;
  float* pb = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(pbuf) +
      warp * round16(kIntPV ? 3 * g * pw : pw * kPPitch * 4));

  float m_w[GM], l_w[GM], acc[GM][NDL][DPL];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    m_w[gi] = kNegInf;
    l_w[gi] = 0.f;
#pragma unroll
    for (int k = 0; k < NDL; ++k)
#pragma unroll
      for (int u = 0; u < DPL; ++u) acc[gi][k][u] = 0.f;
  }

  // the first kStages - 1 sub-chunks in flight before the walk starts
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (!(kProbe & 2) && c < nchunks) {
      const int s0 = a + c * C;
      issue_chunk<F::kQuant>(p, ring, tab, j0, h0, c, s0, min(C, e - s0));
    }
    cp_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    const int start = a + c * C;
    const int n = min(C, e - start);
    cp_wait<kStages - 2>();
    // every thread's copies of sub-chunk c have landed, and every warp is
    // done with sub-chunk c - 1, whose stage the next copies refill
    __syncthreads();
    const int ahead = c + kStages - 1;
    if (!(kProbe & 2) && ahead < nchunks) {
      const int s0 = a + ahead * C;
      issue_chunk<F::kQuant>(p, ring, tab, j0, h0, ahead % kStages, s0,
                             min(C, e - s0));
    }
    cp_commit();
    const uint8_t* kst = ring + (c % kStages) * p.stage;
    const uint8_t* vst = kst + C * p.kpitch;
    const float* kss = reinterpret_cast<const float*>(vst + C * p.kpitch);
    const float* vss = kss + C * H;
    const int t0 = part * pw;
    const int nw = min(pw, n - t0);  // this warp's positions here
    if (nw <= 0 || (kProbe & 1)) continue;

    // (1) scores of position t0 + tt for the G query heads
    const bool valid = tt < nw;
    const int t = t0 + tt;
    float s[GM];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) s[gi] = 0.f;
    const uint8_t* krow = kst + t * p.kpitch + hh * p.rpitch;
    if constexpr (F::kQuant) {
      const int8_t* qi = reinterpret_cast<const int8_t*>(qs);
      int S[GM][3];
#pragma unroll
      for (int gi = 0; gi < GM; ++gi)
#pragma unroll
        for (int k = 0; k < 3; ++k) S[gi][k] = 0;
      if (valid && !(kProbe & 8)) {
        for (int u = sub; u < p.units; u += lp) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + u * 16);
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int gi = 0; gi < GM; ++gi) {
            if (gi < g) {
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                const int8_t* qk = qi + ((hh * g + gi) * 3 + k) * p.qp;
                if constexpr (BITS == 8) {
                  const uint4 qw = *reinterpret_cast<const uint4*>(qk + u * 16);
                  S[gi][k] = dp4a_ss(w[0], qw.x, S[gi][k]);
                  S[gi][k] = dp4a_ss(w[1], qw.y, S[gi][k]);
                  S[gi][k] = dp4a_ss(w[2], qw.z, S[gi][k]);
                  S[gi][k] = dp4a_ss(w[3], qw.w, S[gi][k]);
                } else {
                  const uint4* q2 = reinterpret_cast<const uint4*>(qk + u * 32);
                  const uint4 ql = q2[0], qh = q2[1];
                  const uint32_t qlo[4] = {ql.x, ql.y, ql.z, ql.w};
                  const uint32_t qhi[4] = {qh.x, qh.y, qh.z, qh.w};
#pragma unroll
                  for (int j = 0; j < 4; ++j) {
                    const uint32_t x = w[j] ^ 0x88888888u;
                    S[gi][k] = dp4a_us(x & 0x0F0F0F0Fu, qlo[j], S[gi][k]);
                    S[gi][k] =
                        dp4a_us((x >> 4) & 0x0F0F0F0Fu, qhi[j], S[gi][k]);
                  }
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          for (int o = lp >> 1; o > 0; o >>= 1)
            S[gi][k] += __shfl_xor_sync(0xffffffffu, S[gi][k], o);
        if (gi < g) {
          const int r = (hh * g + gi) * 3;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            s[gi] = fmaf(static_cast<float>(S[gi][k] - qof[r + k]),
                         qsc[r + k], s[gi]);
        }
      }
    } else {
      if (valid && !(kProbe & 8)) {
        for (int u = sub; u < p.units; u += lp) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + u * 16);
          float kv[EPU];
          F::unit(raw, kv);
#pragma unroll
          for (int gi = 0; gi < GM; ++gi) {
            if (gi < g) {
              const float4* q4 = reinterpret_cast<const float4*>(
                  qs + (hh * g + gi) * p.qp + u * EPU);
#pragma unroll
              for (int e4 = 0; e4 < EPU / 4; ++e4) {
                const float4 qv = q4[e4];
                s[gi] = fmaf(qv.x, kv[4 * e4], s[gi]);
                s[gi] = fmaf(qv.y, kv[4 * e4 + 1], s[gi]);
                s[gi] = fmaf(qv.z, kv[4 * e4 + 2], s[gi]);
                s[gi] = fmaf(qv.w, kv[4 * e4 + 3], s[gi]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < GM; ++gi)
        for (int o = lp >> 1; o > 0; o >>= 1)
          s[gi] += __shfl_xor_sync(0xffffffffu, s[gi], o);
    }
    const float scl =
        valid ? (F::kQuant ? kss[t * H + hh] * p.sm_scale : p.sm_scale) : 0.f;
    const float vsc = valid && F::kQuant ? vss[t * H + hh] : 1.f;

    // (2) online softmax of each query head over the warp's positions;
    // p times the V scale to the warp's buffer, as floats or, for the
    // integer P.V, as three int8 parts a position (bytes (gi * 3 + part)
    // * pw + position) with their scales
    float corr[GM];
    float psc[GM][3];
    int8_t* pa = reinterpret_cast<int8_t*>(pb);
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      corr[gi] = 1.f;
      if (gi < g) {
        float x = s[gi] * scl;
        if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
        x = valid ? x : kNegInf;
        const float m_new = fmaxf(m_w[gi], warp_max(x));
        const float pr = valid ? expf(x - m_new) : 0.f;
        const float sum = warp_sum(sub == 0 ? pr : 0.f);
        corr[gi] = expf(m_w[gi] - m_new);
        l_w[gi] = l_w[gi] * corr[gi] + sum;
        m_w[gi] = m_new;
        if constexpr (kIntPV) {
          const float pv = pr * vsc;
          part_scales(warp_max(pv), psc[gi]);
          if (sub == 0) {
            const uint32_t a = split3(pv, psc[gi]);
#pragma unroll
            for (int k = 0; k < 3; ++k)
              pa[(gi * 3 + k) * pw + tt] =
                  static_cast<int8_t>((a >> (8 * k)) & 0xFF);
          }
        } else {
          if (valid && sub == 0) pb[tt * kPPitch + gi] = pr * vsc;
        }
      }
    }
    __syncwarp();

    // (3) acc = acc * corr + p @ v
#pragma unroll
    for (int gi = 0; gi < GM; ++gi)
#pragma unroll
      for (int k = 0; k < NDL; ++k)
#pragma unroll
        for (int u = 0; u < DPL; ++u) acc[gi][k][u] *= corr[gi];
    if constexpr (kIntPV) {
      if (pv_lane && !(kProbe & 4)) {
        // four positions a step: their V words, transposed to four
        // positions a head dimension, dp4a'd with p's parts; int4 nibbles
        // in offset binary, less 8 * sum(p parts)
        int A[GM][NDL][3][DPL], As[GM][3];
#pragma unroll
        for (int gi = 0; gi < GM; ++gi) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            As[gi][k] = 0;
#pragma unroll
            for (int kk = 0; kk < NDL; ++kk)
#pragma unroll
              for (int u = 0; u < DPL; ++u) A[gi][kk][k][u] = 0;
          }
        }
        for (int j = 4 * grp; j < nw; j += 4 * ng) {
          const uint8_t* vrow = vst + (t0 + j) * p.kpitch + hh * p.rpitch;
          uint32_t aw[GM][3];
#pragma unroll
          for (int gi = 0; gi < GM; ++gi)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              aw[gi][k] = *reinterpret_cast<const uint32_t*>(
                  pa + (gi * 3 + k) * pw + j);
              if constexpr (BITS == 4)
                As[gi][k] = dp4a_ss(aw[gi][k], 0x01010101u, As[gi][k]);
            }
#pragma unroll
          for (int kk = 0; kk < NDL; ++kk) {
            const int dg = dg0 + 32 * kk;
            if (dg < ndg) {
              uint32_t w[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                w[i] = *reinterpret_cast<const uint32_t*>(
                    vrow + i * p.kpitch + dg * 4);
              uint32_t x[DPL];
              if constexpr (BITS == 8) {
                transpose4(w, x);
              } else {
                uint32_t lo[4], hi[4], xl[4], xh[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const uint32_t b = w[i] ^ 0x88888888u;
                  lo[i] = b & 0x0F0F0F0Fu;
                  hi[i] = (b >> 4) & 0x0F0F0F0Fu;
                }
                transpose4(lo, xl);
                transpose4(hi, xh);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  x[2 * i] = xl[i];
                  x[2 * i + 1] = xh[i];
                }
              }
#pragma unroll
              for (int gi = 0; gi < GM; ++gi) {
                if (gi < g) {
#pragma unroll
                  for (int k = 0; k < 3; ++k)
#pragma unroll
                    for (int u = 0; u < DPL; ++u)
                      A[gi][kk][k][u] =
                          BITS == 8 ? dp4a_ss(x[u], aw[gi][k], A[gi][kk][k][u])
                                    : dp4a_us(x[u], aw[gi][k], A[gi][kk][k][u]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int gi = 0; gi < GM; ++gi) {
          if (gi < g) {
#pragma unroll
            for (int kk = 0; kk < NDL; ++kk)
#pragma unroll
              for (int u = 0; u < DPL; ++u)
#pragma unroll
                for (int k = 0; k < 3; ++k)
                  acc[gi][kk][u] = fmaf(
                      static_cast<float>(A[gi][kk][k][u] -
                                         (BITS == 4 ? 8 * As[gi][k] : 0)),
                      psc[gi][k], acc[gi][kk][u]);
          }
        }
      }
    } else if (pv_lane && !(kProbe & 4)) {
      // two positions a step: both rows' loads issue before either's math
      for (int j = grp; j < nw; j += 2 * ng) {
        const bool two = j + ng < nw;
        const uint8_t* vrow0 = vst + (t0 + j) * p.kpitch + hh * p.rpitch;
        const uint8_t* vrow1 = two ? vrow0 + ng * p.kpitch : vrow0;
        float vv[2][NDL][DPL];
#pragma unroll
        for (int k = 0; k < NDL; ++k) {
          const int dg = dg0 + 32 * k;
          if (dg < ndg) {
            F::pv(vrow0, dg, vv[0][k]);
            F::pv(vrow1, dg, vv[1][k]);
          }
        }
        float pr[2][GM];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float* pp = pb + (j + x * ng) * kPPitch;
          if constexpr (GM == 1) {
            pr[x][0] = (x == 0 || two) ? pp[0] : 0.f;
          } else if constexpr (GM == 2) {
            const float2 v2 = *reinterpret_cast<const float2*>(pp);
            pr[x][0] = (x == 0 || two) ? v2.x : 0.f;
            pr[x][1] = (x == 0 || two) ? v2.y : 0.f;
          } else {
#pragma unroll
            for (int i = 0; i < GM / 4; ++i) {
              const float4 v4 = reinterpret_cast<const float4*>(pp)[i];
              pr[x][4 * i] = (x == 0 || two) ? v4.x : 0.f;
              pr[x][4 * i + 1] = (x == 0 || two) ? v4.y : 0.f;
              pr[x][4 * i + 2] = (x == 0 || two) ? v4.z : 0.f;
              pr[x][4 * i + 3] = (x == 0 || two) ? v4.w : 0.f;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < NDL; ++k) {
          if (dg0 + 32 * k < ndg) {
#pragma unroll
            for (int gi = 0; gi < GM; ++gi) {
              if (gi < g) {
#pragma unroll
                for (int u = 0; u < DPL; ++u) {
                  acc[gi][k][u] = fmaf(pr[0][gi], vv[0][k][u], acc[gi][k][u]);
                  acc[gi][k][u] = fmaf(pr[1][gi], vv[1][k][u], acc[gi][k][u]);
                }
              }
            }
          }
        }
      }
    }
    __syncwarp();
  }
  cp_wait<0>();
  __syncthreads();

  // the warps of each head, in order: their partials through the ring
  float* red = reinterpret_cast<float*>(ring);
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi < g) {
        wm[warp * kMaxG + gi] = m_w[gi];
        wl[warp * kMaxG + gi] = l_w[gi];
      }
    }
  }
  if (pv_lane) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi < g) {
#pragma unroll
        for (int k = 0; k < NDL; ++k) {
          const int dg = dg0 + 32 * k;
#pragma unroll
          for (int u = 0; u < DPL; ++u) {
            const int d = dg * DPL + u;
            if (dg < ndg && d < dh)
              red[((warp * ng + grp) * g + gi) * dh + d] = acc[gi][k][u];
          }
        }
      }
    }
  }
  __syncthreads();
  const int total = H * g * dh;
  const int wph = kWarps / H;
  for (int i = tid; i < total; i += kThreads) {
    const int r = i / dh, d = i - r * dh;  // r = head * g + query head
    const int hx = r / g, gi = r - hx * g;
    float mx = kNegInf;
    for (int pt = 0; pt < wph; ++pt) {
      const int w = pt * H + hx;
      if (wl[w * kMaxG + gi] > 0.f) mx = fmaxf(mx, wm[w * kMaxG + gi]);
    }
    float sa = 0.f, sl = 0.f;
    for (int pt = 0; pt < wph; ++pt) {
      const int w = pt * H + hx;
      const float l = wl[w * kMaxG + gi];
      if (l > 0.f) {
        const float f = expf(wm[w * kMaxG + gi] - mx);
        float sw = 0.f;
        for (int q = 0; q < ng; ++q)
          sw += red[((w * ng + q) * g + gi) * dh + d];
        sa += f * sw;
        sl += f * l;
      }
    }
    cacc[i] = sa;
    if (d == 0) {
      cm[r] = mx;
      cl[r] = sl;
    }
  }

  // the splits of this (slot, head group): each CTA's slice of the
  // workspace, m [H*g], l [H*g], acc [H*g*dh]; the last to arrive adds them
  float* ob = p.out + (static_cast<size_t>(bi) * p.kvh + h0) * g * dh;
  if (p.splits == 1) {
    __syncthreads();
    for (int i = tid; i < total; i += kThreads)
      ob[i] = cacc[i] / fmaxf(cl[i / dh], 1e-30f);
    return;
  }
  const int slice = H * g * (dh + 2);
  const int group = bi * (p.kvh / H) + blockIdx.y;
  float* wsg = p.ws + static_cast<size_t>(group) * p.splits * slice;
  float* mine = wsg + static_cast<size_t>(split) * slice;
  __syncthreads();
  for (int i = tid; i < H * g; i += kThreads) {
    mine[i] = cm[i];
    mine[H * g + i] = cl[i];
  }
  for (int i = tid; i < total; i += kThreads) mine[2 * H * g + i] = cacc[i];
  __threadfence();
  __syncthreads();
  int* last = tab;  // the walk is over: the table's first entry is free
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(p.cnt + group)
                 : "memory");
    *last = prev == p.splits - 1;
    if (*last) p.cnt[group] = 0;  // every split has arrived: ready for reuse
  }
  __syncthreads();
  if (!*last) return;
  for (int r = tid; r < H * g; r += kThreads) {
    float mx = kNegInf;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float* o = wsg + static_cast<size_t>(sp) * slice;
      if (__ldcg(o + H * g + r) > 0.f) mx = fmaxf(mx, __ldcg(o + r));
    }
    float sl = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float* o = wsg + static_cast<size_t>(sp) * slice;
      const float l = __ldcg(o + H * g + r);
      const float w = l > 0.f ? expf(__ldcg(o + r) - mx) : 0.f;
      ws[r * kMaxSplits + sp] = w;
      sl += w * l;
    }
    lt[r] = fmaxf(sl, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < total; i += kThreads) {
    const int r = i / dh;
    float sa = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float w = ws[r * kMaxSplits + sp];
      if (w != 0.f)
        sa += w * __ldcg(wsg + static_cast<size_t>(sp) * slice + 2 * H * g + i);
    }
    ob[i] = sa / lt[r];
  }
}

template <int BITS, int GM>
int launch(const Params& p, int b, int splits, int smem, cudaStream_t st,
           int* resident) {
  auto kern = paged_attention_kernel<BITS, GM>;
  // the shared-memory opt-in is per device: raise it once on each (up to
  // 64) to the largest size asked for
  static int granted[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024 && smem > granted[dev & 63]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted[dev & 63] = smem;
  }
  const dim3 grid(splits, p.kvh / p.heads, b);
  if (resident != nullptr) {
    // how many CTAs of this launch an SM holds at once
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, kern, kThreads, smem));
  }
  kern<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_g(const Params& p, int b, int splits, int smem, cudaStream_t st,
             int* resident) {
  if (p.g <= 1) return launch<BITS, 1>(p, b, splits, smem, st, resident);
  if (p.g <= 2) return launch<BITS, 2>(p, b, splits, smem, st, resident);
  if (p.g <= 4) return launch<BITS, 4>(p, b, splits, smem, st, resident);
  return launch<BITS, 8>(p, b, splits, smem, st, resident);
}

}  // namespace

// q: f32 (b, kvh, g, dh); k/v pools (P, page, kvh, dh) int8 / bf16 / f32 or
// (P, page, kvh, dh/2) uint8 (bits = 8 / 16 / 32 / 4); ks/vs: f32
// (P, page, kvh) for bits 8 and 4, else unused; table: int32 (b, nb);
// kv_len: int32 (b,); out: f32 (b, kvh, g, dh).  The plan's geometry (and
// its shared-memory size, checked here against the kernel's own layout)
// comes in ``a``.  Launches on ``stream``, does not synchronise, returns
// cudaGetLastError() (0 when the launch was accepted).
static int dispatch(const void* q, const void* kp, const void* vp,
                    const void* ks, const void* vs, const void* table,
                    const void* kv_len, void* out, const AttentionArgs* a,
                    void* stream, int* resident) {
  if (a->b <= 0 || a->kvh <= 0) return 0;
  const int bits = a->bits, H = a->heads;
  const int wph = H >= 1 && H <= kWarps ? kWarps / H : 0;
  const int pw = wph ? a->chunk / wph : 0;
  if (a->g < 1 || a->g > kMaxG || a->dh < 1 || a->dh > kMaxDh ||
      a->page < 1 || a->nb < 1 || a->splits < 1 ||
      a->splits > kMaxSplits || (a->splits > 1 && !(a->ws && a->cnt)) ||
      a->split_len < 1 || a->splits * a->split_len < a->nb * a->page ||
      !(H == 1 || H == 2 || H == 4) || a->kvh % H ||
      a->chunk != pw * wph || !(pw == 4 || pw == 8 || pw == 16 || pw == 32) ||
      !(bits == 8 || bits == 4 || bits == 16 || bits == 32) ||
      (bits == 4 && a->dh % 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout l = layout(a->g, a->dh, bits, H, a->chunk, a->n_tab);
  if (l.total != a->smem || l.total > kMaxSmem ||
      a->n_tab < (a->split_len + a->page - 1) / a->page + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = static_cast<const float*>(q);
  p.kp = static_cast<const uint8_t*>(kp);
  p.vp = static_cast<const uint8_t*>(vp);
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.table = static_cast<const int*>(table);
  p.kv_len = static_cast<const int*>(kv_len);
  p.out = static_cast<float*>(out);
  p.ws = static_cast<float*>(a->ws);
  p.cnt = static_cast<int*>(a->cnt);
  p.splits = a->splits;
  p.kvh = a->kvh;
  p.g = a->g;
  p.dh = a->dh;
  p.page = a->page;
  p.nb = a->nb;
  p.window = a->window;
  p.split_len = a->split_len;
  p.heads = H;
  p.chunk = a->chunk;
  p.row_bytes = l.row_bytes;
  p.units = l.units;
  p.rpitch = l.rpitch;
  p.kpitch = l.kpitch;
  p.qp = l.qp;
  p.ndg = l.ndg;
  p.ng = l.ng;
  p.stage = l.stage;
  // copy widths: a position's run of rows (whole units) or one row, and a
  // position's run of H scales
  const int run = l.rpitch == l.row_bytes ? H * l.row_bytes : l.row_bytes;
  const uintptr_t al = reinterpret_cast<uintptr_t>(kp) |
                       reinterpret_cast<uintptr_t>(vp);
  p.vec = (run % 16 == 0 && al % 16 == 0)  ? 16
          : (run % 8 == 0 && al % 8 == 0) ? 8
          : (run % 4 == 0 && al % 4 == 0) ? 4
                                           : 0;
  const uintptr_t als = reinterpret_cast<uintptr_t>(ks) |
                        reinterpret_cast<uintptr_t>(vs);
  p.vec_s = (H > 1 && als % (4 * H) == 0) ? 4 * H : 4;
  p.off_q = l.off_q;
  p.off_p = l.off_p;
  p.off_acc = l.off_acc;
  p.off_st = l.off_st;
  p.off_tab = l.off_tab;
  p.sm_scale = a->sm_scale;
  p.softcap = a->softcap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 8:
      return launch_g<8>(p, a->b, a->splits, a->smem, st, resident);
    case 4:
      return launch_g<4>(p, a->b, a->splits, a->smem, st, resident);
    case 16:
      return launch_g<16>(p, a->b, a->splits, a->smem, st, resident);
    default:
      return launch_g<32>(p, a->b, a->splits, a->smem, st, resident);
  }
}

extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* table,
                                      const void* kv_len, void* out,
                                      const AttentionArgs* a, void* stream) {
  return dispatch(q, kp, vp, ks, vs, table, kv_len, out, a, stream, nullptr);
}

// The CTAs of the launch ``a`` describes that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into ``resident``;
// nothing runs.
extern "C" int paged_attention_resident(const AttentionArgs* a,
                                        int* resident) {
  *resident = 0;
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, a, nullptr, resident);
}
