// Shared machinery of the two weight-matmul kernels (packed_matmul.cu,
// bitplane_matmul.cu) for Hopper (sm_90a): the split-K geometry, the
// deterministic self-resetting split-K reduction, the bf16 hi/lo weight
// split, mma.sync / ldmatrix fragments, the cp.async ring, and the two
// kernel skeletons.  Each .cu file supplies a decoder (how its wire format
// turns into f32 weights); the skeletons do the rest.
//
// y[M, N] = x[M, K] @ W with f32 accumulation, W decoded from a compressed
// wire format.  Two regimes, chosen per call by the wrapper's plan
// (kernels/tiling.py::matmul_plan):
//
// * stream (M <= 16: decode, the speculative draft, verify up to 3
//   drafts).  Bound by the weight bytes over HBM, and on the H100 as much
//   by latency: launch, the round trips to HBM and the split-K arrival
//   each cost about a microsecond beside the few microseconds the bytes
//   take.  A block owns 128 output columns, 4 rows of x and one K slice;
//   its 256 threads each load 16 bytes a row (8
//   threads cover a 128-byte row, 32 rows at a time), the next batch of
//   rows loading while this one is used; the block's slice of x is staged
//   once in shared memory as f32, after the first weight loads are issued.
//   f32 FMAs on the CUDA cores.  Split-K gives every phi3 shape at least
//   2 * 132 blocks, two resident an SM.  M > 4 takes more row tiles
//   (grid y), each reading the same weight slice, mostly from L2 (on the
//   H100, two 4-row tiles beat one 8-row block: fewer registers, more
//   loads in flight).
// * tensor (M > 16: verify, prefill).  Bound by operations.  A block
//   computes a BM x 128 output tile (BM 32 or 128) over one K slice; raw x
//   and weight tiles (32 K rows each) flow through a 4-stage cp.async ring;
//   each weight tile is decoded once per block into bf16 hi/lo tiles
//   (w = hi + lo to ~2^-16 relative) in shared memory, double-buffered so
//   that tile t+1 is decoded while tile t is multiplied (one barrier a
//   tile), and mma.sync m16n8k16 bf16 -> f32 takes x_hi*hi + x_hi*lo
//   (+ x_lo*hi for f32 x).  The tensor cores add into their f32
//   accumulator with truncation, which biases a long sum: each 32-row
//   tile's products start from zero and are added to the running sum by
//   rounded f32 adds, so the truncation never spans more than 32 rows.
//
// Split-K reduction: each block writes its partial tile to a workspace
// slice; the last block of a tile to arrive (an atomic counter per tile,
// which that block resets to 0) adds the slices in slice order.  No float
// atomics, so a launch's result does not change from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Measurement switches, 0 in the port's build.  scripts/matmul_probe.py
// builds variants with -DWMM_PROBE=<mask>: each of the first five takes a
// stage out (the variant computes garbage and only its time is read);
// kProbeChain keeps a whole K slice in the tensor cores' accumulator, the
// first design, for its error and its time.
#ifndef WMM_PROBE
#define WMM_PROBE 0
#endif

namespace wmm {

constexpr int kProbe = WMM_PROBE;
constexpr int kProbeLaunch = 1;     // every block returns at once
constexpr int kProbeNoReduce = 2;   // no split-K arrival and reduction
constexpr int kProbeNoCompute = 4;  // stream: weights loaded, not multiplied
constexpr int kProbeNoDecode = 8;   // tensor: no weight decode
constexpr int kProbeNoLoads = 16;   // tensor: no tile loads
constexpr int kProbeChain = 32;     // tensor: one accumulator per K slice

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;            // output columns a block owns
constexpr int kBK = 32;             // K rows of one tensor-regime tile
constexpr int kStages = 4;          // cp.async ring depth
constexpr int kXPadBF = kBK + 8;    // bf16 row pitch of x tiles (elements)
constexpr int kXPadF = kBK + 4;     // f32 row pitch of raw f32 x tiles
constexpr int kWPitch = kBN + 8;    // bf16 row pitch of decoded weights
constexpr int kXStage = 8192;       // f32 words of the stream x stage

struct Geo {
  const void* x;
  int ldx, m, kend, x_bf16;
  int n, gc, wbr, wbc;
  float rwbr, rwbc;  // 1 / wbr, 1 / wbc (for div_r)
  int wshift;      // log2(wbr) when the stream fast path may use it
  int aligned;     // tensor regime: 16-byte cp.async legal for x and w
  float* out;
  float* ws;       // (ksplit, m, n) partial sums when ksplit > 1
  int* cnt;        // one arrival counter per output tile, left at 0
  int ksplit, kchunk;
};

// ---------------------------------------------------------------- helpers

// a / d for 0 <= a < 2^22, from r = 1.f / d, in three instructions instead
// of an integer division's ~20: (a + 0.5) / d lies at least 0.5 / d from
// an integer and the two float roundings move it by under 2^-23 of itself,
// so truncation is exact
__device__ __forceinline__ int div_r(int a, float r) {
  return static_cast<int>((static_cast<float>(a) + 0.5f) * r);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int sz = pred ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(sz));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// w = hi + lo with both bf16: the pair keeps ~16 significant bits where one
// bf16 keeps 8 (the difference between 1e-6 and 1e-3 of the output).  2 or
// 4 adjacent weights of one row are stored as packed bf16 pairs (one 4- or
// 8-byte shared-memory store each for hi and lo).
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void split_pair(float a, float b, uint32_t* hi,
                                           uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  *hi = bf2_bits(h);
  *lo = bf2_bits(__floats2bfloat162_rn(a - f.x, b - f.y));
}
__device__ __forceinline__ void store_split2(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo, float a,
                                             float b) {
  uint32_t h, l;
  split_pair(a, b, &h, &l);
  *reinterpret_cast<uint32_t*>(hi) = h;
  *reinterpret_cast<uint32_t*>(lo) = l;
}
__device__ __forceinline__ void store_split4(__nv_bfloat16* hi,
                                             __nv_bfloat16* lo,
                                             const float* v) {
  uint2 h, l;
  split_pair(v[0], v[1], &h.x, &l.x);
  split_pair(v[2], v[3], &h.y, &l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

// byte i of v as a float plus 2^23 (exact, no I2F: one PRMT and the caller
// subtracts the offset with one FADD)
__device__ __forceinline__ float byte_f(uint32_t v, int i) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440u | i));
}
constexpr float kMagic = 8388608.f;   // 2^23

__device__ __forceinline__ uint32_t word_of(const uint4& v, int t) {
  return t == 0 ? v.x : t == 1 ? v.y : t == 2 ? v.z : v.w;
}

// 16 bytes of one weight row at columns c0..c0+15; zeros past n.  FAST:
// one 16-byte load (n % 16 == 0 and a 16-byte-aligned row).
template <bool FAST>
__device__ __forceinline__ uint4 load16(const uint8_t* row, int c0, int n) {
  if constexpr (FAST) {
    if (c0 >= n) return make_uint4(0, 0, 0, 0);
    // read once: no L1 allocation; ask L2 for the whole 256-byte sector
    // group, which the neighbouring column tile reads next
    uint4 v;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0,%1,%2,%3}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(row + c0));
    return v;
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (c0 + j < n) w[j >> 2] |= static_cast<uint32_t>(row[c0 + j])
                                   << (8 * (j & 3));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ float load_x(const Geo& g, int m, int k) {
  const size_t i = static_cast<size_t>(m) * g.ldx + k;
  return g.x_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(g.x)[i])
                  : static_cast<const float*>(g.x)[i];
}

// ------------------------------------------------------- split-K reduction

// Called by every thread of a block after it wrote its partial tile.
// True in the last block to arrive at ``tile``, which has reset the
// counter and may now read every slice.  The barrier orders the block's
// writes before thread 0's release-acquire atomic (as CUTLASS's semaphore
// does), and the barrier after it orders every later read after it.
__device__ __forceinline__ bool arrive_last(const Geo& g, int tile) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(g.cnt + tile)
                 : "memory");
    last = prev == g.ksplit - 1;
    if (last) g.cnt[tile] = 0;   // every slice has arrived: ready for reuse
  }
  __syncthreads();
  return last;
}

// out[r, c] = sum over slices s in order of ws[s, r, c], rows [r0, r1),
// columns [c0, c1); eight slices' loads in flight at a time
__device__ __forceinline__ void reduce_slices(const Geo& g, int r0, int r1,
                                              int c0, int c1) {
  const int w = c1 - c0;
  const float rw = 1.f / static_cast<float>(w);
  const size_t plane = static_cast<size_t>(g.m) * g.n;
  for (int e = threadIdx.x; e < (r1 - r0) * w; e += kThreads) {
    const int r = div_r(e, rw);
    const float* src = g.ws + static_cast<size_t>(r0 + r) * g.n + c0 + e -
                       r * w;
    float s = 0.f;
    for (int q0 = 0; q0 < g.ksplit; q0 += 8) {
      float v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        v[q] = q0 + q < g.ksplit ? __ldcg(src + (q0 + q) * plane) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q0 + q < g.ksplit) s += v[q];
      }
    }
    g.out[src - g.ws] = s;
  }
}

// ------------------------------------------------------- stream regime

// Dec::stream<MB, FAST>(acc, xs, kpad, k0, k1, rg, c0, g, stage_x) adds
// this thread's share of the slice [k0, k1) to acc[m][j] (row m, column
// c0 + j), walking its units (int8 row, int4 byte row, bit-plane byte row)
// rg, rg + 32, ...; it calls stage_x() exactly once, after issuing its
// first loads, which fills xs[m * kpad + k - k0] with x as f32 (zero past
// k1) and synchronises the block.
template <int MB, bool FAST, class Dec>
__global__ void __launch_bounds__(kThreads, 2)
stream_kernel(Geo gm, Dec dec) {
  __shared__ __align__(16) float smem[kXStage];
  if constexpr (kProbe & kProbeLaunch) return;
  // this block's row tile: rows [m0, m0 + MB) of x and out, its own
  // workspace region (ksplit slices of its rows) and arrival counters
  const int m0 = blockIdx.y * MB;
  Geo g = gm;
  g.x = static_cast<const char*>(gm.x) +
        static_cast<size_t>(m0) * gm.ldx * (gm.x_bf16 ? 2 : 4);
  g.m = min(MB, gm.m - m0);
  g.out = gm.out + static_cast<size_t>(m0) * gm.n;
  g.ws = gm.ws + static_cast<size_t>(blockIdx.y) * gm.ksplit * MB * gm.n;
  g.cnt = gm.cnt + blockIdx.y * gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int s = blockIdx.z;
  const int k0 = s * g.kchunk;
  const int k1 = min(g.kend, k0 + g.kchunk);
  const int klen = max(k1 - k0, 0);
  const int kpad = (klen + 7) & ~7;
  const float rkpad = 1.f / static_cast<float>(max(kpad, 1));
  // every thread calls this once, after issuing its first weight loads, so
  // the x stage and those loads are in flight together
  auto stage_x = [&]() {
    for (int e = tid; e < MB * kpad; e += kThreads) {
      const int m = div_r(e, rkpad), kk = e - m * kpad;
      smem[e] = (m < g.m && kk < klen) ? load_x(g, m, k0 + kk) : 0.f;
    }
    __syncthreads();
  };

  const int chunk = lane & 7;          // 16-byte column chunk of the row
  const int rg = warp * 4 + (lane >> 3);   // row group 0..31
  const int c0 = n0 + chunk * 16;
  float acc[MB][16];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;
  dec.template stream<MB, FAST>(acc, smem, kpad, k0, k1, rg, c0, g, stage_x);

  // the warp's 4 row groups share columns: lanes l, l^8, l^16, l^24
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  __syncthreads();                     // x stage no longer read
  if (lane < 8) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        smem[(warp * MB + m) * kBN + chunk * 16 + j] = acc[m][j];
  }
  __syncthreads();
  float* dst = g.ksplit > 1
                   ? g.ws + static_cast<size_t>(s) * g.m * g.n
                   : g.out;
  for (int e = tid; e < MB * kBN; e += kThreads) {
    const int m = e / kBN, c = e - m * kBN;
    if (m < g.m && n0 + c < g.n) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += smem[(w * MB + m) * kBN + c];
      dst[static_cast<size_t>(m) * g.n + n0 + c] = v;
    }
  }
  if (!(kProbe & kProbeNoReduce) && g.ksplit > 1 &&
      arrive_last(g, blockIdx.x)) {
    reduce_slices(g, 0, g.m, n0, min(n0 + kBN, g.n));
  }
}

// ------------------------------------------------------- tensor regime

template <int MI, bool XBF16, class Dec>
struct TensorSmem {
  static constexpr int BM = 32 * MI;
  static constexpr int kXPitch = XBF16 ? kXPadBF * 2 : kXPadF * 4;  // bytes
  static constexpr int kX = BM * kXPitch;
  static constexpr int kW = Dec::kRawRows * kBN + Dec::kMetaFloats * 4;
  static constexpr int kStage = kX + kW;
  static constexpr int kDec = kBK * kWPitch * 2;          // one bf16 tile
  static constexpr int kSplitX = XBF16 ? 0 : BM * kXPadBF * 2;
  // the ring, then two decoded weight tiles (hi, lo) and, for f32 x, two
  // split x tiles (hi, lo): tile t+1 is decoded while tile t is multiplied
  static constexpr int kDecOff = kStages * kStage;
  static constexpr int kSplitOff = kDecOff + 4 * kDec;
  static constexpr int kBytes = kSplitOff + 4 * kSplitX;
};

// The per-WB entries (scales; for bit-planes also the mask planes) that a
// tensor tile (K rows [kt, min(kt+32, k1)), columns [n0, min(n0+128, n)))
// reads: WB rows g0..g0+nr-1 x WB columns h0..h0+nc-1.  They ride the
// cp.async ring with the tile's raw bytes, so the decode step reads them
// from shared memory instead of waiting on L2 for every tile; a box larger
// than the decoder's budget (very small WBs) is read from global memory.
struct MetaBox {
  int g0, h0, nr, nc;
  __device__ __forceinline__ MetaBox(int kt, int k1, int n0, const Geo& g) {
    const int kl = min(kt + kBK, k1) - 1;
    const int nl = min(n0 + kBN, g.n) - 1;
    g0 = div_r(kt, g.rwbr);
    nr = div_r(kl, g.rwbr) - g0 + 1;
    h0 = div_r(n0, g.rwbc);
    nc = div_r(nl, g.rwbc) - h0 + 1;
  }
  __device__ __forceinline__ int size() const { return nr * nc; }
  __device__ __forceinline__ int at(int gi, int h) const {
    return (gi - g0) * nc + h - h0;
  }
};

// planes x box entries of ``src`` (plane stride ``pstride`` floats, row
// stride g.gc) into dst[p * box.size() + box.at(gi, h)]
__device__ __forceinline__ void stage_meta(float* dst, const float* src,
                                           int planes, size_t pstride,
                                           const MetaBox& box, const Geo& g) {
  const int per = box.size();
  const float rper = 1.f / static_cast<float>(per);
  const float rnc = 1.f / static_cast<float>(box.nc);
  for (int e = threadIdx.x; e < planes * per; e += kThreads) {
    const int p = div_r(e, rper), rem = e - p * per;
    const int r = div_r(rem, rnc), c = rem - r * box.nc;
    cp_async4(dst + e, src + p * pstride +
                           static_cast<size_t>(box.g0 + r) * g.gc + box.h0 +
                           c);
  }
}

// raw x tile: rows m0.., K columns kt..kt+31, zero past m and k1
template <int BM, bool XBF16>
__device__ __forceinline__ void load_x_tile(const Geo& g, unsigned char* st,
                                            int m0, int kt, int k1) {
  constexpr int E = XBF16 ? 2 : 4;
  constexpr int kPitch = XBF16 ? kXPadBF * 2 : kXPadF * 4;
  const unsigned char* xb = static_cast<const unsigned char*>(g.x);
  if (g.aligned) {
    constexpr int kChunks = kBK * E / 16;
    for (int c = threadIdx.x; c < BM * kChunks; c += kThreads) {
      const int r = c / kChunks, q = c - r * kChunks;
      const int k = kt + q * (16 / E);
      const bool ok = m0 + r < g.m && k < k1;
      const unsigned char* src =
          ok ? xb + (static_cast<size_t>(m0 + r) * g.ldx + k) * E : xb;
      cp_async16(st + r * kPitch + q * 16, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, c = e - r * kBK;
      const int k = kt + c;
      const bool ok = m0 + r < g.m && k < k1;
      const size_t i = static_cast<size_t>(m0 + r) * g.ldx + k;
      if constexpr (XBF16) {
        *reinterpret_cast<uint16_t*>(st + r * kPitch + c * 2) =
            ok ? reinterpret_cast<const uint16_t*>(g.x)[i] : uint16_t(0);
      } else {
        *reinterpret_cast<float*>(st + r * kPitch + c * 4) =
            ok ? static_cast<const float*>(g.x)[i] : 0.f;
      }
    }
  }
}

// f32 x tile -> bf16 hi/lo tiles (x = hi + lo), 4 values a thread a step
template <int BM>
__device__ __forceinline__ void split_x_tile(const unsigned char* st,
                                             __nv_bfloat16* xhi,
                                             __nv_bfloat16* xlo) {
  const float* xs = reinterpret_cast<const float*>(st);
  constexpr int kQuads = kBK / 4;
  for (int e = threadIdx.x; e < BM * kQuads; e += kThreads) {
    const int r = e / kQuads, c = (e - r * kQuads) * 4;
    const float4 v = *reinterpret_cast<const float4*>(xs + r * kXPadF + c);
    const float f[4] = {v.x, v.y, v.z, v.w};
    store_split4(xhi + r * kXPadBF + c, xlo + r * kXPadBF + c, f);
  }
}

// Dec::load_raw(st, kt, k1, n0, g) stages the raw weight bytes of K rows
// [kt, kt+32) x columns [n0, n0+128) (cp.async when g.aligned);
// Dec::decode(st, kt, k1, n0, g, whi, wlo) writes the tile's f32 weights,
// zero at k >= k1 or n >= g.n, as bf16 hi/lo [32][kWPitch].
template <int MI, bool XBF16, class Dec>
__global__ void __launch_bounds__(kThreads, XBF16 ? 2 : 1)
tensor_kernel(Geo g, Dec dec) {
  using S = TensorSmem<MI, XBF16, Dec>;
  constexpr int BM = S::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kProbe & kProbeLaunch) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int s = blockIdx.z;
  const int k0 = s * g.kchunk;
  const int k1 = min(g.kend, k0 + g.kchunk);
  const int ntiles = k1 > k0 ? (k1 - k0 + kBK - 1) / kBK : 0;

  auto stage = [&](int t) { return smem + (t % kStages) * S::kStage; };
  auto wdec = [&](int t) {       // hi tile of tile t; lo follows it
    return reinterpret_cast<__nv_bfloat16*>(smem + S::kDecOff +
                                            (t & 1) * 2 * S::kDec);
  };
  auto xsplit = [&](int t) {     // f32 x: hi tile of tile t; lo follows
    return reinterpret_cast<__nv_bfloat16*>(smem + S::kSplitOff +
                                            (t & 1) * 2 * S::kSplitX);
  };
  auto load_tile = [&](int t) {
    if constexpr (kProbe & kProbeNoLoads) return;
    const int kt = k0 + t * kBK;
    load_x_tile<BM, XBF16>(g, stage(t), m0, kt, k1);
    dec.load_raw(stage(t) + S::kX, kt, k1, n0, g);
  };
  auto decode_tile = [&](int t) {
    if constexpr (kProbe & kProbeNoDecode) return;
    __nv_bfloat16* wh = wdec(t);
    dec.decode(stage(t) + S::kX, k0 + t * kBK, k1, n0, g, wh,
               wh + kBK * kWPitch);
    if constexpr (!XBF16) {
      __nv_bfloat16* xh = xsplit(t);
      split_x_tile<BM>(stage(t), xh, xh + BM * kXPadBF);
    }
  };

  // warp grid 2 (rows) x 4 (columns); a warp owns (16*MI) x 32 outputs
  const int wm = warp >> 2, wn = warp & 3;
  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();
  if (ntiles > 0) decode_tile(0);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 3>();
    __syncthreads();    // tile t decoded, tile t+1 landed, tile t-1 done
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    cp_async_commit();
    if (t + 1 < ntiles) decode_tile(t + 1);   // overlaps tile t's products

    const __nv_bfloat16* whi = wdec(t);
    const __nv_bfloat16* wlo = whi + kBK * kWPitch;
    const __nv_bfloat16* xa =
        XBF16 ? reinterpret_cast<const __nv_bfloat16*>(stage(t)) : xsplit(t);
    const __nv_bfloat16* xlo = xa + BM * kXPadBF;     // f32 x only
    // this tile's products from zero, added to acc after the tile
    float part[MI][4][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[MI][4], al[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = wm * 16 * MI + i * 16 + (lane & 15);
        const int col = ks * 16 + (lane >> 4) * 8;
        ldsm_x4(a[i], xa + row * kXPadBF + col);
        if constexpr (!XBF16) ldsm_x4(al[i], xlo + row * kXPadBF + col);
      }
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int krow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ncol = wn * 32 + jp * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ldsm_x4_t(r, whi + krow * kWPitch + ncol);
        bh[2 * jp][0] = r[0];
        bh[2 * jp][1] = r[1];
        bh[2 * jp + 1][0] = r[2];
        bh[2 * jp + 1][1] = r[3];
        ldsm_x4_t(r, wlo + krow * kWPitch + ncol);
        bl[2 * jp][0] = r[0];
        bl[2 * jp][1] = r[1];
        bl[2 * jp + 1][0] = r[2];
        bl[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kProbe & kProbeChain) {
            mma_bf16(acc[i][j], a[i], bh[j]);
            mma_bf16(acc[i][j], a[i], bl[j]);
            if constexpr (!XBF16) mma_bf16(acc[i][j], al[i], bh[j]);
          } else {
            mma_bf16(part[i][j], a[i], bh[j]);
            mma_bf16(part[i][j], a[i], bl[j]);
            if constexpr (!XBF16) mma_bf16(part[i][j], al[i], bh[j]);
          }
        }
    }
    if constexpr (!(kProbe & kProbeChain)) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
    }
  }
  cp_async_wait<0>();

  float* dst = g.ksplit > 1
                   ? g.ws + static_cast<size_t>(s) * g.m * g.n
                   : g.out;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + wm * 16 * MI + i * 16 + (lane >> 2) + (q >> 1) * 8;
        const int col = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + (q & 1);
        if (row < g.m && col < g.n)
          dst[static_cast<size_t>(row) * g.n + col] = acc[i][j][q];
      }
  if (!(kProbe & kProbeNoReduce) && g.ksplit > 1 &&
      arrive_last(g, blockIdx.y * gridDim.x + blockIdx.x)) {
    reduce_slices(g, m0, min(m0 + BM, g.m), n0, min(n0 + kBN, g.n));
  }
}

// --------------------------------------------------------------- launch

template <int MI, bool XBF16, class Dec>
int launch_tensor(const Geo& g, const Dec& dec, cudaStream_t st) {
  using S = TensorSmem<MI, XBF16, Dec>;
  auto kern = tensor_kernel<MI, XBF16, Dec>;
  // the shared-memory opt-in is per device: set once on each (up to 64)
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(done & bit)) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    done |= bit;
  }
  const dim3 grid((g.n + kBN - 1) / kBN, (g.m + S::BM - 1) / S::BM,
                  g.ksplit);
  kern<<<grid, kThreads, S::kBytes, st>>>(g, dec);
  return static_cast<int>(cudaGetLastError());
}

template <int MB, bool FAST, class Dec>
int launch_stream(const Geo& g, const Dec& dec, cudaStream_t st) {
  const dim3 grid((g.n + kBN - 1) / kBN, (g.m + MB - 1) / MB, g.ksplit);
  stream_kernel<MB, FAST, Dec><<<grid, kThreads, 0, st>>>(g, dec);
  return static_cast<int>(cudaGetLastError());
}

// regime 0: stream with row tiles of ``rows`` = 4; regime 1: tensor with
// BM = ``rows`` (32 or 128).  ``fast``: the stream fast path's
// conditions hold (checked by the caller for its format).
template <class Dec>
int launch(const Geo& g, const Dec& dec, int regime, int rows, bool fast,
           cudaStream_t st) {
  if (regime == 0) {
    const int klen = g.kchunk < g.kend ? g.kchunk : g.kend;
    if (rows != 4 || ((klen + 7) & ~7) * rows > kXStage)
      return static_cast<int>(cudaErrorInvalidValue);
    return fast ? launch_stream<4, true>(g, dec, st)
                : launch_stream<4, false>(g, dec, st);
  }
  if (g.kchunk % kBK) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 32) {
    return g.x_bf16 ? launch_tensor<1, true>(g, dec, st)
                    : launch_tensor<1, false>(g, dec, st);
  } else if (rows == 128) {
    return g.x_bf16 ? launch_tensor<4, true>(g, dec, st)
                    : launch_tensor<4, false>(g, dec, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wmm
