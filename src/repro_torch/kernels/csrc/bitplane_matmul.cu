// Bit-plane-sliced mixed-precision matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/bitplane_matmul.py::bitplane_matmul
// (kernel body _kernel):
//     y[M, N] = x[M, K] @ W,
//     W[k, n] = (1 - 2 sign[k, n]) * sum_b 2^b plane_b[k, n] mask_b[k/wbr, n/wbc]
//               * scale
// with the planes and the sign plane packed 8 rows per byte (row 8j+r is bit
// r of byte row j), mask the binary (bit, block) LUT and scale either the
// per-WB effective f32 LUT (K/wbr, N/wbc), applied as is, or a per-layer
// scalar divided by 2^n - 1.  x (M, kx) is f32 or bf16; f32 accumulation
// and output.  Rows past kend = min(kx, GR * wbr) are never used: x is zero
// there (x narrower than K), or they are byte-pad rows with no mask or
// scale entry (odd block-padded K, e.g. 63 rows of 9x8 blocks in 64).  The
// live-plane set and scale of a row are looked up by index (k / wbr,
// n / wbc), so any WB geometry works; each row's magnitude keeps only its
// own live planes, so the draft model's truncated masks (which zero the LOW
// planes) are honoured plane by plane.
//
// Two regimes (wmm_common.cuh; the plan from kernels/tiling.py):
//
// * stream, M <= 16 (decode, the draft, short verify).  Bound on an H100 SXM
//   by the bytes over the 3.35 TB/s of HBM: one bit per live (plane,
//   weight) plus the sign bit of every live block, which is what BWQ's
//   per-block precision buys.  A thread takes 16 columns of a byte row:
//   it looks up the row's live planes, loads 16 bytes of each live plane
//   only (a fully masked block is not read at all) and of the sign, and
//   composes 4 columns' magnitudes at once with two 32-bit operations a
//   plane (shift, and-or: the 8x8 bit transpose, 4 columns at a time); one
//   fma turns a magnitude into its scaled float exactly.  The next unit's
//   live set is looked up before this one is used.  Split-K fills the
//   card, x (4 rows a block; more rows take more row tiles) comes from
//   shared memory.  The bit work (~12 operations a weight) makes the CUDA
//   cores, not HBM, the nearer limit at 5-6 live planes.
// * tensor, M > 16 (longer verify, prefill).  Bound by operations: the
//   composed weight tile (all planes staged through the cp.async ring) is
//   decoded once per block into bf16 hi/lo tiles, 4 columns at a time by
//   the same 32-bit plane arithmetic, and multiplied on the tensor cores,
//   2 (bf16 x) or 3 (f32 x) products a weight.
//
// Left for later: wgmma with a TMA-fed producer warp, TMA multicast of a
// weight tile to the blocks of a cluster that share it, a persistent
// schedule, and skipping dead planes in the tensor regime's loads.
#include "wmm_common.cuh"

namespace {

using namespace wmm;

struct BitplaneDec {
  const uint8_t* planes;
  const uint8_t* sign;
  const float* mask;
  const float* scale;
  long long pstride;
  int nbits, gr, per_block;
  static constexpr int kSignRow = 8 * (kBK / 8);      // raw row of the sign
  static constexpr int kRawRows = 9 * (kBK / 8);      // 8 planes + sign
  static constexpr int kMetaFloats = 1024;  // staged mask planes and scales

  // live planes of WB (gi, h) as bits 0..nbits-1
  __device__ __forceinline__ uint32_t live_at(int gi, int h,
                                              const Geo& g) const {
    const float* mp = mask + static_cast<size_t>(gi) * g.gc + h;
    const size_t ms = static_cast<size_t>(gr) * g.gc;
    uint32_t live = 0;
    for (int b = 0; b < nbits; ++b) {
      live |= (__ldg(mp + b * ms) != 0.f ? 1u : 0u) << b;
    }
    return live;
  }
  __device__ __forceinline__ float layer_scale() const {
    return per_block ? 0.f
                     : __ldg(scale) / static_cast<float>((1 << nbits) - 1);
  }
  __device__ __forceinline__ float scale_at(int gi, int h, float s_l,
                                            const Geo& g) const {
    return per_block ? __ldg(scale + static_cast<size_t>(gi) * g.gc + h)
                     : s_l;
  }

  // live planes and scale of WB (gi, h) in the tensor regime, from the
  // staged box (``meta``) or, for boxes over budget, global memory
  __device__ __forceinline__ uint32_t wb_lookup(const float* meta,
                                                const MetaBox& box, int gi,
                                                int h, float s_l,
                                                const Geo& g,
                                                float* sc) const {
    if (!meta) {
      *sc = scale_at(gi, h, s_l, g);
      return live_at(gi, h, g);
    }
    const int per = box.size(), at = box.at(gi, h);
    uint32_t live = 0;
    for (int b = 0; b < nbits; ++b) {
      live |= (meta[b * per + at] != 0.f ? 1u : 0u) << b;
    }
    *sc = per_block ? meta[nbits * per + at] : s_l;
    return live;
  }

  // ---- stream regime: a unit is a byte row (8 K rows)
  template <int MB, bool FAST, class Stage>
  __device__ __forceinline__ void stream(float (&acc)[MB][16],
                                         const float* xs, int kpad, int k0,
                                         int k1, int rg, int c0, const Geo& g,
                                         Stage&& stage_x) const {
    const bool on = c0 < g.n;              // columns past n walk nothing
    const float s_l = layer_scale();
    const int j1 = on ? (k1 + 7) >> 3 : 0;
    int j = (k0 >> 3) + rg;
    if constexpr (FAST) {
      // wbr is a power of two >= 8 and wbc % 16 == 0: a unit's 8 x 16
      // weights share one WB, so one live set and one scale
      const int h = on ? c0 / g.wbc : 0;
      uint4 p[8], sg;
      uint32_t live, live_next;
      float sc, sc_next;
      // a unit's live planes and scale (one round trip), then its live
      // planes' bytes (a second): the next unit's lookup is issued before
      // this unit's compute, so only the plane bytes wait after it
      auto lookup = [&](int jj, uint32_t& lv, float& s) {
        lv = 0;
        s = 0.f;
        if (jj >= j1) return;
        const int gi = (jj * 8) >> g.wshift;
        lv = live_at(gi, h, g);
        s = scale_at(gi, h, s_l, g);       // beside the mask, not after it
      };
      auto load = [&](int jj) {
        sg = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int b = 0; b < 8; ++b) p[b] = make_uint4(0, 0, 0, 0);
        if (live == 0) return;               // fully masked: read nothing
        const size_t row = static_cast<size_t>(jj) * g.n;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if ((live >> b) & 1u) {
            p[b] = load16<true>(planes + b * pstride + row, c0, g.n);
          }
        }
        sg = load16<true>(sign + row, c0, g.n);
      };
      lookup(j, live, sc);
      load(j);
      stage_x();
      for (; j < j1; j += 32) {
        lookup(j + 32, live_next, sc_next);
        if constexpr (kProbe & kProbeNoCompute) {
          acc[0][0] += __uint_as_float(p[0].x ^ p[1].y ^ p[2].z ^ p[3].w ^
                                       p[4].x ^ p[5].y ^ p[6].z ^ p[7].w ^
                                       sg.x);
        } else if (live) {
          const int kb = j * 8 - k0;
          const float nsc = -kMagic * sc;    // exact: a power of two times sc
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            float xv[MB];
#pragma unroll
            for (int m = 0; m < MB; ++m) xv[m] = xs[m * kpad + kb + r];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              // byte c of mag: row r's magnitude in column 4t + c, bit b
              // from bit r of plane b's byte (dead planes are zero)
              uint32_t mag = 0;
#pragma unroll
              for (int b = 0; b < 8; ++b) {
                const uint32_t wd = word_of(p[b], t);
                const uint32_t sh = r >= b ? wd >> (r - b) : wd << (b - r);
                mag |= sh & (0x01010101u << b);
              }
              const uint32_t sw = word_of(sg, t);
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                // fma((2^23 + mag), sc, -2^23 sc) = fl(mag * sc) exactly
                const float v = fmaf(byte_f(mag, c), sc, nsc);
                const uint32_t neg = (sw << (31 - 8 * c - r)) & 0x80000000u;
                const float wv = __uint_as_float(__float_as_uint(v) ^ neg);
#pragma unroll
                for (int m = 0; m < MB; ++m)
                  acc[m][t * 4 + c] = fmaf(xv[m], wv, acc[m][t * 4 + c]);
              }
            }
          }
        }
        live = live_next;
        sc = sc_next;
        load(j + 32);
      }
    } else {
      stage_x();
      // any geometry: per (row, column) lookups, byte loads
      for (; j < j1; j += 32) {
        const int kb = j * 8 - k0;
        const size_t row = static_cast<size_t>(j) * g.n;
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int col = c0 + jj;
          if (col >= g.n) continue;
          const int h = col / g.wbc;
          const uint32_t sb = sign[row + col];
#pragma unroll 1
          for (int r = 0; r < 8; ++r) {
            const int k = j * 8 + r;
            if (k >= k1) break;
            const int gi = k / g.wbr;
            const uint32_t live = live_at(gi, h, g);
            uint32_t mag = 0;
            for (int b = 0; b < nbits; ++b) {
              if ((live >> b) & 1u) {
                mag |= ((planes[b * pstride + row + col] >> r) & 1u) << b;
              }
            }
            float wv = static_cast<float>(mag) * scale_at(gi, h, s_l, g);
            if ((sb >> r) & 1u) wv = -wv;
#pragma unroll
            for (int m = 0; m < MB; ++m)
              acc[m][jj] = fmaf(xs[m * kpad + kb + r], wv, acc[m][jj]);
          }
        }
      }
    }
  }

  // ---- tensor regime: raw rows of one 32-row K tile, 4 byte rows of each
  // plane (raw rows 4b..4b+3) and of the sign (raw rows 32..35)
  __device__ __forceinline__ void load_raw(unsigned char* st, int kt, int k1,
                                           int n0, const Geo& g) const {
    const int j0 = kt >> 3;
    const int jend = (k1 + 7) >> 3;
    const int rows = (nbits + 1) * 4;
    if (g.aligned) {
      for (int c = threadIdx.x; c < rows * (kBN / 16); c += kThreads) {
        const int ri = c >> 3, col = (c & 7) * 16;
        const int b = ri >> 2, jr = ri & 3;
        const bool ok = j0 + jr < jend && n0 + col < g.n;
        const uint8_t* base = b < nbits ? planes + b * pstride : sign;
        const int dr = (b < nbits ? b * 4 : kSignRow) + jr;
        cp_async16(st + dr * kBN + col,
                   ok ? base + static_cast<size_t>(j0 + jr) * g.n + n0 + col
                      : base,
                   ok);
      }
    } else {
      for (int e = threadIdx.x; e < rows * kBN; e += kThreads) {
        const int ri = e / kBN, col = e - ri * kBN;
        const int b = ri >> 2, jr = ri & 3;
        const bool ok = j0 + jr < jend && n0 + col < g.n;
        const uint8_t* base = b < nbits ? planes + b * pstride : sign;
        const int dr = (b < nbits ? b * 4 : kSignRow) + jr;
        st[dr * kBN + col] =
            ok ? base[static_cast<size_t>(j0 + jr) * g.n + n0 + col]
               : uint8_t(0);
      }
    }
    // mask planes 0..nbits-1, then (per-WB scale) the scale as plane nbits
    const MetaBox box(kt, k1, n0, g);
    const int planes_m = nbits + (per_block ? 1 : 0);
    if (box.size() * planes_m <= kMetaFloats) {
      float* meta = reinterpret_cast<float*>(st + kRawRows * kBN);
      const size_t ms = static_cast<size_t>(gr) * g.gc;
      stage_meta(meta, mask, nbits, ms, box, g);
      if (per_block) stage_meta(meta + nbits * box.size(), scale, 1, 0, box, g);
    }
  }

  // thread: 4 adjacent columns x 4 rows of the 32-row tile.  One 4-byte
  // shared load a plane holds the 4 columns' bytes; row r's 4 magnitudes
  // come out of them together, two 32-bit operations a plane (the 8x8 bit
  // transpose of 4 columns at once), then one fma a weight scales them
  // exactly; packed bf16 stores.
  __device__ __forceinline__ void decode(const unsigned char* st, int kt,
                                         int k1, int n0, const Geo& g,
                                         __nv_bfloat16* whi,
                                         __nv_bfloat16* wlo) const {
    const int cq = (threadIdx.x & 31) * 4, rq = (threadIdx.x >> 5) * 4;
    const int jr = rq >> 3, r0 = rq & 7;      // byte row, first bit row
    int h[4];
    bool ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ok[c] = n0 + cq + c < g.n;
      h[c] = ok[c] ? div_r(n0 + cq + c, g.rwbc) : 0;
    }
    const float s_l = layer_scale();
    const MetaBox box(kt, k1, n0, g);
    const int per = box.size();
    const float* meta =
        per * (nbits + (per_block ? 1 : 0)) <= kMetaFloats
            ? reinterpret_cast<const float*>(st + kRawRows * kBN)
            : nullptr;

    uint32_t wp[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      wp[b] = b < nbits ? *reinterpret_cast<const uint32_t*>(
                              st + (b * 4 + jr) * kBN + cq)
                        : 0u;
    }
    const uint32_t sw =
        *reinterpret_cast<const uint32_t*>(st + (kSignRow + jr) * kBN + cq);
    const int kk = kt + rq;
    int gi = div_r(kk, g.rwbr), rr = kk - gi * g.wbr;
    int gcur = -1;
    uint32_t live4 = 0;                       // byte c: column c's live set
    float sc[4] = {0.f, 0.f, 0.f, 0.f}, nsc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i, k = kk + i, tr = rq + i;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (k < k1) {
        if (gi != gcur) {
          gcur = gi;
          live4 = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const bool same = c > 0 && h[c] == h[0] && ok[0];
            uint32_t lv = same ? (live4 & 0xFFu) : 0u;
            if (same) {
              sc[c] = sc[0];
            } else if (ok[c]) {
              lv = wb_lookup(meta, box, gi, h[c], s_l, g, &sc[c]);
            } else {
              sc[c] = 0.f;
            }
            live4 |= lv << (8 * c);
            nsc[c] = -kMagic * sc[c];         // exact: a power of two
          }
        }
        uint32_t mag = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const uint32_t sh = r >= b ? wp[b] >> (r - b) : wp[b] << (b - r);
          mag |= sh & (0x01010101u << b);
        }
        mag &= live4;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // fma((2^23 + mag), sc, -2^23 sc) = fl(mag * sc) exactly
          const float f = fmaf(byte_f(mag, c), sc[c], nsc[c]);
          const uint32_t neg = (sw << (31 - 8 * c - r)) & 0x80000000u;
          v[c] = __uint_as_float(__float_as_uint(f) ^ neg);
        }
      }
      store_split4(whi + tr * kWPitch + cq, wlo + tr * kWPitch + cq, v);
      if (++rr == g.wbr) {
        rr = 0;
        ++gi;
      }
    }
  }
};

}  // namespace

// The launch's fixed geometry, built once for each call shape by the
// wrapper (kernels/bitplane_matmul.py::_Args mirrors it).  x: (m, ldx)
// row-major, the first kend columns used (kend <= kx and kend <= gr *
// wbr); planes: uint8 (nbits, >= ceil(kend/8), n) with plane stride
// ``pstride`` bytes and row stride n; sign: uint8 (>= ceil(kend/8), n);
// mask: f32 (nbits, gr, gc) in {0, 1}; scale: f32 (gr, gc) when
// per_block, else (1,); out: f32 (m, n).  The plan, ws and cnt as in
// packed_matmul.cu.
struct BitplaneArgs {
  int x_bf16, ldx, m, kend, nbits, gr, gc, per_block, n, wbr, wbc, regime,
      rows, ksplit, kchunk;
  long long pstride;
  void* ws;
  void* cnt;
};

// Launches on ``stream``, does not synchronise, returns cudaGetLastError()
// (0 when the launch was accepted).
extern "C" int bitplane_matmul_launch(const void* x, const void* planes,
                                      const void* sign, const void* mask,
                                      const void* scale, void* out,
                                      const BitplaneArgs* a, void* stream) {
  if (a->m <= 0 || a->n <= 0) return 0;
  if (a->nbits < 1 || a->nbits > 8 || a->wbr < 1 || a->wbc < 1 ||
      a->ksplit < 1 || a->kchunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geo g;
  g.x = x;
  g.ldx = a->ldx;
  g.m = a->m;
  g.kend = a->kend;
  g.x_bf16 = a->x_bf16;
  g.n = a->n;
  g.gc = a->gc;
  g.wbr = a->wbr;
  g.wbc = a->wbc;
  g.rwbr = 1.f / static_cast<float>(a->wbr);
  g.rwbc = 1.f / static_cast<float>(a->wbc);
  g.out = static_cast<float*>(out);
  g.ws = static_cast<float*>(a->ws);
  g.cnt = static_cast<int*>(a->cnt);
  g.ksplit = a->ksplit;
  g.kchunk = a->kchunk;
  const int wbr = a->wbr;
  const bool pow2 = (wbr & (wbr - 1)) == 0;
  g.wshift = pow2 ? __builtin_ctz(wbr) : 0;
  const bool w16 = a->n % 16 == 0 && a->pstride % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(planes) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(sign) & 15) == 0;
  const int esz = a->x_bf16 ? 2 : 4;
  g.aligned = w16 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
              (a->ldx * esz) % 16 == 0 && a->kend % (16 / esz) == 0;
  const bool fast = w16 && pow2 && wbr >= 8 && a->wbc % 16 == 0;
  const BitplaneDec dec{static_cast<const uint8_t*>(planes),
                        static_cast<const uint8_t*>(sign),
                        static_cast<const float*>(mask),
                        static_cast<const float*>(scale),
                        a->pstride,
                        a->nbits,
                        a->gr,
                        a->per_block};
  return launch(g, dec, a->regime, a->rows, fast,
                static_cast<cudaStream_t>(stream));
}
