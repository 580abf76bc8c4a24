// Packed-integer dequant matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/packed_matmul.py::packed_matmul
// (kernel bodies _kernel8 and _kernel4):
//     y[M, N] = x[M, K] @ (w_int * expand(scale))      f32 accumulation
// with w_int int8 (K, N), or uint8 (ceil(K/2), N) nibble pairs along K (row
// 2j in the low nibble), and scale the per-WB f32 grid (K/wbr, N/wbc),
// looked up by index (k / wbr, n / wbc) so that any WB geometry works, 9x8
// as well as 8x128.  x (M, kx <= K) is f32 or bf16; columns of x past kx
// are zero, so rows k >= kx are never read (that also skips an int4 odd-K
// pad row).  The weight is dequantized as fl(q * s), as the plain version.
//
// Two regimes (wmm_common.cuh; the plan from kernels/tiling.py):
//
// * stream, M <= 16 (decode, short verify).  Bound on an H100 SXM by the
//   weight bytes over the 3.35 TB/s of HBM (int8 (3072, 8192): 25.2 MB ->
//   7.5 us; int4 half that), and beside the bytes by the latency of
//   launch, round trips and split-K arrival (wmm_common.cuh).  Each thread
//   loads 16 bytes of a row at a time, four rows in flight and four more
//   loading while they are used, and turns bytes into floats without I2F
//   (a PRMT into a float's mantissa and one FADD); the row's one scale
//   rides on x; split-K fills the card; f32 FMAs, x from shared memory.
//   With 4 rows of x a block, the ~6 operations a weight stay below what
//   the bytes cost; more rows take more row tiles.
// * tensor, M > 16 (longer verify, prefill).  Bound by operations: 2
//   (bf16 x) or 3 (f32 x) bf16 tensor-core products per weight, since one
//   bf16 weight would be 20x outside the 1e-4 tolerance; at M = 512 the
//   dequantization (once per block and weight tile) costs less than the
//   products.
//
// Left for later: wgmma with a TMA-fed producer warp, TMA multicast of a
// weight tile to the blocks of a cluster that share it, a persistent
// schedule that overlaps one tile's epilogue with the next tile's loads.
#include "wmm_common.cuh"

namespace {

using namespace wmm;

template <int BITS>
struct PackedDec {
  const uint8_t* w;
  const float* scale;
  static constexpr int kRawRows = BITS == 8 ? kBK : kBK / 2;
  static constexpr int kMetaFloats = 512;   // staged scales a tile

  __device__ __forceinline__ float scale_at(int k, int col,
                                            const Geo& g) const {
    return __ldg(scale + static_cast<size_t>(k / g.wbr) * g.gc +
                 col / g.wbc);
  }

  // ---- stream regime: a unit is a row (int8) or a byte row (int4); U
  // units a thread in flight, the next batch loading while this one is used
  template <int MB, bool FAST, class Stage>
  __device__ __forceinline__ void stream(float (&acc)[MB][16],
                                         const float* xs, int kpad, int k0,
                                         int k1, int rg, int c0, const Geo& g,
                                         Stage&& stage_x) const {
    constexpr int R = BITS == 8 ? 1 : 2;   // K rows a unit
    constexpr int U = 4;
    const bool on = c0 < g.n;              // columns past n walk nothing
    const int u1 = on ? (k1 + R - 1) / R : 0;
    const int h = on ? c0 / g.wbc : 0;
    // FAST: wbr is a power of two >= 8, so a unit's rows share a WB row,
    // and wbc % 16 == 0, so its 16 columns share a WB column: one scale
    auto load = [&](int ub, uint4 (&q)[U], float (&sc)[U]) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int unit = ub + 32 * u;
        q[u] = make_uint4(0, 0, 0, 0);
        sc[u] = 0.f;
        if (unit < u1) {
          q[u] = load16<FAST>(w + static_cast<size_t>(unit) * g.n, c0, g.n);
          if (FAST) {
            sc[u] = __ldg(scale + static_cast<size_t>((unit * R) >> g.wshift)
                                      * g.gc + h);
          }
        }
      }
    };
    uint4 q[U];
    float sc[U];
    int ub = k0 / R + rg;
    load(ub, q, sc);
    stage_x();
    for (; ub < u1; ub += 32 * U) {
      uint4 qn[U];
      float sn[U];
      load(ub + 32 * U, qn, sn);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int unit = ub + 32 * u;
        if (unit >= u1) break;
        const int kb = unit * R - k0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int k = unit * R + r;
          if (!FAST && k >= k1) break;
          // FAST: the unit's one scale rides on x (MB products a row, not
          // one a weight); the sums differ from fl(q * s) * x by f32
          // rounding only
          float xv[MB];
#pragma unroll
          for (int m = 0; m < MB; ++m)
            xv[m] = FAST ? xs[m * kpad + kb + r] * sc[u]
                         : xs[m * kpad + kb + r];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            uint32_t v;
            float off;
            if constexpr (BITS == 8) {
              v = word_of(q[u], t) ^ 0x80808080u;      // q + 128
              off = kMagic + 128.f;
            } else {
              v = ((word_of(q[u], t) ^ 0x88888888u) >> (4 * r)) &
                  0x0F0F0F0Fu;                         // nibble + 8
              off = kMagic + 8.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = t * 4 + i;
              float wv = byte_f(v, i) - off;
              if (!FAST) wv *= c0 + j < g.n ? scale_at(k, c0 + j, g) : 0.f;
              if constexpr (kProbe & kProbeNoCompute) {
                acc[0][j] += wv;
              } else {
#pragma unroll
                for (int m = 0; m < MB; ++m)
                  acc[m][j] = fmaf(xv[m], wv, acc[m][j]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        q[u] = qn[u];
        sc[u] = sn[u];
      }
    }
  }

  // ---- tensor regime: raw rows of one 32-row K tile
  __device__ __forceinline__ void load_raw(unsigned char* st, int kt, int k1,
                                           int n0, const Geo& g) const {
    const int r0 = BITS == 8 ? kt : kt / 2;
    const int rend = BITS == 8 ? k1 : (k1 + 1) / 2;
    if (g.aligned) {
      for (int c = threadIdx.x; c < kRawRows * (kBN / 16); c += kThreads) {
        const int r = c >> 3, col = (c & 7) * 16;
        const bool ok = r0 + r < rend && n0 + col < g.n;
        cp_async16(st + r * kBN + col,
                   ok ? w + static_cast<size_t>(r0 + r) * g.n + n0 + col : w,
                   ok);
      }
    } else {
      for (int e = threadIdx.x; e < kRawRows * kBN; e += kThreads) {
        const int r = e / kBN, col = e - r * kBN;
        st[e] = (r0 + r < rend && n0 + col < g.n)
                    ? w[static_cast<size_t>(r0 + r) * g.n + n0 + col]
                    : uint8_t(0);
      }
    }
    const MetaBox box(kt, k1, n0, g);
    if (box.size() <= kMetaFloats) {
      stage_meta(reinterpret_cast<float*>(st + kRawRows * kBN), scale, 1, 0,
                 box, g);
    }
  }

  // thread: 4 adjacent columns x 4 rows of the 32-row tile; one 4-byte
  // shared load a row, packed bf16 stores
  __device__ __forceinline__ void decode(const unsigned char* st, int kt,
                                         int k1, int n0, const Geo& g,
                                         __nv_bfloat16* whi,
                                         __nv_bfloat16* wlo) const {
    const int cq = (threadIdx.x & 31) * 4, rq = (threadIdx.x >> 5) * 4;
    int h[4];
    bool ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ok[c] = n0 + cq + c < g.n;
      h[c] = ok[c] ? div_r(n0 + cq + c, g.rwbc) : 0;
    }
    const MetaBox box(kt, k1, n0, g);
    const float* meta = box.size() <= kMetaFloats
                            ? reinterpret_cast<const float*>(st + kRawRows * kBN)
                            : nullptr;
    const int kk = kt + rq;
    int gi = div_r(kk, g.rwbr), rr = kk - gi * g.wbr;
    int gcur = -1;
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = kk + r, tr = rq + r;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (k < k1) {
        if (gi != gcur) {
          gcur = gi;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sc[c] = !ok[c] ? 0.f
                    : meta ? meta[box.at(gi, h[c])]
                           : __ldg(scale + static_cast<size_t>(gi) * g.gc + h[c]);
          }
        }
        uint32_t word;
        float off;
        if constexpr (BITS == 8) {
          word = *reinterpret_cast<const uint32_t*>(st + tr * kBN + cq) ^
                 0x80808080u;
          off = kMagic + 128.f;
        } else {
          word = ((*reinterpret_cast<const uint32_t*>(st + (tr >> 1) * kBN +
                                                       cq) ^
                   0x88888888u) >> (4 * (tr & 1))) & 0x0F0F0F0Fu;
          off = kMagic + 8.f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = (byte_f(word, c) - off) * sc[c];
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
// wrapper (kernels/packed_matmul.py::_Args mirrors it).  x: (m, ldx)
// row-major, the first kx columns used; w: int8 (K, n) when bits == 8,
// uint8 (ceil(K/2), n) when bits == 4; scale: f32 (K/wbr, gc); out: f32
// (m, n).  The plan (kernels/tiling.py::matmul_plan): regime 0 (stream,
// row tiles of ``rows``) or 1 (tensor, BM = ``rows``), ``ksplit`` K slices
// of ``kchunk`` rows; ws: f32 (ksplit, m, n) when ksplit > 1; cnt: int32
// zeros, one per output tile, left at zero.
struct PackedArgs {
  int x_bf16, ldx, m, kx, bits, n, gc, wbr, wbc, regime, rows, ksplit,
      kchunk;
  void* ws;
  void* cnt;
};

// Launches on ``stream``, does not synchronise, returns cudaGetLastError()
// (0 when the launch was accepted).
extern "C" int packed_matmul_launch(const void* x, const void* w,
                                    const void* scale, void* out,
                                    const PackedArgs* a, void* stream) {
  if (a->m <= 0 || a->n <= 0) return 0;
  if (a->wbr < 1 || a->wbc < 1 || a->ksplit < 1 || a->kchunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geo g;
  g.x = x;
  g.ldx = a->ldx;
  g.m = a->m;
  g.kend = a->kx;
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
  const int wbr = a->wbr, n = a->n;
  const bool pow2 = (wbr & (wbr - 1)) == 0;
  g.wshift = pow2 ? __builtin_ctz(wbr) : 0;
  const bool w16 = n % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int esz = a->x_bf16 ? 2 : 4;
  g.aligned = w16 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
              (a->ldx * esz) % 16 == 0 && a->kx % (16 / esz) == 0;
  const bool fast = w16 && pow2 && wbr >= 8 && a->wbc % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* s = static_cast<const float*>(scale);
  const uint8_t* wb = static_cast<const uint8_t*>(w);
  if (a->bits == 8) {
    return launch(g, PackedDec<8>{wb, s}, a->regime, a->rows, fast, st);
  }
  if (a->bits == 4) {
    return launch(g, PackedDec<4>{wb, s}, a->regime, a->rows, fast, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
