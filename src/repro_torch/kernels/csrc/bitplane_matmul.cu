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
// scalar divided by 2^n - 1.  x (M, kx) is f32 or bf16, converted to f32
// before the multiply; f32 accumulation and output.  Rows past
// kend = min(kx, GR * wbr) are never read: x is zero there (x narrower than
// K), or they are byte-pad rows with no mask or scale entry (odd
// block-padded K, e.g. 63 rows of 9x8 blocks packed into 64).
//
// Bound on an H100 SXM: at decode (M = 1..20) each weight feeds only M
// FMAs, so the kernel is bound by the bytes it streams over the 3.35 TB/s
// of HBM: one bit per live (plane, weight) plus the sign bit of every live
// block, the mask and the scales.  A block with b live planes costs b + 1
// bits a weight, which is what BWQ's per-block precision buys.  At prefill
// (M = B*P) it is bound by operations on the f32 FMA units (67 TFLOP/s),
// not the tensor cores.
//
// Design, simple first, after packed_matmul.cu.  One block of 8 warps owns
// 32 output columns (lane = column) and up to BM rows of x; the 8 warps
// split K into contiguous ranges of whole byte rows, and their partial sums
// meet in shared memory in a fixed order.  For each byte row a lane first
// looks up, by index (k / wbr, n / wbc, so any WB geometry works, 9x8 as
// well as 8x128), the live-plane set and scale of each of its 8 rows.  It
// loads only the plane bytes live in one of them (a fully masked block is
// never read), transposes the 8x8 bit matrix (plane b, row r) in one 64-bit
// register so that byte r holds row r's magnitude bits, masks each row's
// magnitude with its own live set (the draft model's truncated masks zero
// the LOW planes, so every plane is honoured, not a prefix), applies sign
// and scale and adds x[m, k] * w into BM accumulators.  Tensor cores, TMA
// and a staged pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kBN = 32;

template <bool XBF16>
__device__ __forceinline__ float load_x(const void* x, size_t i) {
  if constexpr (XBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
  } else {
    return __ldg(static_cast<const float*>(x) + i);
  }
}

// 8x8 bit-matrix transpose: bit r of byte b moves to bit b of byte r.
__device__ __forceinline__ uint64_t transpose8(uint64_t v) {
  uint64_t t = (v ^ (v >> 7)) & 0x00AA00AA00AA00AAull;
  v = v ^ t ^ (t << 7);
  t = (v ^ (v >> 14)) & 0x0000CCCC0000CCCCull;
  v = v ^ t ^ (t << 14);
  t = (v ^ (v >> 28)) & 0x00000000F0F0F0F0ull;
  return v ^ t ^ (t << 28);
}

template <int BM, bool XBF16, bool PER_BLOCK>
__global__ void __launch_bounds__(kWarps * 32)
bitplane_matmul_kernel(const void* __restrict__ x, int ldx, int m, int kend,
                       const uint8_t* __restrict__ planes,
                       const uint8_t* __restrict__ sign, int nbits,
                       long long plane_stride,
                       const float* __restrict__ mask,
                       const float* __restrict__ scale, int n, int gr,
                       int gc, int wbr, int wbc, float* __restrict__ out) {
  __shared__ float part[kWarps][BM][kBN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kBN + lane;
  const int row0 = blockIdx.y * BM;
  const int rows = min(BM, m - row0);

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  // this warp's contiguous range of byte rows
  const int nbytes = (kend + 7) >> 3;
  const int chunk = (nbytes + kWarps - 1) / kWarps;
  const int j0 = min(nbytes, warp * chunk);
  const int j1 = min(nbytes, j0 + chunk);

  if (col < n) {
    const int h = col / wbc;
    const size_t mstride = static_cast<size_t>(gr) * gc;
    const float s_layer =
        PER_BLOCK ? 0.f
                  : __ldg(scale) / static_cast<float>((1 << nbits) - 1);
    const uint8_t* pcol = planes + col;
    const uint8_t* scol = sign + col;
    int g = (j0 * 8) / wbr;        // WB row of the next row walked
    int rr = j0 * 8 - g * wbr;     // that row's place inside its WB
    int g_cur = -1;
    uint32_t live_cur = 0;
    float s_cur = s_layer;
    for (int j = j0; j < j1; ++j) {
      const int k0 = j * 8;
      uint32_t live[8];
      float sc[8];
      uint32_t any = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        live[r] = 0;
        sc[r] = 0.f;
        if (k0 + r < kend) {
          if (g != g_cur) {  // a new WB row: its live planes and scale
            g_cur = g;
            const float* mp = mask + static_cast<size_t>(g) * gc + h;
            live_cur = 0;
            for (int b = 0; b < nbits; ++b) {
              live_cur |= (__ldg(mp + b * mstride) != 0.f ? 1u : 0u) << b;
            }
            if (PER_BLOCK) s_cur = __ldg(scale + static_cast<size_t>(g) * gc + h);
          }
          live[r] = live_cur;
          sc[r] = s_cur;
          any |= live_cur;
        }
        if (++rr == wbr) {
          rr = 0;
          ++g;
        }
      }
      if (any == 0) continue;  // every row masked here: read nothing
      uint64_t pb = 0;
      for (int b = 0; b < nbits; ++b) {
        if ((any >> b) & 1u) {
          pb |= static_cast<uint64_t>(
                    pcol[b * plane_stride + static_cast<long long>(j) * n])
                << (8 * b);
        }
      }
      const uint32_t sb = scol[static_cast<size_t>(j) * n];
      const uint64_t q = transpose8(pb);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t mag =
            static_cast<uint32_t>((q >> (8 * r)) & 0xFFu) & live[r];
        if (mag == 0u) continue;  // also covers rows k >= kend
        float wv = static_cast<float>(mag) * sc[r];
        if ((sb >> r) & 1u) wv = -wv;
        const int k = k0 + r;
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          if (i < rows) {
            acc[i] = fmaf(
                load_x<XBF16>(x, static_cast<size_t>(row0 + i) * ldx + k), wv,
                acc[i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < BM; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * kBN; idx += kWarps * 32) {
    const int i = idx / kBN;
    const int c = idx - i * kBN;
    const int oc = blockIdx.x * kBN + c;
    if (i < rows && oc < n) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][i][c];
      out[static_cast<size_t>(row0 + i) * n + oc] = s;
    }
  }
}

struct Args {
  const void* x;
  int ldx, m, kend;
  const uint8_t* planes;
  const uint8_t* sign;
  int nbits;
  long long plane_stride;
  const float* mask;
  const float* scale;
  int n, gr, gc, wbr, wbc;
  float* out;
};

template <int BM, bool XBF16, bool PER_BLOCK>
void launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.n + kBN - 1) / kBN, (a.m + BM - 1) / BM);
  bitplane_matmul_kernel<BM, XBF16, PER_BLOCK>
      <<<grid, kWarps * 32, 0, stream>>>(
          a.x, a.ldx, a.m, a.kend, a.planes, a.sign, a.nbits, a.plane_stride,
          a.mask, a.scale, a.n, a.gr, a.gc, a.wbr, a.wbc, a.out);
}

template <bool XBF16, bool PER_BLOCK>
void launch_rows(const Args& a, cudaStream_t stream) {
  if (a.m == 1) {
    launch<1, XBF16, PER_BLOCK>(a, stream);
  } else if (a.m <= 4) {
    launch<4, XBF16, PER_BLOCK>(a, stream);
  } else if (a.m <= 8) {
    launch<8, XBF16, PER_BLOCK>(a, stream);
  } else {
    launch<16, XBF16, PER_BLOCK>(a, stream);
  }
}

}  // namespace

// x: (m, ldx) row-major, the first kend columns used (kend <= kx and
// kend <= gr * wbr); planes: uint8 (nbits, >= ceil(kend/8), n) with plane
// stride plane_stride bytes and row stride n; sign: uint8 (>= ceil(kend/8),
// n); mask: f32 (nbits, gr, gc) in {0, 1}; scale: f32 (gr, gc) when
// per_block, else (1,); out: f32 (m, n).  Launches on ``stream``, does not
// synchronise, returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int bitplane_matmul_launch(const void* x, int x_bf16, int ldx,
                                      int m, int kend, const void* planes,
                                      const void* sign, int nbits,
                                      long long plane_stride,
                                      const void* mask, int gr, int gc,
                                      const void* scale, int per_block, int n,
                                      int wbr, int wbc, void* out,
                                      void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (nbits < 1 || nbits > 8 || wbr < 1 || wbc < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, ldx, m, kend, static_cast<const uint8_t*>(planes),
               static_cast<const uint8_t*>(sign), nbits, plane_stride,
               static_cast<const float*>(mask),
               static_cast<const float*>(scale), n, gr, gc, wbr, wbc,
               static_cast<float*>(out)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && per_block) {
    launch_rows<true, true>(a, st);
  } else if (x_bf16) {
    launch_rows<true, false>(a, st);
  } else if (per_block) {
    launch_rows<false, true>(a, st);
  } else {
    launch_rows<false, false>(a, st);
  }
  return static_cast<int>(cudaGetLastError());
}
