// Packed-integer dequant matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel repro/kernels/packed_matmul.py::packed_matmul
// (kernel bodies _kernel8 and _kernel4):
//     y[M, N] = x[M, K] @ (w_int * expand(scale))      f32 accumulation
// with w_int int8 (K, N), or uint8 (ceil(K/2), N) nibble pairs along K (row
// 2j in the low nibble), and scale the per-WB f32 grid (K/wbr, N/wbc).
// x (M, kx <= K) is f32 or bf16 and converted to f32 before the multiply, as
// the TPU kernel does; columns of x past kx are zero, so rows k >= kx are
// never read (that also skips an int4 odd-K pad row).
//
// Bound on an H100 SXM: at decode (M = 1..16) each weight byte feeds only M
// FMAs, so the kernel is bound by the weight bytes over the 3.35 TB/s of HBM
// (int8 (3072, 8192): 25.2 MB -> 7.5 us; int4 half that).  At prefill
// (M = B*P in the hundreds) it is bound by operations: it uses the f32 FMA
// units (67 TFLOP/s), not the tensor cores.
//
// Design, simple first.  One block of 8 warps owns 32 output columns and up
// to BM rows.  Lane = column, so a warp reads one full 32-byte sector of a
// weight row per load; it dequantizes in registers (nibble unpack, then the
// per-WB scale, looked up by index k / wbr and n / wbc so that any WB
// geometry works, 9x8 as well as 8x128) and adds x[m, k] * w into BM f32
// accumulators.  The 8 warps split K into contiguous ranges and each issues
// four weight loads before it uses them, which keeps enough bytes in flight
// per SM; their partial sums meet in shared memory and are added in a fixed
// order, so results do not change from run to run.  Tensor cores (wgmma),
// TMA and a multi-stage pipeline are later work.
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

__device__ __forceinline__ int nibble(int byte, int shift) {
  const int v = (byte >> shift) & 0xF;
  return v >= 8 ? v - 16 : v;
}

template <int BM, int BITS, bool XBF16>
__global__ void __launch_bounds__(kWarps * 32)
packed_matmul_kernel(const void* __restrict__ x, int ldx, int m, int kx,
                     const uint8_t* __restrict__ w,
                     const float* __restrict__ scale, int n, int gc, int wbr,
                     int wbc, float* __restrict__ out) {
  __shared__ float part[kWarps][BM][kBN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * kBN + lane;
  const int row0 = blockIdx.y * BM;
  const int rows = min(BM, m - row0);

  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  // this warp's contiguous K range, even-aligned so int4 pairs never split
  int chunk = (kx + kWarps - 1) / kWarps;
  chunk = (chunk + 1) & ~1;
  const int k0 = min(kx, warp * chunk);
  const int k1 = min(kx, k0 + chunk);

  if (col < n) {
    const float* scol = scale + col / wbc;  // this column of the scale grid
    int g = k0 / wbr;                       // WB row of k
    int r = k0 - g * wbr;                   // k's row inside its WB
    auto next_scale = [&]() {
      const float s = __ldg(scol + static_cast<size_t>(g) * gc);
      if (++r == wbr) {
        r = 0;
        ++g;
      }
      return s;
    };
    auto fma_row = [&](int k, float wv) {
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        if (i < rows) {
          acc[i] = fmaf(
              load_x<XBF16>(x, static_cast<size_t>(row0 + i) * ldx + k), wv,
              acc[i]);
        }
      }
    };
    if constexpr (BITS == 8) {
      const int8_t* wp = reinterpret_cast<const int8_t*>(w) + col;
      int k = k0;
      for (; k + 4 <= k1; k += 4) {
        int q[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) q[u] = wp[static_cast<size_t>(k + u) * n];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float s = next_scale();
          fma_row(k + u, static_cast<float>(q[u]) * s);
        }
      }
      for (; k < k1; ++k) {
        const int q = wp[static_cast<size_t>(k) * n];
        const float s = next_scale();
        fma_row(k, static_cast<float>(q) * s);
      }
    } else {
      const uint8_t* wp = w + col;
      int k = k0;
      for (; k + 4 <= k1; k += 4) {  // two bytes = four K rows
        const int b0 = wp[static_cast<size_t>(k >> 1) * n];
        const int b1 = wp[static_cast<size_t>((k >> 1) + 1) * n];
        const int q[4] = {nibble(b0, 0), nibble(b0, 4), nibble(b1, 0),
                          nibble(b1, 4)};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float s = next_scale();
          fma_row(k + u, static_cast<float>(q[u]) * s);
        }
      }
      for (; k < k1; ++k) {  // k is even here; the pair may be cut by k1
        const int b = wp[static_cast<size_t>(k >> 1) * n];
        const float s = next_scale();
        fma_row(k, static_cast<float>(nibble(b, (k & 1) * 4)) * s);
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
      for (int q = 0; q < kWarps; ++q) s += part[q][i][c];
      out[static_cast<size_t>(row0 + i) * n + oc] = s;
    }
  }
}

template <int BM, int BITS, bool XBF16>
void launch(const void* x, int ldx, int m, int kx, const void* w,
            const void* scale, int n, int gc, int wbr, int wbc, void* out,
            cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM);
  packed_matmul_kernel<BM, BITS, XBF16><<<grid, kWarps * 32, 0, stream>>>(
      x, ldx, m, kx, static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), n, gc, wbr, wbc,
      static_cast<float*>(out));
}

template <int BITS, bool XBF16>
void launch_rows(const void* x, int ldx, int m, int kx, const void* w,
                 const void* scale, int n, int gc, int wbr, int wbc,
                 void* out, cudaStream_t stream) {
  if (m == 1) {
    launch<1, BITS, XBF16>(x, ldx, m, kx, w, scale, n, gc, wbr, wbc, out,
                           stream);
  } else if (m <= 4) {
    launch<4, BITS, XBF16>(x, ldx, m, kx, w, scale, n, gc, wbr, wbc, out,
                           stream);
  } else if (m <= 8) {
    launch<8, BITS, XBF16>(x, ldx, m, kx, w, scale, n, gc, wbr, wbc, out,
                           stream);
  } else {
    launch<16, BITS, XBF16>(x, ldx, m, kx, w, scale, n, gc, wbr, wbc, out,
                            stream);
  }
}

}  // namespace

// x: (m, ldx) row-major, the first kx columns used; w: int8 (K, n) when
// bits == 8, uint8 (ceil(K/2), n) when bits == 4; scale: f32 (K/wbr, gc);
// out: f32 (m, n).  Launches on ``stream``, does not synchronise, returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int packed_matmul_launch(const void* x, int x_bf16, int ldx, int m,
                                    int kx, const void* w, int bits,
                                    const void* scale, int n, int gc, int wbr,
                                    int wbc, void* out, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8 && x_bf16) {
    launch_rows<8, true>(x, ldx, m, kx, w, scale, n, gc, wbr, wbc, out, st);
  } else if (bits == 8) {
    launch_rows<8, false>(x, ldx, m, kx, w, scale, n, gc, wbr, wbc, out, st);
  } else if (bits == 4 && x_bf16) {
    launch_rows<4, true>(x, ldx, m, kx, w, scale, n, gc, wbr, wbc, out, st);
  } else if (bits == 4) {
    launch_rows<4, false>(x, ldx, m, kx, w, scale, n, gc, wbr, wbc, out, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
