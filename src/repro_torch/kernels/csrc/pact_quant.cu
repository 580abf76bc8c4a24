// Fused symmetric-PACT clip + uniform quantization for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel repro/kernels/pact_kernel.py::pact_quant_pallas
// (kernel body _kernel):
//     b = max(beta, 1e-6),  L = 2^(act_bits - 1) - 1,
//     y = round(clip(x, -b, b) / b * L) * (b / L)
// elementwise, computed in x's dtype (f32, bf16 or f16) as the TPU kernel
// does: each operation is done in f32 and rounded to x's dtype, which for
// these operations gives the correctly rounded result in that dtype, and
// round() is to nearest even like jnp.round / torch.round.
//
// Bound on an H100 SXM: one read and one write of x, 2 * R * C * sizeof(x)
// bytes over the 3.35 TB/s of HBM; a handful of operations a byte.
//
// Design: CUDA rather than Triton, so the port keeps one build route
// (nvcc, ctypes).  A grid-stride loop over the flat tensor; each thread
// moves 16 bytes at a time where the tensor is 16-byte aligned and its
// length a multiple of the vector, and one element at a time otherwise, so
// any row count works.  No shared memory and no tensor cores: the pass is
// bound by bytes.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// round to x's dtype after each operation
template <typename T>
__device__ __forceinline__ float rt(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T>
__device__ __forceinline__ T quant(T xv, float b, float levels, float step) {
  const float y = fminf(fmaxf(to_f<T>(xv), -b), b);
  const float t = rt<T>(rt<T>(y / b) * levels);
  return from_f<T>(rintf(t) * step);
}

template <typename T, int VEC>
__global__ void pact_quant_kernel(const T* __restrict__ x,
                                  const float* __restrict__ beta,
                                  T* __restrict__ out, long long count,
                                  float levels) {
  const float b = rt<T>(fmaxf(__ldg(beta), 1e-6f));
  levels = rt<T>(levels);  // the TPU kernel casts L to x's dtype
  const float step = rt<T>(b / levels);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long nvec = count / VEC;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < nvec; i += stride) {
    if constexpr (VEC > 1) {
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + i);
      T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = quant<T>(v[e], b, levels, step);
      reinterpret_cast<uint4*>(out)[i] = raw;
    } else {
      out[i] = quant<T>(x[i], b, levels, step);
    }
  }
}

template <typename T>
int launch(const void* x, const void* beta, void* out, long long count,
           float levels, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kThreads = 256;
  const bool vec = count % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long items = vec ? count / kVec : count;
  const long long want = (items + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const float* bp = static_cast<const float*>(beta);
  if (vec) {
    pact_quant_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(
        xp, bp, op, count, levels);
  } else {
    pact_quant_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(xp, bp, op,
                                                             count, levels);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: ``count`` contiguous elements of dtype ``dtype`` (0 = f32,
// 1 = bf16, 2 = f16); beta: f32 (1,).  Launches on ``stream``, does not
// synchronise, returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int pact_quant_launch(const void* x, int dtype, const void* beta,
                                 void* out, long long count, int act_bits,
                                 void* stream) {
  if (count <= 0) return 0;
  if (act_bits < 2 || act_bits > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float levels = static_cast<float>((1 << (act_bits - 1)) - 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, beta, out, count, levels, st);
    case 1:
      return launch<__nv_bfloat16>(x, beta, out, count, levels, st);
    case 2:
      return launch<__half>(x, beta, out, count, levels, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
