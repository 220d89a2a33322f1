// Fused normalize + quantize kernel for Hopper (sm_90a), used at index
// build and ingest:
//
//   codes[b, j] = bucket(x[b, j] / max(||x[b]||, 1e-12))
//   bucket(v)   = sign(v * param) * floor(|v * param| + 0.5)   (rounding)
//               = floor(v / param)                          (interval)
//
// cast to int8 or int16.
//
// Replaces: src/repro/kernels/bucketize/kernel.py::bucketize_pallas (body
// _bucketize_kernel).  The TPU kernel normalizes and quantizes a
// (BLOCK_B, n) tile in VMEM.  Here one warp takes one row: a row whose
// length is a whole number of float4s (at most kVecPerLane * 128 floats,
// on a 16-byte aligned table) is loaded once into registers, 16 bytes a
// lane; the warp sums its squares by shuffles; then each lane writes the
// codes of its float4s as one packed 4-byte (int8) or 8-byte (int16)
// store.  Other rows are read twice, a float a lane (the second read
// finds the row in L1).
//
// Arithmetic as the reference's: sqrtf, an IEEE division by
// max(norm, 1e-12f), then a multiply by the scale or an IEEE division by
// the width.  `param` is a float32 argument and is divided by, never
// replaced by its reciprocal; build without --use_fast_math, so nothing
// is flushed to zero.  The sum of squares runs in another order than
// jnp.linalg.norm's, so a value on a bucket edge may land one bucket off:
// the reference suite's contract is >= 99.99% of codes equal, every other
// code one bucket away.
//
// What bounds it on the H100: bytes.  Each element is read once (4 bytes)
// and its code written once (1 or 2 bytes), with a few operations each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // 8 rows a block, a warp each
constexpr int kVecPerLane = 4;    // rows of up to 512 floats in registers

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mode 0: rounding (param = scale), mode 1: interval (param = width)
__device__ __forceinline__ float bucket(float v, int mode, float param) {
  if (mode == 0) {
    const float s = v * param;
    return copysignf(floorf(fabsf(s) + 0.5f), s);
  }
  return floorf(v / param);
}

__device__ __forceinline__ void store4(int8_t* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<char4*>(p) =
      make_char4((signed char)(int)a, (signed char)(int)b,
                 (signed char)(int)c, (signed char)(int)d);
}

__device__ __forceinline__ void store4(int16_t* p, float a, float b,
                                       float c, float d) {
  *reinterpret_cast<short4*>(p) = make_short4((short)(int)a, (short)(int)b,
                                              (short)(int)c, (short)(int)d);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bucketize_kernel(const float* __restrict__ x, T* __restrict__ out, int B,
                 int n, int mode, float param, int vec) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= B) return;
  const float* xr = x + row * n;
  T* orow = out + row * n;
  if (vec) {
    const int n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4 v[kVecPerLane];
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < kVecPerLane; ++k) {
      const int i = lane + 32 * k;
      if (i < n4) {
        v[k] = x4[i];
        ss = fmaf(v[k].x, v[k].x, ss);
        ss = fmaf(v[k].y, v[k].y, ss);
        ss = fmaf(v[k].z, v[k].z, ss);
        ss = fmaf(v[k].w, v[k].w, ss);
      }
    }
    const float den = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
#pragma unroll
    for (int k = 0; k < kVecPerLane; ++k) {
      const int i = lane + 32 * k;
      if (i < n4)
        store4(orow + 4 * i, bucket(v[k].x / den, mode, param),
               bucket(v[k].y / den, mode, param),
               bucket(v[k].z / den, mode, param),
               bucket(v[k].w / den, mode, param));
    }
    return;
  }
  float ss = 0.0f;
  for (int j = lane; j < n; j += 32) ss = fmaf(xr[j], xr[j], ss);
  const float den = fmaxf(sqrtf(warp_sum(ss)), 1e-12f);
  for (int j = lane; j < n; j += 32)
    orow[j] = (T)(int)bucket(xr[j] / den, mode, param);
}

template <typename T>
int launch(const void* x, void* out, int B, int n, int mode, float param,
           void* stream) {
  if (B < 1 || n < 1 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const int vec = (n % 4 == 0) && n <= 128 * kVecPerLane &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0);
  const unsigned blocks =
      (unsigned)(((long long)B + kThreads / 32 - 1) / (kThreads / 32));
  bucketize_kernel<T><<<blocks, kThreads, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<T*>(out), B, n, mode, param,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bucketize_int8(const void* x, void* out, int B, int n,
                              int mode, float param, void* stream) {
  return launch<int8_t>(x, out, B, n, mode, param, stream);
}

extern "C" int bucketize_int16(const void* x, void* out, int B, int n,
                               int mode, float param, void* stream) {
  return launch<int16_t>(x, out, B, n, mode, param, stream);
}
