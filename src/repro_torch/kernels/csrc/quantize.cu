// int8 block quantization codec for the FL uplink, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize.py:
// quantize_int8 (pallas_call at :41) and dequantize_int8 (:69).
//
// Bound: both are streaming passes that do ~1 operation per byte, so they
// are bound by device-memory bytes (fp32 in + int8 out + one fp32 scale per
// 256 values, or the reverse).  At the model's Np = 1,974,528 that is
// ~9.9 MB, ~3.0 us at 3.35 TB/s.
//
// Design: quantize gives each 256-value block to one warp.  Each lane
// loads 8 floats as two float4 (neighbouring lanes on neighbouring 16 B, so
// every load is one coalesced 512 B warp access), the block's absmax is a
// warp-shuffle reduction in registers, and lane 0 stores the scale: no
// shared memory, no second pass.  The codes must match the plain version
// bit for bit, so scale = absmax / 127 and x / scale are true IEEE
// divisions (no --use_fast_math, no reciprocal) and rounding is rintf:
// half to even, as torch.round and jnp.round do.  The absmax propagates
// NaN, as torch.amax and jnp.max do, so a diverged client's block ships a
// NaN scale and poisons the aggregate visibly instead of being clipped
// into range; the codes of a non-finite block are outside the bitwise
// contract (float -> int8 of NaN is undefined in PyTorch).  Dequantize is
// elementwise: each thread loads 8 codes (one 8 B load) and its block's
// scale and stores two float4.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;        // values per quantization block
constexpr int kWarpsPerCta = 8;    // quantize: one block per warp
constexpr int kDequantThreads = 256;
constexpr int kCodesPerThread = 8; // dequantize: 8 codes per thread

// max that keeps NaN (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float absmax4(float4 v) {
  return nan_max(nan_max(fabsf(v.x), fabsf(v.y)), nan_max(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ signed char code(float v, float scale) {
  float r = rintf(v / scale);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(r));
}

__device__ __forceinline__ char4 codes4(float4 v, float scale) {
  return make_char4(code(v.x, scale), code(v.y, scale), code(v.z, scale),
                    code(v.w, scale));
}

__global__ void quantize_int8_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scales,
                                     int64_t n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t blk =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // whole warps leave together
  const float4* src = reinterpret_cast<const float4*>(x + blk * kBlock);
  const float4 a = src[lane];       // values [4 lane, 4 lane + 4)
  const float4 b = src[32 + lane];  // values [128 + 4 lane, ...)
  float m = nan_max(absmax4(a), absmax4(b));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  float scale = m / 127.0f;
  if (scale == 0.0f) scale = 1.0f;
  char4* dst = reinterpret_cast<char4*>(q + blk * kBlock);
  dst[lane] = codes4(a, scale);
  dst[32 + lane] = codes4(b, scale);
  if (lane == 0) scales[blk] = scale;
}

__global__ void dequantize_int8_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ x,
                                       int64_t n_chunks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_chunks) return;
  const int2 raw = reinterpret_cast<const int2*>(q)[i];
  const float s = scales[i / (kBlock / kCodesPerThread)];
  const signed char* v = reinterpret_cast<const signed char*>(&raw);
  float4* dst = reinterpret_cast<float4*>(x) + 2 * i;
  dst[0] = make_float4(v[0] * s, v[1] * s, v[2] * s, v[3] * s);
  dst[1] = make_float4(v[4] * s, v[5] * s, v[6] * s, v[7] * s);
}

}  // namespace

// x: (n_blocks * 256,) fp32 -> q: int8, scales: (n_blocks,) fp32.
// Every pointer is 16-byte aligned (the wrapper checks).
extern "C" int repro_quantize_int8(const float* x, int8_t* q, float* scales,
                                   int64_t n_blocks, cudaStream_t stream) {
  if (n_blocks > 0) {
    const int64_t grid = (n_blocks + kWarpsPerCta - 1) / kWarpsPerCta;
    quantize_int8_kernel<<<static_cast<unsigned>(grid), kWarpsPerCta * 32, 0,
                           stream>>>(x, q, scales, n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (n_blocks * 256,) int8, scales: (n_blocks,) fp32 -> x: fp32.
extern "C" int repro_dequantize_int8(const int8_t* q, const float* scales,
                                     float* x, int64_t n_blocks,
                                     cudaStream_t stream) {
  const int64_t n_chunks = n_blocks * (kBlock / kCodesPerThread);
  if (n_chunks > 0) {
    const int64_t grid = (n_chunks + kDequantThreads - 1) / kDequantThreads;
    dequantize_int8_kernel<<<static_cast<unsigned>(grid), kDequantThreads, 0,
                             stream>>>(q, scales, x, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
