// int8 pack/unpack of the compressed mesh collective, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/collective_quant.py:
// collective_pack (pallas_call at :57) and collective_unpack (:85).
//
// The mesh round step all-reduces each rank's partial weighted sum.  With
// the int8 collective every rank quantizes that sum against a per-256-block
// scale that all ranks agreed on beforehand (a MAX all-reduce of the block
// absmax), so the int32 codes of all ranks sum exactly and one unpack after
// the last hop gives the fp32 total.  Unlike quantize.cu the scale is an
// INPUT here: pack never derives it from x.
//
// Bound: both are streaming passes with ~1 operation per 8 bytes, bound by
// device-memory bytes: 4 B in + 4 B out per value plus 4 B per 256-block of
// scale.  At the head model's largest leaf (N = 1,638,400) that is
// ~13.1 MB, ~3.9 us at 3.35 TB/s.
//
// Design: pack gives each 256-value block to one warp.  Each lane loads
// 8 floats as two float4 (neighbouring lanes on neighbouring 16 B, one
// coalesced 512 B access per warp instruction) and the block's scale once,
// and stores 8 int32 codes as two int4.  The codes must match the plain
// version bit for bit, so x / scale is a true IEEE division (no
// --use_fast_math, no reciprocal), rounding is rintf (half to even, as
// torch.round and jnp.round), and the clamp to +-127 lets NaN through as
// PyTorch's clamp does, so the float -> int32 conversion maps it exactly as
// the plain version's conversion on the card does.  Unpack is elementwise:
// each thread loads 4 codes (one int4) and its block's scale, and stores
// one float4 of code * scale, each product one rounded multiply
// (__fmul_rn), as the plain version's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;          // values per scale block
constexpr int kWarpsPerCta = 8;      // pack: one block per warp
constexpr int kUnpackThreads = 256;  // unpack: 4 codes per thread

// clip(rint(v / scale), -127, 127) as an int32, NaN passed to the
// conversion as torch.clamp passes it
__device__ __forceinline__ int code(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = r < -127.0f ? -127.0f : (r > 127.0f ? 127.0f : r);
  return static_cast<int>(r);
}

__device__ __forceinline__ int4 codes4(float4 v, float scale) {
  return make_int4(code(v.x, scale), code(v.y, scale), code(v.z, scale),
                   code(v.w, scale));
}

__global__ void collective_pack_kernel(const float* __restrict__ x,
                                       const float* __restrict__ scales,
                                       int32_t* __restrict__ q,
                                       int64_t n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t blk =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // whole warps leave together
  const float scale = scales[blk];
  const float4* src = reinterpret_cast<const float4*>(x + blk * kBlock);
  int4* dst = reinterpret_cast<int4*>(q + blk * kBlock);
  dst[lane] = codes4(src[lane], scale);            // values [4 lane, 4 lane + 4)
  dst[32 + lane] = codes4(src[32 + lane], scale);  // values [128 + 4 lane, ...)
}

__global__ void collective_unpack_kernel(const int32_t* __restrict__ q,
                                         const float* __restrict__ scales,
                                         float* __restrict__ x,
                                         int64_t n_chunks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_chunks) return;
  const int4 c = reinterpret_cast<const int4*>(q)[i];
  const float s = scales[i / (kBlock / 4)];
  reinterpret_cast<float4*>(x)[i] = make_float4(
      __fmul_rn(static_cast<float>(c.x), s), __fmul_rn(static_cast<float>(c.y), s),
      __fmul_rn(static_cast<float>(c.z), s), __fmul_rn(static_cast<float>(c.w), s));
}

}  // namespace

// x: (n_blocks * 256,) fp32, scales: (n_blocks,) fp32 -> q: int32 codes.
// x and q are 16-byte aligned (the wrapper checks).
extern "C" int repro_collective_pack(const float* x, const float* scales,
                                     int32_t* q, int64_t n_blocks,
                                     cudaStream_t stream) {
  if (n_blocks > 0) {
    const int64_t grid = (n_blocks + kWarpsPerCta - 1) / kWarpsPerCta;
    collective_pack_kernel<<<static_cast<unsigned>(grid), kWarpsPerCta * 32, 0,
                             stream>>>(x, scales, q, n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (n_blocks * 256,) int32 (one rank's codes or their sum over ranks),
// scales: (n_blocks,) fp32 -> x: fp32.  q and x are 16-byte aligned.
extern "C" int repro_collective_unpack(const int32_t* q, const float* scales,
                                       float* x, int64_t n_blocks,
                                       cudaStream_t stream) {
  const int64_t n_chunks = n_blocks * (kBlock / 4);
  if (n_chunks > 0) {
    const int64_t grid = (n_chunks + kUnpackThreads - 1) / kUnpackThreads;
    collective_unpack_kernel<<<static_cast<unsigned>(grid), kUnpackThreads, 0,
                               stream>>>(q, scales, x, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
