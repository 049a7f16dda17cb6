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
// Arithmetic (bitwise the plain version, kernels/ref.py): per 256-value
// block, scale = absmax / 127 as an IEEE division (0 -> 1), and each code
// clip(rintf(x / scale), +-127) with x / scale a true IEEE division (no
// --use_fast_math, no reciprocal); rintf rounds half to even, as
// torch.round and jnp.round do.  The absmax propagates NaN, as torch.amax
// and jnp.max do, so a diverged client's block ships a NaN scale and
// poisons the aggregate visibly instead of being clipped into range; the
// codes of a non-finite block are outside the bitwise contract (float ->
// int8 of NaN is undefined in PyTorch).  Dequantize is one rounded
// multiply a value, (float)code * scale.
//
// Design.  Both kernels run a grid of the CTAs resident on the card at
// once (at most, fewer when the input is smaller), each warp walking its
// share in a grid stride and issuing the next piece's loads before it
// works on the current one, so its loads stay in flight while it reduces,
// divides and stores.
// - quantize: a warp takes one 256-block at a time.  Lane l works on values
//   [4l, 4l + 4) and [128 + 4l, ...) as two float4 (one coalesced 512 B
//   access a warp instruction), the absmax is a shuffle reduction in
//   registers, lane 0 stores the scale, and the codes go out as two char4
//   a lane.  The blocks stream through a ring of two slots a warp in
//   shared memory by 16-byte cp.async: the copies of the warp's next block
//   are issued before the current block is reduced.  Each lane reads back
//   only the two pieces it copied, so no barrier is needed.  The ring
//   holds the kernel at 32 registers and 8 CTAs an SM; a register double
//   buffer took 40 (6 CTAs an SM) and was slower at the codec's Np, and a
//   third slot gained nothing (codec_ablation.py).
// - quantize takes the unpadded length n: values at index >= n read as 0,
//   so codes and scales are those of the input padded with zeros to a
//   block multiple, and the codec's pad costs no pass of its own.  Only
//   the last block can be partial; the piece that straddles n copies the
//   values before n and zero-fills the rest, and nothing reads at or past
//   n.
// - quantize takes x at any 4-byte start: a model leaf's slice of the flat
//   update starts where the leaves before it end (head.w1 of the head
//   model at float 1,638,687, 12 bytes past a 16-byte boundary).  The
//   entry point picks the kernel by x's alignment: a 16-byte start takes
//   the kernel above, unchanged; any other takes
//   quantize_int8_unaligned_kernel, the same ring, reduction and stores
//   with each lane's piece copied as four 4-byte cp.async (each value at or
//   past n zero-filled) in place of one 16-byte copy.
// - dequantize: a warp takes two blocks at a time, 16 codes a lane as four
//   4-byte loads laid out so that each of the lane's four float4 stores is
//   part of one coalesced 512 B warp store (16 codes a lane as one 16 B
//   load stored as 64 contiguous bytes a lane wrote each 32 B sector in
//   halves from two instructions and ran at half the copy rate past L2).
//   Lanes 0 and 1 load the two blocks' scales once and share them by
//   shuffle.  The next two blocks' codes and scales are loaded before the
//   current ones' stores.  Plain stores: the decoded vector is read right
//   after it is written (the residual delta - decode), so it should stay
//   in L2; streaming stores (__stcs) made that residual slower.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;   // values per quantization block
constexpr int kThreads = 256; // threads a CTA, both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;    // quantize: ring slots a warp (the block and the next)

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

// 16-byte asynchronous copy into shared memory: `bytes` (0..16) of gmem,
// the rest zero-filled; nothing is read past them
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(gmem), "r"(bytes));
}

// 4-byte asynchronous copy: `bytes` (0 or 4) of gmem, zero-filled otherwise
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// a: values [4 lane, 4 lane + 4) of block blk, b: [128 + 4 lane, ...)
__device__ __forceinline__ void quantize_block(float4 a, float4 b, int blk, int lane,
                                               int8_t* __restrict__ q,
                                               float* __restrict__ scales) {
  float m = nan_max(absmax4(a), absmax4(b));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  float scale = m / 127.0f;
  if (scale == 0.0f) scale = 1.0f;
  char4* dst = reinterpret_cast<char4*>(q + static_cast<int64_t>(blk) * kBlock);
  dst[lane] = codes4(a, scale);
  dst[32 + lane] = codes4(b, scale);
  if (lane == 0) scales[blk] = scale;
}

// Block indices are 32-bit: the entry point refuses 2^30 blocks or more.
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, int64_t n, int n_blocks) {
  __shared__ float4 ring[kWarps][kStages][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  // this lane's two pieces of block blk into ring slot `slot`, zero past n;
  // a group is committed even past the last block, so the count holds
  auto issue = [&](int blk, int slot) {
    if (blk < n_blocks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t i = static_cast<int64_t>(blk) * kBlock + 128 * h + 4 * lane;
        const int64_t left = n - i;
        const int bytes = left >= 4 ? 16 : left > 0 ? 4 * static_cast<int>(left) : 0;
        cp_async16(&ring[warp][slot][32 * h + lane], bytes ? x + i : x, bytes);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(first + k * stride, k);
  int slot = 0;
  for (int blk = first; blk < n_blocks; blk += stride) {
    issue(blk + (kStages - 1) * stride, (slot + kStages - 1) % kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));  // block blk's copies landed
    quantize_block(ring[warp][slot][lane], ring[warp][slot][32 + lane], blk, lane, q, scales);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
}

// quantize_int8_kernel at any 4-byte start of x: each lane's piece lands
// in its ring slot as four 4-byte copies, each zero-filled at or past n.
__global__ void __launch_bounds__(kThreads)
quantize_int8_unaligned_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                               float* __restrict__ scales, int64_t n, int n_blocks) {
  __shared__ float4 ring[kWarps][kStages][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  auto issue = [&](int blk, int slot) {
    if (blk < n_blocks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t i = static_cast<int64_t>(blk) * kBlock + 128 * h + 4 * lane;
        float* dst = reinterpret_cast<float*>(&ring[warp][slot][32 * h + lane]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = i + e < n;
          cp_async4(dst + e, in ? x + i + e : x, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(first + k * stride, k);
  int slot = 0;
  for (int blk = first; blk < n_blocks; blk += stride) {
    issue(blk + (kStages - 1) * stride, (slot + kStages - 1) % kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    quantize_block(ring[warp][slot][lane], ring[warp][slot][32 + lane], blk, lane, q, scales);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
}

__device__ __forceinline__ float4 dequant4(uint32_t word, float s) {
  return make_float4(
      __fmul_rn(static_cast<float>(static_cast<signed char>(word)), s),
      __fmul_rn(static_cast<float>(static_cast<signed char>(word >> 8)), s),
      __fmul_rn(static_cast<float>(static_cast<signed char>(word >> 16)), s),
      __fmul_rn(static_cast<float>(static_cast<signed char>(word >> 24)), s));
}

// A warp-step is two blocks, 512 codes: lane l takes the 4 codes of words
// 32 j + l (j = 0..3), so each of its four loads and four float4 stores is
// one coalesced warp access (128 B of codes, 512 B of floats) and every
// 32 B sector of the output is written whole by one instruction.  Words
// j = 0, 1 are block 2 w, j = 2, 3 block 2 w + 1, whose scales lanes 0
// and 1 load and share by shuffle.  The last step of an odd block count
// holds one block; which j exist is the same for every lane.
__global__ void __launch_bounds__(kThreads)
dequantize_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                       float* __restrict__ x, int64_t n_blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t steps = (n_blocks + 1) / 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= steps) return;  // whole warps leave together
  const uint32_t* words = reinterpret_cast<const uint32_t*>(q);
  // step w's words (zero past the last block) and, in lanes 0 and 1, its scales
  auto load = [&](int64_t step, uint32_t (&c)[4], float& s) {
    const bool second = 2 * step + 1 < n_blocks;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = j < 2 || second ? words[step * 128 + 32 * j + lane] : 0u;
    if (lane == 0 || (lane == 1 && second)) s = scales[2 * step + lane];
  };
  uint32_t cur[4];
  float s_cur = 0.0f;
  load(w, cur, s_cur);
  for (; w < steps; w += stride) {
    uint32_t next[4] = {};
    float s_next = 0.0f;
    if (w + stride < steps) load(w + stride, next, s_next);
    const float s0 = __shfl_sync(0xffffffffu, s_cur, 0);
    const float s1 = __shfl_sync(0xffffffffu, s_cur, 1);
    const bool second = 2 * w + 1 < n_blocks;
    float4* dst = reinterpret_cast<float4*>(x) + w * 128 + lane;
    dst[0] = dequant4(cur[0], s0);
    dst[32] = dequant4(cur[1], s0);
    if (second) {
      dst[64] = dequant4(cur[2], s1);
      dst[96] = dequant4(cur[3], s1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = next[j];
    s_cur = s_next;
  }
}

// CTAs of `kernel` resident on the current card at once, kept per device
// (-1 and err set if the runtime refuses the query).
template <typename Kernel>
int64_t resident_ctas(Kernel kernel, int64_t* cache, cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess) return -1;
  if (dev >= 64) {
    *err = cudaErrorInvalidDevice;
    return -1;
  }
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (*err != cudaSuccess) return -1;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return -1;
    cache[dev] = static_cast<int64_t>(per_sm < 1 ? 1 : per_sm) * sms;
  }
  return cache[dev];
}

// the grid for `warp_steps` pieces of one warp each: one CTA a kWarps
// pieces, at most the resident CTAs
int64_t grid_for(int64_t warp_steps, int64_t resident) {
  const int64_t grid = (warp_steps + kWarps - 1) / kWarps;
  return grid < resident ? grid : resident;
}

}  // namespace

// x: (n,) fp32 -> q: (n_blocks * 256,) int8, scales: (n_blocks,) fp32, with
// n_blocks = ceil(n / 256): the codes and scales of x padded with zeros,
// the pad's codes written too.  x is 4-byte aligned, q 16-byte aligned
// (the wrapper checks); x's alignment picks the kernel.
extern "C" int repro_quantize_int8(const float* x, int8_t* q, float* scales, int64_t n,
                                   int64_t n_blocks, cudaStream_t stream) {
  if (n < 0 || n_blocks != (n + kBlock - 1) / kBlock || n_blocks >= (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    cudaError_t err;
    if (reinterpret_cast<uintptr_t>(x) % 16) {
      static int64_t resident_u[64] = {};
      const int64_t cap_u = resident_ctas(quantize_int8_unaligned_kernel, resident_u, &err);
      if (cap_u < 0) return static_cast<int>(err);
      quantize_int8_unaligned_kernel<<<static_cast<unsigned>(grid_for(n_blocks, cap_u)),
                                       kThreads, 0, stream>>>(x, q, scales, n,
                                                              static_cast<int>(n_blocks));
      return static_cast<int>(cudaGetLastError());
    }
    static int64_t resident[64] = {};
    const int64_t cap = resident_ctas(quantize_int8_kernel, resident, &err);
    if (cap < 0) return static_cast<int>(err);
    quantize_int8_kernel<<<static_cast<unsigned>(grid_for(n_blocks, cap)), kThreads, 0,
                           stream>>>(x, q, scales, n, static_cast<int>(n_blocks));
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (n_blocks * 256,) int8, scales: (n_blocks,) fp32 -> x: fp32.  q and x
// are 16-byte aligned (the wrapper checks).
extern "C" int repro_dequantize_int8(const int8_t* q, const float* scales, float* x,
                                     int64_t n_blocks, cudaStream_t stream) {
  if (n_blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    static int64_t resident[64] = {};
    cudaError_t err;
    const int64_t cap = resident_ctas(dequantize_int8_kernel, resident, &err);
    if (cap < 0) return static_cast<int>(err);
    dequantize_int8_kernel<<<static_cast<unsigned>(grid_for((n_blocks + 1) / 2, cap)),
                             kThreads, 0, stream>>>(q, scales, x, n_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
