// Fused dequantize + weighted FedAvg reduce of the clients' Int8 wires,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dequant_reduce.py:
// dequant_reduce (pallas_call at :77).
//
//   out[j] = sum over c = 0..C-1 of wn_c * fl(q[c][j] * s[c][j / 256]),  wn_c = w_c / ws
//
// with ws = safe_weight_sum(w): the fp32 sum of the raw weights in client
// order, 0 -> 1.  The sum over c is one fmaf chain from 0 in client order,
// each code times its block scale rounded on its own first (the TPU
// kernel dequantizes the tile before its dot), wn_c an IEEE division.
// With ``normalize`` off the kernel writes fl(mean * ws): the bits of
// ``out * safe_weight_sum(w)`` around it (the grouped wire reduce's
// weighted sum).  For integer weights summing below 2**24 every order of
// the weight sum is exact, so ws has the bits of PyTorch's sum and the
// result those of the composition this launch replaced (the weights
// normalized around the kernel, the same chain, then the product).
//
// Bound: device-memory bytes.  One multiply and one multiply-add per int8
// code read, so the bytes are the int8 payload (C x Np), its fp32 block
// scales (C x Np/256), the weights and the fp32 (Np,) result: ~19.9 MB for
// the fleet's C = 6 Int8 clients at Np = 1,974,528, ~5.9 us at 3.35 TB/s.
// The unfused form would write and re-read an fp32 (C, Np) matrix, 4x the
// payload.
//
// Design: ONE launch does the weight sum, the normalization, the reduce
// and (normalize off) the product, so an ops call costs one kernel's time.
// - A warp owns a span of 512 columns: two quantization blocks (the last
//   span of an odd block count one).  Lane l holds 16 of its columns, four
//   groups of four at 4 (32 g + l), so a row's codes are four 4-byte loads
//   a lane, each a coalesced 128 B warp access, and the result four float4
//   stores, each one whole 512 B warp store (a lane's 16 codes as one
//   16 B load would be stored as 64 contiguous bytes a lane: each 32 B
//   sector in halves, from two instructions).
// - CTA b's warps own spans 8 b .. 8 b + 7, one a warp.  At the model's Np
//   that is 3,857 spans in 483 CTAs, 4 of them resident an SM (64
//   registers): one wave of 3 or 4 CTAs an SM, so 87 SMs take 32 spans and
//   45 take 24.  Launching the resident 528 CTAs instead, with the spans
//   split evenly (29 or 30 an SM), is `reduce_ablation.py`'s "even-SM
//   grid": on an H100 (700 W) it was 1.2% slower at C = 6 and 0.9% faster
//   at C = 64 (PERF.md, PR 21), since the SMs share one HBM, so the grid
//   stays this simple one.
// - kAhead rows of a lane's codes are in flight, in registers: row c +
//   kAhead is loaded as soon as row c is accumulated.  The first rows are
//   loaded before the weight sum.  The codes are read once, with the
//   evict-first hint (__ldcs).
// - A code becomes a float by a byte permute and an add, not by the I2F
//   unit, which converts 16 values a clock an SM: 126 M codes at C = 64
//   would keep it busy ~30 us.
// - A warp stages its span's block scales in shared memory, kSRows rows at
//   a time (two lanes a row), read back as broadcasts: one load of each
//   scale in place of 16 lanes loading it.
// - Each CTA sums the weights itself (one thread, client order, from shared
//   memory) and keeps the first kWShared normalized weights there; a
//   client past them divides its weight itself.
// - Each output is written once, with no atomics: deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;             // values per quantization block
constexpr int kSpan = 2 * kBlock;       // columns a warp: two blocks, 16 a lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;               // rows of a lane's codes in flight
constexpr int kMinCtas = 4;             // CTAs an SM: the launch bound caps registers at 64
constexpr int kSRows = 64;              // rows of block scales a warp stages at a time
constexpr int kWShared = 1024;          // normalized weights kept in shared memory
constexpr int kScalesPerLane = 2 * kSRows / 32;
static_assert(kSRows % kAhead == 0, "row c's codes live in v[c % kAhead]");

// row `row`'s codes of the lane's 16 columns of span `span`: word g holds
// columns 4 (32 g + lane) .. + 3, in the span's block g / 2 (words 2 and 3
// read as 0 where the span has no second block)
__device__ __forceinline__ void load_codes(uint32_t (&v)[4], const int8_t* __restrict__ row,
                                           int64_t span, int lane, bool second) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(row + span * kSpan) + lane;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    v[g] = (g < 2 || second) ? __ldcs(p + 32 * g) : 0u;
}

// byte b of word `word` as a signed code, exactly, in float: the byte
// biased by 128 placed in the low mantissa bits of 2**23, less 2**23 + 128.
// A byte permute and an add issue at 4x and 8x the rate of the I2F
// conversions (16 a clock an SM), which would take 30 us at C = 64.
__device__ __forceinline__ float code_to_float(uint32_t word, int b) {
  return __int_as_float(__byte_perm(word ^ 0x80808080u, 0x4B000000u, 0x7440 + b)) - 8388736.0f;
}

// block scales of rows [c0, c0 + kSRows) of span `span`: lane l loads
// (row, block) = ((l + 32 m) / 2, (l + 32 m) % 2), 0 past the rows or the
// span's blocks
__device__ __forceinline__ void load_scales(float (&sr)[kScalesPerLane],
                                            const float* __restrict__ scales, int64_t n_blocks,
                                            int64_t c0, int64_t c_rows, int64_t span, int lane,
                                            bool second) {
#pragma unroll
  for (int m = 0; m < kScalesPerLane; ++m) {
    const int e = lane + 32 * m, h = e & 1;
    const int64_t c = c0 + (e >> 1);
    sr[m] = (c < c_rows && (h == 0 || second)) ? __ldg(scales + c * n_blocks + 2 * span + h)
                                               : 0.0f;
  }
}

__device__ __forceinline__ void store_scales(float (*ss)[2], const float (&sr)[kScalesPerLane],
                                             int lane) {
  __syncwarp();  // every lane has read the rows these overwrite
#pragma unroll
  for (int m = 0; m < kScalesPerLane; ++m) {
    const int e = lane + 32 * m;
    ss[e >> 1][e & 1] = sr[m];
  }
  __syncwarp();
}

// acc[4 g + b] += wc * fl(code * scale) for byte b of word g, with the
// scales s0 of words 0 and 1 and s1 of words 2 and 3
__device__ __forceinline__ void accumulate(float (&acc)[16], const uint32_t (&v)[4], float wc,
                                           float s0, float s1) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float sg = g < 2 ? s0 : s1;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float x = code_to_float(v[g], b);
      acc[4 * g + b] = fmaf(wc, __fmul_rn(x, sg), acc[4 * g + b]);
    }
  }
}

__device__ __forceinline__ void store_out(float* __restrict__ out, const float (&acc)[16],
                                          int64_t span, int lane, bool second, int normalize,
                                          float ws) {
  float4* dst = reinterpret_cast<float4*>(out + span * kSpan) + lane;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (g >= 2 && !second) continue;
    float4 o = make_float4(acc[4 * g], acc[4 * g + 1], acc[4 * g + 2], acc[4 * g + 3]);
    if (!normalize)
      o = make_float4(__fmul_rn(o.x, ws), __fmul_rn(o.y, ws), __fmul_rn(o.z, ws),
                      __fmul_rn(o.w, ws));
    dst[32 * g] = o;
  }
}

__global__ void __launch_bounds__(kThreads, kMinCtas) dequant_reduce_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ scales,
    const float* __restrict__ w, float* __restrict__ out, int64_t c_rows, int64_t np_,
    int normalize) {
  __shared__ float wn[kWShared];
  __shared__ float wsum_s;
  __shared__ float ss_all[kWarps][kSRows][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float (*ss)[2] = ss_all[warp];
  const int64_t n_blocks = np_ / kBlock;
  const int64_t n_spans = (n_blocks + 1) / 2;
  const int64_t shared_rows = c_rows < kWShared ? c_rows : kWShared;

  const int64_t span = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const bool live = span < n_spans;  // the last CTA's warps past the spans only sum
  const bool second = 2 * span + 1 < n_blocks;
  uint32_t v[kAhead][4];  // rows c0 .. c0 + kAhead - 1, row c in v[c % kAhead]
  float sr[kScalesPerLane];
  if (live) {  // the first rows and scales, before the weight sum
#pragma unroll
    for (int r = 0; r < kAhead; ++r)
      if (r < c_rows) load_codes(v[r], q + r * np_, span, lane, second);
    load_scales(sr, scales, n_blocks, 0, c_rows, span, lane, second);
  }

  // safe_weight_sum, in client order, by one thread from shared memory
  for (int64_t c = tid; c < shared_rows; c += kThreads) wn[c] = w[c];
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
#pragma unroll 8
    for (int64_t c = 0; c < c_rows; ++c) s = __fadd_rn(s, c < kWShared ? wn[c] : w[c]);
    wsum_s = s == 0.0f ? 1.0f : s;
  }
  __syncthreads();
  const float ws = wsum_s;
  for (int64_t c = tid; c < shared_rows; c += kThreads) wn[c] = __fdiv_rn(wn[c], ws);
  __syncthreads();
  if (!live) return;
  store_scales(ss, sr, lane);

  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
  for (int64_t g0 = 0; g0 < c_rows; g0 += kSRows) {
    if (g0 > 0) {
      load_scales(sr, scales, n_blocks, g0, c_rows, span, lane, second);
      store_scales(ss, sr, lane);
    }
    const int64_t g1 = g0 + kSRows < c_rows ? g0 + kSRows : c_rows;
    for (int64_t c0 = g0; c0 < g1; c0 += kAhead) {
#pragma unroll
      for (int r = 0; r < kAhead; ++r) {
        const int64_t c = c0 + r;
        if (c >= g1) break;
        const float wc = c < kWShared ? wn[c] : __fdiv_rn(w[c], ws);
        accumulate(acc, v[r], wc, ss[c - g0][0], ss[c - g0][1]);
        if (c + kAhead < c_rows) load_codes(v[r], q + (c + kAhead) * np_, span, lane, second);
      }
    }
  }
  store_out(out, acc, span, lane, second, normalize, ws);
}

}  // namespace

// q: (c_rows, np_) int8, scales: (c_rows, np_/256) fp32, w: (c_rows,) fp32
// raw weights -> out: (np_,) fp32.  normalize != 0: the weighted mean; 0:
// the mean times safe_weight_sum(w), rounded to fp32.  c_rows, np_ >= 1,
// np_ % 256 == 0; q is 16-byte aligned and out comes from the allocator
// (the wrapper checks).
extern "C" int repro_dequant_reduce(const int8_t* q, const float* scales, const float* w,
                                    float* out, int64_t c_rows, int64_t np_,
                                    int64_t normalize, cudaStream_t stream) {
  if (c_rows < 1 || np_ < 1 || np_ % kBlock) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_spans = (np_ / kBlock + 1) / 2;
  const int64_t grid = (n_spans + kWarps - 1) / kWarps;
  dequant_reduce_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      q, scales, w, out, c_rows, np_, normalize != 0);
  return static_cast<int>(cudaGetLastError());
}
