// int8 pack/unpack of the compressed mesh collective, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/collective_quant.py:
// collective_pack (pallas_call at :57) and collective_unpack (:85), and
// takes in the work that CompressedPsum.psum runs around them
// (src/repro/core/compression.py:1290-1313): the fold of the rank's weight
// and residual, the per-block absmax (:1285), the pad, the scale rule, the
// new residual and the masked-rank selects.
//
// The mesh round step all-reduces each rank's partial weighted sum of every
// model leaf.  With the int8 collective every rank quantizes that sum
// against a per-256-block scale that all ranks agreed on beforehand (a MAX
// all-reduce of the block absmax), so the int32 codes of all ranks sum
// exactly and one unpack after the last hop gives the fp32 total.  A round
// makes three launches, each over every leaf at once:
//   collective_absmax: eff = fl(fl(d * wf) + r) (0 for a masked rank), and
//     the block's max |eff|, NaN kept, into one (Nb,) fp32 buffer;
//   -- a MAX all-reduce of that buffer over every tier --
//   collective_pack: scale = absmax == 0 ? 1 : absmax / 127; the codes
//     clip(rint(eff / scale), +-127) into one (Np,) int32 buffer, the
//     scales into an (Nb,) one, and the new residual
//     fl(eff - fl(code * scale)) (a masked rank's carried as it was) into
//     one (Np,) fp32 buffer;
//   -- a SUM all-reduce of the codes over every tier --
//   collective_unpack: fl(code * scale) into one (Np,) fp32 buffer.
// Leaf i owns blocks [b_i, b_i+1) of the flat buffers, that is slots
// [256 b_i, 256 b_i + n_i), and its last block reads zeros past n_i: that
// is the reference's pad, and no pass of its own.  The single-vector pack
// of the TPU kernel (x against given scales, N % 256 == 0) is the same pack
// launch with one leaf, no weight, no residual and the scales an input;
// the single-vector unpack is the same unpack launch.
//
// Arithmetic (bitwise the plain versions, kernels/ref.py, leaf by leaf):
// every product, sum and difference is one IEEE rounding in the
// reference's order (__fmul_rn, __fadd_rn, __fsub_rn: no contraction into
// an fma), each division a true IEEE division (__fdiv_rn: no
// --use_fast_math, no reciprocal), rintf rounds half to even as
// torch.round and jnp.round do, and the clamp to +-127 lets NaN through as
// torch.clamp does, so the float -> int32 conversion maps it as the plain
// version's conversion on the card does.  The absmax keeps NaN (fmaxf
// drops it; torch.amax and jnp.max keep it).
//
// Bound: all three stream device memory at ~1 operation per 4 bytes.  At
// the head model's five leaves (N = 1,974,303 values, Nb = 7,713 blocks,
// Np = 1,974,528 slots): absmax reads d and r (15.8 MB, ~4.7 us at
// 3.35 TB/s); pack reads them again with the absmax and writes codes,
// scales and residual (31.6 MB, ~9.4 us); unpack reads codes and scales
// and writes the totals (15.8 MB, ~4.7 us).  Pack recomputes eff rather
// than reading it back: the same DRAM bytes either way (absmax would
// write 4 B a slot that pack reads in place of 8), no (Np,) buffer, and
// d and r (15.8 MB) are likely still in the 50 MB L2 after the MAX
// all-reduce of 31 KB.
//
// Design.  A warp takes one 256-value block at a time; lane l works on
// values [4l, 4l + 4) and [128 + 4l, ...), so each warp access of 16 B a
// lane is one coalesced 512 B access.  The grid is the CTAs resident on
// the card at once (fewer when the input is smaller), walking the blocks
// of every leaf in a grid stride; the leaf of a block is found by walking
// the leaf table forward (a warp's blocks only grow), and the table is a
// __grid_constant__ kernel parameter, read in place from the constant
// bank: no copy to the card, none to local memory.  A leaf's values and
// residual load 16 B a lane where their start is 16-byte aligned, 4 B
// otherwise (a leaf of a flat decode starts anywhere: the head model's
// head.w1 at float 1,638,687); the outputs are flat buffers that start
// aligned, so every store is a whole 512 B warp store (64 contiguous bytes
// a lane ran at half the copy rate past L2 in codec_ablation.py).  At Np
// the resident grid holds every block of absmax in one wave and of pack in
// 1.2 (40 registers: 6 CTAs an SM; the uncapped grid times the same in
// collective_ablation.py), so neither keeps loads of a next block in
// flight; unpack, with 8 registers of codes a block, does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;     // values per scale block
constexpr int kThreads = 256;   // threads a CTA, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLeaves = 96;  // the table stays under 4 KB of kernel parameters

// The leaves of one launch: leaf i is d[i][0, n[i]) with its residual
// r[i] (nullptr: none) and owns blocks [first[i], first[i + 1]).
struct Leaves {
  const float* d[kMaxLeaves];
  const float* r[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int first[kMaxLeaves + 1];
  int count;
};

// The rank's fold: eff = fl(fl(d * w) + r) (no multiply without a weight,
// no add without a residual); a masked rank's eff is 0.
struct Fold {
  float w;
  bool has_w;
  bool live;
};

__device__ __forceinline__ Fold fold_of(const float* wf, const bool* live) {
  return Fold{wf ? *wf : 1.0f, wf != nullptr, live ? *live : true};
}

// max that keeps NaN (fmaxf drops it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float absmax4(float4 v) {
  return nan_max(nan_max(fabsf(v.x), fabsf(v.y)), nan_max(fabsf(v.z), fabsf(v.w)));
}

// p[i, i + 4) with zeros at and past n, nothing read there; one 16-byte
// load where p starts 16-byte aligned (i is a multiple of 4)
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int64_t i, int64_t n) {
  const int64_t left = n - i;
  if (left >= 4) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0)
      return __ldg(reinterpret_cast<const float4*>(p + i));
    return make_float4(__ldg(p + i), __ldg(p + i + 1), __ldg(p + i + 2), __ldg(p + i + 3));
  }
  return make_float4(left > 0 ? __ldg(p + i) : 0.0f, left > 1 ? __ldg(p + i + 1) : 0.0f,
                     left > 2 ? __ldg(p + i + 2) : 0.0f, 0.0f);
}

__device__ __forceinline__ float eff1(float d, float r, bool has_r, bool valid, Fold f) {
  if (!valid || !f.live) return 0.0f;  // the pad, or a rank that sends nothing
  const float x = f.has_w ? __fmul_rn(d, f.w) : d;
  return has_r ? __fadd_rn(x, r) : x;
}

// eff of the four values from i, zero at and past n
__device__ __forceinline__ float4 eff4(float4 d, float4 r, bool has_r, int64_t i, int64_t n,
                                       Fold f) {
  const int64_t left = n - i;
  return make_float4(eff1(d.x, r.x, has_r, left > 0, f), eff1(d.y, r.y, has_r, left > 1, f),
                     eff1(d.z, r.z, has_r, left > 2, f), eff1(d.w, r.w, has_r, left > 3, f));
}

// One warp's view of block blk: values [4 lane, 4 lane + 4) (h = 0) and
// [128 + 4 lane, ...) (h = 1) of its leaf, and their residual
struct BlockView {
  float4 d[2], r[2], eff[2];
};

__device__ __forceinline__ BlockView view_block(const Leaves& lv, int leaf, int blk, int lane,
                                                Fold f) {
  BlockView v;
  const int64_t n = lv.n[leaf];
  const float* d = lv.d[leaf];
  const float* r = lv.r[leaf];
  const int64_t base = static_cast<int64_t>(blk - lv.first[leaf]) * kBlock + 4 * lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t i = base + 128 * h;
    v.d[h] = load4(d, i, n);
    v.r[h] = r ? load4(r, i, n) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v.eff[h] = eff4(v.d[h], v.r[h], r != nullptr, i, n, f);
  }
  return v;
}

// clip(rint(v / scale), -127, 127) as an int32, NaN passed to the
// conversion as torch.clamp passes it
__device__ __forceinline__ int code(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = r < -127.0f ? -127.0f : (r > 127.0f ? 127.0f : r);
  return static_cast<int>(r);
}

__device__ __forceinline__ int4 codes4(float4 v, float scale) {
  return make_int4(code(v.x, scale), code(v.y, scale), code(v.z, scale), code(v.w, scale));
}

__device__ __forceinline__ float4 unpack4(int4 c, float s) {
  return make_float4(__fmul_rn(static_cast<float>(c.x), s), __fmul_rn(static_cast<float>(c.y), s),
                     __fmul_rn(static_cast<float>(c.z), s), __fmul_rn(static_cast<float>(c.w), s));
}

// what was not sent: fl(eff - fl(code * scale))
__device__ __forceinline__ float4 residual4(float4 e, int4 c, float s) {
  const float4 sent = unpack4(c, s);
  return make_float4(__fsub_rn(e.x, sent.x), __fsub_rn(e.y, sent.y), __fsub_rn(e.z, sent.z),
                     __fsub_rn(e.w, sent.w));
}

__global__ void __launch_bounds__(kThreads)
collective_absmax_kernel(const __grid_constant__ Leaves lv, const float* __restrict__ wf,
                         const bool* __restrict__ live, float* __restrict__ absmax) {
  const int lane = threadIdx.x & 31;
  const int n_blocks = lv.first[lv.count];
  const int stride = gridDim.x * kWarps;
  const Fold f = fold_of(wf, live);
  int leaf = 0;
  for (int blk = blockIdx.x * kWarps + (threadIdx.x >> 5); blk < n_blocks; blk += stride) {
    while (lv.first[leaf + 1] <= blk) ++leaf;  // uniform in the warp
    const BlockView v = view_block(lv, leaf, blk, lane, f);
    float m = nan_max(absmax4(v.eff[0]), absmax4(v.eff[1]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) absmax[blk] = m;
  }
}

// derive: sc_in holds the agreed absmax, and the scales derived from it
// go to scales_out; otherwise sc_in holds the scales.  r_out (nullptr:
// not written) takes the new residual, a masked rank's carried.
__global__ void __launch_bounds__(kThreads)
collective_pack_kernel(const __grid_constant__ Leaves lv, const float* __restrict__ wf,
                       const bool* __restrict__ live, const float* __restrict__ sc_in,
                       bool derive, int32_t* __restrict__ q, float* __restrict__ scales_out,
                       float* __restrict__ r_out) {
  const int lane = threadIdx.x & 31;
  const int n_blocks = lv.first[lv.count];
  const int stride = gridDim.x * kWarps;
  const Fold f = fold_of(wf, live);
  int leaf = 0;
  for (int blk = blockIdx.x * kWarps + (threadIdx.x >> 5); blk < n_blocks; blk += stride) {
    while (lv.first[leaf + 1] <= blk) ++leaf;  // uniform in the warp
    const BlockView v = view_block(lv, leaf, blk, lane, f);
    float s = __ldg(sc_in + blk);
    if (derive) {
      s = s == 0.0f ? 1.0f : __fdiv_rn(s, 127.0f);
      if (lane == 0) scales_out[blk] = s;
    }
    const int64_t out = static_cast<int64_t>(blk) * (kBlock / 4) + lane;  // in 16 B units
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int4 c = codes4(v.eff[h], s);
      reinterpret_cast<int4*>(q)[out + 32 * h] = c;
      if (r_out)
        reinterpret_cast<float4*>(r_out)[out + 32 * h] =
            f.live ? residual4(v.eff[h], c, s) : v.r[h];
    }
  }
}

// A warp takes a block at a time, lane l its codes [4l, 4l + 4) and
// [128 + 4l, ...) as two int4, and loads the next block's codes and scale
// before it stores the current one's two float4.
__global__ void __launch_bounds__(kThreads)
collective_unpack_kernel(const int32_t* __restrict__ q, const float* __restrict__ scales,
                         float* __restrict__ x, int n_blocks) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  int blk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // whole warps leave together
  const int4* src = reinterpret_cast<const int4*>(q);
  float4* dst = reinterpret_cast<float4*>(x);
  auto at = [&](int b) { return static_cast<int64_t>(b) * (kBlock / 4) + lane; };
  int4 c0 = __ldg(src + at(blk)), c1 = __ldg(src + at(blk) + 32);
  float s = __ldg(scales + blk);
  for (; blk < n_blocks; blk += stride) {
    int4 n0 = make_int4(0, 0, 0, 0), n1 = n0;
    float ns = 0.0f;
    if (blk + stride < n_blocks) {
      n0 = __ldg(src + at(blk + stride));
      n1 = __ldg(src + at(blk + stride) + 32);
      ns = __ldg(scales + blk + stride);
    }
    dst[at(blk)] = unpack4(c0, s);
    dst[at(blk) + 32] = unpack4(c1, s);
    c0 = n0;
    c1 = n1;
    s = ns;
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

// the grid for n_blocks blocks of one warp each: a CTA every kWarps
// blocks, at most the resident CTAs
template <typename Kernel>
int64_t grid_for(Kernel kernel, int64_t* cache, int64_t n_blocks, cudaError_t* err) {
  const int64_t cap = resident_ctas(kernel, cache, err);
  if (cap < 0) return -1;
  const int64_t grid = (n_blocks + kWarps - 1) / kWarps;
  return grid < cap ? grid : cap;
}

// The table from the caller's (n_leaves, 3) int64 rows (values pointer,
// residual pointer or 0, length); false if it does not fit, or its blocks
// do not add up to n_blocks (block indices are 32-bit: under 2^30).
bool read_table(const int64_t* rows, int64_t n_leaves, int64_t n_blocks, Leaves* lv) {
  if (rows == nullptr || n_leaves < 1 || n_leaves > kMaxLeaves || n_blocks < 0 ||
      n_blocks >= (int64_t{1} << 30))
    return false;
  int64_t first = 0;
  for (int64_t i = 0; i < n_leaves; ++i) {
    const int64_t n = rows[3 * i + 2];
    if (n < 0 || (n > 0 && rows[3 * i] == 0)) return false;
    lv->d[i] = reinterpret_cast<const float*>(rows[3 * i]);
    lv->r[i] = reinterpret_cast<const float*>(rows[3 * i + 1]);
    lv->n[i] = n;
    lv->first[i] = static_cast<int>(first);
    first += (n + kBlock - 1) / kBlock;
    if (first > n_blocks) return false;
  }
  lv->first[n_leaves] = static_cast<int>(first);
  lv->count = static_cast<int>(n_leaves);
  return first == n_blocks;
}

}  // namespace

// table: (n_leaves, 3) int64 rows on the host (values pointer, residual
// pointer or 0, length); wf: the rank's weight or nullptr; live: whether
// it takes part or nullptr -> absmax: (n_blocks,) fp32, every leaf's
// blocks in order.
extern "C" int repro_collective_absmax(const int64_t* table, int64_t n_leaves, const float* wf,
                                       const bool* live, float* absmax, int64_t n_blocks,
                                       cudaStream_t stream) {
  Leaves lv;
  if (!read_table(table, n_leaves, n_blocks, &lv)) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    static int64_t resident[64] = {};
    cudaError_t err;
    const int64_t grid = grid_for(collective_absmax_kernel, resident, n_blocks, &err);
    if (grid < 0) return static_cast<int>(err);
    collective_absmax_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        lv, wf, live, absmax);
  }
  return static_cast<int>(cudaGetLastError());
}

// The table, wf and live as for the absmax.  derive != 0: sc_in is the
// agreed (n_blocks,) absmax and the scales go to scales_out; otherwise
// sc_in holds the scales.  q: (n_blocks * 256,) int32 codes; r_out: the
// (n_blocks * 256,) fp32 new residual, or nullptr (every leaf then has
// none).  q, scales_out and r_out are 16-byte aligned (the wrapper
// allocates them).
extern "C" int repro_collective_pack(const int64_t* table, int64_t n_leaves, const float* wf,
                                     const bool* live, const float* sc_in, int64_t derive,
                                     int32_t* q, float* scales_out, float* r_out,
                                     int64_t n_blocks, cudaStream_t stream) {
  Leaves lv;
  if (!read_table(table, n_leaves, n_blocks, &lv) || (derive && scales_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    static int64_t resident[64] = {};
    cudaError_t err;
    const int64_t grid = grid_for(collective_pack_kernel, resident, n_blocks, &err);
    if (grid < 0) return static_cast<int>(err);
    collective_pack_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        lv, wf, live, sc_in, derive != 0, q, scales_out, r_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (n_blocks * 256,) int32 (one rank's codes or their sum over ranks),
// scales: (n_blocks,) fp32 -> x: fp32.  q and x are 16-byte aligned (the
// wrapper checks).
extern "C" int repro_collective_unpack(const int32_t* q, const float* scales, float* x,
                                       int64_t n_blocks, cudaStream_t stream) {
  if (n_blocks < 0 || n_blocks >= (int64_t{1} << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks > 0) {
    static int64_t resident[64] = {};
    cudaError_t err;
    const int64_t grid = grid_for(collective_unpack_kernel, resident, n_blocks, &err);
    if (grid < 0) return static_cast<int>(err);
    collective_unpack_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        q, scales, x, static_cast<int>(n_blocks));
  }
  return static_cast<int>(cudaGetLastError());
}
