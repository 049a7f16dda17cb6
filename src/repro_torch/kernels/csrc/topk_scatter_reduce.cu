// TopK scatter-accumulate weighted reduce of the clients' sparse (idx, val)
// wires, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scatter_reduce.py:
// topk_scatter_reduce (pallas_call at :108).
//
//   out[i] = (sum over c, j with idx[c][j] == i of fl(w_c * val[c][j])) / wsum
//
// summed in client order c = 0..C-1, with wsum = safe_weight_sum(w): the
// fp32 sum of the weights, 0 -> 1.  With ``normalize`` off the kernel
// writes fl(fl(acc / wsum) * wsum) instead, the two roundings of the mean
// times safe_weight_sum(w) (the grouped wire reduce's weighted sum).
// Out-of-range and negative indices are dropped (as index 0 with value 0,
// exactly as the plain version sanitizes them), duplicates accumulate, any
// N.
//
// Bound: device-memory bytes.  The wires are C*k*8 B (int32 index + fp32
// value) and the (N,) fp32 result N*4 B; for the mixed fleet's C = 4 TopK
// clients at N = 1,974,303 and k = 19,743 that is ~8.53 MB, ~2.55 us at
// 3.35 TB/s, and the output write dominates.  The (C, N) dense matrix is
// never built.
//
// Design: ONE cooperative launch does the weight sum, the check and index
// of the wires, the scatter and the normalization, so an ops call costs one
// kernel's time and no more.  Every CTA of the grid is resident at once;
// one grid-wide barrier splits the launch in two phases.
// - Phase 1 checks the wires and indexes them.  A unit is 1024 consecutive
//   entries of one row, four a thread, all loaded before any is used; the
//   CTAs take the units in turn.  A unit writes its flag, 1 if any of its
//   entries is out of [0, N) or not above its predecessor (a foreign wire:
//   unsorted, repeated or out of range), else 0; and, for every tile
//   boundary t * kTile that falls between an entry and its predecessor,
//   start[c][t] = j (the row's first entry in tile t).  On a canonical row
//   (TopKCodec's wire: distinct, ascending, in range) every
//   start[c][0..tiles] is written once, by exactly one entry, so nothing is
//   read that this launch did not write; on a foreign row start is never
//   read.  Each CTA also sums the weights in a fixed order (per-thread
//   strided sums, then shuffles in each warp, then the 8 warp sums in
//   order): for weights that are integers (example counts) summing below
//   2**24 every partial sum is exact, so wsum has the bits of any other
//   order, PyTorch's included.  Then, before the barrier, each CTA fills
//   the output span of each of its tiles with fl(0 / wsum) (times wsum
//   when not normalizing): the (N,) write, which bounds the kernel, is in
//   flight while the barrier is met and the scatter runs (with up to kAhead
//   rows; with more, the span is written whole after the scatter).
// - After the barrier each CTA owns kTile output floats in shared memory
//   at a time (tile t, t + gridDim.x, ...), ORs the unit flags of every
//   row, and adds the rows' entries that land in its tile, row by row in
//   client order with a __syncthreads() between rows.  A canonical row's
//   entries for tile t are the contiguous range start[c][t] ..
//   start[c][t+1], one thread an entry, so no two threads touch one float
//   and the adds need no atomics: every float receives its terms in client
//   order, the same bits on every launch.  A foreign row is scanned whole
//   by every CTA and added with a compare-and-swap loop, so no term is lost
//   and the order of its additions may vary.  Then the CTA writes, divided
//   by wsum, only the floats its entries touched, over the fill (with more
//   than kAhead rows, the whole span).
// Products and sums are two rounded operations (__fmul_rn, __fadd_rn), as
// in the plain version, never an FMA.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 8192;    // output floats per CTA (32 KB of shared memory)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                 // entries a thread checks per unit in phase 1
constexpr int kUnit = kThreads * kPer;  // entries of a row in a phase-1 unit
constexpr int kAhead = 8;      // rows whose entries a thread loads before adding

// Exact IEEE add into shared memory from several threads at once (the
// foreign-row path): a float atomicAdd would flush subnormals.
__device__ __forceinline__ void add_cas(float* addr, float x) {
  int* a = reinterpret_cast<int*>(addr);
  int old = *a, assumed;
  do {
    assumed = old;
    old = atomicCAS(a, assumed, __float_as_int(__fadd_rn(__int_as_float(assumed), x)));
  } while (old != assumed);
}

__device__ __forceinline__ float finish(float acc, float wsum, int normalize) {
  const float mean = __fdiv_rn(acc, wsum);
  return normalize ? mean : __fmul_rn(mean, wsum);
}

__global__ void __launch_bounds__(kThreads) topk_scatter_reduce_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ val,
    const float* __restrict__ w, float* __restrict__ out, int32_t* __restrict__ flags,
    int32_t* __restrict__ start, int64_t c_rows, int64_t k, int64_t n, int64_t tiles,
    int64_t units_per_row, int normalize) {
  __shared__ __align__(16) float tile[kTile];
  __shared__ int32_t seg_a[kThreads], seg_b[kThreads], seg_f[kThreads];
  __shared__ float seg_w[kThreads];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the first weights are loaded now and summed after phase 1
  const float w0 = tid < c_rows ? w[tid] : 0.0f;

  // ---- phase 1: flag foreign rows, index the canonical ones ----
  for (int64_t u = blockIdx.x; u < c_rows * units_per_row; u += gridDim.x) {
    const int64_t c = u / units_per_row;
    const int64_t j0 = (u % units_per_row) * kUnit + tid;
    const int32_t* row = idx + c * k;
    int64_t cur[kPer], prev[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int64_t j = j0 + p * kThreads;
      cur[p] = j < k ? row[j] : 0;
      prev[p] = j > 0 && j < k ? row[j - 1] : -1;
    }
    int bad = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int64_t j = j0 + p * kThreads;
      if (j >= k) break;
      if (cur[p] < 0 || cur[p] >= n || prev[p] >= cur[p]) {
        bad = 1;
      } else if (prev[p] >= -1) {  // below -1: entry j - 1 flags the row
        int32_t* s = start + c * (tiles + 1);
        const int64_t tc = cur[p] / kTile;
        for (int64_t t = prev[p] < 0 ? 0 : prev[p] / kTile + 1; t <= tc; ++t)
          s[t] = static_cast<int32_t>(j);
        if (j == k - 1)
          for (int64_t t = tc + 1; t <= tiles; ++t) s[t] = static_cast<int32_t>(k);
      }
    }
    bad = __syncthreads_or(bad);
    if (tid == 0) flags[u] = bad;
  }

  // safe_weight_sum in a fixed order
  float part = w0;
  for (int64_t c = tid + kThreads; c < c_rows; c += kThreads) part = __fadd_rn(part, w[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
  if (lane == 0) seg_w[warp] = part;
  __syncthreads();
  float wsum = seg_w[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) wsum = __fadd_rn(wsum, seg_w[i]);
  wsum = wsum == 0.0f ? 1.0f : wsum;

  // fill this CTA's spans with what an untouched float becomes; out + lo is
  // 16-byte aligned where out is (lo is a multiple of kTile)
  const float z = finish(0.0f, wsum, normalize);
  for (int64_t t = blockIdx.x; c_rows <= kAhead && t < tiles; t += gridDim.x) {
    const int64_t lo = t * kTile;
    const int64_t span = (lo + kTile < n ? lo + kTile : n) - lo;
    for (int64_t i = tid; i < span / 4; i += kThreads)
      reinterpret_cast<float4*>(out + lo)[i] = make_float4(z, z, z, z);
    for (int64_t i = span / 4 * 4 + tid; i < span; i += kThreads) out[lo + i] = z;
  }
  cg::this_grid().sync();  // every flag and start of this launch is written

  // ---- phase 2: scatter, one tile of the output at a time ----
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t lo = t * kTile;
    const int64_t hi = lo + kTile < n ? lo + kTile : n;
    __syncthreads();  // the previous tile's floats are written out
    for (int i = tid; i < kTile / 4; i += kThreads)
      reinterpret_cast<float4*>(tile)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    // this thread's first entry of each of the next kAhead rows, all loads
    // in flight at once (with c_rows <= kAhead: of every row, kept for the
    // write-out)
    int32_t pi[kAhead];
    float pv[kAhead];
    for (int64_t g0 = 0; g0 < c_rows; g0 += kThreads) {
      const int64_t g_rows = c_rows - g0 < kThreads ? c_rows - g0 : kThreads;
      __syncthreads();  // the previous group's bounds are no longer read
      if (tid < g_rows) {
        const int64_t c = g0 + tid;
        seg_f[tid] = 0;
        // a foreign row's start is not of this launch, and never used
        seg_a[tid] = start[c * (tiles + 1) + t];
        seg_b[tid] = start[c * (tiles + 1) + t + 1];
        seg_w[tid] = w[c];
      }
      __syncthreads();
      // a row is foreign if any of its unit flags is set: every flag of the
      // group's rows loaded at once
#pragma unroll 4
      for (int64_t i = tid; i < g_rows * units_per_row; i += kThreads)
        if (flags[g0 * units_per_row + i]) atomicOr(&seg_f[i / units_per_row], 1);
      __syncthreads();
      for (int64_t r0 = 0; r0 < g_rows; r0 += kAhead) {
#pragma unroll
        for (int r = 0; r < kAhead; ++r) {
          pi[r] = -1;
          pv[r] = 0.0f;
          const int64_t rr = r0 + r;
          if (rr < g_rows && !seg_f[rr]) {
            const int64_t j = seg_a[rr] + tid;
            if (j < seg_b[rr]) {
              const int64_t e = (g0 + rr) * k + j;
              pi[r] = idx[e];
              pv[r] = val[e];
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kAhead; ++r) {
          const int64_t rr = r0 + r;
          if (rr >= g_rows) break;  // the same for every thread of the CTA
          const int64_t base = (g0 + rr) * k;
          const float wc = seg_w[rr];
          if (seg_f[rr]) {
            for (int64_t j = tid; j < k; j += kThreads) {
              int64_t i = idx[base + j];
              float v = val[base + j];
              if (i < 0 || i >= n) {
                i = 0;
                v = 0.0f;
              }
              if (i >= lo && i < hi) add_cas(&tile[i - lo], __fmul_rn(wc, v));
            }
          } else {
            if (pi[r] >= 0) {
              float* p = &tile[pi[r] - lo];
              *p = __fadd_rn(*p, __fmul_rn(wc, pv[r]));
            }
            for (int64_t j = seg_a[rr] + tid + kThreads; j < seg_b[rr]; j += kThreads) {
              float* p = &tile[idx[base + j] - lo];
              *p = __fadd_rn(*p, __fmul_rn(wc, val[base + j]));
            }
          }
          __syncthreads();  // client c's terms land before client c+1's
        }
      }
    }

    if (c_rows <= kAhead) {  // one batch: its bounds and first entries are at hand
#pragma unroll
      for (int r = 0; r < kAhead; ++r) {
        if (r >= c_rows) break;
        const int64_t base = r * k;
        if (seg_f[r]) {
          for (int64_t j = tid; j < k; j += kThreads) {
            int64_t i = idx[base + j];
            if (i < 0 || i >= n) i = 0;  // the scatter added its 0 there
            if (i >= lo && i < hi) out[i] = finish(tile[i - lo], wsum, normalize);
          }
        } else {
          if (pi[r] >= 0) out[pi[r]] = finish(tile[pi[r] - lo], wsum, normalize);
          for (int64_t j = seg_a[r] + tid + kThreads; j < seg_b[r]; j += kThreads) {
            const int64_t i = idx[base + j];
            out[i] = finish(tile[i - lo], wsum, normalize);
          }
        }
      }
    } else {
      const int64_t span = hi - lo;
      for (int64_t i = tid; i < span / 4; i += kThreads) {
        const float4 v = reinterpret_cast<const float4*>(tile)[i];
        reinterpret_cast<float4*>(out + lo)[i] =
            make_float4(finish(v.x, wsum, normalize), finish(v.y, wsum, normalize),
                        finish(v.z, wsum, normalize), finish(v.w, wsum, normalize));
      }
      for (int64_t i = span / 4 * 4 + tid; i < span; i += kThreads)
        out[lo + i] = finish(tile[i], wsum, normalize);
    }
  }
}

}  // namespace

// idx: (c_rows, k) int32, val: (c_rows, k) fp32, w: (c_rows,) fp32 raw
// weights -> out: (n,) fp32, 16-byte aligned.  workspace: at least
// c_rows * (ceil(k / 1024) + ceil(n / 8192) + 1) int32 of scratch, written
// by the launch before it is read.  normalize != 0: the weighted mean;
// 0: the mean times safe_weight_sum(w).  c_rows, k, n >= 1 and c_rows <=
// 65535 (the wrapper returns zeros for an empty payload without calling
// this).  One cooperative launch.
extern "C" int repro_topk_scatter_reduce(const int32_t* idx, const float* val,
                                         const float* w, float* out, int32_t* workspace,
                                         int64_t c_rows, int64_t k, int64_t n,
                                         int64_t workspace_ints, int64_t normalize,
                                         cudaStream_t stream) {
  int64_t tiles = (n + kTile - 1) / kTile;
  int64_t units_per_row = (k + kUnit - 1) / kUnit;
  if (c_rows < 1 || c_rows > 65535 || k < 1 || n < 1 ||
      workspace_ints < c_rows * (units_per_row + tiles + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // CTAs that fit on the card at once: a cooperative grid must be resident
  static int resident[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_scatter_reduce_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    resident[dev] = per_sm * sms;
  }
  const int64_t units = c_rows * units_per_row;
  int64_t grid = tiles > units ? tiles : units;
  if (grid > resident[dev]) grid = resident[dev];
  int32_t* flags = workspace;
  int32_t* start = workspace + units;
  int norm = normalize != 0;
  void* args[] = {&idx, &val, &w, &out, &flags, &start, &c_rows, &k, &n, &tiles,
                  &units_per_row, &norm};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(topk_scatter_reduce_kernel),
                                    dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, 0,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
