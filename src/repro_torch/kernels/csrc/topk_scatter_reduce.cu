// TopK scatter-accumulate weighted reduce of the clients' sparse (idx, val)
// wires, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scatter_reduce.py:
// topk_scatter_reduce (pallas_call at :108).
//
//   out[i] = (sum over c, j with idx[c][j] == i of fl(w_c * val[c][j])) / wsum
//
// summed in client order c = 0..C-1, with wsum = safe_weight_sum(w) given
// by the wrapper.  Out-of-range and negative indices are dropped (as index
// 0 with value 0, exactly as the plain version sanitizes them), duplicates
// accumulate, any N.
//
// Bound: device-memory bytes.  The wires are C*k*8 B (int32 index + fp32
// value) and the (N,) fp32 result N*4 B; for the mixed fleet's C = 4 TopK
// clients at N = 1,974,303 and k = 19,743 that is ~8.53 MB, ~2.55 us at
// 3.35 TB/s, and the output write dominates.  The (C, N) dense matrix is
// never built.
//
// Design (per output tile, deterministic): the TPU kernel keeps the whole
// (N,) accumulator in VMEM and walks the clients in a sequential grid.
// Here each CTA owns kTile output floats in shared memory and adds the
// clients' entries that land in its span, client by client, with a
// __syncthreads() between clients, then writes its span once, divided by
// wsum.  TopKCodec's wire has distinct indices, ascending in every row,
// so within a row no two threads touch one float and the adds need no
// atomics: every float receives its terms in client order, the same bits
// on every launch.  A first pass finds, for every canonical row, where
// each tile's entries start (a row's entries for tile t are one contiguous
// range), so a CTA reads only its own entries: O(C*k) reads in all.  A
// row that is not canonical (unsorted, repeated or out-of-range indices: a
// foreign wire) is flagged by that pass; every CTA then scans the whole
// row and adds with a compare-and-swap loop, so no term is lost and the
// order of its additions may vary.  Products and sums are two rounded
// operations (__fmul_rn, __fadd_rn), as in the plain version, never an
// FMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8192;    // output floats per CTA (32 KB of shared memory)
constexpr int kThreads = 256;
constexpr int kAhead = 8;      // rows whose entries a thread loads before adding

// Pass 1, one thread per entry: flag rows that are not strictly ascending
// inside [0, n); for the others, start[c][t] = the first j with
// idx[c][j] >= t * kTile, for t = 0..tiles.
__global__ void topk_index_rows(const int32_t* __restrict__ idx, int64_t k,
                                int64_t n, int64_t tiles,
                                int32_t* __restrict__ start,
                                int32_t* __restrict__ foreign) {
  const int64_t c = blockIdx.y;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= k) return;
  const int32_t* row = idx + c * k;
  const int64_t cur = row[j];
  const int64_t prev = j > 0 ? row[j - 1] : -1;
  if (cur < 0 || cur >= n || prev >= cur) {
    foreign[c] = 1;
    return;
  }
  if (prev < -1) return;  // thread j-1 flags the row
  int32_t* s = start + c * (tiles + 1);
  const int64_t tc = cur / kTile;
  for (int64_t t = prev < 0 ? 0 : prev / kTile + 1; t <= tc; ++t) s[t] = static_cast<int32_t>(j);
  if (j == k - 1)
    for (int64_t t = tc + 1; t <= tiles; ++t) s[t] = static_cast<int32_t>(k);
}

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

// Pass 2, one CTA per output tile.
__global__ void __launch_bounds__(kThreads) topk_scatter_tiles(
    const int32_t* __restrict__ idx, const float* __restrict__ val,
    const float* __restrict__ w, const float* __restrict__ wsum,
    const int32_t* __restrict__ start, const int32_t* __restrict__ foreign,
    float* __restrict__ out, int64_t c_rows, int64_t k, int64_t n,
    int64_t tiles) {
  __shared__ float tile[kTile];
  __shared__ int32_t seg_a[kThreads], seg_b[kThreads], seg_f[kThreads];
  __shared__ float seg_w[kThreads];
  const int64_t t = blockIdx.x;
  const int64_t lo = t * kTile;
  const int64_t hi = lo + kTile < n ? lo + kTile : n;
  for (int i = threadIdx.x; i < kTile; i += kThreads) tile[i] = 0.0f;

  for (int64_t g0 = 0; g0 < c_rows; g0 += kThreads) {
    const int64_t g_rows = c_rows - g0 < kThreads ? c_rows - g0 : kThreads;
    __syncthreads();  // the previous group's bounds are no longer read
    if (threadIdx.x < g_rows) {
      const int64_t c = g0 + threadIdx.x;
      seg_f[threadIdx.x] = foreign[c];
      seg_a[threadIdx.x] = start[c * (tiles + 1) + t];
      seg_b[threadIdx.x] = start[c * (tiles + 1) + t + 1];
      seg_w[threadIdx.x] = w[c];
    }
    __syncthreads();
    for (int64_t r0 = 0; r0 < g_rows; r0 += kAhead) {
      // this thread's first entry of each of the next kAhead rows, all
      // loads in flight at once
      int32_t pi[kAhead];
      float pv[kAhead];
#pragma unroll
      for (int r = 0; r < kAhead; ++r) {
        pi[r] = -1;
        pv[r] = 0.0f;
        const int64_t rr = r0 + r;
        if (rr < g_rows && !seg_f[rr]) {
          const int64_t j = seg_a[rr] + threadIdx.x;
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
          for (int64_t j = threadIdx.x; j < k; j += kThreads) {
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
          for (int64_t j = seg_a[rr] + threadIdx.x + kThreads; j < seg_b[rr]; j += kThreads) {
            float* p = &tile[idx[base + j] - lo];
            *p = __fadd_rn(*p, __fmul_rn(wc, val[base + j]));
          }
        }
        __syncthreads();  // client c's terms land before client c+1's
      }
    }
  }
  __syncthreads();
  const float s = *wsum;
  for (int64_t i = threadIdx.x; lo + i < hi; i += kThreads) out[lo + i] = __fdiv_rn(tile[i], s);
}

}  // namespace

// idx: (c_rows, k) int32, val: (c_rows, k) fp32, w: (c_rows,) fp32 raw
// weights, wsum: their safe_weight_sum (one fp32 on the card) -> out: (n,)
// fp32.  workspace: c_rows * (ceil(n / 8192) + 2) int32 of scratch.
// c_rows, k, n >= 1 and c_rows <= 65535 (the wrapper returns zeros for an
// empty payload without calling this).
extern "C" int repro_topk_scatter_reduce(const int32_t* idx, const float* val,
                                         const float* w, const float* wsum,
                                         float* out, int32_t* workspace,
                                         int64_t c_rows, int64_t k, int64_t n,
                                         int64_t workspace_ints,
                                         cudaStream_t stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (c_rows < 1 || c_rows > 65535 || k < 1 || n < 1 ||
      workspace_ints < c_rows * (tiles + 2))
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* foreign = workspace;
  int32_t* start = workspace + c_rows;
  cudaError_t err = cudaMemsetAsync(foreign, 0, c_rows * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rows_grid(static_cast<unsigned>((k + kThreads - 1) / kThreads),
                       static_cast<unsigned>(c_rows));
  topk_index_rows<<<rows_grid, kThreads, 0, stream>>>(idx, k, n, tiles, start, foreign);
  topk_scatter_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      idx, val, w, wsum, start, foreign, out, c_rows, k, n, tiles);
  return static_cast<int>(cudaGetLastError());
}
