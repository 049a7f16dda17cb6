// Mamba selective scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py:
// selective_scan (pallas_call at :86, body _scan_kernel at :25).
//
// Computes, for x, dt (B,S,Di), A (G,Di,N), B, C (B,S,N), D (G,Di) and an
// optional initial state h0 (B,Di,N), with every value but x in fp32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per channel d)
//   y_t = sum_n h_t[n] * C_t[n] + D * x_t
// y in x's dtype (fp32 or bf16), the final state h_S in fp32.  Batch row b
// reads A and D of group b / (B / G): G = 1 serves, G clients' batches
// folded into one B train (a vmapped cohort).  Given a checkpoint buffer,
// the forward also writes the state entering every kSeg-th step, which
// the backward below (selective_scan_bwd_kernel) recomputes from.  The state
// update rounds each product and the sum as the plain version's separate
// PyTorch ops do (__fmul_rn / __fadd_rn, no contraction into an FMA), and
// expf is the IEEE-accurate one, never __expf or fast math: the state is
// the plain version's, bit for bit.  Only y's sum over n runs in another
// order (four interleaved partial sums, then a tree), each product still
// rounded on its own.
//
// Bound: the exponentials.  B*S*Di*N of them, one MUFU ex2 each (expf is
// ex2 after a range reduction on the FMA units), 16 a clock on each of
// the 132 SMs: at the serving shape (B=8, S=1024, Di=16384, N=16) that is
// 2.147e9 exponentials, ~514 us at a 1.98 GHz clock.  The bytes (x and y
// bf16, dt fp32, A, B, C, D and the final state: 1.084 GB) take 323.7 us
// at 3.35 TB/s.  What binds first is the instruction issue: the accurate
// expf is 8 instructions (2 range-reduction FMAs, a rounding add, 2 FMAs,
// a shift, the ex2, the scaling multiply), dt * A, the rounded update and
// the y term 6 more, ~15 a state element a step with the loads and the
// loop, on 4 schedulers an SM issuing one warp instruction a clock each:
// ~1 ms at the serving shape.  Other roundings (an approximate ex2, FMAs)
// would halve it, and the state would no longer be the plain version's.
//
// Design: the TPU kernel carries the (bd, N) state in VMEM across a
// sequential grid axis of sequence chunks; on Hopper nothing carries
// between blocks, so the sequence is a loop inside the block.
// - One thread per (b, d) channel keeps its N states and its row of A in
//   registers (compiled for N_MAX = 8, 16, 32 or 64; the states past N
//   are zero, with zero A, B and C, and stay zero) and walks t = 0..S-1,
//   four steps an iteration.
// - A block takes 128 neighbouring channels of one batch row.  For
//   N_MAX <= 16 ptxas holds a thread to 128 registers, so 4 blocks fit an
//   SM and the serving shape's 1024 blocks run in two whole waves of the
//   528 the card holds (the first design's 6 blocks an SM ran 1.3 waves;
//   8 blocks an SM would need 64 registers, and ptxas spilled there).
// - The sequence streams through a ring of kStages slots in shared
//   memory, each kChunk steps of the block's x and dt tiles and of B_t and
//   C_t, by 16-byte cp.async, coalesced.  The copies of chunk k + 2 are
//   issued when chunk k begins, so no step waits on device memory, and a
//   thread's only per-step loads are its x and dt from shared memory and
//   B_t, C_t as float4 broadcasts.  Each thread's share of a chunk's
//   copies is fixed before the loop: a few address additions a chunk.
// - Rows of x and dt are ld >= Di elements apart, ld a multiple of 8, and
//   rows of B and C N_MAX apart, zero past N (the wrapper pads them when
//   they are not), so every copy is 16-byte aligned and none is masked
//   but at the end of the sequence and of the channels.
// - Ragged edges are masked: channels past Di idle (they still copy and
//   join the barriers), the last chunk runs S % kChunk steps.  Unlike the
//   Pallas kernel, which leaves the tails of y and of the state unwritten
//   when S % chunk or Di % bd is nonzero, every output is written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels a block, one a thread
constexpr int kChunk = 8;      // steps a ring slot holds
constexpr int kStages = 3;     // ring slots: chunks k + 1 and k + 2 in flight during k
constexpr int kSeg = kChunk;   // steps between checkpoints (one a chunk): the backward's segment

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// Asynchronous 16-byte copy from device to shared memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

template <typename T, int NMAX>
struct Ring {
  alignas(16) T x[kStages][kChunk][kThreads];
  alignas(16) float dt[kStages][kChunk][kThreads];
  alignas(16) float b[kStages][kChunk][NMAX];
  alignas(16) float c[kStages][kChunk][NMAX];
};

// A thread's fixed share of every chunk's 16-byte copies.
template <typename T, int NMAX>
struct Copies {
  static constexpr int kXRow = kThreads * sizeof(T) / 16;  // copies a row of x
  static constexpr int kX = kChunk * kXRow / kThreads;     // a thread's x copies a chunk
  static constexpr int kDtRow = kThreads * 4 / 16;
  static constexpr int kDt = kChunk * kDtRow / kThreads;
  static constexpr int kBC = 2 * kChunk * NMAX / 4;        // B and C copies a chunk
  static constexpr int kBCPer = (kBC + kThreads - 1) / kThreads;
  static_assert(kChunk * kXRow % kThreads == 0 && kChunk * kDtRow % kThreads == 0, "");
};

// Blocks an SM that ptxas must make room for: 4 (128 registers a thread)
// for N_MAX <= 16; the 32 and 64 states of the larger buckets take what
// they need, up to 255 registers.
constexpr int min_blocks(int nmax) { return nmax <= 16 ? 4 : 1; }

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads, min_blocks(NMAX))
selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ dskip,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ hout, float* __restrict__ ckpt, int64_t s,
                      int64_t di, int n, int64_t ld, int64_t rows) {
  using K = Copies<T, NMAX>;
  __shared__ Ring<T, NMAX> ring;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t d = d0 + tid;
  const bool live = d < di;
  const int64_t chan = b * di + d;  // (b, d) in the (B, Di, N) state
  const int chunks = static_cast<int>((s + kChunk - 1) / kChunk);
  a += b / rows * di * n;  // this row's group of A and D
  dskip += b / rows * di;

  // this thread's copies: x and dt at a fixed column piece of rows
  // xr + i * (kThreads / kXRow) (resp. dtr + ...) of each chunk, and the
  // B / C pieces tid + i * kThreads of the chunk's 2 * kChunk * NMAX / 4
  constexpr int kXPiece = 16 / sizeof(T);
  const int xr = tid / K::kXRow, xp = tid % K::kXRow;
  const int dtr = tid / K::kDtRow, dtp = tid % K::kDtRow;
  const bool x_in = d0 + (xp + 1) * kXPiece <= ld, dt_in = d0 + (dtp + 1) * 4 <= ld;
  const T* xsrc = x + (b * s + xr) * ld + d0 + xp * kXPiece;
  const float* dtsrc = dt + (b * s + dtr) * ld + d0 + dtp * 4;
  const float* bsrc = bm + b * s * NMAX;
  const float* csrc = cm + b * s * NMAX;
  auto issue = [&](int k) {  // chunk k into slot k % kStages
    const int slot = k % kStages;
    const int64_t t0 = static_cast<int64_t>(k) * kChunk;
#pragma unroll
    for (int i = 0; i < K::kX; ++i) {
      const int r = xr + i * (kThreads / K::kXRow);
      if (x_in && t0 + r < s)
        cp_async16(&ring.x[slot][r][xp * kXPiece], xsrc + (t0 + i * (kThreads / K::kXRow)) * ld);
    }
#pragma unroll
    for (int i = 0; i < K::kDt; ++i) {
      const int r = dtr + i * (kThreads / K::kDtRow);
      if (dt_in && t0 + r < s)
        cp_async16(&ring.dt[slot][r][dtp * 4], dtsrc + (t0 + i * (kThreads / K::kDtRow)) * ld);
    }
#pragma unroll
    for (int i = 0; i < K::kBCPer; ++i) {
      const int q = tid + i * kThreads;            // a 4-float piece of B (first half) or C
      const int f = (q % (K::kBC / 2)) * 4;        // its first float in the chunk
      if (q < K::kBC && t0 + f / NMAX < s)
        cp_async16(q < K::kBC / 2 ? &ring.b[slot][0][f] : &ring.c[slot][0][f],
                   (q < K::kBC / 2 ? bsrc : csrc) + t0 * NMAX + f);
    }
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < chunks) issue(k);
    cp_async_commit();
  }

  float ar[NMAX], h[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    ar[j] = live && j < n ? __ldg(a + d * n + j) : 0.0f;
    h[j] = live && j < n && h0 != nullptr ? __ldg(h0 + chan * n + j) : 0.0f;
  }
  const float dd = live ? __ldg(dskip + d) : 0.0f;
  T* yp = y + b * s * di + d;  // y at (b, t, d), t advancing

  for (int k = 0; k < chunks; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk k have landed
    __syncthreads();               // everyone's have, and chunk k - 1 is consumed
    if (k + kStages - 1 < chunks) issue(k + kStages - 1);
    cp_async_commit();
    if (!live) continue;
    if (ckpt != nullptr) {  // the state entering chunk k
      // (b, k, j, d): a warp's stores of one state j are 32 neighbours
      float* cp = ckpt + (b * chunks + k) * n * di + d;
#pragma unroll
      for (int j = 0; j < NMAX; ++j)
        if (j < n) cp[j * di] = h[j];
    }
    const int slot = k % kStages;
    const int len = static_cast<int>(s - static_cast<int64_t>(k) * kChunk < kChunk
                                         ? s - static_cast<int64_t>(k) * kChunk : kChunk);
    const T* xs = &ring.x[slot][0][tid];
    const float* dts = &ring.dt[slot][0][tid];
    const float4* bs = reinterpret_cast<const float4*>(&ring.b[slot][0][0]);
    const float4* cs = reinterpret_cast<const float4*>(&ring.c[slot][0][0]);
#pragma unroll 4
    for (int tt = 0; tt < len; ++tt) {
      const float xt = to_f32(xs[tt * kThreads]);
      const float dtt = dts[tt * kThreads];
      const float dtx = __fmul_rn(dtt, xt);
      float part[4];
#pragma unroll
      for (int q = 0; q < NMAX / 4; ++q) {
        const float4 bv = bs[tt * (NMAX / 4) + q], cv = cs[tt * (NMAX / 4) + q];
        const float bq[4] = {bv.x, bv.y, bv.z, bv.w}, cq[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * q + r;
          const float da = expf(__fmul_rn(dtt, ar[j]));
          h[j] = __fadd_rn(__fmul_rn(da, h[j]), __fmul_rn(dtx, bq[r]));
          const float p = __fmul_rn(h[j], cq[r]);
          part[r] = q == 0 ? p : __fadd_rn(part[r], p);
        }
      }
      const float sum = __fadd_rn(__fadd_rn(part[0], part[1]), __fadd_rn(part[2], part[3]));
      store(yp, __fadd_rn(sum, __fmul_rn(dd, xt)));
      yp += di;
    }
  }
  cp_async_wait<0>();
  if (live) {
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) hout[chan * n + j] = h[j];
  }
}

template <typename T, int NMAX>
int launch_n(const T* x, const float* dt, const float* a, const float* bm, const float* cm,
             const float* dskip, const float* h0, T* y, float* hout, float* ckpt, int64_t b,
             int64_t s, int64_t di, int64_t n, int64_t ld, int64_t rows, cudaStream_t stream) {
  // all of an SM's shared memory for blocks: the carveout sets how many fit
  static bool carved = false;
  if (!carved) {
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_kernel<T, NMAX>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    carved = true;
  }
  const dim3 grid(static_cast<unsigned>((di + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  selective_scan_kernel<T, NMAX><<<grid, kThreads, 0, stream>>>(
      x, dt, a, bm, cm, dskip, h0, y, hout, ckpt, s, di, static_cast<int>(n), ld, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const float* dt, const float* a, const float* bm, const float* cm,
           const float* dskip, const float* h0, T* y, float* hout, float* ckpt, int64_t b,
           int64_t s, int64_t di, int64_t n, int64_t ld, int64_t groups, cudaStream_t stream) {
  if (b < 1 || b > 65535 || s < 1 || s > INT32_MAX - kChunk || di < 1 || n < 1 || n > 64 ||
      ld < di || ld % 8 || groups < 1 || b % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = b / groups;
  if (n <= 8)
    return launch_n<T, 8>(x, dt, a, bm, cm, dskip, h0, y, hout, ckpt, b, s, di, n, ld, rows,
                          stream);
  if (n <= 16)
    return launch_n<T, 16>(x, dt, a, bm, cm, dskip, h0, y, hout, ckpt, b, s, di, n, ld, rows,
                           stream);
  if (n <= 32)
    return launch_n<T, 32>(x, dt, a, bm, cm, dskip, h0, y, hout, ckpt, b, s, di, n, ld, rows,
                           stream);
  return launch_n<T, 64>(x, dt, a, bm, cm, dskip, h0, y, hout, ckpt, b, s, di, n, ld, rows,
                         stream);
}

// ---------------- the backward ----------------
//
// Given dy (B,S,Di) in x's dtype, the forward's checkpoints (the state
// entering every kSeg-th step, (B, ceil(S/kSeg), N, Di)) and an optional
// cotangent dh_S (B,Di,N) of the final state, computes with
// a_t = exp(dt_t A), u_t = dt_t x_t and g_t the state's cotangent,
//   g_{S-1} = dh_S + dy_{S-1} C_{S-1},  g_{t-1} = a_t g_t + dy_{t-1} C_{t-1}
//   dx_t = dt_t du_t + D dy_t,  du_t = sum_n g_t B_t      (dx in x's dtype)
//   ddt_t = x_t du_t + sum_n A a_t h_{t-1} g_t
//   dB_t = sum_d u_t g_t,  dC_t = sum_d dy_t h_t           (over the Di channels)
//   dA = sum_{b in group, t} dt_t a_t h_{t-1} g_t,  dD = sum_{b in group, t} dy_t x_t
//   dh0 = a_0 g_0
// every sum in fp32.  It replaces no TPU kernel: the JAX package
// differentiates its oracle (src/repro/kernels/ref.py:169), a chunked
// associative scan under jax.checkpoint.
//
// Design.  One thread per (b, d) channel and state slice, as the forward:
// - The states are recomputed, never stored by the forward.  The thread
//   walks the kSeg-step segments from last to first; for each it reloads
//   the segment's checkpoint, recomputes its kSeg states with the
//   forward's exact roundings (__fmul_rn / __fadd_rn, the accurate expf),
//   so h_{t-1} is the forward's bit for bit, keeps them in shared memory,
//   and walks them back in time carrying g in registers.  The segment's
//   x, dt, dy, B and C are staged in shared memory once for both walks.
// - Shared memory is what limits the block: kSeg * 16 states a thread.
//   A thread keeps at most 16 of a channel's states (kPer), so N_MAX = 32
//   and 64 take 2 and 4 threads a channel (kSub), which add their du and
//   ddt terms by shuffles; a block holds kThreads threads, 128 / kSub
//   channels, ~83-90 KB: 2 blocks an SM (4 at N_MAX = 8).
// - dB and dC are sums over the channels, done without atomics in a fixed
//   order, so two calls are bitwise equal: within a warp a reduce-scatter
//   (each exchange halves the values a lane keeps: about kPer shuffles for
//   kPer values, not kPer * 5), the 4 warps' sums added in order through
//   shared memory, one partial a block and step written to a
//   (blocks, B, S, 2, N_MAX) buffer, and a second kernel
//   (selective_scan_bwd_sum_kernel) that adds the blocks' partials in
//   block order.  dA and dD are summed over t in registers, written per
//   row, and the second kernel adds each group's rows in row order.
//
// Bound: the exponentials, two a state element a step (the recompute's
// and the reverse walk's a_t), 2 * B*S*Di*N MUFU ex2 at 16 a clock per SM;
// what binds first is dispatching ~40 instructions a state element a step
// (the forward's ~15, the reverse walk's products and the two reductions'
// shuffles).

template <int NMAX>
struct BwdShape {
  static constexpr int kSub = NMAX > 16 ? NMAX / 16 : 1;  // threads a channel
  static constexpr int kPer = NMAX / kSub;                // states a thread (8 or 16)
  static constexpr int kChan = kThreads / kSub;           // channels a block
};

constexpr int kWarps = kThreads / 32;
constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

template <int NMAX>
struct BwdSmem {
  using P = BwdShape<NMAX>;
  float h[kSeg][P::kPer][kThreads];  // h_{t-1} of each step, a thread's own column
  float x[kSeg][P::kChan];
  float dt[kSeg][P::kChan];
  float dy[kSeg][P::kChan];
  float b[kSeg][NMAX];
  float c[kSeg][NMAX];
  float part[kSeg][2][kWarps][NMAX];  // each warp's sums of dB (0) and dC (1)
};

// Sums v (M of a lane's values) over the lanes that differ in bits OFF,
// OFF / 2, ..., LO of the lane index, in a fixed order.  While a lane holds
// more than one value, an exchange halves them: the lane keeps the lower
// or upper half (by its bit OFF) and adds its partner's copy of that half.
// Returns the index, in v's first M, of the lane's first kept value.
template <int N, int M, int OFF, int LO>
__device__ __forceinline__ int reduce_scatter(float (&v)[N], int lane) {
  if constexpr (OFF < LO) {
    return 0;
  } else if constexpr (M > 1) {
    constexpr int H = M / 2;
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    return (up ? H : 0) + reduce_scatter<N, H, OFF / 2, LO>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
    return reduce_scatter<N, 1, OFF / 2, LO>(v, lane);
  }
}

// After reduce_scatter over a warp's channel lanes (bits kSub .. 16): the
// values a lane keeps, and the lane bits under which lanes hold the same.
template <int NMAX>
struct Scatter {
  using P = BwdShape<NMAX>;
  static constexpr int kOffsets = ilog2(32 / P::kSub);
  static constexpr int kHalvings = ilog2(P::kPer) < kOffsets ? ilog2(P::kPer) : kOffsets;
  static constexpr int kLeft = P::kPer >> kHalvings;
  static constexpr int kSame = P::kSub * ((1 << (kOffsets - kHalvings)) - 1);
};

// 2 blocks an SM by their shared memory (4 at N_MAX = 8): registers to match
template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads, NMAX <= 8 ? 4 : 2)
selective_scan_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ a, const float* __restrict__ bm,
                          const float* __restrict__ cm, const float* __restrict__ dskip,
                          const T* __restrict__ dy, const float* __restrict__ ckpt,
                          const float* __restrict__ dhf, T* __restrict__ dx,
                          float* __restrict__ ddt, float* __restrict__ dh0,
                          float* __restrict__ part, float* __restrict__ arow,
                          float* __restrict__ drow, int64_t s, int64_t di, int n, int64_t ld,
                          int64_t rows) {
  using P = BwdShape<NMAX>;
  using R = Scatter<NMAX>;
  constexpr int kPer = P::kPer;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<NMAX>& sm = *reinterpret_cast<BwdSmem<NMAX>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = tid / P::kSub, sub = tid % P::kSub, j0 = sub * kPer;
  const int64_t bsz = gridDim.y, b = blockIdx.y;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * P::kChan;
  const int64_t d = d0 + ch;
  const bool live = d < di;
  const int64_t grp = b / rows;
  const int segs = static_cast<int>((s + kSeg - 1) / kSeg);

  float ar[kPer], g[kPer], gda[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const bool on = live && j0 + i < n;
    ar[i] = on ? __ldg(a + (grp * di + d) * n + j0 + i) : 0.0f;
    g[i] = on && dhf != nullptr ? __ldg(dhf + (b * di + d) * n + j0 + i) : 0.0f;
    gda[i] = 0.0f;
  }
  const float dd = live ? __ldg(dskip + grp * di + d) : 0.0f;
  float gdd = 0.0f;

  for (int k = segs - 1; k >= 0; --k) {
    const int64_t t0 = static_cast<int64_t>(k) * kSeg;
    const int len = static_cast<int>(s - t0 < kSeg ? s - t0 : kSeg);
    __syncthreads();  // the last segment's shared memory is read
    for (int e = tid; e < kSeg * P::kChan; e += kThreads) {
      const int tt = e / P::kChan, c = e % P::kChan;
      const bool on = tt < len && d0 + c < di;
      const int64_t at = (b * s + t0 + tt) * ld + d0 + c;
      sm.x[tt][c] = on ? to_f32(x[at]) : 0.0f;
      sm.dt[tt][c] = on ? dt[at] : 0.0f;
      sm.dy[tt][c] = on ? to_f32(dy[at]) : 0.0f;
    }
    for (int e = tid; e < kSeg * NMAX; e += kThreads) {
      const int tt = e / NMAX, j = e % NMAX;
      const int64_t at = (b * s + t0 + tt) * NMAX + j;
      sm.b[tt][j] = tt < len ? bm[at] : 0.0f;
      sm.c[tt][j] = tt < len ? cm[at] : 0.0f;
    }
    __syncthreads();

    // the segment's states from its checkpoint, in the forward's roundings;
    // dC_t = sum_d dy_t h_t on the way
    float st[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      st[i] = live && j0 + i < n ? ckpt[((b * segs + k) * n + j0 + i) * di + d] : 0.0f;
    for (int tt = 0; tt < len; ++tt) {
      const float xv = sm.x[tt][ch], dtv = sm.dt[tt][ch], dyv = sm.dy[tt][ch];
      const float ux = __fmul_rn(dtv, xv);
      float pc[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        sm.h[tt][i][tid] = st[i];
        const float decay = expf(__fmul_rn(dtv, ar[i]));
        st[i] = __fadd_rn(__fmul_rn(decay, st[i]), __fmul_rn(ux, sm.b[tt][j0 + i]));
        pc[i] = dyv * st[i];
      }
      const int base = reduce_scatter<kPer, kPer, 16, P::kSub>(pc, lane);
      if ((lane & R::kSame) == 0) {
#pragma unroll
        for (int i = 0; i < R::kLeft; ++i) sm.part[tt][1][warp][j0 + base + i] = pc[i];
      }
    }

    // back in time through the segment
    for (int tt = len - 1; tt >= 0; --tt) {
      const float xv = sm.x[tt][ch], dtv = sm.dt[tt][ch], dyv = sm.dy[tt][ch];
      const float ux = __fmul_rn(dtv, xv);
      float du = 0.0f, dsum = 0.0f, pb[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        g[i] = fmaf(dyv, sm.c[tt][j0 + i], g[i]);                   // g_t
        du = fmaf(g[i], sm.b[tt][j0 + i], du);
        const float decay = expf(__fmul_rn(dtv, ar[i]));            // a_t
        const float sens = decay * sm.h[tt][i][tid] * g[i];         // a_t h_{t-1} g_t
        dsum = fmaf(ar[i], sens, dsum);
        gda[i] = fmaf(dtv, sens, gda[i]);
        pb[i] = ux * g[i];
        g[i] = decay * g[i];                                        // a_t g_t, for t - 1
      }
#pragma unroll
      for (int off = 1; off < P::kSub; off <<= 1) {  // the channel's other states
        du += __shfl_xor_sync(0xffffffffu, du, off);
        dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
      }
      if (live && sub == 0) {
        const int64_t at = (b * s + t0 + tt) * di + d;
        store(dx + at, fmaf(dtv, du, dd * dyv));
        ddt[at] = fmaf(xv, du, dsum);
      }
      gdd = fmaf(dyv, xv, gdd);
      const int base = reduce_scatter<kPer, kPer, 16, P::kSub>(pb, lane);
      if ((lane & R::kSame) == 0) {
#pragma unroll
        for (int i = 0; i < R::kLeft; ++i) sm.part[tt][0][warp][j0 + base + i] = pb[i];
      }
    }
    __syncthreads();  // every warp's sums of the segment are in
    for (int e = tid; e < len * 2 * NMAX; e += kThreads) {
      const int tt = e / (2 * NMAX), w = e / NMAX % 2, j = e % NMAX;
      float acc = sm.part[tt][w][0][j];
#pragma unroll
      for (int q = 1; q < kWarps; ++q) acc += sm.part[tt][w][q][j];
      part[((static_cast<int64_t>(blockIdx.x) * bsz + b) * s + t0 + tt) * 2 * NMAX + e % (2 * NMAX)] =
          acc;
    }
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (j0 + i < n) {
        arow[(b * di + d) * n + j0 + i] = gda[i];
        if (dh0 != nullptr) dh0[(b * di + d) * n + j0 + i] = g[i];  // a_0 g_0
      }
    }
    if (sub == 0) drow[b * di + d] = gdd;
  }
}

// The backward's fixed-order sums: dB and dC over the channel blocks'
// partials (block order), dA and dD over each group's rows (row order).
__global__ void __launch_bounds__(256)
selective_scan_bwd_sum_kernel(const float* __restrict__ part, const float* __restrict__ arow,
                              const float* __restrict__ drow, float* __restrict__ dbm,
                              float* __restrict__ dcm, float* __restrict__ da,
                              float* __restrict__ dd, int64_t bsz, int64_t s, int64_t di, int n,
                              int nmax, int64_t blocks, int64_t rows) {
  const int64_t groups = bsz / rows;
  const int64_t n_bc = bsz * s * 2 * n, n_a = groups * di * n, total = n_bc + n_a + groups * di;
  const int64_t stride = bsz * s * 2 * nmax;  // one block's partials
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (e < n_bc) {
      const int64_t j = e % n, w = e / n % 2, bt = e / (2 * n);
      const float* p = part + (bt * 2 + w) * nmax + j;
      float acc = p[0];
      for (int64_t q = 1; q < blocks; ++q) acc += p[q * stride];
      (w == 0 ? dbm : dcm)[bt * n + j] = acc;
    } else if (e < n_bc + n_a) {
      const int64_t f = e - n_bc, j = f % n, gd = f / n;
      const float* p = arow + (gd / di * rows * di + gd % di) * n + j;
      float acc = p[0];
      for (int64_t r = 1; r < rows; ++r) acc += p[r * di * n];
      da[f] = acc;
    } else {
      const int64_t f = e - n_bc - n_a;
      const float* p = drow + f / di * rows * di + f % di;
      float acc = p[0];
      for (int64_t r = 1; r < rows; ++r) acc += p[r * di];
      dd[f] = acc;
    }
  }
}

template <typename T, int NMAX>
int launch_bwd_n(const T* x, const float* dt, const float* a, const float* bm, const float* cm,
                 const float* dskip, const T* dy, const float* ckpt, const float* dhf, T* dx,
                 float* ddt, float* dbm, float* dcm, float* da, float* dd, float* dh0,
                 float* part, float* arow, float* drow, int64_t b, int64_t s, int64_t di,
                 int64_t n, int64_t ld, int64_t rows, int64_t part_blocks,
                 cudaStream_t stream) {
  using P = BwdShape<NMAX>;
  const int64_t blocks = (di + P::kChan - 1) / P::kChan;
  if (part_blocks != blocks) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = static_cast<int>(sizeof(BwdSmem<NMAX>));
  static bool set = false;
  if (!set) {
    cudaError_t err = cudaFuncSetAttribute(selective_scan_bwd_kernel<T, NMAX>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(selective_scan_bwd_kernel<T, NMAX>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    set = true;
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(b));
  selective_scan_bwd_kernel<T, NMAX><<<grid, kThreads, smem, stream>>>(
      x, dt, a, bm, cm, dskip, dy, ckpt, dhf, dx, ddt, dh0, part, arow, drow, s, di,
      static_cast<int>(n), ld, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = b * s * 2 * n + (b / rows) * di * (n + 1);
  const unsigned sum_blocks = static_cast<unsigned>(
      (total + 255) / 256 < 132 * 8 ? (total + 255) / 256 : 132 * 8);
  selective_scan_bwd_sum_kernel<<<sum_blocks, 256, 0, stream>>>(
      part, arow, drow, dbm, dcm, da, dd, b, s, di, static_cast<int>(n), NMAX, blocks, rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const T* x, const float* dt, const float* a, const float* bm, const float* cm,
               const float* dskip, const T* dy, const float* ckpt, const float* dhf, T* dx,
               float* ddt, float* dbm, float* dcm, float* da, float* dd, float* dh0,
               float* part, float* arow, float* drow, int64_t b, int64_t s, int64_t di,
               int64_t n, int64_t ld, int64_t groups, int64_t part_blocks,
               cudaStream_t stream) {
  if (b < 1 || b > 65535 || s < 1 || s > INT32_MAX - kSeg || di < 1 || n < 1 || n > 64 ||
      ld < di || ld % 8 || groups < 1 || b % groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = b / groups;
#define REPRO_SCAN_BWD(NM)                                                                \
  launch_bwd_n<T, NM>(x, dt, a, bm, cm, dskip, dy, ckpt, dhf, dx, ddt, dbm, dcm, da, dd, \
                      dh0, part, arow, drow, b, s, di, n, ld, rows, part_blocks, stream)
  if (n <= 8) return REPRO_SCAN_BWD(8);
  if (n <= 16) return REPRO_SCAN_BWD(16);
  if (n <= 32) return REPRO_SCAN_BWD(32);
  return REPRO_SCAN_BWD(64);
#undef REPRO_SCAN_BWD
}

}  // namespace

// x: (b, s, ld) fp32 / bf16 and dt: (b, s, ld) fp32, of which the first di
// columns are read, ld >= di a multiple of 8; a: (groups, di, n); bm, cm:
// (b, s, n_max), zero past n, where n_max is n rounded up to 8, 16, 32 or
// 64; dskip: (groups, di); h0: (b, di, n) or NULL for a zero state; y:
// (b, s, di) in x's dtype; hout: (b, di, n); ckpt: (b, ceil(s / 8), n, di)
// or NULL (serving: no checkpoint written).  All contiguous, all but x and
// y fp32; x, dt, bm and cm 16-byte aligned; b, s, di >= 1, 1 <= n <= 64,
// b <= 65535, s < 2**31 - 8, groups dividing b.
extern "C" int repro_selective_scan_f32(const float* x, const float* dt, const float* a,
                                        const float* bm, const float* cm, const float* dskip,
                                        const float* h0, float* y, float* hout, float* ckpt,
                                        int64_t b, int64_t s, int64_t di, int64_t n, int64_t ld,
                                        int64_t groups, cudaStream_t stream) {
  return launch<float>(x, dt, a, bm, cm, dskip, h0, y, hout, ckpt, b, s, di, n, ld, groups,
                       stream);
}

extern "C" int repro_selective_scan_bf16(const __nv_bfloat16* x, const float* dt,
                                         const float* a, const float* bm, const float* cm,
                                         const float* dskip, const float* h0,
                                         __nv_bfloat16* y, float* hout, float* ckpt, int64_t b,
                                         int64_t s, int64_t di, int64_t n, int64_t ld,
                                         int64_t groups, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, dskip, h0, y, hout, ckpt, b, s, di, n, ld,
                               groups, stream);
}

// The backward.  x, dt, a, bm, cm, dskip, ld and groups as the forward's;
// dy: (b, s, ld) in x's dtype; ckpt: the forward's checkpoints; dhf: the
// final state's cotangent (b, di, n) or NULL for zero.  Writes dx (b, s,
// di) in x's dtype, ddt (b, s, di), dbm, dcm (b, s, n), da (groups, di, n),
// dd (groups, di) and, unless NULL, dh0 (b, di, n), all fp32 but dx.
// Scratch: part (part_blocks, b, s, 2, n_max), arow (b, di, n), drow (b,
// di), with part_blocks = ceil(di / (128 / max(1, n_max / 16))).
extern "C" int repro_selective_scan_bwd_f32(
    const float* x, const float* dt, const float* a, const float* bm, const float* cm,
    const float* dskip, const float* dy, const float* ckpt, const float* dhf, float* dx,
    float* ddt, float* dbm, float* dcm, float* da, float* dd, float* dh0, float* part,
    float* arow, float* drow, int64_t b, int64_t s, int64_t di, int64_t n, int64_t ld,
    int64_t groups, int64_t part_blocks, cudaStream_t stream) {
  return launch_bwd<float>(x, dt, a, bm, cm, dskip, dy, ckpt, dhf, dx, ddt, dbm, dcm, da, dd,
                           dh0, part, arow, drow, b, s, di, n, ld, groups, part_blocks, stream);
}

extern "C" int repro_selective_scan_bwd_bf16(
    const __nv_bfloat16* x, const float* dt, const float* a, const float* bm, const float* cm,
    const float* dskip, const __nv_bfloat16* dy, const float* ckpt, const float* dhf,
    __nv_bfloat16* dx, float* ddt, float* dbm, float* dcm, float* da, float* dd, float* dh0,
    float* part, float* arow, float* drow, int64_t b, int64_t s, int64_t di, int64_t n,
    int64_t ld, int64_t groups, int64_t part_blocks, cudaStream_t stream) {
  return launch_bwd<__nv_bfloat16>(x, dt, a, bm, cm, dskip, dy, ckpt, dhf, dx, ddt, dbm, dcm,
                                   da, dd, dh0, part, arow, drow, b, s, di, n, ld, groups,
                                   part_blocks, stream);
}
