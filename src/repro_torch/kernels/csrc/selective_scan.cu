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
// Design.  A block of 512 threads (16 warps) takes a slice of channels of
// one batch row; a thread keeps 4 of a channel's states (kPer), so a
// channel is kSub = N_MAX / 4 neighbouring lanes and a block holds 512 /
// kSub channels (128 at N_MAX = 16).
// - The states are recomputed, never stored by the forward.  The block
//   walks the kSeg-step segments from last to first; for each, a thread
//   recomputes its states from the segment's checkpoint with the forward's
//   exact roundings (__fmul_rn / __fadd_rn, the accurate expf), so every
//   state is the forward's bit for bit, then walks the segment back in
//   time carrying g.  Both walks are unrolled over the segment, so what
//   the recompute keeps for the reverse walk stays in registers: a_t and
//   the rounded product a_t h_{t-1} of each step and state (2 * 8 * 4
//   registers).  The reverse walk's a_t h_{t-1} g_t is that kept product
//   times g_t, the same bits as forming it again, and it needs neither
//   h_{t-1} nor a second exponential: one expf a state-step.
// - A segment's x, dt, dy, B and C are staged in shared memory by 16-byte
//   cp.async, coalesced, into one of two slots, segment k - 1's copies in
//   flight while segment k is walked; its checkpoint is loaded into
//   registers from the reverse walk's first step on.  Columns past Di and
//   the ragged last segment's steps past S read zeros (the slots are
//   zeroed once; a 16-byte piece across Di is copied element by element):
//   such a step leaves g, the state and every sum as they are (a_t = 1,
//   every product 0), so the walks run all kSeg steps with no bounds, and
//   nothing past Di adds to dB or dC.
// - Sums in a fixed order, without atomics, so two calls are bitwise
//   equal.  A thread's du and ddt terms are summed over its states in
//   order and stored to shared memory each step; after the walks a thread
//   a channel adds the channel's kSub threads' terms in order and stores
//   the step's dx and ddt, a row of neighbouring channels a warp.  dB and
//   dC are sums over the block's channels: each step a thread stores its
//   4 products u_t g_t (and dy_t h_t) in one 16-byte store; after the
//   walks a thread adds one 4-state piece of a step over a range of 16
//   channels in channel order, and in the next segment's first phase the
//   ranges are added in range order, one partial a block and step written
//   to a (blocks, B, S, 2, N_MAX) buffer; a second kernel
//   (selective_scan_bwd_sum_kernel) adds the blocks' partials in block
//   order.  dA and dD are summed over t in registers, written per row,
//   and the second kernel adds each group's rows in row order.  Two
//   barriers a segment.
// - ptxas holds a thread to 128 registers (__launch_bounds__(512, 1)): one
//   block, 16 warps, an SM.  The kept values take half of them.
//
// Bound: one exponential a state element a step, B*S*Di*N MUFU ex2 at 16 a
// clock per SM, and the fp32 operations (21 a state-step) at 67 TFLOP/s.
// What binds first is issuing the instructions, ~40 a state-step: ~20 of
// arithmetic (the recompute's 13 with expf's 8, the reverse walk's 7), the
// rest loads, stores, sums and addresses; and the shared-memory traffic of
// the dB / dC sums (their products written and read back, 128 KB a block
// and segment at N_MAX = 16), about a fifth of the kernel's time
// (scan_ablation.py).

constexpr int kBwdThreads = 512;             // a backward block's threads
constexpr int kPer = 4;                      // states a thread
constexpr int kRange = 16;                   // channels a thread of the dB / dC sums adds

template <int NMAX>
struct BwdShape {
  static constexpr int kSub = NMAX / kPer;           // threads a channel: 2, 4, 8, 16
  static constexpr int kChan = kBwdThreads / kSub;   // channels a block: 256, 128, 64, 32
  static constexpr int kQuads = kSeg * 2 * NMAX / 4; // 4-state pieces of a segment's dB and dC
  static constexpr int kRanges = kChan / kRange;     // channel ranges a piece is summed in
  static_assert(kQuads * kRanges == kBwdThreads, "a thread a piece and range");
};

// One segment's inputs (x and dy in x's dtype), a block's channels.
template <typename T, int NMAX>
struct BwdStage {
  static constexpr int kChan = BwdShape<NMAX>::kChan;
  alignas(16) T x[kSeg][kChan];
  alignas(16) float dt[kSeg][kChan];
  alignas(16) T dy[kSeg][kChan];
  alignas(16) float b[kSeg][NMAX];
  alignas(16) float c[kSeg][NMAX];
};

template <typename T, int NMAX>
struct BwdSmem {
  using P = BwdShape<NMAX>;
  BwdStage<T, NMAX> in[2];  // segment k, and k - 1 in flight
  // each thread's products u_t g_t (row 2 tt) and dy_t h_t (row 2 tt + 1),
  // (channel, state) in a row; NMAX more floats a row keep the sums' reads
  // of neighbouring rows on other banks
  alignas(16) float prod[2 * kSeg][P::kChan * NMAX + NMAX];
  alignas(16) float range_sum[2][P::kRanges][2 * kSeg * NMAX];  // each range's sums, by slot
  // each thread's du and ddt terms of a step, [sub][channel]: a channel's
  // kSub terms are a column, read by one thread.  Row q's channels are
  // swizzled (c ^ (q % (kSub / 2)) * (32 / kSub)) so that a warp's stores
  // of its kSub rows fill both halves of the banks
  alignas(16) float2 terms[kSeg][P::kSub][P::kChan];
};

// A 16-byte piece of E elements into shared memory: by cp.async when it
// lies before column Di (``left`` elements of the row remain), element by
// element with zeros past Di when it straddles it, not at all past it.
template <int E, typename T>
__device__ __forceinline__ void copy_piece(T* dst, const T* src, int64_t left) {
  if (left >= E) {
    cp_async16(dst, src);
  } else if (left > 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (e < left) dst[e] = src[e];
      else store(dst + e, 0.0f);
    }
  }
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kBwdThreads, 1)
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
  using Stage = BwdStage<T, NMAX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<T, NMAX>& sm = *reinterpret_cast<BwdSmem<T, NMAX>*>(smem_raw);
  const int tid = threadIdx.x;
  const int ch = tid / P::kSub, sub = tid % P::kSub, j0 = sub * kPer;
  const int64_t bsz = gridDim.y, b = blockIdx.y;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * P::kChan;
  const int64_t d = d0 + ch;
  const bool live = d < di;
  const int64_t grp = b / rows;
  const int segs = static_cast<int>((s + kSeg - 1) / kSeg);

  // the copies of a segment: rows of x, then of dy, then dt, then B and C
  constexpr int kXPiece = 16 / sizeof(T);
  constexpr int kXRow = P::kChan / kXPiece, kDtRow = P::kChan / 4, kBC = kSeg * NMAX / 4;
  constexpr int kXs = 2 * kSeg * kXRow, kDts = kSeg * kDtRow;
  auto issue = [&](int k, int slot) {
    Stage& in = sm.in[slot];
    const int64_t t0 = static_cast<int64_t>(k) * kSeg, row = (b * s + t0) * ld + d0;
    const int rows = static_cast<int>(s - t0 < kSeg ? s - t0 : kSeg);
    const int64_t left = di - d0;  // columns of the block before Di
#pragma unroll 1  // unrolled, its addresses pushed some N_MAX's walks to spill
    for (int i = 0; i < (kXs + kDts + 2 * kBC + kBwdThreads - 1) / kBwdThreads; ++i) {
      const int q = tid + i * kBwdThreads;
      if (q < kXs) {
        const int w = q / (kSeg * kXRow), r = q / kXRow % kSeg, c = q % kXRow * kXPiece;
        if (r < rows)
          copy_piece<kXPiece>(w ? &in.dy[r][c] : &in.x[r][c], (w ? dy : x) + row + r * ld + c,
                              left - c);
      } else if (q < kXs + kDts) {
        const int r = (q - kXs) / kDtRow, c = (q - kXs) % kDtRow * 4;
        if (r < rows) copy_piece<4>(&in.dt[r][c], dt + row + r * ld + c, left - c);
      } else if (q < kXs + kDts + 2 * kBC) {
        const int e = q - kXs - kDts, w = e / kBC, f = e % kBC * 4;
        if (f / NMAX < rows)
          cp_async16((w ? &in.c[0][0] : &in.b[0][0]) + f, (w ? cm : bm) + (b * s + t0) * NMAX + f);
      }
    }
  };

  // the ragged block's columns past Di, and the ragged last segment's steps
  // past S, read zeros: those steps then leave g, the state and the sums
  // as they are (a_t = 1, every product 0), so the walks need no bounds
  if (d0 + P::kChan > di || s % kSeg != 0) {
    int4* z = reinterpret_cast<int4*>(sm.in);
    for (int i = tid; i < static_cast<int>(sizeof(sm.in) / 16); i += kBwdThreads)
      z[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
  }
  issue(segs - 1, 0);
  cp_async_commit();

  // the checkpoint's states j0 .. j0 + 3 of segment k, read into next
  bool on[kPer];
  float ar[kPer], g[kPer], gda[kPer], next[kPer];
  const float* ck = ckpt + (b * segs * n + j0) * di + d;  // state j0 of segment 0
  const int64_t seg_stride = n * di;
  auto load_checkpoint = [&](int k) {
    const float* p = ck + k * seg_stride;
#pragma unroll
    for (int i = 0; i < kPer; ++i, p += di) next[i] = on[i] ? p[0] : 0.0f;
  };
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    on[i] = live && j0 + i < n;
    ar[i] = on[i] ? __ldg(a + (grp * di + d) * n + j0 + i) : 0.0f;
    g[i] = on[i] && dhf != nullptr ? __ldg(dhf + (b * di + d) * n + j0 + i) : 0.0f;
    gda[i] = 0.0f;
  }
  load_checkpoint(segs - 1);
  float gdd = 0.0f;
  // segment k's dB and dC partials of the block: its ranges' sums (in slot
  // ``slot`` of range_sum) added in range order, after the barrier that
  // follows them (in the next segment's first phase)
  auto combine = [&](int k, int slot) {
    const int64_t t0 = static_cast<int64_t>(k) * kSeg;
    const int len = static_cast<int>(s - t0 < kSeg ? s - t0 : kSeg);
#pragma unroll
    for (int i = 0; i < (2 * kSeg * NMAX + kBwdThreads - 1) / kBwdThreads; ++i) {
      const int e = tid + i * kBwdThreads;
      if (e >= len * 2 * NMAX) break;
      float acc = sm.range_sum[slot][0][e];
#pragma unroll
      for (int r = 1; r < P::kRanges; ++r) acc = __fadd_rn(acc, sm.range_sum[slot][r][e]);
      part[((static_cast<int64_t>(blockIdx.x) * bsz + b) * s + t0) * 2 * NMAX + e] = acc;
    }
  };
  // the channel this thread stores dx and ddt of, and its D
  const int out_c = tid % P::kChan;
  const bool out_live = d0 + out_c < di;
  const float out_d = out_live ? __ldg(dskip + grp * di + d0 + out_c) : 0.0f;
  T* out_dx = dx + b * s * di + d0 + out_c;
  float* out_ddt = ddt + b * s * di + d0 + out_c;

  for (int k = segs - 1, slot = 0; k >= 0; --k, slot ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // segment k is in; segment k + 1's slot and partials are read
    if (k > 0) issue(k - 1, slot ^ 1);
    cp_async_commit();
    if (k + 1 < segs) combine(k + 1, slot ^ 1);
    const Stage& in = sm.in[slot];
    const int64_t t0 = static_cast<int64_t>(k) * kSeg;
    const int len = static_cast<int>(s - t0 < kSeg ? s - t0 : kSeg);
    float st[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) st[i] = next[i];

    // the segment's states from its checkpoint, in the forward's roundings,
    // keeping a_t and a_t h_{t-1}; dC_t = sum_d dy_t h_t on the way
    float decay[kSeg][kPer], kept[kSeg][kPer];
#pragma unroll
    for (int tt = 0; tt < kSeg; ++tt) {
      const float xv = to_f32(in.x[tt][ch]), dtv = in.dt[tt][ch], dyv = to_f32(in.dy[tt][ch]);
      const float ux = __fmul_rn(dtv, xv);
      const float4 bv = *reinterpret_cast<const float4*>(&in.b[tt][j0]);
      const float bq[kPer] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        decay[tt][i] = expf(__fmul_rn(dtv, ar[i]));
        kept[tt][i] = __fmul_rn(decay[tt][i], st[i]);
        st[i] = __fadd_rn(kept[tt][i], __fmul_rn(ux, bq[i]));
      }
      *reinterpret_cast<float4*>(&sm.prod[2 * tt + 1][ch * NMAX + j0]) = make_float4(
          __fmul_rn(dyv, st[0]), __fmul_rn(dyv, st[1]), __fmul_rn(dyv, st[2]),
          __fmul_rn(dyv, st[3]));
    }

    // back in time through the segment
#pragma unroll
    for (int tt = kSeg - 1; tt >= 0; --tt) {
      const float xv = to_f32(in.x[tt][ch]), dtv = in.dt[tt][ch], dyv = to_f32(in.dy[tt][ch]);
      const float ux = __fmul_rn(dtv, xv);
      const float4 bv = *reinterpret_cast<const float4*>(&in.b[tt][j0]);
      const float4 cv = *reinterpret_cast<const float4*>(&in.c[tt][j0]);
      const float bq[kPer] = {bv.x, bv.y, bv.z, bv.w}, cq[kPer] = {cv.x, cv.y, cv.z, cv.w};
      float du = 0.0f, dsum = 0.0f, pb[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        g[i] = fmaf(dyv, cq[i], g[i]);                          // g_t
        du = fmaf(g[i], bq[i], du);
        const float sens = __fmul_rn(kept[tt][i], g[i]);        // a_t h_{t-1} g_t
        dsum = fmaf(ar[i], sens, dsum);
        gda[i] = fmaf(dtv, sens, gda[i]);
        pb[i] = __fmul_rn(ux, g[i]);
        g[i] = __fmul_rn(decay[tt][i], g[i]);                   // a_t g_t, for t - 1
      }
      sm.terms[tt][sub][ch ^ (sub % (P::kSub / 2) * (32 / P::kSub))] = make_float2(du, dsum);
      gdd = fmaf(dyv, xv, gdd);
      *reinterpret_cast<float4*>(&sm.prod[2 * tt][ch * NMAX + j0]) =
          make_float4(pb[0], pb[1], pb[2], pb[3]);
      // segment k - 1's checkpoint, once this step's kept values are free
      if (tt == kSeg - 1 && k > 0) load_checkpoint(k - 1);
    }

    // dB_t and dC_t over the block's channels: a thread adds one 4-state
    // piece over a range of kRange channels in channel order, then the
    // ranges are added in range order
    __syncthreads();  // every thread's products of the segment are in
    {
      const int piece = tid % P::kQuads, range = tid / P::kQuads;
      const int row = piece / (NMAX / 4), j = piece % (NMAX / 4) * 4;
      if (row / 2 < len) {
        const float* v = &sm.prod[row][range * kRange * NMAX + j];
        float4 acc = *reinterpret_cast<const float4*>(v);
#pragma unroll
        for (int c = 1; c < kRange; ++c) {
          const float4 u = *reinterpret_cast<const float4*>(v + c * NMAX);
          acc = make_float4(__fadd_rn(acc.x, u.x), __fadd_rn(acc.y, u.y), __fadd_rn(acc.z, u.z),
                            __fadd_rn(acc.w, u.w));
        }
        *reinterpret_cast<float4*>(&sm.range_sum[slot][range][row * NMAX + j]) = acc;
      }
    }
    // the segment's dx and ddt: a thread takes one channel (column) and
    // every kSub-th step, adding the channel's kSub threads' terms in order
#pragma unroll
    for (int i = 0; i < (kSeg + P::kSub - 1) / P::kSub; ++i) {
      const int tt = tid / P::kChan + i * P::kSub;
      if (out_live && tt < len) {
        float du = 0.0f, dsum = 0.0f;
#pragma unroll
        for (int q = 0; q < P::kSub; ++q) {
          const float2 v = sm.terms[tt][q][out_c ^ (q % (P::kSub / 2) * (32 / P::kSub))];
          du = q == 0 ? v.x : __fadd_rn(du, v.x);
          dsum = q == 0 ? v.y : __fadd_rn(dsum, v.y);
        }
        const float xv = to_f32(in.x[tt][out_c]), dtv = in.dt[tt][out_c];
        const int64_t at = (t0 + tt) * di;
        store(out_dx + at, fmaf(dtv, du, __fmul_rn(out_d, to_f32(in.dy[tt][out_c]))));
        out_ddt[at] = fmaf(xv, du, dsum);
      }
    }
  }
  __syncthreads();  // segment 0's range sums are in
  combine(0, (segs - 1) & 1);

  if (live) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (on[i]) {
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

// The backward kernel's attributes, set once a process: its dynamic shared
// memory (over the 48 KB default) and all of the SM's shared memory for it.
template <typename T, int NMAX>
cudaError_t bwd_prepare() {
  static bool set = false;
  if (set) return cudaSuccess;
  constexpr int smem = static_cast<int>(sizeof(BwdSmem<T, NMAX>));
  cudaError_t err = cudaFuncSetAttribute(selective_scan_bwd_kernel<T, NMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(selective_scan_bwd_kernel<T, NMAX>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  set = err == cudaSuccess;
  return err;
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
  cudaError_t err = bwd_prepare<T, NMAX>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(b));
  selective_scan_bwd_kernel<T, NMAX><<<grid, kBwdThreads, sizeof(BwdSmem<T, NMAX>), stream>>>(
      x, dt, a, bm, cm, dskip, dy, ckpt, dhf, dx, ddt, dh0, part, arow, drow, s, di,
      static_cast<int>(n), ld, rows);
  err = cudaGetLastError();
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

// The blocks an SM the runtime grants one backward instantiation, at its
// block and shared memory.
template <typename T, int NMAX>
int bwd_blocks_per_sm(int64_t* out) {
  cudaError_t err = bwd_prepare<T, NMAX>();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, selective_scan_bwd_kernel<T, NMAX>, kBwdThreads, sizeof(BwdSmem<T, NMAX>));
  *out = per_sm;
  return static_cast<int>(err);
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
// di), with part_blocks = ceil(di / (512 / (n_max / 4))).
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

// The blocks an SM that the backward kernel for the state bucket n_max (8,
// 16, 32 or 64) and x's dtype (bf16 unless 0) runs at, into *out.
extern "C" int repro_selective_scan_bwd_blocks_per_sm(int64_t n_max, int64_t bf16,
                                                      int64_t* out) {
#define REPRO_SCAN_BWD_BLOCKS(NM)                                                    \
  (bf16 ? bwd_blocks_per_sm<__nv_bfloat16, NM>(out) : bwd_blocks_per_sm<float, NM>(out))
  switch (n_max) {
    case 8: return REPRO_SCAN_BWD_BLOCKS(8);
    case 16: return REPRO_SCAN_BWD_BLOCKS(16);
    case 32: return REPRO_SCAN_BWD_BLOCKS(32);
    case 64: return REPRO_SCAN_BWD_BLOCKS(64);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_SCAN_BWD_BLOCKS
}
