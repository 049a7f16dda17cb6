// Mamba selective scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py:
// selective_scan (pallas_call at :86, body _scan_kernel at :25).
//
// Computes, for x, dt (B,S,Di), A (Di,N), B, C (B,S,N), D (Di,) and an
// optional initial state h0 (B,Di,N), with every value but x in fp32:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t      (per channel d)
//   y_t = sum_n h_t[n] * C_t[n] + D * x_t
// y in x's dtype (fp32 or bf16), the final state h_S in fp32.  The state
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
                      float* __restrict__ hout, int64_t s, int64_t di, int n, int64_t ld) {
  using K = Copies<T, NMAX>;
  __shared__ Ring<T, NMAX> ring;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t d = d0 + tid;
  const bool live = d < di;
  const int64_t chan = b * di + d;  // (b, d) in the (B, Di, N) state
  const int chunks = static_cast<int>((s + kChunk - 1) / kChunk);

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
             const float* dskip, const float* h0, T* y, float* hout, int64_t b, int64_t s,
             int64_t di, int64_t n, int64_t ld, cudaStream_t stream) {
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
      x, dt, a, bm, cm, dskip, h0, y, hout, s, di, static_cast<int>(n), ld);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const float* dt, const float* a, const float* bm, const float* cm,
           const float* dskip, const float* h0, T* y, float* hout, int64_t b, int64_t s,
           int64_t di, int64_t n, int64_t ld, cudaStream_t stream) {
  if (b < 1 || b > 65535 || s < 1 || s > INT32_MAX - kChunk || di < 1 || n < 1 || n > 64 ||
      ld < di || ld % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 8)
    return launch_n<T, 8>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, ld, stream);
  if (n <= 16)
    return launch_n<T, 16>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, ld, stream);
  if (n <= 32)
    return launch_n<T, 32>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, ld, stream);
  return launch_n<T, 64>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, ld, stream);
}

}  // namespace

// x: (b, s, ld) fp32 / bf16 and dt: (b, s, ld) fp32, of which the first di
// columns are read, ld >= di a multiple of 8; a: (di, n); bm, cm: (b, s,
// n_max), zero past n, where n_max is n rounded up to 8, 16, 32 or 64;
// dskip: (di,); h0: (b, di, n) or NULL for a zero state; y: (b, s, di) in
// x's dtype; hout: (b, di, n).  All contiguous, all but x and y fp32; x,
// dt, bm and cm 16-byte aligned; b, s, di >= 1, 1 <= n <= 64, b <= 65535,
// s < 2**31 - 8.
extern "C" int repro_selective_scan_f32(const float* x, const float* dt, const float* a,
                                        const float* bm, const float* cm, const float* dskip,
                                        const float* h0, float* y, float* hout, int64_t b,
                                        int64_t s, int64_t di, int64_t n, int64_t ld,
                                        cudaStream_t stream) {
  return launch<float>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, ld, stream);
}

extern "C" int repro_selective_scan_bf16(const __nv_bfloat16* x, const float* dt,
                                         const float* a, const float* bm, const float* cm,
                                         const float* dskip, const float* h0,
                                         __nv_bfloat16* y, float* hout, int64_t b, int64_t s,
                                         int64_t di, int64_t n, int64_t ld,
                                         cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, ld,
                               stream);
}
