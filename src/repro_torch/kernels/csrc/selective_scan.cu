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
// expf is the IEEE-accurate one, never __expf or fast math.
//
// Bound: the exponentials.  B*S*Di*N of them, one MUFU ex2 each (expf is
// ex2 after a range reduction on the FMA units), 16 a clock on each of
// the 132 SMs: at the serving shape (B=8, S=1024, Di=16384, N=16) that is
// 2.147e9 exponentials, ~514 us at a 1.98 GHz clock.  The bytes (x and y
// bf16, dt fp32, A, B, C, D and the final state: 1.084 GB) take 323.7 us
// at 3.35 TB/s; the ~6.4e9 multiply-adds ~192 us at 67 TFLOP/s fp32.
//
// Design (a first, simple kernel): the TPU kernel carries the (bd, N)
// state in VMEM across a sequential grid axis of sequence chunks; on
// Hopper nothing carries between blocks, so the sequence is a loop inside
// the block.
// - one thread per (b, d) channel keeps its N states and its row of A in
//   registers (N <= 64, compiled for N_MAX = 8, 16, 32 or 64 with the
//   states past N never touched) and walks t = 0..S-1;
// - a block of 128 threads takes 128 neighbouring channels of one batch
//   row, so each step's loads of x and dt and store of y are coalesced;
//   the next step's x and dt are loaded before this step's arithmetic;
// - every channel of a batch row reads the same B_t and C_t: the block
//   stages them for 32 steps at a time in shared memory, and each step
//   reads them as broadcasts;
// - ragged edges are masked: channels past Di idle (they still join the
//   block's barriers), the last chunk runs S % 32 steps.  Unlike the
//   Pallas kernel, which leaves the tails of y and of the state unwritten
//   when S % chunk or Di % bd is nonzero, every output is written.
// At the serving shape that is 1024 blocks of 4 warps.  ptxas gives
// N_MAX = 16 80 registers a thread, so 6 blocks fit an SM and the grid
// runs in 1.3 waves: sizing the grid to whole waves, and the chunked form
// on the tensor cores, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kChunk = 32;     // steps of B and C staged at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const float* __restrict__ bm,
                      const float* __restrict__ cm, const float* __restrict__ dskip,
                      const float* __restrict__ h0, T* __restrict__ y,
                      float* __restrict__ hout, int64_t s, int64_t di, int n) {
  __shared__ float bs[kChunk][NMAX];
  __shared__ float cs[kChunk][NMAX];
  const int64_t b = blockIdx.y;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = d < di;
  const int64_t chan = b * di + d;  // (b, d) in the (B, Di, N) state

  float ar[NMAX], h[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    ar[j] = live && j < n ? __ldg(a + d * n + j) : 0.0f;
    h[j] = live && j < n && h0 != nullptr ? __ldg(h0 + chan * n + j) : 0.0f;
  }
  const float dd = live ? __ldg(dskip + d) : 0.0f;
  const int64_t row0 = b * s * di + d;  // x / dt / y at (b, 0, d)
  const float* bmb = bm + b * s * n;
  const float* cmb = cm + b * s * n;

  float x_next = live ? to_f32(x[row0]) : 0.0f;
  float dt_next = live ? __ldg(dt + row0) : 0.0f;
  for (int64_t t0 = 0; t0 < s; t0 += kChunk) {
    const int len = static_cast<int>(s - t0 < kChunk ? s - t0 : kChunk);
    __syncthreads();  // the previous chunk's reads of bs / cs are done
    for (int i = threadIdx.x; i < len * n; i += kThreads) {
      bs[i / n][i % n] = __ldg(bmb + t0 * n + i);
      cs[i / n][i % n] = __ldg(cmb + t0 * n + i);
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < len; ++tt) {
      const int64_t off = row0 + (t0 + tt) * di;
      const float xt = x_next, dtt = dt_next;
      if (t0 + tt + 1 < s) {  // the next step's loads, in flight during this one
        x_next = to_f32(x[off + di]);
        dt_next = __ldg(dt + off + di);
      }
      const float dtx = __fmul_rn(dtt, xt);
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          const float da = expf(__fmul_rn(dtt, ar[j]));
          h[j] = __fadd_rn(__fmul_rn(da, h[j]), __fmul_rn(dtx, bs[tt][j]));
          acc = __fadd_rn(acc, __fmul_rn(h[j], cs[tt][j]));
        }
      }
      store(y + off, __fadd_rn(acc, __fmul_rn(dd, xt)));
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) hout[chan * n + j] = h[j];
  }
}

template <typename T, int NMAX>
int launch_n(const T* x, const float* dt, const float* a, const float* bm, const float* cm,
             const float* dskip, const float* h0, T* y, float* hout, int64_t b, int64_t s,
             int64_t di, int64_t n, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((di + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  selective_scan_kernel<T, NMAX><<<grid, kThreads, 0, stream>>>(
      x, dt, a, bm, cm, dskip, h0, y, hout, s, di, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const float* dt, const float* a, const float* bm, const float* cm,
           const float* dskip, const float* h0, T* y, float* hout, int64_t b, int64_t s,
           int64_t di, int64_t n, cudaStream_t stream) {
  if (n <= 8) return launch_n<T, 8>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, stream);
  if (n <= 16) return launch_n<T, 16>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, stream);
  if (n <= 32) return launch_n<T, 32>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, stream);
  return launch_n<T, 64>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, stream);
}

}  // namespace

// x: (b, s, di) fp32 / bf16; dt: (b, s, di); a: (di, n); bm, cm: (b, s, n);
// dskip: (di,); h0: (b, di, n) or NULL for a zero state; y: (b, s, di) in
// x's dtype; hout: (b, di, n).  All contiguous, all but x and y fp32;
// b, s, di >= 1, 1 <= n <= 64, b <= 65535.
extern "C" int repro_selective_scan_f32(const float* x, const float* dt, const float* a,
                                        const float* bm, const float* cm, const float* dskip,
                                        const float* h0, float* y, float* hout, int64_t b,
                                        int64_t s, int64_t di, int64_t n,
                                        cudaStream_t stream) {
  return launch<float>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, stream);
}

extern "C" int repro_selective_scan_bf16(const __nv_bfloat16* x, const float* dt,
                                         const float* a, const float* bm, const float* cm,
                                         const float* dskip, const float* h0,
                                         __nv_bfloat16* y, float* hout, int64_t b, int64_t s,
                                         int64_t di, int64_t n, cudaStream_t stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, dskip, h0, y, hout, b, s, di, n, stream);
}
