// FedAvg weighted reduce of the clients' fp32/bf16 updates, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_reduce.py:
// fedavg_reduce (pallas_call at :56).
//
//   out[j] = fl_T(sum over c = 0..C-1 of wn_c * u[c][j]),  wn_c = w_c / ws
//
// with ws = safe_weight_sum(w): the fp32 sum of the raw weights in client
// order, 0 -> 1.  The sum over c is one fmaf chain from 0 in client order
// (the TPU kernel's dot, as XLA's CPU dot orders a short one), wn_c an IEEE
// division.  With ``normalize`` off the kernel writes
// fl_T(fl_T(mean) * fl_T(ws)) instead: the mean rounded to T times ws
// rounded to T, rounded again -- the bits of ``out * safe_weight_sum(w)``
// in T around the kernel (the grouped wire reduce's weighted sum).  For
// integer weights summing below 2**24 every order of the weight sum is
// exact, so ws has the bits of PyTorch's sum and the result those of the
// composition (normalized weights in, then the product) this launch
// replaced.
//
// Bound: device-memory bytes.  One multiply-add per element read: the
// (C, N) updates in, the (N,) result out.  For the fleet's C = 2 Null
// clients at N = 1,974,303 fp32 that is ~23.7 MB, ~7.1 us at 3.35 TB/s.
//
// Design: ONE launch does the weight sum, the normalization, the reduce
// and (normalize off) the product, so an ops call costs one kernel's time.
// - A CTA takes a tile of kTile = 2048 columns; a thread owns 8 of them,
//   spaced one CTA width apart, so every load of a warp is one coalesced
//   128 B (fp32) access.  N = 1,974,303 is odd, so a row starts at another
//   offset mod 16 B in each client and the loads are scalar; the ragged
//   tail is masked per column.
// - kAhead rows of a thread's columns are in flight at a time: row c +
//   kAhead is loaded as soon as row c is accumulated, and the first rows
//   are loaded before the weights are summed.
// - Each CTA sums the weights itself (one thread, client order, from
//   shared memory) and keeps the first kWShared normalized weights there,
//   read as broadcasts; a client past them divides its weight itself.
// - Each output is written once in T (bf16 rounds to nearest even, as
//   torch's .to(torch.bfloat16) does), with no atomics: deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                  // columns a thread, kThreads apart
constexpr int kTile = kThreads * kPer;   // columns a CTA
constexpr int kAhead = 2;                // rows of a thread's columns in flight
constexpr int kWShared = 1024;           // normalized weights kept in shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__device__ __forceinline__ void load_row(float (&v)[kPer], const T* __restrict__ row,
                                         int64_t j0, int64_t n) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t j = j0 + k * kThreads;
    v[k] = j < n ? to_f32(row[j]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) fedavg_reduce_kernel(
    const T* __restrict__ u, const float* __restrict__ w, T* __restrict__ out,
    int64_t c_rows, int64_t n, int normalize) {
  __shared__ float wn[kWShared];
  __shared__ float wsum_s;
  const int tid = threadIdx.x;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kTile + tid;
  const int64_t shared_rows = c_rows < kWShared ? c_rows : kWShared;

  float v[kAhead][kPer];  // rows c0 .. c0 + kAhead - 1, row c in v[c % kAhead]
#pragma unroll
  for (int r = 0; r < kAhead; ++r)
    if (r < c_rows) load_row(v[r], u + r * n, j0, n);

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

  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0.0f;
  for (int64_t c0 = 0; c0 < c_rows; c0 += kAhead) {
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      const int64_t c = c0 + r;
      if (c >= c_rows) break;
      const float wc = c < kWShared ? wn[c] : __fdiv_rn(w[c], ws);
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] = fmaf(wc, v[r][k], acc[k]);
      if (c + kAhead < c_rows) load_row(v[r], u + (c + kAhead) * n, j0, n);
    }
  }
  const float ws_t = to_f32(from_f32<T>(ws));
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int64_t j = j0 + k * kThreads;
    if (j < n) {
      const T mean = from_f32<T>(acc[k]);
      out[j] = normalize ? mean : from_f32<T>(__fmul_rn(to_f32(mean), ws_t));
    }
  }
}

template <typename T>
int launch(const T* u, const float* w, T* out, int64_t c_rows, int64_t n, int64_t normalize,
           cudaStream_t stream) {
  if (c_rows < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t grid = (n + kTile - 1) / kTile;
  fedavg_reduce_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      u, w, out, c_rows, n, normalize != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u: (c_rows, n) fp32, w: (c_rows,) fp32 raw weights -> out: (n,) fp32.
// normalize != 0: the weighted mean; 0: the mean times
// safe_weight_sum(w), each rounded to fp32.  c_rows, n >= 1.
extern "C" int repro_fedavg_reduce_f32(const float* u, const float* w, float* out,
                                       int64_t c_rows, int64_t n, int64_t normalize,
                                       cudaStream_t stream) {
  return launch<float>(u, w, out, c_rows, n, normalize, stream);
}

// The same over bf16 updates, with a bf16 result (and, normalize off, the
// mean and safe_weight_sum(w) each rounded to bf16 before their product).
extern "C" int repro_fedavg_reduce_bf16(const __nv_bfloat16* u, const float* w,
                                        __nv_bfloat16* out, int64_t c_rows, int64_t n,
                                        int64_t normalize, cudaStream_t stream) {
  return launch<__nv_bfloat16>(u, w, out, c_rows, n, normalize, stream);
}
