// FedAvg weighted reduce of the clients' fp32/bf16 updates, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fedavg_reduce.py:
// fedavg_reduce (pallas_call at :56).
//
// Bound: device-memory bytes.  One multiply-add per element read: the
// (C, N) updates in, the (N,) result out.  For the fleet's C = 2 Null
// clients at N = 1,974,303 fp32 that is ~23.7 MB, ~7.1 us at 3.35 TB/s.
//
// Design: the TPU kernel walks (C, bn) column tiles in a sequential grid
// and contracts each on the MXU.  Here each thread owns 4 columns, spaced
// one CTA width apart so that every load of a warp is one coalesced 128 B
// (fp32) access, and loops over the C client rows with fp32 accumulators
// in registers.  N = 1,974,303 is odd, so rows are not 16-byte aligned and
// the loads are scalar; the ragged tail is masked per column.  Each output
// is written once in the input dtype (bf16 rounds to nearest even, as
// torch's .to(torch.bfloat16) does), with no atomics, so the result is
// deterministic.  The wrapper normalizes the weights before the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

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
__global__ void fedavg_reduce_kernel(const T* __restrict__ u,
                                     const float* __restrict__ wn,
                                     T* __restrict__ out, int64_t c_rows,
                                     int64_t n) {
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kThreads * kPerThread + threadIdx.x;
  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.0f;
  for (int64_t c = 0; c < c_rows; ++c) {
    const float w = __ldg(wn + c);
    const T* row = u + c * n;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int64_t j = base + k * kThreads;
      if (j < n) acc[k] = fmaf(w, to_f32(row[j]), acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t j = base + k * kThreads;
    if (j < n) out[j] = from_f32<T>(acc[k]);
  }
}

template <typename T>
int launch(const T* u, const float* wn, T* out, int64_t c_rows, int64_t n,
           cudaStream_t stream) {
  if (n > 0) {
    const int64_t per_cta = static_cast<int64_t>(kThreads) * kPerThread;
    const int64_t grid = (n + per_cta - 1) / per_cta;
    fedavg_reduce_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        u, wn, out, c_rows, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u: (c_rows, n) fp32, wn: (c_rows,) fp32 normalized weights -> out: (n,) fp32.
extern "C" int repro_fedavg_reduce_f32(const float* u, const float* wn,
                                       float* out, int64_t c_rows, int64_t n,
                                       cudaStream_t stream) {
  return launch<float>(u, wn, out, c_rows, n, stream);
}

// The same over bf16 updates, with a bf16 result.
extern "C" int repro_fedavg_reduce_bf16(const __nv_bfloat16* u, const float* wn,
                                        __nv_bfloat16* out, int64_t c_rows,
                                        int64_t n, cudaStream_t stream) {
  return launch<__nv_bfloat16>(u, wn, out, c_rows, n, stream);
}
