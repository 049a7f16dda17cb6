// Fused dequantize + weighted FedAvg reduce of the clients' Int8 wires,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dequant_reduce.py:
// dequant_reduce (pallas_call at :77).
//
// Bound: device-memory bytes.  The work is one multiply-add per int8 code
// read, so the bytes are the int8 payload (C x Np), its fp32 block scales
// (C x Np/256) and the fp32 (Np,) result: ~19.9 MB for the fleet's C = 6
// Int8 clients at Np = 1,974,528, ~5.9 us at 3.35 TB/s.  The unfused form
// would write and re-read an fp32 (C, Np) matrix, 4x the payload.
//
// Design: the TPU kernel walks column tiles in a sequential grid and
// contracts each (C, bn) tile on the MXU.  Here each thread owns 16
// columns and loops over the C client rows itself: per row, one 16 B load
// of codes (neighbouring threads on neighbouring 16 B, so a warp reads
// 512 contiguous bytes), the row's block scale and its normalized weight,
// and 16 fp32 accumulators in registers.  Each output value is written
// once, with no atomics and nothing carried between blocks, so the result
// is deterministic.  The wrapper normalizes the weights before the launch,
// as the Pallas kernel's wrapper does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // values per quantization block
constexpr int kCols = 16;    // columns per thread: one 16 B load per row
constexpr int kThreads = 256;

__global__ void dequant_reduce_kernel(const int8_t* __restrict__ q,
                                      const float* __restrict__ scales,
                                      const float* __restrict__ wn,
                                      float* __restrict__ out, int64_t c_rows,
                                      int64_t np_) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_chunks = np_ / kCols;
  if (i >= n_chunks) return;
  const int64_t n_scales = np_ / kBlock;
  const int64_t blk = i / (kBlock / kCols);
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
#pragma unroll 4
  for (int64_t c = 0; c < c_rows; ++c) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(q + c * np_) + i);
    const float s = __ldg(scales + c * n_scales + blk);
    const float w = __ldg(wn + c);
    const signed char* v = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = fmaf(w, v[k] * s, acc[k]);
  }
  float4* dst = reinterpret_cast<float4*>(out) + 4 * i;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    dst[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
}

}  // namespace

// q: (c_rows, np_) int8, scales: (c_rows, np_/256) fp32, wn: (c_rows,) fp32
// normalized weights -> out: (np_,) fp32.  np_ % 256 == 0; q and out are
// 16-byte aligned (the wrapper checks).
extern "C" int repro_dequant_reduce(const int8_t* q, const float* scales,
                                    const float* wn, float* out, int64_t c_rows,
                                    int64_t np_, cudaStream_t stream) {
  const int64_t n_chunks = np_ / kCols;
  if (n_chunks > 0) {
    const int64_t grid = (n_chunks + kThreads - 1) / kThreads;
    dequant_reduce_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        q, scales, wn, out, c_rows, np_);
  }
  return static_cast<int>(cudaGetLastError());
}
