// Causal / sliding-window GQA flash attention (prefill), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (pallas_call at :102, body _flash_kernel at :30).
//
// Computes, for q (B,Sq,H,D) and k, v (B,Skv,KV,D), query head h reading
// KV head h / (H/KV): s = (q * D^-1/2 in fp32) . k^T; key j is masked for
// query row i (position i + q_offset) when causal and j > i + q_offset, or
// when a window is given and j <= i + q_offset - window; masked scores are
// -1e30 (finite: a row with no valid key becomes the uniform mean, never
// NaN); fp32 online softmax (m, l, acc); out = acc / max(l, 1e-30) in q's
// dtype.
//
// Bound: operations at the serving shape.  4*B*H*D flops per valid (query,
// key) pair: 34.4 GFLOP a layer at B=8, Sq=Skv=1024, H=16, D=128, causal,
// 34.8 us at the card's 989 TFLOP/s bf16 peak, against ~100 MB of q, k, v
// and out (30 us at 3.35 TB/s).
//
// Design (a first, simple kernel; products on the CUDA cores in fp32):
// - one CTA of 256 threads per (b*h, 64-row query tile); the JAX wrapper's
//   transposes are gone: tiles are read straight from the (B,S,H,D) strides;
// - the scaled Q tile stays in shared memory as fp32; each 64-key tile of K,
//   then of V, is staged through one shared buffer (rows padded to D_pad + 4
//   floats: 16-byte aligned, conflict-free float4 reads);
// - thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16i and key
//   columns tx + 16j (i, j < 4) of the score tile, and output columns
//   4*tx + 64*jj .. +3 of its rows; a row's 16 threads sit in one half-warp,
//   so its max and sum are shuffle reductions, and the softmax state (m, l)
//   and the output accumulator live in registers;
// - ragged Sq / Skv: rows past Sq are zero and never written, keys past Skv
//   score -inf (exactly no weight, even for a row with no valid key);
// - key tiles wholly above the diagonal or before the window are skipped.
//   The JAX kernel walks them, but once a valid key arrives their weight is
//   wiped by alpha = exp(-1e30 - m) = 0, so the result is the same -- except
//   for a tile holding a row with no valid key at all, which walks every key
//   tile as the JAX kernel does;
// - head dims: any D % 8 == 0 up to 256, zero-padded in shared memory to
//   D_pad in {64, 128, 256} (zeros add nothing to the products).
// expf and IEEE division, never fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // keys per tile
constexpr int kPPitch = kBK + 1;    // probability tile row pitch (floats)
constexpr float kNegInf = -1e30f;   // the JAX kernels' NEG_INF

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c,
                                       float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Rows [row0, row0 + ROWS) of one head, row r at base + r * row_stride,
// into shared memory as fp32 times `scale`, row pitch DP + 4; rows past
// n_rows and columns past d are zero.
template <typename T, int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* sm, const T* __restrict__ base,
                                          int64_t row_stride, int64_t row0,
                                          int64_t n_rows, int d, float scale) {
  constexpr int kChunksPerRow = DP / 8;
  constexpr int kPitch = DP + 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kChunksPerRow; i += kThreads) {
    const int r = i / kChunksPerRow;
    const int c = (i % kChunksPerRow) * 8;
    float x[8];
    if (row0 + r < n_rows && c < d) {
      load8(base + (row0 + r) * row_stride + c, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = __fmul_rn(x[e], scale);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.0f;
    }
    store4(sm + r * kPitch + c, x[0], x[1], x[2], x[3]);
    store4(sm + r * kPitch + c + 4, x[4], x[5], x[6], x[7]);
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((kBQ + kBK) * (DP + 4) + kBQ * kPPitch);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int64_t sq,
                       int64_t skv, int h, int kv, int d, int causal,
                       int64_t window, int64_t q_offset, float scale) {
  constexpr int kPitch = DP + 4;
  constexpr int kCols = DP / 64;  // float4 output chunks per row and thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x kPitch, scaled q
  float* kvs = qs + kBQ * kPitch;               // kBK x kPitch, K then V
  float* ps = kvs + kBK * kPitch;               // kBQ x kPPitch, probabilities

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int kvh = hh / (h / kv);
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  const int64_t q_stride = static_cast<int64_t>(h) * d;
  const int64_t kv_stride = static_cast<int64_t>(kv) * d;
  const T* qb = q + (b * sq * h + hh) * static_cast<int64_t>(d);
  const T* kb = k + (b * skv * kv + kvh) * static_cast<int64_t>(d);
  const T* vb = v + (b * skv * kv + kvh) * static_cast<int64_t>(d);

  load_tile<T, kBQ, DP>(qs, qb, q_stride, q0, sq, d, scale);

  // The key tiles this query tile needs.  Whether a row has no valid key
  // grows with its position, so the tile's last row decides for all.
  const bool has_window = window >= 0;
  const int64_t qlo = q0 + q_offset;
  const int64_t qhi = min64(q0 + kBQ, sq) - 1 + q_offset;
  const bool empty_row =
      has_window && qhi - window + 1 > min64(causal ? qhi : skv - 1, skv - 1);
  int64_t kt0 = 0, kt1 = (skv + kBK - 1) / kBK;
  if (!empty_row) {
    if (causal) kt1 = min64(kt1, qhi / kBK + 1);
    if (has_window) kt0 = max64(0, qlo - window + 1) / kBK;
  }

  float m[4], l[4], acc[4][kCols * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < kCols * 4; ++e) acc[i][e] = 0.0f;
  }

  for (int64_t kt = kt0; kt < kt1; ++kt) {
    const int64_t k0 = kt * kBK;
    __syncthreads();  // the previous tile's V reads are done
    load_tile<T, kBK, DP>(kvs, kb, kv_stride, k0, skv, d, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      float4 qa[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kPitch + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * j) * kPitch + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kk[j].w, s[i][j]);
        }
    }

    // mask, then the online softmax of each of this thread's rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty + 16 * i + q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t c = k0 + tx + 16 * j;
        if (c >= skv) {
          s[i][j] = -INFINITY;
        } else if ((causal && c > qpos) || (has_window && c <= qpos - window)) {
          s[i][j] = kNegInf;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: key k0 < skv is in range
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kCols * 4; ++e) acc[i][e] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kPPitch + tx + 16 * j] = s[i][j];
    }

    __syncthreads();  // every thread is done with K
    load_tile<T, kBK, DP>(kvs, vb, kv_stride, k0, skv, d, 1.0f);
    __syncthreads();  // V and the probabilities are in place

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPPitch + c];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float4 vv =
            *reinterpret_cast<const float4*>(kvs + c * kPitch + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj + 0] = fmaf(p[i], vv.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(p[i], vv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(p[i], vv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(p[i], vv.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((b * sq + r) * h + hh) * static_cast<int64_t>(d);
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int col = 4 * tx + 64 * jj;
      if (col < d)  // d % 8 == 0, so col + 3 < d too
        store4(orow + col, acc[i][4 * jj] / denom, acc[i][4 * jj + 1] / denom,
               acc[i][4 * jj + 2] / denom, acc[i][4 * jj + 3] / denom);
    }
  }
}

template <typename T, int DP>
int launch_dp(const T* q, const T* k, const T* v, T* o, int64_t b, int64_t sq,
              int64_t skv, int64_t h, int64_t kv, int64_t d, int64_t causal,
              int64_t window, int64_t q_offset, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes<DP>();
  static bool configured = false;  // the attribute is per function, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(b * h), static_cast<unsigned>((sq + kBQ - 1) / kBQ));
  flash_attention_kernel<T, DP><<<grid, kThreads, kSmem, stream>>>(
      q, k, v, o, sq, skv, static_cast<int>(h), static_cast<int>(kv), static_cast<int>(d),
      static_cast<int>(causal), window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int64_t b, int64_t sq, int64_t skv,
           int64_t h, int64_t kv, int64_t d, int64_t causal, int64_t window,
           int64_t q_offset, float scale, cudaStream_t stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  if (d <= 64)
    return launch_dp<T, 64>(q, k, v, o, b, sq, skv, h, kv, d, causal, window, q_offset,
                            scale, stream);
  if (d <= 128)
    return launch_dp<T, 128>(q, k, v, o, b, sq, skv, h, kv, d, causal, window, q_offset,
                             scale, stream);
  return launch_dp<T, 256>(q, k, v, o, b, sq, skv, h, kv, d, causal, window, q_offset,
                           scale, stream);
}

}  // namespace

// q: (b, sq, h, d), k, v: (b, skv, kv, d), o: (b, sq, h, d), all contiguous
// and 16-byte aligned; h % kv == 0, d % 8 == 0, 8 <= d <= 256, skv >= 1;
// window < 0 means no window; scale = d ** -0.5 as an fp32 value.
extern "C" int repro_flash_attention_f32(const float* q, const float* k, const float* v,
                                         float* o, int64_t b, int64_t sq, int64_t skv,
                                         int64_t h, int64_t kv, int64_t d, int64_t causal,
                                         int64_t window, int64_t q_offset, float scale,
                                         cudaStream_t stream) {
  return launch<float>(q, k, v, o, b, sq, skv, h, kv, d, causal, window, q_offset, scale,
                       stream);
}

extern "C" int repro_flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, __nv_bfloat16* o,
                                          int64_t b, int64_t sq, int64_t skv, int64_t h,
                                          int64_t kv, int64_t d, int64_t causal,
                                          int64_t window, int64_t q_offset, float scale,
                                          cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, o, b, sq, skv, h, kv, d, causal, window, q_offset,
                               scale, stream);
}
