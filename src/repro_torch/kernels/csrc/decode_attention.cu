// One-token GQA decode attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (pallas_call at :83, body _decode_kernel at :26).
//
// Computes, for q (B,H,D), caches (B,S,KV,D) and kv_valid (B,S) bool: the
// G = H/KV query heads of KV head j (heads j*G .. j*G+G-1) against every
// cache slot, s = (q * D^-1/2 in fp32) . k, invalid slots at -1e30, fp32
// online softmax over cache tiles, out = acc / max(l, 1e-30) in q's dtype.
// The plain version (kernels/ref.py) rounds q * scale and the
// probabilities to the cache dtype before its products, as the JAX oracle
// does; this kernel, like the Pallas body, keeps them in fp32.
//
// Bound: device-memory bytes.  The output depends only on the valid
// slots' K and V (except in a row with no valid slot, the uniform mean over
// all of them): at KV=8, D=128 in bf16 that is 4 KB a valid slot of a
// batch row, 34.1 MB a layer at B=8 when 1041 of 2048 slots are valid,
// 10.2 us at 3.35 TB/s; the products are 4*H*D = 8 KFLOP a valid slot.
//
// Design (a first, simple kernel):
// - one CTA of 256 threads per (b, KV head), walking the cache in tiles of
//   BK slots (128, or 64 at D_pad = 256); the G query rows are read once
//   into shared memory, scaled, as fp32;
// - each tile of K and V is read with 16-byte loads straight from the
//   (B,S,KV,D) strides (no transposes), every load of a thread issued
//   before the first is used (the bytes in flight are what a cache read
//   with few CTAs is bound by), V's while the scores are computed, and
//   stored to shared memory as fp32, K with rows padded by one float so
//   that one thread per (head, slot) reads its row conflict-free;
// - a warp per query head takes the tile's max and sum by shuffles and
//   keeps (m, l) in shared memory; thread t owns outputs t, t + 256, ... of
//   the (G, D_pad) accumulator, in registers;
// - slots past S score -inf (no weight); a row whose slots are all invalid
//   is the uniform mean over the S slots, as in JAX;
// - a tile whose slots are all invalid is skipped, K and V unread, in a row
//   that has a valid slot: its weights exp(-1e30 - m) are 0 once a valid
//   slot is seen, and before that alpha = 0 wipes them, so the result is
//   the same.  A linear cache at position pos reads ceil((pos + 1) / BK)
//   tiles, a ring cache the tiles its window covers.
// At the serving shape that is B*KV = 64 CTAs on 132 SMs: splitting S
// across CTAs is left to a later change.  expf and IEEE division, never
// fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOut = 16;        // G * D_pad <= 4096: at most 16 outputs a thread
constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ void unpack(const uint4& u, float* dst) {  // 4 fp32
  dst[0] = __uint_as_float(u.x); dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z); dst[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float* dst, __nv_bfloat16) {  // 8 bf16
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// One tile of BK cache rows of one KV head, as 16-byte chunks: a thread's
// kPer chunks are all requested before any is used, so the CTA keeps
// kThreads * kPer * 16 bytes in flight.
template <typename T, int DP, int BK>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);           // elements a chunk
  static constexpr int kChunksPerRow = DP / kVec;
  static constexpr int kPer = BK * kChunksPerRow / kThreads;
  static_assert(BK * kChunksPerRow % kThreads == 0, "tile chunks split evenly");
  uint4 raw[kPer];

  __device__ __forceinline__ void load(const T* __restrict__ base, int64_t row_stride,
                                       int64_t c0, int64_t s, int d) {
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int i = threadIdx.x + n * kThreads;
      const int r = i / kChunksPerRow, c = (i % kChunksPerRow) * kVec;
      raw[n] = (c0 + r < s && c < d)  // d % 8 == 0: a chunk is all in or all out
                   ? __ldg(reinterpret_cast<const uint4*>(base + (c0 + r) * row_stride + c))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // into shared memory as fp32, row pitch `pitch`
  __device__ __forceinline__ void store(float* sm, int pitch) const {
#pragma unroll
    for (int n = 0; n < kPer; ++n) {
      const int i = threadIdx.x + n * kThreads;
      const int r = i / kChunksPerRow, c = (i % kChunksPerRow) * kVec;
      float x[kVec];
      if constexpr (sizeof(T) == 4) unpack(raw[n], x);
      else unpack(raw[n], x, T{});
#pragma unroll
      for (int e = 0; e < kVec; ++e) sm[r * pitch + c + e] = x[e];
    }
  }
};

template <int DP, int BK>
size_t smem_bytes(int g) {
  // q (G x DP), K (BK x (DP + 1)), V (BK x DP), p (G x BK), m / l / alpha (G each)
  return sizeof(float) * (static_cast<size_t>(g) * DP + BK * (DP + 1) + BK * DP + g * BK + 3 * g);
}

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const uint8_t* __restrict__ valid,
                        T* __restrict__ o, int64_t s, int h, int kv, int d, float scale) {
  static_assert(BK <= kThreads, "a thread checks one slot of a tile for validity");
  constexpr int kKPitch = DP + 1;
  extern __shared__ float smem[];
  const int g = h / kv;
  float* qs = smem;                  // g x DP, scaled q
  float* ks = qs + g * DP;           // BK x kKPitch
  float* vs = ks + BK * kKPitch;     // BK x DP
  float* ps = vs + BK * DP;          // g x BK, scores then probabilities
  float* m_s = ps + g * BK;          // g: running max
  float* l_s = m_s + g;              // g: running sum
  float* a_s = l_s + g;              // g: this tile's rescale

  const int b = blockIdx.x / kv, kvh = blockIdx.x % kv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t kv_stride = static_cast<int64_t>(kv) * d;
  const T* qb = q + (static_cast<int64_t>(b) * h + static_cast<int64_t>(kvh) * g) * d;
  const T* kb = kc + (static_cast<int64_t>(b) * s * kv + kvh) * d;
  const T* vb = vc + (static_cast<int64_t>(b) * s * kv + kvh) * d;
  const uint8_t* vrow = valid + static_cast<int64_t>(b) * s;

  for (int i = tid; i < g * DP; i += kThreads) {
    const int gi = i / DP, dd = i % DP;
    qs[i] = dd < d ? __fmul_rn(to_f32(qb[gi * d + dd]), scale) : 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int n = 0; n < kMaxOut; ++n) acc[n] = 0.0f;
  int any = 0;
  for (int64_t i = tid; i < s; i += kThreads) any |= vrow[i];
  const bool skip_invalid_tiles = __syncthreads_or(any) != 0;  // uniform across the CTA

  for (int64_t c0 = 0; c0 < s; c0 += BK) {
    if (skip_invalid_tiles) {
      const int mine = tid < BK && c0 + tid < s ? vrow[c0 + tid] : 0;
      if (!__syncthreads_or(mine)) continue;
    }
    Tile<T, DP, BK> tile;
    tile.load(kb, kv_stride, c0, s, d);
    __syncthreads();  // the previous tile's reads are done
    tile.store(ks, kKPitch);
    tile.load(vb, kv_stride, c0, s, d);  // V arrives while the scores are computed
    __syncthreads();

    // scores: one thread per (query head, slot)
    for (int i = tid; i < g * BK; i += kThreads) {
      const int gi = i / BK, c = i % BK;
      const float* qrow = qs + gi * DP;
      const float* krow = ks + c * kKPitch;
      float dot = 0.0f;
#pragma unroll 8
      for (int dd = 0; dd < DP; ++dd) dot = fmaf(qrow[dd], krow[dd], dot);
      const int64_t slot = c0 + c;
      ps[i] = slot >= s ? -INFINITY : (vrow[slot] ? dot : kNegInf);
    }
    tile.store(vs, DP);
    __syncthreads();

    // online softmax: a warp per query head
    for (int gi = warp; gi < g; gi += kWarps) {
      float* prow = ps + gi * BK;
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, prow[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);  // finite: slot c0 < s is in range
      float sum = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
        a_s[gi] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V
#pragma unroll
    for (int n = 0; n < kMaxOut; ++n) {
      const int i = tid + n * kThreads;
      if (i < g * DP) {
        const int gi = i / DP, dd = i % DP;
        const float* prow = ps + gi * BK;
        float a = acc[n] * a_s[gi];
#pragma unroll 8
        for (int c = 0; c < BK; ++c) a = fmaf(prow[c], vs[c * DP + dd], a);
        acc[n] = a;
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int n = 0; n < kMaxOut; ++n) {
    const int i = tid + n * kThreads;
    if (i < g * DP) {
      const int gi = i / DP, dd = i % DP;
      if (dd < d) from_f32(o + (static_cast<int64_t>(b) * h + kvh * g + gi) * d + dd,
                           acc[n] / fmaxf(l_s[gi], 1e-30f));
    }
  }
}

template <typename T, int DP, int BK>
int launch_dp(const T* q, const T* kc, const T* vc, const uint8_t* valid, T* o, int64_t b,
              int64_t s, int64_t h, int64_t kv, int64_t d, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP, BK>(static_cast<int>(h / kv));
  static bool configured = false;  // per function, once: what the largest G needs
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, DP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<DP, BK>(4096 / DP)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  decode_attention_kernel<T, DP, BK><<<static_cast<unsigned>(b * kv), kThreads, smem, stream>>>(
      q, kc, vc, valid, o, s, static_cast<int>(h), static_cast<int>(kv), static_cast<int>(d),
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* kc, const T* vc, const uint8_t* valid, T* o, int64_t b,
           int64_t s, int64_t h, int64_t kv, int64_t d, float scale, cudaStream_t stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  if (d <= 64) return launch_dp<T, 64, 128>(q, kc, vc, valid, o, b, s, h, kv, d, scale, stream);
  if (d <= 128) return launch_dp<T, 128, 128>(q, kc, vc, valid, o, b, s, h, kv, d, scale, stream);
  return launch_dp<T, 256, 64>(q, kc, vc, valid, o, b, s, h, kv, d, scale, stream);
}

}  // namespace

// q: (b, h, d), k_cache, v_cache: (b, s, kv, d), valid: (b, s) bytes (0/1),
// o: (b, h, d), all contiguous, the fp tensors 16-byte aligned; h % kv == 0,
// d % 8 == 0, 8 <= d <= 256, (h / kv) * d_pad <= 4096, s >= 1;
// scale = d ** -0.5 as an fp32 value.
extern "C" int repro_decode_attention_f32(const float* q, const float* kc, const float* vc,
                                          const uint8_t* valid, float* o, int64_t b,
                                          int64_t s, int64_t h, int64_t kv, int64_t d,
                                          float scale, cudaStream_t stream) {
  return launch<float>(q, kc, vc, valid, o, b, s, h, kv, d, scale, stream);
}

extern "C" int repro_decode_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* kc,
                                           const __nv_bfloat16* vc, const uint8_t* valid,
                                           __nv_bfloat16* o, int64_t b, int64_t s, int64_t h,
                                           int64_t kv, int64_t d, float scale,
                                           cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, kc, vc, valid, o, b, s, h, kv, d, scale, stream);
}
