// Causal / sliding-window GQA flash attention (prefill), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (pallas_call at :102, body _flash_kernel at :28).
//
// Computes, for q (B,Sq,H,D) and k, v (B,Skv,KV,D), query head h reading
// KV head h / (H/KV): the scores q . k^T times D^-1/2; key j is masked for
// query row i (position i + q_offset) when causal and j > i + q_offset, or
// when a window is given and j <= i + q_offset - window; masked scores are
// -1e30 (finite: a row with no valid key becomes the uniform mean, never
// NaN) and keys past Skv -inf; online softmax (m, l, acc) in fp32; out =
// acc / max(l, 1e-30) in q's dtype.
//
// Bound: operations at the serving shape.  4*B*H*D flops per valid (query,
// key) pair: 34.4 GFLOP a layer at B=8, Sq=Skv=1024, H=16, D=128, causal,
// 32.1 us at 1070 TFLOP/s (the H100's dense bf16 rate at its 1980 MHz
// maximum SM clock: 132 SMs x 4096 flops a clock), against ~100 MB of q,
// k, v and out (30 us at 3.35 TB/s).  Only the tensor cores come near it.
//
// The dtype picks the route in the C entry points (a route, not a fallback):
//
// bf16, flash_attention_kernel_wgmma: both products on the tensor cores.
// - work items of (b*h, 128-row query tile), walked heaviest first (under
//   causal masking the last tiles see the most keys) by one persistent CTA
//   an SM; warpgroups 0 and 1 each own 64 of an item's rows.  Two
//   warpgroups, not a third that loads: ptxas held a 12-warp CTA to 168
//   registers a thread despite setmaxnreg (D_pad 256 spilled), and 8 warps
//   get 255;
// - thread 0 loads with TMA, in the order the tiles are used: each item's Q
//   into one of two slots, its K and V tiles (128 keys; 32 at D_pad = 256,
//   for registers) into a 2-stage ring that runs on from one item into the
//   next, completing on mbarriers.  A stage refills once both warpgroups
//   release it (K after the scores, V after P . V), so copies overlap the
//   products and the next item's first tiles the current item's last.
//   Warpgroup 0 meets (a named barrier) after thread 0 may have waited, so
//   no warp asks for a wgmma its warpgroup's other warps have not;
// - the tensor maps view q, k, v as 4-D (D, heads, S, B), read in
//   64-column boxes with the 128-byte swizzle: rows past Sq / Skv and
//   columns past D arrive as zeros.  They are made on the host per call
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: no -lcuda)
//   and passed as __grid_constant__;
// - S = Q . K^T: wgmma m64nBKk16 from shared memory, both operands K-major
//   (D contiguous, as they lie in memory), fp32 accumulators; the scale
//   (times log2 e) multiplies the fp32 scores, masks apply before the max,
//   exp2 on the special function unit; a row's max and sum run over the 4
//   threads of a quad;
// - O += P . V: wgmma m64nDk16 with P from registers: the score
//   accumulator's layout is the A fragment's, so P is rounded to bf16 in
//   place and never goes through shared memory; V (keys x D, D contiguous)
//   is the MN-major B operand (the transpose bit);
// - bf16 operands with fp32 sums are the route's one departure from the
//   JAX kernel's fp32 products; XLA on a TPU runs those as bf16 passes at
//   default precision too;
// - where its time goes (flash_ablation.py, H100 at 700 W): at the serving
//   shape no single part dominates; taking out either product or the
//   softmax saves 10-13 us of ~105, and the copies with nothing to hide
//   them behind take ~82.
//
// fp32, flash_attention_kernel: the CUDA-core kernel, unchanged: TF32 on
// the tensor cores keeps 10 mantissa bits and would fail fp32's 2e-5 gate
// (no model path serves attention in fp32).
// - one CTA of 256 threads per (b*h, 64-row query tile); the scaled Q tile
//   stays in shared memory as fp32; each 64-key tile of K, then of V, is
//   staged through one shared buffer (rows padded to D_pad + 4 floats:
//   16-byte aligned, conflict-free float4 reads);
// - thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16i and key
//   columns tx + 16j (i, j < 4) of the score tile, and output columns
//   4*tx + 64*jj .. +3 of its rows; a row's 16 threads sit in one half-warp,
//   so its max and sum are shuffle reductions, and the softmax state (m, l)
//   and the output accumulator live in registers; expf and IEEE division.
//
// Both routes:
// - tiles are read straight from the (B,S,H,D) strides (no transposes);
// - ragged Sq / Skv: rows past Sq are never written, keys past Skv score
//   -inf (exactly no weight, even for a row with no valid key);
// - key tiles wholly above the diagonal or before the window are skipped.
//   The JAX kernel walks them, but once a valid key arrives their weight is
//   wiped by alpha = exp(-1e30 - m) = 0, so the result is the same -- except
//   for a tile holding a row with no valid key at all, which walks every key
//   tile as the JAX kernel does;
// - head dims: any D % 8 == 0 up to 256, zero-padded to D_pad in
//   {64, 128, 256} (zeros add nothing to the products);
// - never fast math.
#include <cuda.h>
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

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
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
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int64_t sq,
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
    // m + log(l): a row with no valid key keeps m = -1e30, which absorbs log(l)
    if (lse != nullptr && tx == 0) lse[bh * sq + r] = m[i] + logf(l[i]);
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
int launch_dp(const T* q, const T* k, const T* v, T* o, float* lse, int64_t b,
              int64_t sq, int64_t skv, int64_t h, int64_t kv, int64_t d, int64_t causal,
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
      q, k, v, o, lse, sq, skv, static_cast<int>(h), static_cast<int>(kv),
      static_cast<int>(d), static_cast<int>(causal), window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, float* lse, int64_t b, int64_t sq,
           int64_t skv, int64_t h, int64_t kv, int64_t d, int64_t causal, int64_t window,
           int64_t q_offset, float scale, cudaStream_t stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  if (d <= 64)
    return launch_dp<T, 64>(q, k, v, o, lse, b, sq, skv, h, kv, d, causal, window, q_offset,
                            scale, stream);
  if (d <= 128)
    return launch_dp<T, 128>(q, k, v, o, lse, b, sq, skv, h, kv, d, causal, window, q_offset,
                             scale, stream);
  return launch_dp<T, 256>(q, k, v, o, lse, b, sq, skv, h, kv, d, causal, window, q_offset,
                           scale, stream);
}

}  // namespace

// ---------------- bf16: warpgroup MMA on the tensor cores, TMA copies ----------------
namespace {

constexpr int kWgBQ = 128;          // query rows per work item: two warpgroups of 64
constexpr int kWgThreads = 256;     // two warpgroups: 255 registers a thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of one CTA, every tile 1024-byte aligned (the 128-byte
// swizzle's period).  A tile is DP / 64 panels of 64 columns (128 bytes a
// row), each panel its rows x 128 bytes, as TMA writes a 64-column box.
template <int DP>
struct WgTile {
  static constexpr int kBK = DP == 256 ? 32 : 128;   // keys per tile (registers at 256)
  static constexpr int kStages = 2;                   // the K / V ring
  static constexpr int kQSlots = 2;  // the next item's Q loads while this one computes
  static constexpr int kPanels = DP / 64;
  static constexpr uint32_t kQBytes = kWgBQ * DP * 2;  // one Q slot
  static constexpr uint32_t kKVBytes = kBK * DP * 2;   // one K or V tile
  static constexpr uint32_t kK = kQSlots * kQBytes;    // K stage s at kK + s * kKVBytes
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBars = kV + kStages * kKVBytes;
  static constexpr size_t kSmem = kBars + 16 * 8 + 1024;  // 12 mbarriers; slack to align
  // In its turn on tile g, before it releases that tile's Q slot, thread 0
  // loads tile g + kStages - 1; when that tile starts an item, it first
  // waits for every thread to release the item kQSlots back.  Every item
  // holds at least one tile (Skv >= 1, q_offset >= 0), so that item ended
  // at tile g + kStages - 1 - kQSlots or before: before g, released by
  // thread 0 already, only if kStages <= kQSlots.  Otherwise thread 0 can
  // wait for its own release, still to come.
  static_assert(kStages <= kQSlots, "thread 0 would wait on its own Q release");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, leading byte offset (K-major: unused, 16; MN-major: the stride
// between 64-column panels), stride byte offset 1024 (between 8-row groups).
// The address sits in the low 14 bits, in 16-byte units: adding n / 16 to
// a descriptor moves its start n bytes on.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until this warpgroup's committed products are done.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of asynchronously written
// accumulators above the wait that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// 2^x on the special function unit; results below 2^-126 flush to 0
// (exp2f's denormal path is the same instruction between two rescales):
// a probability that small is no weight next to the row's largest, 1.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 32 fp32) += A (64 x 16, shared, K-major) * B (16 x 32, shared,
// K-major); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 fp32) += A (64 x 16, shared, K-major) * B (16 x 128, shared,
// K-major); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, shared,
// MN-major: the transpose bit); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers) * B (16 x 128, shared,
// MN-major: the transpose bit); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 256 fp32) += A (64 x 16 bf16, registers) * B (16 x 256, shared,
// MN-major: the transpose bit); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (64 x 64 fp32) += A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "no such key tile");
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "no such head dim");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  else wgmma_rs_n256(d, a, db, 1);
}

// The scores of one key tile, in place: scale into log2 units, mask (only
// a tile that holds a masked key), fold the tile into the row max m; then
// sc = exp2(sc - m), l = l * alpha + the tile's row sums, with alpha the
// factor that rescales what was summed before.  A row's 4 threads form a
// quad; this thread holds rows `row` and row + 8 (r = 0, 1) and, of each
// 8-column chunk ch, columns 8 * ch + cq and + 1 (sc[4 * ch + 2 * r + 0/1]).
// Off the edges the scale rides in the exponent's multiply-add (the scale
// is positive, so the max of the raw scores gives the max of the scaled).
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2], bool edge,
                                               int64_t k0, int64_t qpos0, int64_t skv,
                                               int causal, int64_t window, int cq,
                                               float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
  float sl = scale_log2;
  if (edge) {
    // per row, in tile-local columns c: c >= end is past Skv, c > hi after
    // the diagonal, c <= lo before the window
    const int end = static_cast<int>(min64(skv - k0, BK));
    int hi[2], lo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t qp = qpos0 + 8 * r - k0;
      hi[r] = causal ? static_cast<int>(max64(-1, min64(qp, BK))) : BK;
      lo[r] = window >= 0 ? static_cast<int>(max64(-1, min64(qp - window, BK))) : -1;
    }
#pragma unroll
    for (int ch = 0; ch < BK / 8; ++ch)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, c = 8 * ch + cq + e % 2;
        float x = sc[4 * ch + e] * scale_log2;
        if (c >= end) x = -INFINITY;
        else if (c > hi[r] || c <= lo[r]) x = kNegInf;
        sc[4 * ch + e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    sl = 1.0f;
  } else {
#pragma unroll
    for (int ch = 0; ch < BK / 8; ++ch)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * ch + e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] *= scale_log2;
  }
  float rs[2] = {0.0f, 0.0f}, neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);  // finite: m starts at -1e30
    alpha[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
#pragma unroll
  for (int ch = 0; ch < BK / 8; ++ch)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * ch + e] = exp2_ftz(fmaf(sc[4 * ch + e], sl, neg_m[e / 2]));
      rs[e / 2] += sc[4 * ch + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// P in bf16, as the A fragments of the k16 steps j: registers (row, keys
// 16j + cq, + 1), (row + 8, same), (row, 16j + 8 + cq, + 1), (row + 8, same)
// -- the score accumulator's own layout.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2], uint32_t (&pf)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int g = 0; g < 4; ++g) pf[j][g] = pack_bf16(sc[8 * j + 2 * g], sc[8 * j + 2 * g + 1]);
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                             int64_t sq, int64_t skv, int h, int kv, int d, int causal,
                             int64_t window, int64_t q_offset, float scale_log2, int n_items) {
  using C = WgTile<DP>;
  constexpr int kBK = C::kBK, kStages = C::kStages, kQSlots = C::kQSlots;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // mbarriers: per Q slot full, free; per K / V stage K full, V full, K free, V free
  const uint32_t bars = base + C::kBars;
  auto q_full = [&](int j) { return bars + 8u * (j % kQSlots); };
  auto q_free = [&](int j) { return bars + 8u * (2 + j % kQSlots); };
  auto k_full = [&](int s) { return bars + 8u * (4 + s); };
  auto v_full = [&](int s) { return bars + 8u * (4 + kStages + s); };
  auto k_free = [&](int s) { return bars + 8u * (4 + 2 * kStages + s); };
  auto v_free = [&](int s) { return bars + 8u * (4 + 3 * kStages + s); };

  // This CTA's work: items blockIdx.x, + gridDim.x, ...  Item w is one
  // (b*h, 128-row query tile), the query tiles heaviest first: under causal
  // masking the last see the most keys.  Its key tiles are those the fp32
  // kernel walks.
  const bool has_window = window >= 0;
  const int n_qt = static_cast<int>((sq + kWgBQ - 1) / kWgBQ);
  const int n_mine = (n_items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  struct Item {
    int b, hh, n;
    int64_t q0, kt0;
  };
  auto item = [&](int j) {
    const int w = static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x);
    const int bh = w % (n_items / n_qt);
    Item it;
    it.b = bh / h;
    it.hh = bh % h;
    it.q0 = static_cast<int64_t>(n_qt - 1 - w / (n_items / n_qt)) * kWgBQ;
    const int64_t qlo = it.q0 + q_offset, qhi = min64(it.q0 + kWgBQ, sq) - 1 + q_offset;
    // whether a row has no valid key grows with its position: the last decides
    const bool empty_row =
        has_window && qhi - window + 1 > min64(causal ? qhi : skv - 1, skv - 1);
    int64_t kt0 = 0, kt1 = (skv + kBK - 1) / kBK;
    if (!empty_row) {
      if (causal) kt1 = min64(kt1, qhi / kBK + 1);
      if (has_window) kt0 = max64(0, qlo - window + 1) / kBK;
    }
    it.kt0 = kt0;
    it.n = static_cast<int>(kt1 - kt0);
    return it;
  };

  if (threadIdx.x == 0) {
    for (int j = 0; j < kQSlots; ++j) {
      mbar_init(q_full(j), 1);
      mbar_init(q_free(j), kWgThreads);  // every thread releases a slot or stage
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_free(s), kWgThreads);
      mbar_init(v_free(s), kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 loads, in the order the tiles are used: the K / V ring runs on
  // from one item into the next, and an item's Q goes into its slot with
  // its first tile.  load_next() copies the next tile once its stage is
  // free (both warpgroups released the tile kStages before it).
  int lj = 0, lt = 0, gl = 0;  // the next load: item, its tile, tiles loaded so far
  Item li = item(0);
  auto load_next = [&]() {
    if (lj >= n_mine) return;
    if (lt == 0) {
      if (lj >= kQSlots) mbar_wait(q_free(lj), (lj / kQSlots - 1) & 1);
      const uint32_t qs = base + (lj % kQSlots) * C::kQBytes;
      mbar_expect_tx(q_full(lj), C::kQBytes);
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
        tma_load(qs + p * kWgBQ * 128, &tq, q_full(lj), 64 * p, li.hh,
                 static_cast<int>(li.q0), li.b);
    }
    const int s = gl % kStages, kvh = li.hh / (h / kv);
    const int k0 = static_cast<int>((li.kt0 + lt) * kBK);
    if (gl >= kStages) {
      mbar_wait(k_free(s), (gl / kStages - 1) & 1);
      mbar_wait(v_free(s), (gl / kStages - 1) & 1);
    }
    mbar_expect_tx(k_full(s), C::kKVBytes);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
      tma_load(base + C::kK + s * C::kKVBytes + p * kBK * 128, &tk, k_full(s), 64 * p, kvh,
               k0, li.b);
    mbar_expect_tx(v_full(s), C::kKVBytes);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p)
      tma_load(base + C::kV + s * C::kKVBytes + p * kBK * 128, &tv, v_full(s), 64 * p, kvh,
               k0, li.b);
    ++gl;
    if (++lt == li.n) {
      lt = 0;
      if (++lj < n_mine) li = item(lj);
    }
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages; ++i) load_next();

  // Warpgroup wg owns rows wg * 64 .. + 63 of an item.  The accumulator
  // layout: this thread holds rows `row` and row + 8, columns 8 * ch + cq
  // and + 1 of every 8-column chunk ch.
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int row = wg * 64 + (t / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);

  int g = 0;  // tiles used so far, over all items
  for (int j = 0; j < n_mine; ++j) {
    const Item it = item(j);
    const int64_t qlo = it.q0 + q_offset, qhi = min64(it.q0 + kWgBQ, sq) - 1 + q_offset;
    const int64_t qpos0 = it.q0 + row + q_offset;
    const uint64_t dq = sw128_desc(base + (j % kQSlots) * C::kQBytes + wg * 64 * 128, 16);
    float acc[DP / 2];
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[e] = 0.0f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full(j), (j / kQSlots) & 1);
    for (int i = 0; i < it.n; ++i, ++g) {
      const int s = g % kStages;
      const uint32_t parity = (g / kStages) & 1;
      const int64_t k0 = (it.kt0 + i) * kBK;

      // S = Q . K^T: DP / 64 panels of 4 k16 steps (32 bytes) each; the
      // first step overwrites sc
      float sc[kBK / 2];
      const uint64_t dk = sw128_desc(base + C::kK + s * C::kKVBytes, 16);
      mbar_wait(k_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<kBK>(sc, dq + (p * kWgBQ * 128 + kk * 32) / 16,
                        dk + (p * kBK * 128 + kk * 32) / 16, p | kk);
      wgmma_commit();
      // Refill tile g - 1's stage.  Its wait may hold warp 0 until the other
      // warpgroup releases that tile, so warpgroup 0 meets before its next
      // wgmma: a warpgroup whose other warps went on would leave the tensor
      // cores a partial instruction, and the other warpgroup stuck behind it.
      if (threadIdx.x == 0 && g >= 1) load_next();
      if (wg == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
      wgmma_wait();
      fence_regs(sc);
      mbar_arrive(k_free(s));
      if (i == it.n - 1) mbar_arrive(q_free(j));

      float alpha[2];
      const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > qlo) ||
                        (has_window && k0 <= qhi - window);
      online_softmax<kBK>(sc, m, l, alpha, edge, k0, qpos0, skv, causal, window, cq,
                          scale_log2);
#pragma unroll
      for (int ch = 0; ch < DP / 8; ++ch)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * ch + e] *= alpha[e / 2];
      uint32_t pf[kBK / 16][4];
      pack_p<kBK>(sc, pf);

      // O += P . V, 16 keys (2048 bytes) a step; V's panels kBK * 128 bytes apart
      const uint64_t dv = sw128_desc(base + C::kV + s * C::kKVBytes, kBK * 128);
      mbar_wait(v_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < kBK / 16; ++jj) wgmma_rs<DP>(acc, pf[jj], dv + jj * 2048 / 16);
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      mbar_arrive(v_free(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int64_t qr = it.q0 + row + 8 * r;
      if (qr >= sq) continue;
      const float inv = 1.0f / fmaxf(l[r], 1e-30f);  // IEEE; one rounding more than a division
      // m + log(l) in natural units (m is in log2 units); a row with no
      // valid key keeps m = -1e30 unscaled, and gets the plain version's -1e30
      if (lse != nullptr && cq == 0)
        lse[(static_cast<int64_t>(it.b) * h + it.hh) * sq + qr] =
            m[r] == kNegInf ? kNegInf : (m[r] + log2f(l[r])) * kLn2;
      __nv_bfloat16* orow = o + ((it.b * sq + qr) * h + it.hh) * static_cast<int64_t>(d);
#pragma unroll
      for (int ch = 0; ch < DP / 8; ++ch) {
        const int col = 8 * ch + cq;
        if (col < d)  // d % 8 == 0, so col + 1 < d too
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * ch + 2 * r] * inv, acc[4 * ch + 2 * r + 1] * inv);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded: no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// x (B, S, heads, D) bf16 as the 4-D tensor (D, heads, S, B), read in boxes
// of 64 columns x 1 head x `rows` rows x 1 batch row, 128-byte swizzled;
// what lies outside the tensor arrives as zeros.
int tensor_map(CUtensorMap* map, const void* x, int64_t b, int64_t s, int64_t heads,
               int64_t d, uint32_t rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d * 2),
                                 static_cast<cuuint64_t>(heads * d * 2),
                                 static_cast<cuuint64_t>(s * heads * d * 2)};
  const cuuint32_t box[4] = {64, 1, rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int DP>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                 __nv_bfloat16* o, float* lse, int64_t b, int64_t sq, int64_t skv, int64_t h,
                 int64_t kv, int64_t d, int64_t causal, int64_t window, int64_t q_offset,
                 float scale, cudaStream_t stream) {
  using C = WgTile<DP>;
  static bool configured = false;  // the attribute is per function, set once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel_wgmma<DP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(C::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  static int n_sms = 0;  // one persistent CTA an SM
  if (n_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t n_items = (sq + kWgBQ - 1) / kWgBQ * b * h;
  if (n_items > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int rc = tensor_map(&tq, q, b, sq, h, d, kWgBQ);
  if (rc == 0) rc = tensor_map(&tk, k, b, skv, kv, d, C::kBK);
  if (rc == 0) rc = tensor_map(&tv, v, b, skv, kv, d, C::kBK);
  if (rc != 0) return rc;
  const unsigned grid = static_cast<unsigned>(n_items < n_sms ? n_items : n_sms);
  flash_attention_kernel_wgmma<DP><<<grid, kWgThreads, C::kSmem, stream>>>(
      tq, tk, tv, o, lse, sq, skv, static_cast<int>(h), static_cast<int>(kv),
      static_cast<int>(d), static_cast<int>(causal), window, q_offset, scale * kLog2e,
      static_cast<int>(n_items));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------- the backward: two kernels, fp32 sums, no atomics ----------------
//
// Replaces no TPU kernel: the JAX package has no backward kernel, JAX
// differentiates its attention oracle.  Added for training (the port's
// ops._FlashAttentionBwd), from the forward's out and lse: delta =
// rowsum(dO * O), P = exp(S - lse), dP = dO . V^T, dS = P * (dP - delta)
// where the mask lets the pair attend and 0 elsewhere; dQ = scale * dS . K,
// dK = scale * dS^T . Q and dV = P^T . dO summed over a KV head's G query
// heads.  A row with no valid key took the mean of V: it adds dO / Skv to
// every key's dV and nothing to dQ or dK.
//
// Bound at the training shape (B = 8, S = 512, H = 16 over KV = 8, D = 128,
// bf16, causal): ~101 MB of q, k, v, out, lse, dout and the gradients (30 us
// at 3.35 TB/s) against 21.5 GFLOP of the five distinct products (20 us at
// 1070 TFLOP/s); the two-kernel scheme computes S and dP twice, seven
// products, ~30 GFLOP (28 us).  Only the tensor cores come near it: seven
// products in fp32 on the CUDA cores take ~450 us at 67 TFLOP/s.
//
// Two kernels, dQ (with delta) then dK / dV: each CTA owns its rows of dQ,
// or of dK and dV over the G query heads, so there are no atomics and two
// calls give the same bits.  The dtype picks the route (a route, not a
// fallback): bf16 runs on the tensor cores (wgmma, TMA; its section below),
// fp32 on the CUDA cores in fp32 throughout (TF32 would miss fp32's 2e-5
// gate), one CTA of 256 threads a 64-row query tile (dQ) or a key tile (dK /
// dV, 64 keys; 32 at D_pad = 256), tiles staged through shared memory as
// fp32.
namespace {

constexpr int kBwdBQ = 64;  // query rows a tile

// keys a tile: 32 at D_pad = 256 keeps the dK / dV kernel's tiles inside
// 227 KB of shared memory (and its accumulators at 64 floats a thread)
template <int DP>
__host__ __device__ constexpr int bwd_bk() { return DP == 256 ? 32 : 64; }

template <int DP>
constexpr size_t bwd_dq_smem() {
  constexpr int BK = bwd_bk<DP>();
  return sizeof(float) * (2 * kBwdBQ * (DP + 4) + 2 * BK * (DP + 4) + kBwdBQ * (BK + 1) +
                          2 * kBwdBQ);
}

template <int DP>
constexpr size_t bwd_dkv_smem() {
  constexpr int BK = bwd_bk<DP>();
  return sizeof(float) * (2 * BK * (DP + 4) + 2 * kBwdBQ * (DP + 4) + 2 * kBwdBQ * (BK + 1) +
                          2 * kBwdBQ);
}

// The masks, as the forward and ``ref.attention`` apply them: key j attends
// to the query at position qpos when j < skv, (not causal or j <= qpos) and
// (no window or j > qpos - window).  A row with no valid key (possible with
// a window and q_offset) took the uniform mean of V in the forward.
struct Mask {
  int64_t skv, window, q_offset;
  int causal;
  __device__ __forceinline__ bool valid(int64_t qpos, int64_t j) const {
    return j < skv && (!causal || j <= qpos) && (window < 0 || j > qpos - window);
  }
  // the keys [lo, hi] a query at qpos attends (empty when lo > hi)
  __device__ __forceinline__ int64_t lo(int64_t qpos) const {
    return window >= 0 ? max64(qpos - window + 1, 0) : 0;
  }
  __device__ __forceinline__ int64_t hi(int64_t qpos) const {
    return causal ? min64(qpos, skv - 1) : skv - 1;
  }
  __device__ __forceinline__ bool empty(int64_t qpos) const { return lo(qpos) > hi(qpos); }
};

// dQ = scale * dS . K over the key tiles the tile's rows attend, one CTA a
// (b*h, 64-row query tile); first delta = rowsum(dO * O) of its rows, into
// `delta` (B, H, Sq) for the dK / dV kernel.  S and P are recomputed from
// the scaled Q and lse: P = exp(S - lse), dP = dO . V^T, dS = P * (dP -
// delta) where the mask lets the pair attend and 0 elsewhere (the
// forward's where() passes no gradient to a masked score).  Thread (ty,
// tx) holds score rows ty + 16i and key columns tx + 16j, and dQ rows ty +
// 16i, columns 4 tx + 64 jj .. + 3.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ o,
                              const float* __restrict__ lse, const T* __restrict__ dout,
                              T* __restrict__ dq, float* __restrict__ delta, int64_t sq,
                              int h, int kv, int d, Mask mask, float scale) {
  constexpr int BK = bwd_bk<DP>(), kJ = BK / 16, kPitch = DP + 4, kCols = DP / 64;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // scaled Q
  float* dos = qs + kBwdBQ * kPitch;            // dO
  float* ks = dos + kBwdBQ * kPitch;
  float* vs = ks + BK * kPitch;
  float* dss = vs + BK * kPitch;                // dS, kBwdBQ x (BK + 1)
  float* lse_s = dss + kBwdBQ * (BK + 1);
  float* delta_s = lse_s + kBwdBQ;

  const int bh = blockIdx.x, b = bh / h, hh = bh % h, kvh = hh / (h / kv);
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kBwdBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t q_stride = static_cast<int64_t>(h) * d, kv_stride = static_cast<int64_t>(kv) * d;
  const int64_t q_base = (b * sq * h + hh) * static_cast<int64_t>(d);
  const int64_t kv_base = (b * mask.skv * kv + kvh) * static_cast<int64_t>(d);

  load_tile<T, kBwdBQ, DP>(qs, q + q_base, q_stride, q0, sq, d, scale);
  load_tile<T, kBwdBQ, DP>(dos, dout + q_base, q_stride, q0, sq, d, 1.0f);
  __syncthreads();
  // delta: 4 threads a row, each a quarter of D_pad; O read once, here
  {
    const int r = tid / 4, part = tid % 4;
    float acc = 0.0f;
    if (q0 + r < sq) {
      const T* orow = o + q_base + (q0 + r) * q_stride;
      for (int c = part * 8; c < d; c += 32) {
        float x[8];
        load8(orow + c, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(dos[r * kPitch + c + e], x[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      delta_s[r] = acc;
      lse_s[r] = q0 + r < sq ? lse[bh * sq + q0 + r] : 0.0f;
      if (q0 + r < sq) delta[bh * sq + q0 + r] = acc;
    }
  }

  // the key tiles the tile's rows attend: lo and hi grow with the position
  const int64_t qlo = q0 + mask.q_offset, qhi = min64(q0 + kBwdBQ, sq) - 1 + mask.q_offset;
  const int64_t lo = mask.lo(qlo), hi = mask.hi(qhi);
  const int64_t kt0 = lo / BK, kt1 = hi >= lo ? hi / BK + 1 : kt0;

  float acc[4][kCols * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < kCols * 4; ++e) acc[i][e] = 0.0f;

  for (int64_t kt = kt0; kt < kt1; ++kt) {
    const int64_t k0 = kt * BK;
    __syncthreads();  // the previous tile's K reads are done (and delta_s, lse_s written)
    load_tile<T, BK, DP>(ks, k + kv_base, kv_stride, k0, mask.skv, d, 1.0f);
    load_tile<T, BK, DP>(vs, v + kv_base, kv_stride, k0, mask.skv, d, 1.0f);
    __syncthreads();

    float s[4][kJ], dp[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int dd = 0; dd < DP; dd += 4) {
      float4 qa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kPitch + dd);
        da[i] = *reinterpret_cast<const float4*>(dos + (ty + 16 * i) * kPitch + dd);
      }
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kPitch + dd);
        const float4 vv = *reinterpret_cast<const float4*>(vs + (tx + 16 * j) * kPitch + dd);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qa[i].x, kk.x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kk.y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kk.z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kk.w, s[i][j]);
          dp[i][j] = fmaf(da[i].x, vv.x, dp[i][j]);
          dp[i][j] = fmaf(da[i].y, vv.y, dp[i][j]);
          dp[i][j] = fmaf(da[i].z, vv.z, dp[i][j]);
          dp[i][j] = fmaf(da[i].w, vv.w, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int64_t qpos = q0 + r + mask.q_offset;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.0f;
        if (q0 + r < sq && mask.valid(qpos, k0 + c))
          ds = expf(s[i][j] - lse_s[r]) * (dp[i][j] - delta_s[r]);
        dss[r * (BK + 1) + c] = ds;
      }
    }
    __syncthreads();  // dS in place

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = dss[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float4 kk = *reinterpret_cast<const float4*>(ks + c * kPitch + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj + 0] = fmaf(p[i], kk.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(p[i], kk.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(p[i], kk.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(p[i], kk.w, acc[i][4 * jj + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    T* row = dq + q_base + r * q_stride;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int col = 4 * tx + 64 * jj;
      if (col < d)  // a row with no key tile stores zeros
        store4(row + col, acc[i][4 * jj] * scale, acc[i][4 * jj + 1] * scale,
               acc[i][4 * jj + 2] * scale, acc[i][4 * jj + 3] * scale);
    }
  }
}

// dK = dS^T . (scale Q) and dV = P^T . dO for one (b*kv, key tile), summed
// in registers over the G query heads of the KV head and the query tiles
// that reach the key tile: each CTA owns its rows of dK and dV, so there
// are no atomics and the sums run in one fixed order.  A row with no valid
// key adds dO / Skv to every key's dV (its output was the mean of V) and
// nothing to dK.  Thread (ty, tx) holds score rows ty + 16i and key
// columns tx + 16j, and dK / dV key rows ty + 16i, columns 4 tx + 64 jj.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const float* __restrict__ lse,
                               const T* __restrict__ dout, const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv, int64_t sq, int h,
                               int kv, int d, Mask mask, float scale) {
  constexpr int BK = bwd_bk<DP>(), kJ = BK / 16, kPitch = DP + 4, kCols = DP / 64;
  constexpr int kPP = BK + 1;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * kPitch;
  float* qs = vs + BK * kPitch;                 // scaled Q
  float* dos = qs + kBwdBQ * kPitch;
  float* ps = dos + kBwdBQ * kPitch;            // P, kBwdBQ x kPP
  float* dss = ps + kBwdBQ * kPP;               // dS
  float* lse_s = dss + kBwdBQ * kPP;
  float* delta_s = lse_s + kBwdBQ;

  const int bkv = blockIdx.x, b = bkv / kv, kvh = bkv % kv, g = h / kv;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * BK;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t q_stride = static_cast<int64_t>(h) * d, kv_stride = static_cast<int64_t>(kv) * d;
  const int64_t kv_base = (b * mask.skv * kv + kvh) * static_cast<int64_t>(d);
  const float uniform = 1.0f / static_cast<float>(mask.skv);

  load_tile<T, BK, DP>(ks, k + kv_base, kv_stride, k0, mask.skv, d, 1.0f);
  load_tile<T, BK, DP>(vs, v + kv_base, kv_stride, k0, mask.skv, d, 1.0f);

  float dk_acc[kJ][kCols * 4], dv_acc[kJ][kCols * 4];
#pragma unroll
  for (int i = 0; i < kJ; ++i)
#pragma unroll
    for (int e = 0; e < kCols * 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.0f;

  const int64_t n_qt = (sq + kBwdBQ - 1) / kBwdBQ, k1 = k0 + BK - 1;
  for (int hh = kvh * g; hh < (kvh + 1) * g; ++hh) {
    const int64_t bh = static_cast<int64_t>(b) * h + hh;
    const int64_t q_base = (b * sq * h + hh) * static_cast<int64_t>(d);
    for (int64_t qt = 0; qt < n_qt; ++qt) {
      const int64_t q0 = qt * kBwdBQ;
      const int64_t qlo = q0 + mask.q_offset, qhi = min64(q0 + kBwdBQ, sq) - 1 + mask.q_offset;
      // a row with no valid key reaches every key (the mean); emptiness
      // grows with the position, so the tile's last row decides
      if (!mask.empty(qhi) && (mask.hi(qhi) < k0 || mask.lo(qlo) > k1)) continue;
      __syncthreads();  // the previous tile's reads are done
      load_tile<T, kBwdBQ, DP>(qs, q + q_base, q_stride, q0, sq, d, scale);
      load_tile<T, kBwdBQ, DP>(dos, dout + q_base, q_stride, q0, sq, d, 1.0f);
      if (tid < kBwdBQ) {
        const bool in = q0 + tid < sq;
        lse_s[tid] = in ? lse[bh * sq + q0 + tid] : 0.0f;
        delta_s[tid] = in ? delta[bh * sq + q0 + tid] : 0.0f;
      }
      __syncthreads();

      float s[4][kJ], dp[4][kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
      for (int dd = 0; dd < DP; dd += 4) {
        float4 qa[4], da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kPitch + dd);
          da[i] = *reinterpret_cast<const float4*>(dos + (ty + 16 * i) * kPitch + dd);
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const float4 kk = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kPitch + dd);
          const float4 vv = *reinterpret_cast<const float4*>(vs + (tx + 16 * j) * kPitch + dd);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(qa[i].x, kk.x, s[i][j]);
            s[i][j] = fmaf(qa[i].y, kk.y, s[i][j]);
            s[i][j] = fmaf(qa[i].z, kk.z, s[i][j]);
            s[i][j] = fmaf(qa[i].w, kk.w, s[i][j]);
            dp[i][j] = fmaf(da[i].x, vv.x, dp[i][j]);
            dp[i][j] = fmaf(da[i].y, vv.y, dp[i][j]);
            dp[i][j] = fmaf(da[i].z, vv.z, dp[i][j]);
            dp[i][j] = fmaf(da[i].w, vv.w, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int64_t qpos = q0 + r + mask.q_offset;
        const bool row_in = q0 + r < sq, row_empty = mask.empty(qpos);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int c = tx + 16 * j;
          float p = 0.0f, ds = 0.0f;
          if (row_in && mask.valid(qpos, k0 + c)) {
            p = expf(s[i][j] - lse_s[r]);
            ds = p * (dp[i][j] - delta_s[r]);
          } else if (row_in && row_empty && k0 + c < mask.skv) {
            p = uniform;
          }
          ps[r * kPP + c] = p;
          dss[r * kPP + c] = ds;
        }
      }
      __syncthreads();  // P and dS in place

#pragma unroll 4
      for (int r = 0; r < kBwdBQ; ++r) {
        float p[kJ], ds[kJ];
#pragma unroll
        for (int i = 0; i < kJ; ++i) {
          p[i] = ps[r * kPP + ty + 16 * i];
          ds[i] = dss[r * kPP + ty + 16 * i];
        }
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          const float4 da = *reinterpret_cast<const float4*>(dos + r * kPitch + 4 * tx + 64 * jj);
          const float4 qa = *reinterpret_cast<const float4*>(qs + r * kPitch + 4 * tx + 64 * jj);
#pragma unroll
          for (int i = 0; i < kJ; ++i) {
            dv_acc[i][4 * jj + 0] = fmaf(p[i], da.x, dv_acc[i][4 * jj + 0]);
            dv_acc[i][4 * jj + 1] = fmaf(p[i], da.y, dv_acc[i][4 * jj + 1]);
            dv_acc[i][4 * jj + 2] = fmaf(p[i], da.z, dv_acc[i][4 * jj + 2]);
            dv_acc[i][4 * jj + 3] = fmaf(p[i], da.w, dv_acc[i][4 * jj + 3]);
            dk_acc[i][4 * jj + 0] = fmaf(ds[i], qa.x, dk_acc[i][4 * jj + 0]);
            dk_acc[i][4 * jj + 1] = fmaf(ds[i], qa.y, dk_acc[i][4 * jj + 1]);
            dk_acc[i][4 * jj + 2] = fmaf(ds[i], qa.z, dk_acc[i][4 * jj + 2]);
            dk_acc[i][4 * jj + 3] = fmaf(ds[i], qa.w, dk_acc[i][4 * jj + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kJ; ++i) {
    const int64_t r = k0 + ty + 16 * i;
    if (r >= mask.skv) continue;
    T* krow = dk + kv_base + r * kv_stride;
    T* vrow = dv + kv_base + r * kv_stride;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int col = 4 * tx + 64 * jj;
      if (col < d) {
        store4(krow + col, dk_acc[i][4 * jj], dk_acc[i][4 * jj + 1], dk_acc[i][4 * jj + 2],
               dk_acc[i][4 * jj + 3]);
        store4(vrow + col, dv_acc[i][4 * jj], dv_acc[i][4 * jj + 1], dv_acc[i][4 * jj + 2],
               dv_acc[i][4 * jj + 3]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;  // the attribute is per function, set once
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  configured = err == cudaSuccess;
  return err;
}

template <typename T, int DP>
int launch_bwd_dp(const T* q, const T* k, const T* v, const T* o, const float* lse,
                  const T* dout, T* dq, T* dk, T* dv, float* delta, int64_t b, int64_t sq,
                  int64_t skv, int64_t h, int64_t kv, int64_t d, Mask mask, float scale,
                  cudaStream_t stream) {
  constexpr int BK = bwd_bk<DP>();
  static bool dq_ready = false, dkv_ready = false;
  cudaError_t err =
      allow_smem(flash_attention_bwd_dq_kernel<T, DP>, bwd_dq_smem<DP>(), dq_ready);
  if (err == cudaSuccess)
    err = allow_smem(flash_attention_bwd_dkv_kernel<T, DP>, bwd_dkv_smem<DP>(), dkv_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  // dQ (and delta) first: the dK / dV kernel reads delta
  const dim3 dq_grid(static_cast<unsigned>(b * h),
                     static_cast<unsigned>((sq + kBwdBQ - 1) / kBwdBQ));
  flash_attention_bwd_dq_kernel<T, DP><<<dq_grid, kThreads, bwd_dq_smem<DP>(), stream>>>(
      q, k, v, o, lse, dout, dq, delta, sq, static_cast<int>(h), static_cast<int>(kv),
      static_cast<int>(d), mask, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dkv_grid(static_cast<unsigned>(b * kv), static_cast<unsigned>((skv + BK - 1) / BK));
  flash_attention_bwd_dkv_kernel<T, DP><<<dkv_grid, kThreads, bwd_dkv_smem<DP>(), stream>>>(
      q, k, v, lse, dout, delta, dk, dv, sq, static_cast<int>(h), static_cast<int>(kv),
      static_cast<int>(d), mask, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const T* q, const T* k, const T* v, const T* o, const float* lse, const T* dout,
               T* dq, T* dk, T* dv, float* delta, int64_t b, int64_t sq, int64_t skv, int64_t h,
               int64_t kv, int64_t d, int64_t causal, int64_t window, int64_t q_offset,
               float scale, cudaStream_t stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  const Mask mask{skv, window, q_offset, static_cast<int>(causal)};
  if (d <= 64)
    return launch_bwd_dp<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, skv, h, kv, d,
                                mask, scale, stream);
  if (d <= 128)
    return launch_bwd_dp<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, skv, h, kv,
                                 d, mask, scale, stream);
  return launch_bwd_dp<T, 256>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, skv, h, kv, d,
                               mask, scale, stream);
}

}  // namespace

// ---------------- the backward, bf16: wgmma on the tensor cores, TMA copies ----------------
//
// The forward's building blocks (tensor_map's 64-column boxes with the
// 128-byte swizzle, zeros past the edges; the mbarrier ring that thread 0
// fills with TMA; sw128_desc; wgmma_ss / wgmma_rs) in two kernels:
//
// dQ, flash_attention_bwd_dq_kernel_wgmma: work items (b, h, 128 query
// rows), warpgroups 0 and 1 each own 64 rows.  The item's Q and dO arrive
// once (two slots: the next item's load early; one at D_pad = 256), its K
// and V tiles (64 keys; 32 at 256) stream through a ring that runs on from
// item to item (3 stages; 4 at 64).  delta is summed while the first tile's
// products run (dO from the swizzled slot, O from memory, every load asked
// for before the first is used) and written for dK / dV.  Per key tile:
// S = Q . K^T and dP = dO . V^T from shared memory (both K-major), P =
// exp2(S scale log2e - lse log2e), dS = P (dP - delta), rounded to bf16 in
// registers (the accumulator's layout is the A fragment's, as the forward's
// P), dQ += dS . K with K the MN-major B operand.
//
// dK / dV, flash_attention_bwd_dkv_kernel_wgmma: work items (b, KV head, 128
// keys), warpgroups 0 and 1 each own 64 keys; the item's K and V arrive once
// and stay (one slot; two at 64), Q and dO tiles of 64 rows (32 at 256) of
// the G query heads stream through a ring (4 stages; 3 at 256), with their
// rows' lse log2e and delta passed through shared memory.  Per query tile, transposed: S^T
// = K . Q^T and dP^T = V . dO^T from shared memory (both K-major, as they
// lie), P^T and dS^T as above (a row with no valid key: P = 1 / Skv, dS =
// 0), rounded to bf16 in registers, dV += P^T . dO and dK += dS^T . Q with dO
// and Q the MN-major B operand.  dK takes the scale in the epilogue.  At
// D_pad = 256 dK and dV (128 fp32 registers each a thread) do not fit
// together, nor one of them beside the rest (ptxas spilled): the item walks
// its query tiles four times, dV's columns [0, 128) and [128, 256) (S^T
// only), then dK's, each pass with one 64-register accumulator.
//
// Both: one persistent CTA an SM, two warpgroups of 255 registers (the
// forward's reason: no third warpgroup that loads), thread 0 loads; the
// items heaviest first (class Heaviest), the consumers told each slot's item
// by thread 0.  A key or query tile whose pairs are all masked is never
// walked; an edge tile (ragged, diagonal, window, a row with no valid key)
// masks per element from per-row bounds in tile columns, an interior tile
// runs a loop without masks.  Each warpgroup runs a tile's products, its
// elementwise work and its second products in turn; the two warpgroups
// overlap each other, not their own phases (a second tile's scores in
// flight would need registers the accumulators hold).  Rounding: bf16
// operands, fp32 sums, P^T / dS^T / dS rounded to bf16 before their
// products, as the forward rounds P.
namespace {

__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// 8 bf16 products of two 16-byte chunks, summed in fp32 onto acc
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// Tiles 0..n-1 by their walk's length, heaviest first.  A length (the key
// tiles a query tile reaches, or the query tiles a key tile reaches) counts
// an interval that slides across a fixed one: it rises, stays, then falls.
// So heaviest first is the merge of the two sides of the first heaviest
// tile: from it on, the heavier of the nearest tiles not yet taken on either
// side, the left one on a tie.  seek(r) moves on to rank r; ranks only grow,
// so a walker passes over the tiles once for all its items.
struct Heaviest {
  int n, at, left, right, rank;
  template <typename W>
  __device__ void start(int n_tiles, W weight) {
    n = n_tiles;
    at = 0;
    rank = 0;
    int best = weight(0);
    for (int t = 1; t < n; ++t) {
      const int x = weight(t);
      if (x > best) {
        best = x;
        at = t;
      }
    }
    left = at - 1;
    right = at + 1;
  }
  template <typename W>
  __device__ int seek(int r, W weight) {
    for (; rank < r; ++rank)
      at = left >= 0 && (right >= n || weight(left) >= weight(right)) ? left-- : right++;
    return at;
  }
};

// The first query row with no valid key (sq if none): from qpos = skv +
// window - 1 on; every row under a causal window of 0.
__device__ __forceinline__ int64_t first_empty_row(const Mask& mk, int64_t sq) {
  if (mk.window < 0) return sq;
  return min64(mk.causal && mk.window == 0 ? 0 : max64(mk.skv + mk.window - 1 - mk.q_offset, 0),
               sq);
}

// x - origin as a tile-local column, clamped to [-1, n]
__device__ __forceinline__ int local(int64_t x, int64_t origin, int n) {
  return static_cast<int>(max64(-1, min64(x - origin, n)));
}

// The key tiles [kt0, kt0 + n) of BK keys that query rows [q0, q0 + rows)
// reach: lo and hi grow with the position, so the first row's lo and the
// last row's hi bound them (n = 0 when every row has no valid key).
template <int BK>
__device__ __forceinline__ int key_span(const Mask& mk, int64_t sq, int64_t q0, int rows,
                                        int64_t& kt0) {
  const int64_t lo = mk.lo(q0 + mk.q_offset), hi = mk.hi(min64(q0 + rows, sq) - 1 + mk.q_offset);
  kt0 = lo / BK;
  return hi >= lo ? static_cast<int>(hi / BK + 1 - kt0) : 0;
}

// The query tiles of BQ rows that keys [k0, k0 + 128) reach: [f, f + n1),
// whose rows may hold a valid pair with them, then [qe, n_qt), the tiles
// from the first row with no valid key on (it reaches every key: its output
// was the mean of V).  m tiles in all, for each query head.
struct QuerySpan {
  int f, n1, qe, m;
};

template <int BQ>
__device__ __forceinline__ QuerySpan query_span(const Mask& mk, int64_t sq, int64_t k0) {
  const int n_qt = static_cast<int>((sq + BQ - 1) / BQ);
  const int64_t k1 = min64(k0 + 128, mk.skv) - 1;
  // rows whose position can reach [k0, k1]: qpos >= k0 (causal), qpos <=
  // k1 + window - 1 (window)
  const int64_t r_lo = max64(mk.causal ? k0 - mk.q_offset : 0, 0);
  const int64_t r_hi = min64(mk.window >= 0 ? k1 + mk.window - 1 - mk.q_offset : sq - 1, sq - 1);
  const int64_t r_e = first_empty_row(mk, sq);
  const int qe = r_e >= sq ? n_qt : static_cast<int>(r_e / BQ);
  int a0 = 0, a1 = 0;
  if (r_lo <= r_hi) {
    a0 = static_cast<int>(r_lo / BQ);
    a1 = static_cast<int>(r_hi / BQ) + 1;
  }
  QuerySpan s;
  s.f = min(a0, qe);
  s.n1 = max(0, min(a1, qe) - s.f);
  s.qe = qe;
  s.m = s.n1 + n_qt - qe;
  return s;
}

// The query tiles of a dK / dV item in the order its passes walk them:
// each pass the G heads, each head its m query tiles [f, f + n1), [qe,
// n_qt) (QuerySpan); next() gives the tile's query head and first row.
template <int BQ>
struct QueryCursor {
  int hl, qi;
  template <typename Item>
  __device__ void next(const Item& it, int groups, int& head, int64_t& q0) {
    head = it.kvh * groups + hl;
    q0 = static_cast<int64_t>(qi < it.s.n1 ? it.s.f + qi : it.s.qe + qi - it.s.n1) * BQ;
    if (++qi == it.s.m) {
      qi = 0;
      if (++hl == groups) hl = 0;
    }
  }
};

template <int DP>
struct BwdQTile {
  static constexpr int kBQ = 128;                    // query rows an item: two warpgroups of 64
  static constexpr int kBK = DP == 256 ? 32 : 64;    // keys a tile
  static constexpr int kStages = DP == 64 ? 4 : 3;   // the K / V ring: loads kStages - 2 ahead
  static constexpr int kSlots = DP == 256 ? 1 : 2;   // Q and dO: the next item's load early
  static constexpr int kPanels = DP / 64;
  static constexpr uint32_t kQBytes = kBQ * DP * 2;   // Q or dO
  static constexpr uint32_t kKVBytes = kBK * DP * 2;  // K or V
  static constexpr uint32_t kRing = kSlots * 2 * kQBytes;             // slot s: Q, then dO
  static constexpr uint32_t kBars = kRing + kStages * 2 * kKVBytes;   // stage s: K, then V
  static constexpr uint32_t kProducer = kBars + 16 * 8;               // thread 0's walk
  static constexpr size_t kSmem = kProducer + 256 + 1024;             // slack to align
};

template <int DP>
struct BwdKVTile {
  static constexpr int kBK = 128;                    // keys an item: two warpgroups of 64
  static constexpr int kBQ = DP == 256 ? 32 : 64;    // query rows a tile
  // dK and dV a pass accumulates: at 256 (registers) four passes, dV's
  // columns [0, 128) and [128, 256), then dK's
  static constexpr int kPasses = DP == 256 ? 4 : 1;
  static constexpr int kN = DP == 256 ? 128 : DP;   // columns a pass accumulates
  static constexpr int kStages = DP == 256 ? 3 : 4;  // the Q / dO ring: loads kStages - 2 ahead
  static constexpr int kSlots = DP == 64 ? 2 : 1;    // K and V: the next item's load early
  static constexpr int kPanels = DP / 64;
  static constexpr uint32_t kKVBytes = kBK * DP * 2;  // K or V
  static constexpr uint32_t kQBytes = kBQ * DP * 2;   // Q or dO
  static constexpr uint32_t kRing = kSlots * 2 * kKVBytes;            // slot s: K, then V
  static constexpr uint32_t kRows = kRing + kStages * 2 * kQBytes;    // stage s: Q, then dO
  // per warpgroup and tile parity: the tile's rows' lse log2e, then delta
  static constexpr uint32_t kBars = kRows + 2 * 2 * 2 * kBQ * 4;
  static constexpr uint32_t kProducer = kBars + 16 * 8;
  static constexpr size_t kSmem = kProducer + 256 + 1024;
};

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// mbarriers at `bars`: slot full and free (kSlots each), stage full and
// free (kStages each); full ones complete on thread 0's expect_tx and the
// copies, free ones on every thread's arrival.
template <int kSlots, int kStages>
struct Bars {
  static constexpr int kCount = 2 * (kSlots + kStages);
  static_assert(kCount <= 16, "the mbarriers' room");
  uint32_t bars;
  __device__ uint32_t slot_full(int j) const { return bars + 8u * (j % kSlots); }
  __device__ uint32_t slot_free(int j) const { return bars + 8u * (kSlots + j % kSlots); }
  __device__ uint32_t stage_full(int g) const { return bars + 8u * (2 * kSlots + g % kStages); }
  __device__ uint32_t stage_free(int g) const {
    return bars + 8u * (2 * kSlots + kStages + g % kStages);
  }
  __device__ void init() const {
    for (int j = 0; j < kSlots; ++j) {
      mbar_init(slot_full(j), 1);
      mbar_init(slot_free(j), kWgThreads);
    }
    for (int g = 0; g < kStages; ++g) {
      mbar_init(stage_full(g), 1);
      mbar_init(stage_free(g), kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// dQ and delta.  Thread 0 loads: an item's Q and dO into its slot once
// every thread has released the item kSlots back (thread 0 asks right after
// its own release, so it never waits for itself), and the K / V ring, tile
// g + kStages - 2 in its turn on tile g, into the stage of tile g - 2: the
// other warpgroup is done with it, so thread 0 does not wait for it to
// finish the tile just before.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tdo,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const __nv_bfloat16* __restrict__ o,
                                    const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
                                    float* __restrict__ delta, int64_t sq, int h, int kv, int d,
                                    Mask mask, float scale, int n_items) {
  using C = BwdQTile<DP>;
  constexpr int kBK = C::kBK, kBQ = C::kBQ, kSlots = C::kSlots, kStages = C::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Bars<kSlots, kStages> bar{base + C::kBars};

  const int n_qt = static_cast<int>((sq + kBQ - 1) / kBQ);
  const int n_bh = n_items / n_qt;
  const int n_mine = (n_items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  auto weight = [&](int qt) {
    int64_t kt0;
    return key_span<kBK>(mask, sq, static_cast<int64_t>(qt) * kBQ, kBQ, kt0);
  };
  struct Item {
    int b, hh, n;
    int64_t q0, kt0;
  };
  // item j of this CTA, its query tile qt; the walkers find qt
  auto item_at = [&](int j, int qt) {
    const int w = static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x);
    Item it;
    it.b = w % n_bh / h;
    it.hh = w % n_bh % h;
    it.q0 = static_cast<int64_t>(qt) * kBQ;
    it.n = key_span<kBK>(mask, sq, it.q0, kBQ, it.kt0);
    return it;
  };
  auto item = [&](int j, Heaviest& order) {
    const int w = static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x);
    return item_at(j, order.seek(w / n_bh, weight));
  };

  // thread 0's walk lives in shared memory, out of every thread's registers
  struct Producer {
    Heaviest slot_order, ring_order;
    int slot_tile[2];  // the query tile of the item in each slot, for every thread
    Item ri;
    int rj, rt;      // the ring's item, and its next tile
    int gl;          // tiles loaded so far
    int nb, nh, nk;  // the next tile's batch row, KV head, first key (nb < 0: none)
  };
  static_assert(sizeof(Producer) <= 256, "the producer's room");
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  Producer& pr = *reinterpret_cast<Producer*>(smem + C::kProducer);
  auto slot_load = [&](int jj) {
    if (jj >= n_mine) return;
    const Item it = item(jj, pr.slot_order);
    if (jj >= kSlots) mbar_wait(bar.slot_free(jj), (jj / kSlots - 1) & 1);
    pr.slot_tile[jj % kSlots] = static_cast<int>(it.q0 / kBQ);  // seen once the slot is full
    const uint32_t qs = base + (jj % kSlots) * 2 * C::kQBytes;
    mbar_expect_tx(bar.slot_full(jj), 2 * C::kQBytes);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load(qs + p * kBQ * 128, &tq, bar.slot_full(jj), 64 * p, it.hh,
               static_cast<int>(it.q0), it.b);
      tma_load(qs + C::kQBytes + p * kBQ * 128, &tdo, bar.slot_full(jj), 64 * p, it.hh,
               static_cast<int>(it.q0), it.b);
    }
  };
  // the ring's next tile: found ahead (ring_find), copied when its turn
  // comes (ring_issue), so the copy costs warpgroup 0 little
  auto ring_find = [&]() {
    while (pr.rj < n_mine && pr.rt == pr.ri.n) {  // items with no key tile load none
      pr.rt = 0;
      if (++pr.rj < n_mine) pr.ri = item(pr.rj, pr.ring_order);
    }
    pr.nb = pr.rj < n_mine ? pr.ri.b : -1;
    pr.nh = pr.ri.hh / (h / kv);
    pr.nk = static_cast<int>((pr.ri.kt0 + pr.rt++) * kBK);
  };
  auto ring_issue = [&]() {
    const int nb = pr.nb, nh = pr.nh, nk = pr.nk, gl = pr.gl;
    if (nb < 0) return;
    if (gl >= kStages) mbar_wait(bar.stage_free(gl), (gl / kStages - 1) & 1);
    const uint32_t ks = base + C::kRing + (gl % kStages) * 2 * C::kKVBytes;
    mbar_expect_tx(bar.stage_full(gl), 2 * C::kKVBytes);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load(ks + p * kBK * 128, &tk, bar.stage_full(gl), 64 * p, nh, nk, nb);
      tma_load(ks + C::kKVBytes + p * kBK * 128, &tv, bar.stage_full(gl), 64 * p, nh, nk, nb);
    }
    pr.gl = gl + 1;
  };

  if (threadIdx.x == 0) {
    bar.init();
    pr.slot_order.start(n_qt, weight);
    pr.ring_order.start(n_qt, weight);
    pr.ri = item(0, pr.ring_order);
    pr.rj = pr.rt = pr.gl = 0;
    for (int jj = 0; jj < kSlots; ++jj) slot_load(jj);
    ring_find();
    for (int i = 0; i < kStages - 1; ++i) {
      ring_issue();
      ring_find();
    }
  }
  __syncthreads();

  // this thread's rows of an item: row and row + 8; of every 8-column chunk
  // ch of a tile, columns 8 ch + cq and + 1
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int row = wg * 64 + (t / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl = scale * kLog2e;

  int g = 0;  // key tiles walked so far, over all items
  for (int j = 0; j < n_mine; ++j) {
    mbar_wait(bar.slot_full(j), (j / kSlots) & 1);
    const Item it = item_at(j, pr.slot_tile[j % kSlots]);
    const int64_t bh = static_cast<int64_t>(it.b) * h + it.hh;
    const uint32_t qs = base + (j % kSlots) * 2 * C::kQBytes;
    const uint64_t qa = sw128_desc(qs + wg * 64 * 128, 16);
    const uint64_t doa = sw128_desc(qs + C::kQBytes + wg * 64 * 128, 16);
    int64_t qr[2], klo[2], khi[2];  // this thread's rows, the keys [klo, khi] each attends
    float l2[2], dl[2] = {0.0f, 0.0f};  // lse log2e and delta of this thread's rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qr[r] = it.q0 + row + 8 * r;
      l2[r] = qr[r] < sq ? lse[bh * sq + qr[r]] * kLog2e : 0.0f;
      klo[r] = qr[r] < sq ? mask.lo(qr[r] + mask.q_offset) : 1;
      khi[r] = qr[r] < sq ? mask.hi(qr[r] + mask.q_offset) : 0;
    }
    float dqa[DP / 2];  // dQ's accumulator
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) dqa[e] = 0.0f;

    // delta = rowsum(dO * O): a row's quad splits its 16-byte chunks, O
    // from memory (every load asked for before the first is used), dO from
    // the slot (chunk c of row r sits at chunk c ^ (r % 8) of the row's 128
    // bytes: the swizzle)
    auto row_delta = [&]() {
      constexpr int kChunks = DP / 32;           // a thread's chunks of a row
      constexpr int kBatch = DP == 256 ? 1 : 2;  // rows loaded at once (registers)
#pragma unroll
      for (int r0 = 0; r0 < 2; r0 += kBatch) {
        uint4 ov[kBatch][kChunks];
#pragma unroll
        for (int r = r0; r < r0 + kBatch; ++r) {
          const __nv_bfloat16* orow =
              o + ((it.b * sq + min64(qr[r], sq - 1)) * h + it.hh) * static_cast<int64_t>(d);
#pragma unroll
          for (int i = 0; i < kChunks; ++i) {
            const int c = lane % 4 + 4 * i;
            ov[r - r0][i] = qr[r] < sq && 8 * c < d
                                ? *reinterpret_cast<const uint4*>(orow + 8 * c)
                                : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int r = r0; r < r0 + kBatch; ++r) {
          const int rl = row + 8 * r;
          float sum = 0.0f;
#pragma unroll
          for (int i = 0; i < kChunks; ++i) {
            const int c = lane % 4 + 4 * i;
            sum = dot8(ov[r - r0][i],
                       lds128(qs + C::kQBytes + (c / 8) * kBQ * 128 + rl * 128 +
                              ((c % 8) ^ (rl % 8)) * 16),
                       sum);
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          dl[r] = sum;
          if (lane % 4 == 0 && qr[r] < sq) delta[bh * sq + qr[r]] = sum;
        }
      }
    };
    auto release_slot = [&]() {
      mbar_arrive(bar.slot_free(j));
      if (threadIdx.x == 0) slot_load(j + kSlots);
      if (wg == 0) wg_bar(1);
    };

    if (it.n == 0) {
      row_delta();
      release_slot();
    }
    const int64_t qlo = it.q0 + mask.q_offset, qhi = min64(it.q0 + kBQ, sq) - 1 + mask.q_offset;
    for (int i = 0; i < it.n; ++i, ++g) {
      const uint32_t ks = base + C::kRing + (g % kStages) * 2 * C::kKVBytes;
      const int64_t k0 = (it.kt0 + i) * kBK;
      // S = Q . K^T and dP = dO . V^T: DP / 64 panels of 4 k16 steps each
      float st[kBK / 2], dpt[kBK / 2];
      const uint64_t kb = sw128_desc(ks, 16), vb = sw128_desc(ks + C::kKVBytes, 16);
      mbar_wait(bar.stage_full(g), (g / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<kBK>(st, qa + (p * kBQ * 128 + kk * 32) / 16,
                        kb + (p * kBK * 128 + kk * 32) / 16, p | kk);
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<kBK>(dpt, doa + (p * kBQ * 128 + kk * 32) / 16,
                        vb + (p * kBK * 128 + kk * 32) / 16, p | kk);
      wgmma_commit();
      if (i == 0) row_delta();  // while the products run
      // the next tile; warpgroup 0 meets after thread 0 may have waited, so
      // no warp asks for a wgmma its warpgroup's other warps have not
      if (threadIdx.x == 0 && g >= 1) ring_issue();
      if (wg == 0) wg_bar(1);
      wgmma_wait();
      fence_regs(st);
      fence_regs(dpt);
      if (i == it.n - 1) release_slot();

      // dS = P (dP - delta), 0 where the pair does not attend; only an edge
      // tile masks
      const bool edge = k0 + kBK > mask.skv || it.q0 + kBQ > sq ||
                        (mask.causal && k0 + kBK - 1 > qlo) ||
                        (mask.window >= 0 && k0 <= qhi - mask.window);
      const int lo[2] = {local(klo[0], k0, kBK), local(klo[1], k0, kBK)};
      const int hi[2] = {local(khi[0], k0, kBK), local(khi[1], k0, kBK)};
      uint32_t dsa[kBK / 16][4];  // dS in bf16, the A fragments (pack_p's layout)
      auto grads = [&](auto masked) {
#pragma unroll
        for (int ch = 0; ch < kBK / 8; ++ch) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2, c = 8 * ch + cq + e % 2;
            ds[e] = exp2_ftz(fmaf(st[4 * ch + e], sl, -l2[r])) * (dpt[4 * ch + e] - dl[r]);
            if (decltype(masked)::value && (c < lo[r] || c > hi[r])) ds[e] = 0.0f;
          }
#pragma unroll
          for (int r = 0; r < 2; ++r)
            dsa[ch / 2][2 * (ch % 2) + r] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
        }
      };
      if (edge) grads(Flag<true>{});
      else grads(Flag<false>{});

      // dQ += dS . K: K (keys x D) the MN-major B operand, 16 keys a step
      const uint64_t kmn = sw128_desc(ks, kBK * 128);
      wgmma_fence();
#pragma unroll
      for (int ks16 = 0; ks16 < kBK / 16; ++ks16)
        wgmma_rs<DP>(dqa, dsa[ks16], kmn + ks16 * 2048 / 16);
      wgmma_commit();
      if (threadIdx.x == 0 && g >= 1) ring_find();  // while the product runs
      wgmma_wait();
      fence_regs(dqa);
      mbar_arrive(bar.stage_free(g));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qr[r] >= sq) continue;
      __nv_bfloat16* out = dq + ((it.b * sq + qr[r]) * h + it.hh) * static_cast<int64_t>(d);
#pragma unroll
      for (int ch = 0; ch < DP / 8; ++ch) {
        const int col = 8 * ch + cq;
        if (col < d)  // a row with no key tile stores zeros
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(dqa[4 * ch + 2 * r] * scale, dqa[4 * ch + 2 * r + 1] * scale);
      }
    }
  }
}

// dK and dV.  Thread 0 loads: an item's K and V into its slot as the dQ
// kernel loads Q and dO, and the Q / dO ring as the dQ kernel its K / V
// ring.  Each thread of a warpgroup fetches one value of the tile's rows' lse
// and delta before the products and leaves it in shared memory; the
// warpgroup meets before reading them.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_bwd_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                                     const __grid_constant__ CUtensorMap tdo,
                                     const __grid_constant__ CUtensorMap tk,
                                     const __grid_constant__ CUtensorMap tv,
                                     const float* __restrict__ lse,
                                     const float* __restrict__ delta,
                                     __nv_bfloat16* __restrict__ dk,
                                     __nv_bfloat16* __restrict__ dv, int64_t sq, int h, int kv,
                                     int d, Mask mask, float scale, int n_items) {
  using C = BwdKVTile<DP>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kSlots = C::kSlots, kStages = C::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  const Bars<kSlots, kStages> bar{base + C::kBars};

  const int groups = h / kv;
  const int n_kt = static_cast<int>((mask.skv + kBK - 1) / kBK);
  const int n_bk = n_items / n_kt;
  const int n_mine = (n_items - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  auto weight = [&](int kt) {
    return query_span<kBQ>(mask, sq, static_cast<int64_t>(kt) * kBK).m;
  };
  struct Item {
    int b, kvh, n;
    int64_t k0;
    QuerySpan s;
  };
  // item j of this CTA, its key tile kt; the walkers find kt
  auto item_at = [&](int j, int kt) {
    const int w = static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x);
    Item it;
    it.b = w % n_bk / kv;
    it.kvh = w % n_bk % kv;
    it.k0 = static_cast<int64_t>(kt) * kBK;
    it.s = query_span<kBQ>(mask, sq, it.k0);
    it.n = C::kPasses * groups * it.s.m;
    return it;
  };
  auto item = [&](int j, Heaviest& order) {
    const int w = static_cast<int>(blockIdx.x) + j * static_cast<int>(gridDim.x);
    return item_at(j, order.seek(w / n_bk, weight));
  };
  using Cursor = QueryCursor<kBQ>;

  struct Producer {
    Heaviest slot_order, ring_order;
    int slot_tile[2];  // the key tile of the item in each slot, for every thread
    Item ri;
    Cursor rc;
    int rj, rt;     // the ring's item, and its next tile
    int gl;         // tiles loaded so far
    int nb, nh;     // the next tile's batch row (nb < 0: none), query head, first row
    int64_t nq;
  };
  static_assert(sizeof(Producer) <= 256, "the producer's room");
  Producer& pr = *reinterpret_cast<Producer*>(smem + C::kProducer);
  auto slot_load = [&](int jj) {
    if (jj >= n_mine) return;
    const Item it = item(jj, pr.slot_order);
    if (jj >= kSlots) mbar_wait(bar.slot_free(jj), (jj / kSlots - 1) & 1);
    pr.slot_tile[jj % kSlots] = static_cast<int>(it.k0 / kBK);  // seen once the slot is full
    const uint32_t ks = base + (jj % kSlots) * 2 * C::kKVBytes;
    mbar_expect_tx(bar.slot_full(jj), 2 * C::kKVBytes);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load(ks + p * kBK * 128, &tk, bar.slot_full(jj), 64 * p, it.kvh,
               static_cast<int>(it.k0), it.b);
      tma_load(ks + C::kKVBytes + p * kBK * 128, &tv, bar.slot_full(jj), 64 * p, it.kvh,
               static_cast<int>(it.k0), it.b);
    }
  };
  // the ring's next tile: found ahead (ring_find), copied when its turn
  // comes (ring_issue), so the copy costs warpgroup 0 little
  auto ring_find = [&]() {
    while (pr.rj < n_mine && pr.rt == pr.ri.n) {  // items no query tile reaches load none
      pr.rt = 0;
      pr.rc = Cursor{0, 0};
      if (++pr.rj < n_mine) pr.ri = item(pr.rj, pr.ring_order);
    }
    pr.nb = pr.rj < n_mine ? pr.ri.b : -1;
    if (pr.nb < 0) return;
    int head;
    int64_t q0;
    pr.rc.next(pr.ri, groups, head, q0);
    pr.nh = head;
    pr.nq = q0;
    ++pr.rt;
  };
  auto ring_issue = [&]() {
    const int nb = pr.nb, nh = pr.nh, gl = pr.gl, nq = static_cast<int>(pr.nq);
    if (nb < 0) return;
    if (gl >= kStages) mbar_wait(bar.stage_free(gl), (gl / kStages - 1) & 1);
    const uint32_t qs = base + C::kRing + (gl % kStages) * 2 * C::kQBytes;
    mbar_expect_tx(bar.stage_full(gl), 2 * C::kQBytes);
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) {
      tma_load(qs + p * kBQ * 128, &tq, bar.stage_full(gl), 64 * p, nh, nq, nb);
      tma_load(qs + C::kQBytes + p * kBQ * 128, &tdo, bar.stage_full(gl), 64 * p, nh, nq, nb);
    }
    pr.gl = gl + 1;
  };

  if (threadIdx.x == 0) {
    bar.init();
    pr.slot_order.start(n_kt, weight);
    pr.ring_order.start(n_kt, weight);
    pr.ri = item(0, pr.ring_order);
    pr.rc = Cursor{0, 0};
    pr.rj = pr.rt = pr.gl = 0;
    for (int jj = 0; jj < kSlots; ++jj) slot_load(jj);
    ring_find();
    for (int i = 0; i < kStages - 1; ++i) {
      ring_issue();
      ring_find();
    }
  }
  __syncthreads();

  // this thread's keys of an item: row and row + 8; of every 8-column chunk
  // ch of a query tile, columns (query rows) 8 ch + cq and + 1
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int row = wg * 64 + (t / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl = scale * kLog2e, uniform = 1.0f / static_cast<float>(mask.skv);
  const int64_t empty_from = first_empty_row(mask, sq);

  int g = 0;  // query tiles walked so far, over all items
  for (int j = 0; j < n_mine; ++j) {
    mbar_wait(bar.slot_full(j), (j / kSlots) & 1);
    const Item it = item_at(j, pr.slot_tile[j % kSlots]);
    const uint32_t ks = base + (j % kSlots) * 2 * C::kKVBytes;
    const uint64_t ka = sw128_desc(ks + wg * 64 * 128, 16);
    const uint64_t va = sw128_desc(ks + C::kKVBytes + wg * 64 * 128, 16);
    auto release_slot = [&]() {
      mbar_arrive(bar.slot_free(j));
      if (threadIdx.x == 0) slot_load(j + kSlots);
      if (wg == 0) wg_bar(1);
    };
    if (it.n == 0) release_slot();

    Cursor cur{0, 0};

    // dV and dK: two accumulators, or at D_pad = 256 one for each pass
    constexpr int kN = C::kN;
    float accs[C::kPasses == 1 ? 2 : 1][kN / 2];
    float(&dva)[kN / 2] = accs[0];
    float(&dka)[kN / 2] = accs[C::kPasses == 1 ? 1 : 0];
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) dva[e] = dka[e] = 0.0f;

    // query tile i
    auto walk = [&](int i) {
      const int pass = C::kPasses == 1 ? 0 : i / (it.n / C::kPasses);
      const bool with_dv = C::kPasses == 1 || pass < 2;
      const bool with_dk = C::kPasses == 1 || pass >= 2;
      const uint32_t col0 = (pass % 2) * kN / 64 * kBQ * 128;  // the pass's first B panel
      int head;
      int64_t q0;
      cur.next(it, groups, head, q0);
      const int64_t bh = static_cast<int64_t>(it.b) * h + head;
      float rv = 0.0f;  // this thread's value of the tile's lse log2e | delta
      if (t < 2 * kBQ && q0 + t % kBQ < sq)
        rv = t < kBQ ? lse[bh * sq + q0 + t] * kLog2e : delta[bh * sq + q0 + t - kBQ];
      const uint32_t qs = base + C::kRing + (g % kStages) * 2 * C::kQBytes;

      // S^T = K . Q^T and dP^T = V . dO^T: DP / 64 panels of 4 k16 steps
      float sct[kBQ / 2], dpt[kBQ / 2];
      const uint64_t qb = sw128_desc(qs, 16), dob = sw128_desc(qs + C::kQBytes, 16);
      mbar_wait(bar.stage_full(g), (g / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<kBQ>(sct, ka + (p * kBK * 128 + kk * 32) / 16,
                        qb + (p * kBQ * 128 + kk * 32) / 16, p | kk);
      if (with_dk) {
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<kBQ>(dpt, va + (p * kBK * 128 + kk * 32) / 16,
                          dob + (p * kBQ * 128 + kk * 32) / 16, p | kk);
      }
      wgmma_commit();
      float* rows = reinterpret_cast<float*>(smem + C::kRows) + (wg * 2 + g % 2) * 2 * kBQ;
      if (t < 2 * kBQ) rows[t] = rv;
      if (threadIdx.x == 0 && g >= 1) ring_issue();
      wg_bar(2 + wg);  // the rows' values in place; warpgroup 0 also meets thread 0
      wgmma_wait();
      fence_regs(sct);
      if (with_dk) fence_regs(dpt);
      if (i == it.n - 1) release_slot();  // K and V are read by the products above only

      // P^T and dS^T, rounded to bf16 as the A fragments of the k16 steps
      // (as pack_p lays them out) chunk by chunk; only an edge tile masks
      const bool edge = it.k0 + kBK > mask.skv || q0 + kBQ > sq ||
                        (mask.causal && it.k0 + kBK - 1 > q0 + mask.q_offset) ||
                        (mask.window >= 0 && it.k0 <= q0 + kBQ - 1 + mask.q_offset - mask.window);
      // per key row, in tile columns: the valid query rows [lo, hi]; rows
      // [ue, end] have no valid key and take the mean (keys < Skv only)
      const int64_t origin = q0 + mask.q_offset;
      const int end = local(sq - 1, q0, kBQ);
      int lo[2], hi[2], ue[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t key = it.k0 + row + 8 * r;
        const bool in = key < mask.skv;
        lo[r] = in ? (mask.causal ? local(key, origin, kBQ) : 0) : kBQ;
        hi[r] = min(end, mask.window >= 0 ? local(key + mask.window - 1, origin, kBQ) : kBQ);
        ue[r] = in ? local(empty_from, q0, kBQ) : kBQ;
      }
      uint32_t pa[kBQ / 16][4], sa[kBQ / 16][4];
      auto probs = [&](auto masked) {
#pragma unroll
        for (int ch = 0; ch < kBQ / 8; ++ch) {
          const float2 lr = *reinterpret_cast<const float2*>(rows + 8 * ch + cq);
          const float2 dr = *reinterpret_cast<const float2*>(rows + kBQ + 8 * ch + cq);
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            p[e] = exp2_ftz(fmaf(sct[4 * ch + e], sl, -(e % 2 ? lr.y : lr.x)));
            ds[e] = 0.0f;
            if (with_dk) ds[e] = p[e] * (dpt[4 * ch + e] - (e % 2 ? dr.y : dr.x));
            const int r = e / 2, c = 8 * ch + cq + e % 2;
            if (decltype(masked)::value && (c < lo[r] || c > hi[r])) {
              p[e] = c >= ue[r] && c <= end ? uniform : 0.0f;
              ds[e] = 0.0f;
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            pa[ch / 2][2 * (ch % 2) + r] = pack_bf16(p[2 * r], p[2 * r + 1]);
            sa[ch / 2][2 * (ch % 2) + r] = pack_bf16(ds[2 * r], ds[2 * r + 1]);
          }
        }
      };
      if (edge) probs(Flag<true>{});
      else probs(Flag<false>{});

      // dV += P^T . dO, dK += dS^T . Q: dO and Q (query rows x D) the
      // MN-major B operand, 16 rows a step
      const uint64_t qmn = sw128_desc(qs, kBQ * 128), domn = sw128_desc(qs + C::kQBytes, kBQ * 128);
      wgmma_fence();
      if (with_dv) {
#pragma unroll
        for (int jj = 0; jj < kBQ / 16; ++jj)
          wgmma_rs<kN>(dva, pa[jj], domn + (col0 + jj * 2048) / 16);
      }
      if (with_dk) {
#pragma unroll
        for (int jj = 0; jj < kBQ / 16; ++jj)
          wgmma_rs<kN>(dka, sa[jj], qmn + (col0 + jj * 2048) / 16);
      }
      wgmma_commit();
      if (threadIdx.x == 0 && g >= 1) ring_find();  // while the products run
      wgmma_wait();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(bar.stage_free(g));
      ++g;
    };

    // this thread's rows of dK or dV, columns [c0, c0 + kN), times mul
    auto store = [&](__nv_bfloat16* out, const float (&a)[kN / 2], float mul, int c0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t key = it.k0 + row + 8 * r;
        if (key >= mask.skv) continue;
        __nv_bfloat16* dst =
            out + ((it.b * mask.skv + key) * kv + it.kvh) * static_cast<int64_t>(d);
#pragma unroll
        for (int ch = 0; ch < kN / 8; ++ch) {
          const int col = c0 + 8 * ch + cq;
          if (col < d)
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(a[4 * ch + 2 * r] * mul, a[4 * ch + 2 * r + 1] * mul);
        }
      }
    };

    if constexpr (C::kPasses == 1) {
      for (int i = 0; i < it.n; ++i) walk(i);
      store(dv, dva, 1.0f, 0);
      store(dk, dka, scale, 0);
    } else {
      const int per = it.n / C::kPasses;
      for (int pass = 0; pass < C::kPasses; ++pass) {
        for (int i = pass * per; i < (pass + 1) * per; ++i) walk(i);
        store(pass < 2 ? dv : dk, dva, pass < 2 ? 1.0f : scale, (pass % 2) * kN);
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) dva[e] = 0.0f;
      }
    }
  }
}

template <int DP>
int launch_bwd_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                     const __nv_bfloat16* o, const float* lse, const __nv_bfloat16* dout,
                     __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta,
                     int64_t b, int64_t sq, int64_t skv, int64_t h, int64_t kv, int64_t d,
                     Mask mask, float scale, int parts, cudaStream_t stream) {
  using CQ = BwdQTile<DP>;
  using CKV = BwdKVTile<DP>;
  static bool dq_ready = false, dkv_ready = false;
  cudaError_t err = allow_smem(flash_attention_bwd_dq_kernel_wgmma<DP>, CQ::kSmem, dq_ready);
  if (err == cudaSuccess)
    err = allow_smem(flash_attention_bwd_dkv_kernel_wgmma<DP>, CKV::kSmem, dkv_ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int n_sms = 0;  // one persistent CTA an SM
  if (n_sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t n_dq = (sq + CQ::kBQ - 1) / CQ::kBQ * b * h;
  const int64_t n_dkv = (skv + CKV::kBK - 1) / CKV::kBK * b * kv;
  if (n_dq > INT32_MAX || n_dkv > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tdo, tk, tv;
  if (parts & 1) {  // dQ (and delta) first: the dK / dV kernel reads delta
    int rc = tensor_map(&tq, q, b, sq, h, d, CQ::kBQ);
    if (rc == 0) rc = tensor_map(&tdo, dout, b, sq, h, d, CQ::kBQ);
    if (rc == 0) rc = tensor_map(&tk, k, b, skv, kv, d, CQ::kBK);
    if (rc == 0) rc = tensor_map(&tv, v, b, skv, kv, d, CQ::kBK);
    if (rc != 0) return rc;
    flash_attention_bwd_dq_kernel_wgmma<DP>
        <<<static_cast<unsigned>(n_dq < n_sms ? n_dq : n_sms), kWgThreads, CQ::kSmem, stream>>>(
            tq, tdo, tk, tv, o, lse, dq, delta, sq, static_cast<int>(h), static_cast<int>(kv),
            static_cast<int>(d), mask, scale, static_cast<int>(n_dq));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 2) {
    int rc = tensor_map(&tq, q, b, sq, h, d, CKV::kBQ);
    if (rc == 0) rc = tensor_map(&tdo, dout, b, sq, h, d, CKV::kBQ);
    if (rc == 0) rc = tensor_map(&tk, k, b, skv, kv, d, CKV::kBK);
    if (rc == 0) rc = tensor_map(&tv, v, b, skv, kv, d, CKV::kBK);
    if (rc != 0) return rc;
    flash_attention_bwd_dkv_kernel_wgmma<DP>
        <<<static_cast<unsigned>(n_dkv < n_sms ? n_dkv : n_sms), kWgThreads, CKV::kSmem,
           stream>>>(tq, tdo, tk, tv, lse, delta, dk, dv, sq, static_cast<int>(h),
                     static_cast<int>(kv), static_cast<int>(d), mask, scale,
                     static_cast<int>(n_dkv));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (b, sq, h, d), k, v: (b, skv, kv, d), o: (b, sq, h, d), all contiguous
// and 16-byte aligned; h % kv == 0, d % 8 == 0, 8 <= d <= 256, skv >= 1;
// window < 0 means no window; scale = d ** -0.5 as an fp32 value.  lse:
// null (serving), or (b, h, sq) fp32, written with each row's log-sum-exp
// of its scaled, masked scores (the backward's input).
extern "C" int repro_flash_attention_f32(const float* q, const float* k, const float* v,
                                         float* o, float* lse, int64_t b, int64_t sq,
                                         int64_t skv, int64_t h, int64_t kv, int64_t d,
                                         int64_t causal, int64_t window, int64_t q_offset,
                                         float scale, cudaStream_t stream) {
  return launch<float>(q, k, v, o, lse, b, sq, skv, h, kv, d, causal, window, q_offset, scale,
                       stream);
}

extern "C" int repro_flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                          const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                                          int64_t b, int64_t sq, int64_t skv, int64_t h,
                                          int64_t kv, int64_t d, int64_t causal,
                                          int64_t window, int64_t q_offset, float scale,
                                          cudaStream_t stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  if (d <= 64)
    return launch_wgmma<64>(q, k, v, o, lse, b, sq, skv, h, kv, d, causal, window, q_offset,
                            scale, stream);
  if (d <= 128)
    return launch_wgmma<128>(q, k, v, o, lse, b, sq, skv, h, kv, d, causal, window, q_offset,
                             scale, stream);
  return launch_wgmma<256>(q, k, v, o, lse, b, sq, skv, h, kv, d, causal, window, q_offset,
                           scale, stream);
}

// The backward: the forward's arguments, its output o and lse, the
// output's gradient dout (b, sq, h, d) -> dq, dk, dv in the inputs' dtype;
// delta: (b, h, sq) fp32 scratch.  Two launches on `stream`: dQ (with
// delta), then dK and dV.
extern "C" int repro_flash_attention_bwd_f32(const float* q, const float* k, const float* v,
                                             const float* o, const float* lse,
                                             const float* dout, float* dq, float* dk,
                                             float* dv, float* delta, int64_t b, int64_t sq,
                                             int64_t skv, int64_t h, int64_t kv, int64_t d,
                                             int64_t causal, int64_t window, int64_t q_offset,
                                             float scale, cudaStream_t stream) {
  return launch_bwd<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, skv, h, kv, d,
                           causal, window, q_offset, scale, stream);
}

// The bf16 backward's kernels by `parts`: 1 the dQ kernel (and delta), 2
// the dK / dV kernel (reading delta), 3 both.  repro_flash_attention_bwd_bf16
// runs both; chip_smoke.py times each part alone.
extern "C" int repro_flash_attention_bwd_bf16_parts(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const float* lse, const __nv_bfloat16* dout, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta, int64_t b, int64_t sq, int64_t skv,
    int64_t h, int64_t kv, int64_t d, int64_t causal, int64_t window, int64_t q_offset,
    float scale, int64_t parts, cudaStream_t stream) {
  if (b == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  const Mask mask{skv, window, q_offset, static_cast<int>(causal)};
  const int which = static_cast<int>(parts);
  if (d <= 64)
    return launch_bwd_wgmma<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, skv, h, kv, d,
                                mask, scale, which, stream);
  if (d <= 128)
    return launch_bwd_wgmma<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, skv, h, kv, d,
                                 mask, scale, which, stream);
  return launch_bwd_wgmma<256>(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq, skv, h, kv, d,
                               mask, scale, which, stream);
}

extern "C" int repro_flash_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const float* lse, const __nv_bfloat16* dout, __nv_bfloat16* dq,
    __nv_bfloat16* dk, __nv_bfloat16* dv, float* delta, int64_t b, int64_t sq, int64_t skv,
    int64_t h, int64_t kv, int64_t d, int64_t causal, int64_t window, int64_t q_offset,
    float scale, cudaStream_t stream) {
  return repro_flash_attention_bwd_bf16_parts(q, k, v, o, lse, dout, dq, dk, dv, delta, b, sq,
                                              skv, h, kv, d, causal, window, q_offset, scale, 3,
                                              stream);
}
