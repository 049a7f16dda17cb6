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
// 10.2 us at 3.35 TB/s; the products are 4*H*D = 8 KFLOP a valid slot, ~2
// flops a byte, far below the tensor cores' ridge: they run in fp32 on the
// CUDA cores.
//
// Design: the cache is split across CTAs, and each CTA streams its tiles.
// - The grid is (B*KV, splits): the wrapper sizes splits so that the grid
//   is one wave of the card at two CTAs an SM, as many as the ~120
//   registers a thread let stay resident (a second wave waits for the first
//   to end).  A tile is kBK slots (64 where a K tile is at
//   most 16 KB).  Each CTA reads its batch row's whole mask and counts the
//   tiles with a valid slot; if there is one, the split takes its share of
//   THOSE tiles by rank (split * n / splits .. (split + 1) * n / splits), so
//   a tile with no valid slot is never read and every split gets the same
//   work whatever the mask; a row with no valid slot at all shares every
//   tile the same way, and is the uniform mean over all S slots.
// - K and V tiles stream through a kStages ring in shared memory by
//   cp.async (zero-filled past S and past D), kept in the cache dtype, with
//   rows padded by 16 bytes so that 16-byte reads down a column do not
//   conflict; the next tile's copy is in flight while this one is computed.
// - Scores: kQ = 256 / kBK threads a slot, each holding its share of the
//   slot's K (chunks j, j + kQ, ... of the row) in registers and using it
//   for every query head of the group (q scaled, fp32, in shared memory);
//   the kQ sums are combined by shuffles.  Slots past S score -inf, invalid
//   slots -1e30.  Softmax: a warp per query head keeps (m, l).  P.V: each
//   thread owns 8 output columns of up to 4 query heads over a stride of
//   the tile's slots, so each V element it reads serves those heads; the
//   strides sit in neighbouring lanes and are summed by shuffles at the end.
// - Each split writes its fp32 partial (m, l, acc[G][D]) to a workspace,
//   an empty one too (m = -1e30, l = 0, acc = 0: it adds nothing), so
//   nothing needs zeroing.  A second kernel of the same entry point
//   combines the splits in index order, out = sum_i w_i acc_i /
//   max(sum_i w_i l_i, 1e-30) with w_i = exp(m_i - max m), so two launches
//   give the same bits; it is launched with programmatic dependent launch,
//   its CTAs waiting (griddepcontrol.wait) for the split kernel to finish.
// expf and IEEE division, never fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kE = 8;              // P.V columns a thread owns
constexpr int kStages = 2;         // K/V tiles in the shared-memory ring
constexpr int kList = 64;          // tile indices a CTA gathers at a time
constexpr int kMaxGroupWidth = 4096;  // G * D_pad
constexpr float kNegInf = -1e30f;  // the JAX kernels' NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

__device__ __forceinline__ void unpack(const uint4& u, float* dst, float) {  // 4 fp32
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int DP>
struct Shape {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements a 16-byte chunk
  static constexpr int kPieces = kE / kVec;                       // chunks of 8 P.V columns
  static constexpr int kL = DP / kE;                              // 8-column groups a row
  static constexpr int kRowBytes = DP * static_cast<int>(sizeof(T));
  static constexpr int kBK = 16384 / kRowBytes < 64 ? 16384 / kRowBytes : 64;  // slots a tile
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kTileBytes = kBK * kPitch;
  static constexpr int kChunksPerRow = kRowBytes / 16;
  static constexpr int kCopies = kBK * kChunksPerRow / kThreads;  // a thread's 16-byte copies
  static constexpr int kQ = kThreads / kBK;                       // score threads a slot
  static constexpr int kRowsPerWarp = 32 / kQ;
  static constexpr int kNC = kChunksPerRow / kQ;                  // a score thread's K chunks
  static_assert(kBK * kChunksPerRow % kThreads == 0 && kChunksPerRow % kQ == 0,
                "a tile's copies and scores split evenly over the CTA");
  static_assert(kBK % 16 == 0 && kQ <= 32 && kL <= 32, "tile and lane-group shapes");

  // the row column of P.V element e (0..7) of column group ch: piece p =
  // e / kVec is the row's 16-byte chunk ch + p * kL
  static __device__ __forceinline__ int col(int ch, int e) {
    return (ch + (e / kVec) * kL) * kVec + e % kVec;
  }
  // column group ch's 8 elements of row r of a tile in shared memory, as fp32
  static __device__ __forceinline__ void row8(const unsigned char* tile, int r, int ch,
                                              float* x) {
#pragma unroll
    for (int p = 0; p < kPieces; ++p)
      unpack(*reinterpret_cast<const uint4*>(tile + r * kPitch + (ch + p * kL) * 16),
             x + p * kVec, T{});
  }
};

template <typename T, int DP>
size_t smem_bytes(int g) {
  using S = Shape<T, DP>;
  // ring; q (g x DP); p (g x (kBK + 1)); m / l / alpha (g each); list; warp counts
  return static_cast<size_t>(kStages) * 2 * S::kTileBytes +
         sizeof(float) * (static_cast<size_t>(g) * DP + g * (S::kBK + 1) + 3 * g) +
         sizeof(int) * (kList + kWarps);
}

// Whether tile t (slots t*BK .. t*BK+BK-1, clipped to s) has a valid slot.
template <int BK>
__device__ __forceinline__ bool tile_has_valid(const uint8_t* __restrict__ vrow, int64_t t,
                                               int64_t s) {
  const int64_t c0 = t * BK;
  const uint8_t* p = vrow + c0;
  if (c0 + BK <= s && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    unsigned any = 0;
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      any |= u.x | u.y | u.z | u.w;
    }
    return any != 0;
  }
  unsigned any = 0;
  const int64_t end = c0 + BK < s ? c0 + BK : s;
  for (int64_t c = c0; c < end; ++c) any |= vrow[c];
  return any != 0;
}

template <typename T, int DP, int GPT>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                              const T* __restrict__ vc, const uint8_t* __restrict__ valid,
                              float* __restrict__ part_ml, float* __restrict__ part_acc,
                              int64_t s, int h, int kv, int d, int splits, float scale) {
  using S = Shape<T, DP>;
  constexpr int kBK = S::kBK, kL = S::kL, kQ = S::kQ, kPP = kBK + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = h / kv;
  unsigned char* ring = smem;  // kStages x (K tile, V tile)
  float* qs = reinterpret_cast<float*>(ring + kStages * 2 * S::kTileBytes);  // g x DP
  float* ps = qs + g * DP;     // g x kPP: scores, then probabilities
  float* m_s = ps + g * kPP;   // g: running max
  float* l_s = m_s + g;        // g: running sum
  float* a_s = l_s + g;        // g: this tile's rescale
  int* list = reinterpret_cast<int*>(a_s + g);  // kList tile indices
  int* wcnt = list + kList;    // kWarps

  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / kv, kvh = bkv % kv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t kv_stride = static_cast<int64_t>(kv) * d;
  const T* qb = q + (static_cast<int64_t>(b) * h + static_cast<int64_t>(kvh) * g) * d;
  const T* kb = kc + (static_cast<int64_t>(b) * s * kv + kvh) * d;
  const T* vb = vc + (static_cast<int64_t>(b) * s * kv + kvh) * d;
  const uint8_t* vrow = valid + static_cast<int64_t>(b) * s;

  for (int i = tid; i < g * DP; i += kThreads) {  // q scaled, fp32, zero past d
    const int gi = i / DP, c = i % DP;
    qs[i] = c < d ? __fmul_rn(to_f32(qb[gi * d + c]), scale) : 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }

  // scores: slot sr of the tile, chunks sj, sj + kQ, ... of its row; the
  // kQ threads of a slot are lanes kRowsPerWarp apart
  const int sr = warp * S::kRowsPerWarp + lane % S::kRowsPerWarp;
  const int sj = lane / S::kRowsPerWarp;
  // P.V: column group pc of heads pg, pg + pgq, ... (GPT of them), slots
  // ps0, ps0 + psg, ... of the tile; the psg strides of a column group are
  // neighbouring lanes
  const int pgq = (g + GPT - 1) / GPT;
  int psg = kThreads / (kL * pgq);
  while (psg & (psg - 1)) psg &= psg - 1;  // a power of 2, at most 32 (kL >= 8)
  const int ps0 = tid % psg;
  const int pc = (tid / psg) % kL;
  const int pg = tid / (psg * kL);
  const bool pv_active = pg < pgq;
  float acc[GPT][kE];
#pragma unroll
  for (int a = 0; a < GPT; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[a][e] = 0.0f;

  // the row's tiles with a valid slot (all of its tiles if it has none)
  const int64_t tiles = (s + kBK - 1) / kBK;
  int64_t n_valid = 0;
  bool first_chunk = false;  // this thread's tile of the first chunk, kept for the gather
  for (int64_t t0 = 0; t0 < tiles; t0 += kThreads) {
    const int64_t t = t0 + tid;
    const bool f = t < tiles && tile_has_valid<kBK>(vrow, t, s);
    if (t0 == 0) first_chunk = f;
    n_valid += __syncthreads_count(f);
  }
  const int64_t n_take = n_valid > 0 ? n_valid : tiles;
  const int64_t r_lo = split * n_take / splits, r_hi = (split + 1) * n_take / splits;

  for (int64_t base = r_lo; base < r_hi; base += kList) {
    const int n_list = static_cast<int>(r_hi - base < kList ? r_hi - base : kList);
    if (n_valid > 0) {  // the valid tiles of rank base .. base + n_list - 1
      int64_t rank0 = 0;
      for (int64_t t0 = 0; t0 < tiles && rank0 < base + n_list; t0 += kThreads) {
        const int64_t t = t0 + tid;
        const bool f = t0 == 0 ? first_chunk : t < tiles && tile_has_valid<kBK>(vrow, t, s);
        const unsigned ballot = __ballot_sync(0xffffffffu, f);
        if (lane == 0) wcnt[warp] = __popc(ballot);
        __syncthreads();
        int before = 0, total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          before += w < warp ? wcnt[w] : 0;
          total += wcnt[w];
        }
        const int64_t rank = rank0 + before + __popc(ballot & ((1u << lane) - 1u));
        if (f && rank >= base && rank < base + n_list) list[rank - base] = static_cast<int>(t);
        rank0 += total;
        __syncthreads();  // wcnt is read before the next chunk writes it
      }
    } else {
      for (int i = tid; i < n_list; i += kThreads) list[i] = static_cast<int>(base + i);
    }
    __syncthreads();

    auto load_tile = [&](int stage, int64_t t) {
      unsigned char* kt = ring + stage * 2 * S::kTileBytes;
      unsigned char* vt = kt + S::kTileBytes;
      const int64_t c0 = t * kBK;
#pragma unroll
      for (int n = 0; n < S::kCopies; ++n) {
        const int i = tid + n * kThreads;
        const int r = i / S::kChunksPerRow, c = i % S::kChunksPerRow;
        const bool in = c0 + r < s && c * S::kVec < d;  // d % 8 == 0: a chunk is all in or out
        const int64_t off = in ? (c0 + r) * kv_stride + c * S::kVec : 0;
        cp_async16(kt + r * S::kPitch + c * 16, kb + off, in);
        cp_async16(vt + r * S::kPitch + c * 16, vb + off, in);
      }
    };

#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_list) load_tile(st, list[st]);
      cp_async_commit();
    }
    for (int i = 0; i < n_list; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // tile i is in; every thread is done with tile i - 1
      if (i + kStages - 1 < n_list) load_tile((i + kStages - 1) % kStages, list[i + kStages - 1]);
      cp_async_commit();
      const unsigned char* kt = ring + (i % kStages) * 2 * S::kTileBytes;
      const unsigned char* vt = kt + S::kTileBytes;
      const int64_t slot = static_cast<int64_t>(list[i]) * kBK + sr;

      {  // scores, GPT heads at a time: each K chunk read once a group
        const float masked = slot >= s ? -INFINITY : (vrow[slot] ? 0.0f : kNegInf);
        for (int g0 = 0; g0 < g; g0 += GPT) {
          float dot[GPT];
#pragma unroll
          for (int a = 0; a < GPT; ++a) dot[a] = 0.0f;
#pragma unroll
          for (int n = 0; n < S::kNC; ++n) {
            const int chunk = sj + n * kQ;
            float kf[S::kVec];
            unpack(*reinterpret_cast<const uint4*>(kt + sr * S::kPitch + chunk * 16), kf, T{});
#pragma unroll
            for (int a = 0; a < GPT; ++a) {
              if (g0 + a >= g) break;
              const float* qp = qs + (g0 + a) * DP + chunk * S::kVec;
#pragma unroll
              for (int v4 = 0; v4 < S::kVec; v4 += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(qp + v4);
                dot[a] = fmaf(qv.x, kf[v4], dot[a]);
                dot[a] = fmaf(qv.y, kf[v4 + 1], dot[a]);
                dot[a] = fmaf(qv.z, kf[v4 + 2], dot[a]);
                dot[a] = fmaf(qv.w, kf[v4 + 3], dot[a]);
              }
            }
          }
#pragma unroll
          for (int off = S::kRowsPerWarp; off < 32; off <<= 1)
#pragma unroll
            for (int a = 0; a < GPT; ++a) dot[a] += __shfl_xor_sync(0xffffffffu, dot[a], off);
          if (sj == 0)
#pragma unroll
            for (int a = 0; a < GPT; ++a)
              if (g0 + a < g) ps[(g0 + a) * kPP + sr] = masked == 0.0f ? dot[a] : masked;
        }
      }
      __syncthreads();

      // online softmax: a warp per query head
      for (int gi = warp; gi < g; gi += kWarps) {
        float* prow = ps + gi * kPP;
        float mx = -INFINITY;
        for (int c = lane; c < kBK; c += 32) mx = fmaxf(mx, prow[c]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[gi];
        const float m_new = fmaxf(m_old, mx);  // finite: m_old >= -1e30
        float sum = 0.0f;
        for (int c = lane; c < kBK; c += 32) {
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

      // acc = acc * alpha + p . V: each V element read once for its heads
      if (pv_active) {
#pragma unroll
        for (int a = 0; a < GPT; ++a) {
          const int gi = pg + a * pgq;
          if (gi < g) {
            const float alpha = a_s[gi];
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[a][e] *= alpha;
          }
        }
        for (int r = ps0; r < kBK; r += psg) {
          float vf[kE];
          S::row8(vt, r, pc, vf);
#pragma unroll
          for (int a = 0; a < GPT; ++a) {
            const int gi = pg + a * pgq;
            if (gi < g) {
              const float p = ps[gi * kPP + r];
#pragma unroll
              for (int e = 0; e < kE; ++e) acc[a][e] = fmaf(p, vf[e], acc[a][e]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring and the list are free for the next round
  }
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  // the psg strides of a column group, summed by shuffles in a fixed order
  for (int off = 1; off < psg; off <<= 1)
#pragma unroll
    for (int a = 0; a < GPT; ++a)
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[a][e] += __shfl_xor_sync(0xffffffffu, acc[a][e], off);
  const int64_t item = static_cast<int64_t>(bkv) * splits + split;
  if (pv_active && ps0 == 0) {
#pragma unroll
    for (int a = 0; a < GPT; ++a) {
      const int gi = pg + a * pgq;
      if (gi < g) {
        float* dst = part_acc + (item * g + gi) * d;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int c = S::col(pc, e);
          if (c < d) dst[c] = acc[a][e];
        }
      }
    }
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    part_ml[(item * g + gi) * 2] = m_s[gi];
    part_ml[(item * g + gi) * 2 + 1] = l_s[gi];
  }
}

// out[b, h, :] from the splits' partials of (b, h / G), in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_combine_kernel(const float* __restrict__ part_ml,
                                const float* __restrict__ part_acc, T* __restrict__ o,
                                int64_t b, int h, int kv, int d, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the split kernel has finished
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= b * h * d) return;
  const int g = h / kv;
  const int dd = static_cast<int>(i % d);
  const int64_t bh = i / d;
  const int hh = static_cast<int>(bh % h);
  const int64_t bkv = (bh / h) * kv + hh / g;
  const int gi = hh % g;
  const float* ml = part_ml + (bkv * splits * g + gi) * 2;  // a split's stride: 2 * g
  const float* ac = part_acc + (bkv * splits * g + gi) * d + dd;  // a split's stride: g * d
  float mx = -INFINITY;
  for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, ml[static_cast<int64_t>(sp) * 2 * g]);
  float l = 0.0f, acc = 0.0f;
  for (int sp = 0; sp < splits; ++sp) {
    const float w = expf(ml[static_cast<int64_t>(sp) * 2 * g] - mx);  // in [0, 1]
    l = fmaf(w, ml[static_cast<int64_t>(sp) * 2 * g + 1], l);
    acc = fmaf(w, ac[static_cast<int64_t>(sp) * g * d], acc);
  }
  from_f32(o + i, acc / fmaxf(l, 1e-30f));
}

template <typename T, int DP, int GPT>
int launch_split(const T* q, const T* kc, const T* vc, const uint8_t* valid, float* part_ml,
                 float* part_acc, int64_t b, int64_t s, int64_t h, int64_t kv, int64_t d,
                 int64_t splits, float scale, cudaStream_t stream) {
  static bool configured = false;  // per function, once: what the largest G needs
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_split_kernel<T, DP, GPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<T, DP>(kMaxGroupWidth / DP)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  decode_attention_split_kernel<T, DP, GPT>
      <<<dim3(static_cast<unsigned>(b * kv), static_cast<unsigned>(splits)), kThreads,
         smem_bytes<T, DP>(static_cast<int>(h / kv)), stream>>>(
          q, kc, vc, valid, part_ml, part_acc, s, static_cast<int>(h), static_cast<int>(kv),
          static_cast<int>(d), static_cast<int>(splits), scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DP>
int launch_dp(const T* q, const T* kc, const T* vc, const uint8_t* valid, T* o, float* ws,
              int64_t b, int64_t s, int64_t h, int64_t kv, int64_t d, int64_t splits,
              float scale, cudaStream_t stream) {
  const int64_t g = h / kv;
  float* part_ml = ws;
  float* part_acc = ws + b * kv * splits * g * 2;
  // the query heads a P.V thread accumulates: G up to 2, else 4
  const int err0 =
      g == 1 ? launch_split<T, DP, 1>(q, kc, vc, valid, part_ml, part_acc, b, s, h, kv, d,
                                      splits, scale, stream)
      : g == 2 ? launch_split<T, DP, 2>(q, kc, vc, valid, part_ml, part_acc, b, s, h, kv, d,
                                        splits, scale, stream)
               : launch_split<T, DP, 4>(q, kc, vc, valid, part_ml, part_acc, b, s, h, kv, d,
                                        splits, scale, stream);
  if (err0 != 0) return err0;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((b * h * d + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attention_combine_kernel<T>,
                                       static_cast<const float*>(part_ml),
                                       static_cast<const float*>(part_acc), o, b,
                                       static_cast<int>(h), static_cast<int>(kv),
                                       static_cast<int>(d), static_cast<int>(splits));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q, const T* kc, const T* vc, const uint8_t* valid, T* o, float* ws,
           int64_t b, int64_t s, int64_t h, int64_t kv, int64_t d, int64_t splits,
           int64_t ws_floats, float scale, cudaStream_t stream) {
  if (b == 0) return static_cast<int>(cudaGetLastError());
  const int64_t dp = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  if (s < 1 || kv < 1 || h % kv || d < 8 || d > 256 || d % 8 || (h / kv) * dp > kMaxGroupWidth ||
      splits < 1 || splits > 65535 || ws_floats < b * kv * splits * (h / kv) * (d + 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dp == 64) return launch_dp<T, 64>(q, kc, vc, valid, o, ws, b, s, h, kv, d, splits, scale, stream);
  if (dp == 128) return launch_dp<T, 128>(q, kc, vc, valid, o, ws, b, s, h, kv, d, splits, scale, stream);
  return launch_dp<T, 256>(q, kc, vc, valid, o, ws, b, s, h, kv, d, splits, scale, stream);
}

}  // namespace

// q: (b, h, d), k_cache, v_cache: (b, s, kv, d), valid: (b, s) bytes (0/1),
// o: (b, h, d), all contiguous, the fp tensors 16-byte aligned; h % kv == 0,
// d % 8 == 0, 8 <= d <= 256, (h / kv) * d_pad <= 4096, s >= 1;
// 1 <= splits <= 65535; ws: at least b * kv * splits * (h / kv) * (d + 2)
// fp32 of scratch, written before it is read; scale = d ** -0.5 as fp32.
// Two kernels, the split kernel and the combine.
extern "C" int repro_decode_attention_f32(const float* q, const float* kc, const float* vc,
                                          const uint8_t* valid, float* o, float* ws,
                                          int64_t b, int64_t s, int64_t h, int64_t kv,
                                          int64_t d, int64_t splits, int64_t ws_floats,
                                          float scale, cudaStream_t stream) {
  return launch<float>(q, kc, vc, valid, o, ws, b, s, h, kv, d, splits, ws_floats, scale,
                       stream);
}

extern "C" int repro_decode_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* kc,
                                           const __nv_bfloat16* vc, const uint8_t* valid,
                                           __nv_bfloat16* o, float* ws, int64_t b, int64_t s,
                                           int64_t h, int64_t kv, int64_t d, int64_t splits,
                                           int64_t ws_floats, float scale,
                                           cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, kc, vc, valid, o, ws, b, s, h, kv, d, splits, ws_floats,
                               scale, stream);
}
