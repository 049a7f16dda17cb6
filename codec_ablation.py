#!/usr/bin/env python3
"""Design trials of the Int8 codec kernels, on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 codec_ablation.py [--parent DIR]

Builds copies of ``src/repro_torch/kernels/csrc/quantize.cu``, each into
its own library under ``build/codec_ablation/`` (the source stays as it
is; one nvcc a copy, all started together), with one design choice
changed, and times each beside the kernel as it is with CUDA events
(median of 30 calls, each after a 512 MB memset that evicts L2) at the
head model's padded length Np = 1,974,528 and at the round engine's
8 x Np.  Every variant computes the same function, so each one's output
is checked bitwise against the plain version.  Beside them: a device copy
moving the same bytes; for dequantize with and without the streaming
store hint, the decode followed by the residual ``delta - decode`` that
reads it (the codec's caller); and, with ``--parent DIR`` (an unpacked
earlier tree of this repository), that tree's ``quantize.cu`` as one more
variant and its codec encode (``F.pad``, then its kernel on the padded
delta) against this tree's ``Int8Codec().encode``, in turns (earlier,
this, this, earlier).

Prints one line per variant and size with its ptxas registers and spills
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BLOCK = 256
N_PARAMS = 1_974_303          # mobilenet-head-office31's delta
NP = (N_PARAMS // BLOCK + 1) * BLOCK
ENGINE_C = 8

_QUANTIZE_KERNEL = """\
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, int64_t n, int n_blocks) {
  __shared__ float4 ring[kWarps][kStages][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  // this lane's two pieces of block blk into ring slot `slot`, zero past n;
  // a group is committed even past the last block, so the count holds
  auto issue = [&](int blk, int slot) {
    if (blk < n_blocks) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t i = static_cast<int64_t>(blk) * kBlock + 128 * h + 4 * lane;
        const int64_t left = n - i;
        const int bytes = left >= 4 ? 16 : left > 0 ? 4 * static_cast<int>(left) : 0;
        cp_async16(&ring[warp][slot][32 * h + lane], bytes ? x + i : x, bytes);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(first + k * stride, k);
  int slot = 0;
  for (int blk = first; blk < n_blocks; blk += stride) {
    issue(blk + (kStages - 1) * stride, (slot + kStages - 1) % kStages);
    asm volatile("cp.async.wait_group %0;\\n" ::"n"(kStages - 1));  // block blk's copies landed
    quantize_block(ring[warp][slot][lane], ring[warp][slot][32 + lane], blk, lane, q, scales);
    slot = slot + 1 == kStages ? 0 : slot + 1;
  }
}
"""
# the register double buffer in place of the ring: the next block's two
# float4 a lane loaded into registers before the current block is reduced
# (the last block's piece that straddles n as scalars)
_QUANTIZE_REGISTERS = """\
// values [i, i + 4) of x, those at or past n read as 0
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int64_t i, int64_t n) {
  if (i + 4 <= n) return *reinterpret_cast<const float4*>(x + i);
  return make_float4(i < n ? x[i] : 0.0f, i + 1 < n ? x[i + 1] : 0.0f,
                     i + 2 < n ? x[i + 2] : 0.0f, 0.0f);
}

struct Values {
  float4 a, b;
};

__device__ __forceinline__ Values load_block(const float* __restrict__ x, int blk, int full,
                                             int64_t n, int lane) {
  const float4* src = reinterpret_cast<const float4*>(x + static_cast<int64_t>(blk) * kBlock);
  if (blk < full) return {src[lane], src[32 + lane]};
  const int64_t base = static_cast<int64_t>(blk) * kBlock;
  return {load4(x, base + 4 * lane, n), load4(x, base + 128 + 4 * lane, n)};
}

__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scales, int64_t n, int n_blocks) {
  const int lane = threadIdx.x & 31;
  const int full = static_cast<int>(n / kBlock);  // blocks wholly before n
  const int stride = gridDim.x * kWarps;
  int blk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;
  Values cur = load_block(x, blk, full, n, lane);
  for (; blk < n_blocks; blk += stride) {
    Values next = {};
    if (blk + stride < n_blocks) next = load_block(x, blk + stride, full, n, lane);
    quantize_block(cur.a, cur.b, blk, lane, q, scales);
    cur = next;
  }
}
"""
_STAGES = "constexpr int kStages = 2;"
_DEQUANT_HEAD = """\
  uint32_t cur[4];
  float s_cur = 0.0f;
  load(w, cur, s_cur);
  for (; w < steps; w += stride) {
    uint32_t next[4] = {};
    float s_next = 0.0f;
    if (w + stride < steps) load(w + stride, next, s_next);
"""
_DEQUANT_TAIL = """\
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = next[j];
    s_cur = s_next;
"""
_STORES = """\
    dst[0] = dequant4(cur[0], s0);
    dst[32] = dequant4(cur[1], s0);
    if (second) {
      dst[64] = dequant4(cur[2], s1);
      dst[96] = dequant4(cur[3], s1);
    }
"""
_Q_GRID = "grid_for(n_blocks, cap)"
_DQ_GRID = "grid_for((n_blocks + 1) / 2, cap)"

# name -> (kernel it changes, [(text in the source, its replacement), ...])
ABLATIONS = {
    "quantize: a register double buffer for the cp.async ring": (
        "quantize", [(_QUANTIZE_KERNEL, _QUANTIZE_REGISTERS)]),
    "quantize: no prefetch (a 1-slot ring: a block copied when it is quantized)": (
        "quantize", [(_STAGES, "constexpr int kStages = 1;")]),
    "quantize: a 3-slot ring (the next two blocks in flight)": (
        "quantize", [(_STAGES, "constexpr int kStages = 3;")]),
    "quantize: half the resident CTAs": (
        "quantize", [(_Q_GRID, "grid_for(n_blocks, cap / 2)")]),
    "quantize: a warp for every block (the grid not capped)": (
        "quantize", [(_Q_GRID, "grid_for(n_blocks, n_blocks)")]),
    "dequantize: streaming stores (__stcs)": (
        "dequantize", [(_STORES, _STORES.replace("dst[0] = ", "__stcs(dst, ").replace(
            "dst[32] = ", "__stcs(dst + 32, ").replace("dst[64] = ", "__stcs(dst + 64, ").replace(
            "dst[96] = ", "__stcs(dst + 96, ").replace(");\n", "));\n"))]),
    "dequantize: no prefetch (two blocks loaded when they are stored)": (
        "dequantize", [(_DEQUANT_HEAD, "  for (; w < steps; w += stride) {\n"
                                       "    uint32_t cur[4];\n"
                                       "    float s_cur = 0.0f;\n"
                                       "    load(w, cur, s_cur);\n"),
                       (_DEQUANT_TAIL, "")]),
    "dequantize: half the resident CTAs": (
        "dequantize", [(_DQ_GRID, "grid_for((n_blocks + 1) / 2, cap / 2)")]),
    "dequantize: a warp for every two blocks (the grid not capped)": (
        "dequantize", [(_DQ_GRID, "grid_for((n_blocks + 1) / 2, n_blocks)")]),
}


def edited(source: str, name: str, edits) -> str | None:
    for old, new in edits:
        if source.count(old) != 1:
            print(f"codec_ablation: {name}: the source holds {old!r} {source.count(old)} times",
                  flush=True)
            return None
        source = source.replace(old, new)
    return source


def ptxas(log: str) -> dict[str, str]:
    """ptxas' registers and spills per codec kernel."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in ("dequantize", "quantize") if f"{k}_int8_kernel" in line),
                        None)
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name] = f"{m[1]} registers" + out.get(name, "")
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            out[name] = out.get(name, "") + f", {m[1]}/{m[2]} bytes spilled"
    return out


def build_variants(_cuda, texts: dict[str, str]) -> dict[str, tuple[ctypes.CDLL, dict]]:
    """One nvcc a source, all started together; each library with its two
    entry points' argument types set, and ptxas' report."""
    out = _cuda.BUILD_DIR.parent / "codec_ablation"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in texts.items():
        stem = "".join(c if c.isalnum() else "_" for c in name)[:48]
        src, lib = out / f"{stem}.cu", out / f"{stem}.so"
        src.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"codec_ablation: {name} did not build:\n{log}")
        so = ctypes.CDLL(str(lib))
        for fn_name, argtypes in _cuda.SIGNATURES["quantize"].items():
            getattr(so, fn_name).argtypes = argtypes
            getattr(so, fn_name).restype = ctypes.c_int
        built[name] = (so, ptxas(log))
    return built


def time_us(fn, iters: int = 30) -> float:
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends)) * 1e3


def checked(fn, *args):
    def call():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed with cudaError_t {rc}")
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an unpacked earlier tree whose quantize.cu is timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("codec_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.compression import Int8Codec
    from repro_torch.kernels import _cuda, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    source = (_cuda.CSRC / "quantize.cu").read_text()
    texts = {name: edited(source, name, edits) for name, (_, edits) in ABLATIONS.items()}
    if None in texts.values():
        return 1
    parent = "the earlier tree's kernel"
    if args.parent is not None:
        texts[parent] = (args.parent / "src/repro_torch/kernels/csrc/quantize.cu").read_text()
    variants = {"as it is": (_cuda.library("quantize"), ptxas(_cuda.build_log("quantize")))}
    variants.update(build_variants(_cuda, texts))
    if args.parent is not None:  # its quantize entry takes no unpadded length
        fn = variants[parent][0].repro_quantize_int8
        fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_void_p)

    rng = np.random.default_rng(20)
    failed = False
    for size, n in (("Np", NP), (f"{ENGINE_C} x Np", ENGINE_C * NP)):
        x = torch.from_numpy((rng.normal(size=n) * 10.0 ** rng.uniform(-5, -1, size=n // BLOCK)
                              .repeat(BLOCK)).astype(np.float32)).cuda()
        qr, sr = ref.quantize_int8(x)
        xr = ref.dequantize_int8(qr, sr)
        q, s, xd = torch.empty_like(qr), torch.empty_like(sr), torch.empty_like(xr)
        delta, res = torch.empty_like(xr).normal_(), torch.empty_like(xr)
        nb = n // BLOCK
        moved = n * 4 + n + nb * 4
        src = torch.empty(moved // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        print(f"[{size}] a device copy moving the same {moved / 1e6:.2f} MB: "
              f"{time_us(lambda: dst.copy_(src)):.2f} us ({card})", flush=True)
        for name, (so, regs) in variants.items():
            kind = ABLATIONS[name][0] if name in ABLATIONS else "both"
            qargs = ((x.data_ptr(), q.data_ptr(), s.data_ptr(), nb) if name == parent
                     else (x.data_ptr(), q.data_ptr(), s.data_ptr(), n, nb))
            quant = checked(so.repro_quantize_int8, *qargs)
            dequant = checked(so.repro_dequantize_int8, qr.data_ptr(), sr.data_ptr(),
                              xd.data_ptr(), nb)
            if kind in ("quantize", "both"):
                quant()
                torch.cuda.synchronize()
                ok = torch.equal(q, qr) and torch.equal(s, sr)
                failed |= not ok
                print(f"[{size}] {name}: quantize {time_us(quant):.2f} us, bitwise {ok} "
                      f"({regs.get('quantize')}; {card})", flush=True)
            if kind in ("dequantize", "both"):
                dequant()
                torch.cuda.synchronize()
                ok = torch.equal(xd, xr)
                failed |= not ok

                def with_residual(dequant=dequant):
                    dequant()
                    torch.sub(delta, xd, out=res)
                print(f"[{size}] {name}: dequantize {time_us(dequant):.2f} us, with the "
                      f"residual delta - decode after it {time_us(with_residual):.2f} us, "
                      f"bitwise {ok} ({regs.get('dequantize')}; {card})", flush=True)
        del src, dst

    if args.parent is not None:  # the codec's encode, earlier tree against this one
        d = torch.from_numpy((rng.normal(size=N_PARAMS) * 1e-3).astype(np.float32)).cuda()
        fn = variants[parent][0].repro_quantize_int8

        def earlier():
            xp = F.pad(d, (0, NP - N_PARAMS))
            qp = torch.empty(NP, dtype=torch.int8, device="cuda")
            sp = torch.empty(NP // BLOCK, dtype=torch.float32, device="cuda")
            checked(fn, xp.data_ptr(), qp.data_ptr(), sp.data_ptr(), NP // BLOCK)()
            return qp, sp

        enc = Int8Codec().encode(d)
        qp, sp = earlier()
        ok = torch.equal(qp, enc["q"]) and torch.equal(sp, enc["scale"])
        failed |= not ok
        times = [time_us(earlier), time_us(lambda: Int8Codec().encode(d)),
                 time_us(lambda: Int8Codec().encode(d)), time_us(earlier)]
        print(f"encode of a ({N_PARAMS},) fp32 delta: the earlier tree's F.pad then kernel "
              f"{times[0]:.2f} / {times[3]:.2f} us, this tree's Int8Codec().encode "
              f"{times[1]:.2f} / {times[2]:.2f} us (earlier, this, this, earlier), bitwise "
              f"{ok} ({card})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
