#!/usr/bin/env python3
"""Design trials of the Int8 reduce kernel (``dequant_reduce``), on one
NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 reduce_ablation.py [--parent DIR]

Builds copies of ``src/repro_torch/kernels/csrc/dequant_reduce.cu``, each
into its own library under ``build/reduce_ablation/`` (the source stays as
it is; one nvcc a copy, all started together), with one design choice
changed, and times each bare launch beside the kernel as it is with CUDA
events (median of 30 calls) at the smoke fleet's C = 6 Int8 clients and at
C = 64, both at the head model's padded length Np = 1,974,528.  Every
variant computes the same function, so each one's output is checked
bitwise against ``tests/torch_kernel_models.py``'s model of the kernel
(integer weights).  Every time is taken twice: after a 512 MB memset
before each call (the eviction ``chip_smoke.py`` uses, which leaves L2
full of dirty lines that the timed call must write back) and after a
512 MB read (L2 full of clean lines).  Beside them: a device copy moving
the same bytes (half read, half written); the ``ops`` wrapper in both
forms (``normalize`` True and False); and, with ``--parent DIR`` (an
unpacked earlier tree of this repository whose kernel takes normalized
weights), that tree's kernel as a bare launch and its wrapper -- the
weights normalized by ``safe_weight_sum`` around the kernel, and for
``normalize=False`` the mean multiplied back (``ops._denormalize``) --
against this tree's, in turns (earlier, this, this, earlier), checked
bitwise against each other.

Prints one line per variant, size and eviction with its ptxas registers
and spills and the card's name and power limit.
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
SIZES = (6, 64)               # the smoke fleet's Int8 group; a large cohort

_LOAD_SCALES = """\
#pragma unroll
  for (int m = 0; m < kScalesPerLane; ++m) {
    const int e = lane + 32 * m, h = e & 1;
    const int64_t c = c0 + (e >> 1);
    sr[m] = (c < c_rows && (h == 0 || second)) ? __ldg(scales + c * n_blocks + 2 * span + h)
                                               : 0.0f;
  }
"""
_STORE_SCALES = """\
  __syncwarp();  // every lane has read the rows these overwrite
#pragma unroll
  for (int m = 0; m < kScalesPerLane; ++m) {
    const int e = lane + 32 * m;
    ss[e >> 1][e & 1] = sr[m];
  }
  __syncwarp();
"""
_SCALES_READ = "ss[c - g0][0], ss[c - g0][1]"
_SCALES_16B = "ss[c - g0][lane >> 4], ss[c - g0][lane >> 4]"
_SCALES_GLOBAL = ("__ldg(scales + c * n_blocks + 2 * span), "
                  "second ? __ldg(scales + c * n_blocks + 2 * span + 1) : 0.0f")
_CODES_WORDS = """\
  const uint32_t* p = reinterpret_cast<const uint32_t*>(row + span * kSpan) + lane;
#pragma unroll
  for (int g = 0; g < 4; ++g)
    v[g] = (g < 2 || second) ? __ldcs(p + 32 * g) : 0u;
"""
_CODES_16B = """\
  const uint4 x = (lane < 16 || second)
      ? __ldcs(reinterpret_cast<const uint4*>(row + span * kSpan) + lane)
      : make_uint4(0u, 0u, 0u, 0u);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
"""
_SPAN = """\
  const int64_t span = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const bool live = span < n_spans;"""
_SPAN_EVEN = """\
  const int64_t span = static_cast<int64_t>(blockIdx.x) * n_spans / gridDim.x + warp;
  const bool live = span < (static_cast<int64_t>(blockIdx.x) + 1) * n_spans / gridDim.x;"""
_GRID = "  const int64_t grid = (n_spans + kWarps - 1) / kWarps;\n"
# kMinCtas CTAs an SM are resident at 64 registers; a warp still owns at
# most one span, which holds up to 8 x grid spans (the model's Np: 3,857
# spans, 4,224 warps)
_GRID_EVEN = """\
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidDevice);
  const int64_t grid = static_cast<int64_t>(kMinCtas) * sms;
  if (n_spans > kWarps * grid) return static_cast<int>(cudaErrorInvalidValue);
"""
_AHEAD = "constexpr int kAhead = 4;"
_MIN_CTAS = "constexpr int kMinCtas = 4;"
_THREADS = "constexpr int kThreads = 256;"

# name -> [(text in the source, its replacement), ...]
ABLATIONS = {
    "one row in flight (kAhead = 1)": [(_AHEAD, "constexpr int kAhead = 1;")],
    "two rows in flight (kAhead = 2)": [(_AHEAD, "constexpr int kAhead = 2;")],
    "eight rows in flight (kAhead = 8, the register cap of 4 CTAs an SM lifted)": [
        (_AHEAD, "constexpr int kAhead = 8;"), (_MIN_CTAS, "constexpr int kMinCtas = 1;")],
    "scales loaded by every lane from global memory (no shared staging)": [
        (_LOAD_SCALES, ""), (_STORE_SCALES, ""), (_SCALES_READ, _SCALES_GLOBAL)],
    "even-SM grid (the resident 4 CTAs an SM, the spans split evenly among them)": [
        (_SPAN, _SPAN_EVEN), (_GRID, _GRID_EVEN)],
    "128-thread CTAs (8 an SM)": [
        (_THREADS, "constexpr int kThreads = 128;"), (_MIN_CTAS, "constexpr int kMinCtas = 8;")],
    "16 codes a lane as one 16 B load, stored as 64 contiguous bytes a lane": [
        (_CODES_WORDS, _CODES_16B), (_SCALES_READ, _SCALES_16B),
        ("if (g >= 2 && !second) continue;", "if (lane >= 16 && !second) continue;"),
        ("reinterpret_cast<float4*>(out + span * kSpan) + lane;",
         "reinterpret_cast<float4*>(out + span * kSpan) + 4 * lane;"),
        ("dst[32 * g] = o;", "dst[g] = o;")],
    "codes loaded without the evict-first hint (__ldg)": [
        ("__ldcs(p + 32 * g)", "__ldg(p + 32 * g)")],
    "codes converted by the I2F unit (static_cast<float>)": [
        ("const float x = code_to_float(v[g], b);",
         "const float x = static_cast<float>(static_cast<signed char>(v[g] >> (8 * b)));")],
}


def edited(source: str, name: str, edits) -> str | None:
    for old, new in edits:
        if source.count(old) != 1:
            print(f"reduce_ablation: {name}: the source holds {old!r} {source.count(old)} times",
                  flush=True)
            return None
        source = source.replace(old, new)
    return source


def ptxas(log: str) -> str:
    """ptxas' registers and spills of dequant_reduce_kernel."""
    out, inside = "", False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = "dequant_reduce_kernel" in line
        elif inside and (m := re.search(r"Used (\d+) registers", line)):
            out = f"{m[1]} registers" + out
        elif inside and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                        line)):
            out += f", {m[1]}/{m[2]} bytes spilled"
    return out


def build_variants(_cuda, texts: dict[str, str], argtypes: dict[str, tuple]):
    """One nvcc a source, all started together; each library with its entry
    point's argument types set, and ptxas' report."""
    out = _cuda.BUILD_DIR.parent / "reduce_ablation"
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
            raise RuntimeError(f"reduce_ablation: {name} did not build:\n{log}")
        fn = ctypes.CDLL(str(lib)).repro_dequant_reduce
        fn.argtypes = argtypes[name]
        fn.restype = ctypes.c_int
        built[name] = (fn, ptxas(log))
    return built


_EVICT = {}


def time_us(fn, evict: str, iters: int = 30) -> float:
    """Median device time of one call, each after a 512 MB memset
    (``memset``: L2 left dirty) or a 512 MB read (``read``: L2 left
    clean) that also keeps the card busy while the call is enqueued."""
    if not _EVICT:
        buf = torch.zeros(512 << 20, dtype=torch.uint8, device="cuda")
        words = buf.view(torch.int32)
        _EVICT.update(memset=buf.zero_, read=lambda: torch.sum(words, dtype=torch.int64))
    flush = _EVICT[evict]
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush()
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
                        help="an unpacked earlier tree whose dequant_reduce.cu is timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("reduce_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.utils.pytree import safe_weight_sum
    from torch_kernel_models import dequant_reduce_one_launch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    source = (_cuda.CSRC / "dequant_reduce.cu").read_text()
    texts = {name: edited(source, name, edits) for name, edits in ABLATIONS.items()}
    if None in texts.values():
        return 1
    entry = _cuda.SIGNATURES["dequant_reduce"]["repro_dequant_reduce"]
    argtypes = dict.fromkeys(texts, entry)
    parent = "the earlier tree's kernel"
    if args.parent is not None:  # its entry takes normalized weights and no `normalize`
        texts[parent] = (args.parent / "src/repro_torch/kernels/csrc/dequant_reduce.cu").read_text()
        argtypes[parent] = entry[:6] + entry[7:]
    this = _cuda.library("dequant_reduce").repro_dequant_reduce
    variants = {"as it is": (this, ptxas(_cuda.build_log("dequant_reduce")))}
    variants.update(build_variants(_cuda, texts, argtypes))

    rng = np.random.default_rng(21)
    failed = False
    for c in SIZES:
        x = torch.from_numpy((rng.normal(size=(c, NP)) * 10.0 ** rng.uniform(
            -5, -1, size=(c, 1))).astype(np.float32)).cuda()
        qr, sr = ref.quantize_int8(x.reshape(-1))
        q, s = qr.reshape(c, NP), sr.reshape(c, NP // BLOCK)
        del x, qr, sr
        w = torch.from_numpy(rng.integers(10, 500, c).astype(np.float32)).cuda()
        wn = (w / safe_weight_sum(w)).contiguous()
        out = torch.empty(NP, dtype=torch.float32, device="cuda")
        want = dequant_reduce_one_launch(q, s, w)
        moved = q.numel() + s.numel() * 4 + w.numel() * 4 + out.numel() * 4
        src = torch.empty(moved // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        size = f"C={c}, Np={NP}, {moved / 1e6:.2f} MB"
        for evict in ("memset", "read"):
            print(f"[{size}, {evict}] a device copy moving the same bytes: "
                  f"{time_us(lambda: dst.copy_(src), evict):.2f} us ({card})", flush=True)
        del src, dst
        for name, (fn, regs) in variants.items():
            if name == parent:
                call = checked(fn, q.data_ptr(), s.data_ptr(), wn.data_ptr(), out.data_ptr(), c,
                               NP)
            else:
                call = checked(fn, q.data_ptr(), s.data_ptr(), w.data_ptr(), out.data_ptr(), c,
                               NP, 1)
            out.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            ok = torch.equal(out, want)
            failed |= not ok
            times = " / ".join(f"{time_us(call, evict):.2f}" for evict in ("memset", "read"))
            print(f"[{size}] {name}: bare launch {times} us (memset / read eviction), bitwise "
                  f"{ok} ({regs}; {card})", flush=True)

        def this_wrapper(normalize):
            return lambda: ops.dequant_reduce(q, s, w, normalize=normalize)

        for normalize in (True, False):
            for evict in ("memset", "read"):
                print(f"[{size}, {evict}] ops.dequant_reduce(normalize={normalize}): "
                      f"{time_us(this_wrapper(normalize), evict):.2f} us ({card})", flush=True)
        if args.parent is None:
            continue
        fn = variants[parent][0]

        def earlier_wrapper(normalize):
            """The earlier tree's ops.dequant_reduce on the card."""
            def call():
                wf = w.to(torch.float32)
                wn_ = (wf / safe_weight_sum(wf)).contiguous()
                o = torch.empty(NP, dtype=torch.float32, device="cuda")
                checked(fn, q.data_ptr(), s.data_ptr(), wn_.data_ptr(), o.data_ptr(), c, NP)()
                return o if normalize else o * safe_weight_sum(wf)
            return call

        for normalize in (True, False):
            ok = torch.equal(earlier_wrapper(normalize)(), this_wrapper(normalize)())
            failed |= not ok
            for evict in ("memset", "read"):
                times = [time_us(earlier_wrapper(normalize), evict),
                         time_us(this_wrapper(normalize), evict),
                         time_us(this_wrapper(normalize), evict),
                         time_us(earlier_wrapper(normalize), evict)]
                print(f"[{size}, {evict}] wrapper, normalize={normalize}: the earlier tree's "
                      f"{times[0]:.2f} / {times[3]:.2f} us, this tree's {times[1]:.2f} / "
                      f"{times[2]:.2f} us (earlier, this, this, earlier), bitwise {ok} ({card})",
                      flush=True)
        bare = {"earlier": variants[parent][0], "this": this}
        for evict in ("memset", "read"):
            calls = {
                "earlier": checked(bare["earlier"], q.data_ptr(), s.data_ptr(), wn.data_ptr(),
                                   out.data_ptr(), c, NP),
                "this": checked(bare["this"], q.data_ptr(), s.data_ptr(), w.data_ptr(),
                                out.data_ptr(), c, NP, 1),
            }
            times = [time_us(calls[k], evict) for k in ("earlier", "this", "this", "earlier")]
            print(f"[{size}, {evict}] bare launch: the earlier tree's {times[0]:.2f} / "
                  f"{times[3]:.2f} us, this tree's {times[1]:.2f} / {times[2]:.2f} us (earlier, "
                  f"this, this, earlier) ({card})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
