#!/usr/bin/env python3
"""Where the selective scan kernel's time goes, on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scan_ablation.py

Builds copies of ``src/repro_torch/kernels/csrc/selective_scan.cu``, each
into its own library under ``build/scan_ablation/`` (the source stays as it
is; one nvcc a copy, all started together), with parts of the kernel taken out or changed, and times each beside
the whole kernel with CUDA events (median of 20 calls, each after a 512 MB
memset that evicts L2) at the Jamba slice's prefill shape: x (8, 1024,
16384) bf16, dt fp32, N = 16, no initial state, one group of A and D, no
checkpoints (the serving forward), the reference tests' draws.
A copy without a part computes something else: only the whole kernel's
output is checked (against the plain version: y within one bf16 ulp, the
state within 1e-5).  The last variant, the exponential as ``ex2.approx``
of a pre-scaled A with the products contracted into FMAs, times what the
plain version's roundings cost; it is never on the port's path.

Prints one line per variant with its ptxas registers and spills and the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
_EXP = "          const float da = expf(__fmul_rn(dtt, ar[j]));\n"
_UPDATE = "          h[j] = __fadd_rn(__fmul_rn(da, h[j]), __fmul_rn(dtx, bq[r]));\n"
_Y_TERM = ("          const float p = __fmul_rn(h[j], cq[r]);\n"
           "          part[r] = q == 0 ? p : __fadd_rn(part[r], p);\n")
_Y_SUM = ("      const float sum = __fadd_rn(__fadd_rn(part[0], part[1]), "
          "__fadd_rn(part[2], part[3]));\n")
_A_ROW = "    ar[j] = live && j < n ? __ldg(a + d * n + j) : 0.0f;\n"
_HEAD = "__device__ __forceinline__ float to_f32(float v) { return v; }\n"
_BOUNDS = "__global__ void __launch_bounds__(kThreads, min_blocks(NMAX))\n"
# name -> (text in the source, its replacement), applied in turn
ABLATIONS = {
    "no exponentials (dt * A in place of exp(dt * A))": [
        (_EXP, "          const float da = __fmul_rn(dtt, ar[j]);\n")],
    "no loads (the ring, its waits and barriers kept)": [
        ("    if (k < chunks) issue(k);\n", ""),
        ("    if (k + kStages - 1 < chunks) issue(k + kStages - 1);\n", "")],
    "no y sum (y = D x; the state still computed)": [
        (_Y_TERM, ""), (_Y_SUM, "      const float sum = 0.0f;\n")],
    "the old 1.3-wave grid (6 blocks an SM, so at most 80 registers)": [
        (_BOUNDS, "__global__ void __launch_bounds__(kThreads, NMAX <= 16 ? 6 : 1)\n")],
    "ex2.approx of a pre-scaled A, products contracted into FMAs (not the port's roundings)": [
        (_HEAD, "__device__ __forceinline__ float ex2_approx(float v) {\n"
                "  float r;\n"
                "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(r) : \"f\"(v));\n"
                "  return r;\n"
                "}\n" + _HEAD),
        (_A_ROW, "    ar[j] = live && j < n ? __ldg(a + d * n + j) * 1.4426950408889634f : 0.0f;\n"),
        (_EXP, "          const float da = ex2_approx(dtt * ar[j]);\n"),
        (_UPDATE, "          h[j] = fmaf(da, h[j], dtx * bq[r]);\n"),
        (_Y_TERM, "          part[r] = q == 0 ? h[j] * cq[r] : fmaf(h[j], cq[r], part[r]);\n")],
}


def edited(source: str, name: str, edits) -> str | None:
    for old, new in edits:
        if source.count(old) != 1:
            print(f"scan_ablation: {name}: the source holds {old!r} {source.count(old)} times",
                  flush=True)
            return None
        source = source.replace(old, new)
    return source


def ptxas_bf16_16(log: str) -> str:
    """ptxas' registers and spills for the bf16 N_MAX = 16 kernel."""
    at = log.find("selective_scan_kernelI13__nv_bfloat16Li16E")
    regs = re.search(r"Used (\d+) registers", log[at:])
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log[at:])
    return f"{regs[1]} registers, {spill[1]}/{spill[2]} bytes spilled"


def build_variants(_cuda, texts: dict[str, str]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """One nvcc a variant, all started together; each library's bf16
    entry point and ptxas' report of its N_MAX = 16 kernel."""
    out = _cuda.BUILD_DIR.parent / "scan_ablation"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in texts.items():
        stem = "".join(c if c.isalnum() else "_" for c in name)[:40]
        src, lib = out / f"{stem}.cu", out / f"{stem}.so"
        src.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"scan_ablation: {name} did not build:\n{log}")
        so = ctypes.CDLL(str(lib))
        fn = so.repro_selective_scan_bf16
        fn.argtypes = _cuda.SIGNATURES["selective_scan"]["repro_selective_scan_bf16"]
        fn.restype = ctypes.c_int
        built[name] = (so, ptxas_bf16_16(log))
    return built


def bare_args(x, dt, a, bm, cm, d, y, h, stream) -> tuple:
    """``repro_selective_scan_bf16``'s arguments for the serving forward:
    no initial state, no checkpoints, rows of ld = Di, one group."""
    b, s, di = x.shape
    return (x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            d.data_ptr(), None, y.data_ptr(), h.data_ptr(), None, b, s, di, a.shape[-1], di, 1,
            stream)


def time_us(fn, iters: int = 20) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda, ops, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    source = (_cuda.CSRC / "selective_scan.cu").read_text()
    variants = {"whole kernel": (_cuda.library("selective_scan"),
                                 ptxas_bf16_16(_cuda.build_log("selective_scan")))}
    texts = {name: edited(source, name, edits) for name, edits in ABLATIONS.items()}
    if None in texts.values():
        return 1
    variants.update(build_variants(_cuda, texts))

    b, s, di, n = 8, 1024, 16384, 16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    x = (torch.randn(b, s, di, generator=gen, device="cuda") * 0.5).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(b, s, di, generator=gen, device="cuda"))
    a = -torch.exp(torch.randn(di, n, generator=gen, device="cuda") * 0.3)
    bm, cm = (torch.randn(b, s, n, generator=gen, device="cuda") for _ in range(2))
    d = torch.randn(di, generator=gen, device="cuda")
    y, h = ops.selective_scan(x, dt, a, bm, cm, d)
    y_exp, h_exp = ref.selective_scan(x, dt, a, bm, cm, d)
    if not (torch.allclose(y.float(), y_exp.float(), rtol=2**-7, atol=2**-7)
            and torch.allclose(h, h_exp, rtol=1e-5, atol=1e-5)):
        print("scan_ablation: the whole kernel disagrees with its plain version", flush=True)
        return 1
    stream = torch.cuda.current_stream().cuda_stream
    for name, (so, regs) in variants.items():
        fn = so.repro_selective_scan_bf16
        args = bare_args(x, dt, a, bm, cm, d, y, h, stream)

        def call(fn=fn, args=args):
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"launch failed with cudaError_t {rc}")
        print(f"{name}: {time_us(call):.2f} us ({regs}; x ({b}, {s}, {di}) bf16, N {n}; "
              f"{card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
