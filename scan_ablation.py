#!/usr/bin/env python3
"""Where the selective scan kernels' time goes, on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scan_ablation.py [--parent DIR]

Builds copies of ``src/repro_torch/kernels/csrc/selective_scan.cu``, each
into its own library under ``build/scan_ablation/`` (the source stays as it
is; one nvcc a copy, all started together), with parts of a kernel taken
out or changed, and times each beside the whole kernel with CUDA events
(median of 20 calls, each after a 512 MB memset that evicts L2).
A copy without a part computes something else: only the whole kernels'
outputs are checked against their plain versions.

The forward (``ABLATIONS``) at the Jamba slice's prefill shape: x (8,
1024, 16384) bf16, dt fp32, N = 16, no initial state, one group of A and
D, no checkpoints (the serving forward), the reference tests' draws; y
within one bf16 ulp of the plain version, the state within 1e-5.  The
last variant, the exponential as ``ex2.approx`` of a pre-scaled A with the
products contracted into FMAs, times what the plain version's roundings
cost; it is never on the port's path.

The backward (``BWD_ABLATIONS``: the backward kernel and its fixed-order
sum kernel, one bare launch) at phase 20's layer shape: x and dy (4, 512,
16384) bf16, N = 16, G = 2 groups of A and D, a final-state cotangent,
the forward's checkpoints; every gradient of the whole kernel within
relative L2 1e-5 of the plain version's (a bf16 dx 2**-8).  The variants:
the reverse walk computing a_t again with expf (the exponential the kept
value saves); no exponentials at all; the dB / dC sums taken out (their
products, stores and block sums), or only their range sums, or only the
products' stores; the dx / ddt stores taken out; du and ddt's terms
summed by an xor tree of shuffles; the checkpoint loaded at the
segment's start; the launch bounds at 2 blocks an SM (64 registers);
256-thread blocks at 2 an SM (twice the partials), also with odd blocks
starting 2 us late; the backward kernel alone (no sum kernel) and the sum
kernel alone.  With ``--parent DIR`` (an unpacked earlier tree, e.g.
``git archive``), DIR's backward is built too, with
``PARENT_BWD_ABLATIONS`` (the variants of the earlier design, which kept
the segment's states in shared memory and computed a_t twice), and DIR's
whole backward is timed in turns with this tree's (parent, this, this,
parent).

Prints one line per variant with ptxas' registers and spills of its bf16
N_MAX = 16 kernel and the most any of its 8 builds spills; for the
backward, the blocks an SM the runtime grants it where the library
reports it and, from its SASS (cuobjdump), each innermost loop that holds
an exponential with its instructions; and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
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


# the backward at phase 20's layer shape: B·C, S, Di, N, G
BWD_SHAPE = (4, 512, 16384, 16, 2)
_BWD_ENTRY = "repro_selective_scan_bwd_bf16"
_BLOCKS_ENTRY = "repro_selective_scan_bwd_blocks_per_sm"
_BWD_LAUNCH = ("  selective_scan_bwd_kernel<T, NMAX><<<grid, kBwdThreads, sizeof(BwdSmem<T, NMAX>), "
               "stream>>>(\n")
_SUM_LAUNCH = "  selective_scan_bwd_sum_kernel<<<sum_blocks, 256, 0, stream>>>(\n"
# name -> edits of this tree's backward
BWD_ABLATIONS = {
    "a_t computed again in the reverse walk (a second expf a state-step)": [
        ("        g[i] = __fmul_rn(decay[tt][i], g[i]);                   // a_t g_t, for t - 1\n",
         "        g[i] = __fmul_rn(expf(__fmul_rn(dtv, ar[i])), g[i]);\n")],
    "no exponentials (dt * A in place of exp(dt * A))": [
        ("        decay[tt][i] = expf(__fmul_rn(dtv, ar[i]));\n",
         "        decay[tt][i] = __fmul_rn(dtv, ar[i]);\n")],
    "no dB and dC sums (their products, stores and block sums taken out)": [
        ("      *reinterpret_cast<float4*>(&sm.prod[2 * tt + 1][ch * NMAX + j0]) = make_float4(\n"
         "          __fmul_rn(dyv, st[0]), __fmul_rn(dyv, st[1]), __fmul_rn(dyv, st[2]),\n"
         "          __fmul_rn(dyv, st[3]));\n", ""),
        ("      *reinterpret_cast<float4*>(&sm.prod[2 * tt][ch * NMAX + j0]) =\n"
         "          make_float4(pb[0], pb[1], pb[2], pb[3]);\n", ""),
        ("      if (row / 2 < len) {\n", "      if (false) {\n"),
        ("      if (e >= len * 2 * NMAX) break;\n", "      break;\n")],
    "no range sums (the products stored, not read back)": [
        ("      if (row / 2 < len) {\n", "      if (false) {\n")],
    "no product stores (the range sums read what shared memory holds)": [
        ("      *reinterpret_cast<float4*>(&sm.prod[2 * tt + 1][ch * NMAX + j0]) = make_float4(\n"
         "          __fmul_rn(dyv, st[0]), __fmul_rn(dyv, st[1]), __fmul_rn(dyv, st[2]),\n"
         "          __fmul_rn(dyv, st[3]));\n", ""),
        ("      *reinterpret_cast<float4*>(&sm.prod[2 * tt][ch * NMAX + j0]) =\n"
         "          make_float4(pb[0], pb[1], pb[2], pb[3]);\n", "")],
    "no dx / ddt stores (their terms still stored)": [
        ("      if (out_live && tt < len) {\n", "      if (false) {\n")],
    "du and ddt's terms summed by an xor tree of shuffles (one store a channel)": [
        ("      sm.terms[tt][sub][ch ^ (sub % (P::kSub / 2) * (32 / P::kSub))] = make_float2(du, dsum);\n",
         "      for (int off = 1; off < P::kSub; off <<= 1) {\n"
         "        du = __fadd_rn(du, __shfl_xor_sync(0xffffffffu, du, off));\n"
         "        dsum = __fadd_rn(dsum, __shfl_xor_sync(0xffffffffu, dsum, off));\n"
         "      }\n"
         "      if (sub == 0) sm.terms[tt][0][ch] = make_float2(du, dsum);\n"),
        ("        for (int q = 0; q < P::kSub; ++q) {\n", "        for (int q = 0; q < 1; ++q) {\n")],
    "the checkpoint loaded at the segment's start (not in the reverse walk)": [
        ("    for (int i = 0; i < kPer; ++i) st[i] = next[i];\n",
         "    for (int i = 0; i < kPer; ++i) st[i] = next[i];\n    if (k > 0) load_checkpoint(k - 1);\n"),
        ("      if (tt == kSeg - 1 && k > 0) load_checkpoint(k - 1);\n", "")],
    "__launch_bounds__ at 2 blocks an SM (so at most 64 registers)": [
        ("__global__ void __launch_bounds__(kBwdThreads, 1)\n",
         "__global__ void __launch_bounds__(kBwdThreads, 2)\n")],
    "256 threads a block, 2 blocks an SM (twice the partials)": [
        ("constexpr int kBwdThreads = 512;", "constexpr int kBwdThreads = 256;"),
        ("__global__ void __launch_bounds__(kBwdThreads, 1)\n",
         "__global__ void __launch_bounds__(kBwdThreads, 2)\n")],
    "256 threads a block, 2 blocks an SM, odd blocks starting 2 us late (twice the partials)": [
        ("constexpr int kBwdThreads = 512;", "constexpr int kBwdThreads = 256;"),
        ("__global__ void __launch_bounds__(kBwdThreads, 1)\n",
         "__global__ void __launch_bounds__(kBwdThreads, 2)\n"),
        ("  const int segs = static_cast<int>((s + kSeg - 1) / kSeg);\n\n",
         "  const int segs = static_cast<int>((s + kSeg - 1) / kSeg);\n"
         "  if (blockIdx.x & 1) __nanosleep(2000);\n\n")],
    "the backward kernel alone (no sum kernel)": [(_SUM_LAUNCH, "  if (false)" + _SUM_LAUNCH[1:])],
    "the sum kernel alone": [(_BWD_LAUNCH, "  if (false)" + _BWD_LAUNCH[1:])],
}

# name -> edits of the earlier backward (``--parent``): a thread a channel's 16
# states, the segment's states in shared memory, a_t computed twice
_P_BOUNDS = "__global__ void __launch_bounds__(kThreads, NMAX <= 8 ? 4 : 2)\n"
PARENT_BWD_ABLATIONS = {
    "a_t kept from the recompute (no second expf; a product in place of h)": [
        ("        sm.h[tt][i][tid] = st[i];\n"
         "        const float decay = expf(__fmul_rn(dtv, ar[i]));\n"
         "        st[i] = __fadd_rn(__fmul_rn(decay, st[i]), __fmul_rn(ux, sm.b[tt][j0 + i]));\n",
         "        const float decay = expf(__fmul_rn(dtv, ar[i]));\n"
         "        const float kept = __fmul_rn(decay, st[i]);\n"
         "        sm.h[tt][i][tid] = kept;\n"
         "        st[i] = __fadd_rn(kept, __fmul_rn(ux, sm.b[tt][j0 + i]));\n"),
        ("        const float decay = expf(__fmul_rn(dtv, ar[i]));            // a_t\n"
         "        const float sens = decay * sm.h[tt][i][tid] * g[i];         // a_t h_{t-1} g_t\n",
         "        const float decay = sm.h[tt][i][tid];\n"
         "        const float sens = decay * g[i];\n")],
    "no reduce-scatters (dB and dC partials unreduced)": [
        ("      const int base = reduce_scatter<kPer, kPer, 16, P::kSub>(pc, lane);\n",
         "      const int base = 0;\n"),
        ("      const int base = reduce_scatter<kPer, kPer, 16, P::kSub>(pb, lane);\n",
         "      const int base = 0;\n")],
    "__launch_bounds__ at 1 block an SM": [
        (_P_BOUNDS, "__global__ void __launch_bounds__(kThreads, 1)\n")],
    "__launch_bounds__ at 2 blocks an SM (the whole kernel's)": [
        (_P_BOUNDS, "__global__ void __launch_bounds__(kThreads, 2)\n")],
    "the backward kernel alone (no sum kernel)": [(_SUM_LAUNCH, "  if (false)" + _SUM_LAUNCH[1:])],
    "the sum kernel alone": [
        ("  selective_scan_bwd_kernel<T, NMAX><<<grid, kThreads, smem, stream>>>(\n",
         "  if (false) selective_scan_bwd_kernel<T, NMAX><<<grid, kThreads, smem, stream>>>(\n")],
}


def edited(source: str, name: str, edits) -> str | None:
    for old, new in edits:
        if source.count(old) != 1:
            print(f"scan_ablation: {name}: the source holds {old!r} {source.count(old)} times",
                  flush=True)
            return None
        source = source.replace(old, new)
    return source


def ptxas_of(log: str, kernel: str = "selective_scan_kernel") -> str:
    """ptxas' registers and spills for ``kernel``'s bf16 N_MAX = 16 build,
    and the most any of its 8 builds (fp32 and bf16, N_MAX 8 to 64) spills."""
    at = log.find(f"{kernel}I13__nv_bfloat16Li16E")
    regs = re.search(r"Used (\d+) registers", log[at:])
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log[at:])
    worst = max(sum(map(int, re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                       part).groups()))
                for part in log.split("Compiling entry function")[1:]
                if re.match(rf" '\S*{kernel}I", part))
    return (f"{regs[1]} registers, {spill[1]}/{spill[2]} bytes spilled; "
            f"at most {worst} bytes spilled (stores and loads) in any N_MAX and dtype")


def load(_cuda, path: Path) -> ctypes.CDLL:
    """A variant's library with ``SIGNATURES``' argtypes on the entry points
    it has (an earlier tree's may lack the blocks-an-SM query)."""
    so = ctypes.CDLL(str(path))
    for fn_name, argtypes in _cuda.SIGNATURES["selective_scan"].items():
        if hasattr(so, fn_name):
            getattr(so, fn_name).argtypes = argtypes
            getattr(so, fn_name).restype = ctypes.c_int
    return so


def build_variants(_cuda, texts: dict[str, str], tag: str) -> dict[str, tuple]:
    """One nvcc a variant, all started together -> each library, nvcc's
    output (ptxas' report) and the library's path; ``tag`` keeps the
    forward's files apart from the backward's."""
    out = _cuda.BUILD_DIR.parent / "scan_ablation"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(texts.items()):
        stem = f"{tag}{i:02d}_" + "".join(c if c.isalnum() else "_" for c in name)[:40]
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
        built[name] = (load(_cuda, lib), log, lib)
    return built


def bare_args(x, dt, a, bm, cm, d, y, h, stream) -> tuple:
    """``repro_selective_scan_bf16``'s arguments for the serving forward:
    no initial state, no checkpoints, rows of ld = Di, one group."""
    b, s, di = x.shape
    return (x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            d.data_ptr(), None, y.data_ptr(), h.data_ptr(), None, b, s, di, a.shape[-1], di, 1,
            stream)


def bwd_bare_args(ins, outs, scratch, groups, stream) -> tuple:
    """``repro_selective_scan_bwd_bf16``'s arguments: ``ins`` (x, dt, A, B,
    C, D, dy, checkpoints, dh_final), ``outs`` (dx, ddt, dB, dC, dA, dD;
    no dh0), ``scratch`` (the partials, arow, drow), rows of ld = Di."""
    b, s, di = ins[0].shape
    part = scratch[0]
    return (*(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs), None,
            *(t.data_ptr() for t in scratch), b, s, di, ins[2].shape[-1], di, groups,
            part.shape[0], stream)


def blocks_per_sm(so: ctypes.CDLL) -> str:
    """The blocks an SM the runtime grants the bf16 N_MAX = 16 backward."""
    if not hasattr(so, _BLOCKS_ENTRY):
        return "blocks an SM not reported"
    out = ctypes.c_int64(0)
    rc = getattr(so, _BLOCKS_ENTRY)(16, 1, ctypes.byref(out))
    return f"{out.value} blocks an SM" if rc == 0 else f"occupancy query failed ({rc})"


def sass_loops(path: Path) -> str:
    """The bf16 N_MAX = 16 backward's SASS (cuobjdump): for each innermost
    loop that holds an exponential (MUFU.EX2), its instructions and
    exponentials, and its most frequent opcodes."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if re.match(r"\S*selective_scan_bwd_kernelI13__nv_bfloat16Li16E", f))
    code = [(int(a, 16), ins.strip()) for a, ins in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = []  # (first, last address) of each back edge's loop that holds an ex2
    for addr, ins in code:
        m = re.search(r"\bBRA\s+(?:`\()?0x([0-9a-f]+)", ins)
        if m and int(m[1], 16) <= addr and any(
                "MUFU.EX2" in i for a, i in code if int(m[1], 16) <= a <= addr):
            loops.append((int(m[1], 16), addr))
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in loops)]
    parts = []
    for lo, hi in inner:
        span = [i for a, i in code if lo <= a <= hi]
        ops = {}
        for ins in span:
            op = (ins.split()[1] if ins.startswith("@") else ins.split()[0]).split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        top = ", ".join(f"{k} {v}" for k, v in sorted(ops.items(), key=lambda kv: -kv[1])[:8])
        parts.append(f"a loop of {len(span)} SASS instructions with "
                     f"{sum('MUFU.EX2' in i for i in span)} MUFU.EX2 ({top})")
    return "; ".join(parts) or "no loop holds a MUFU.EX2"


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


def checked(fn, args):
    def call():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"launch failed with cudaError_t {rc}")
    return call


def forward(_cuda, ops, ref, source: str, card: str) -> int:
    variants = {"whole kernel": (_cuda.library("selective_scan"),
                                 _cuda.build_log("selective_scan"), None)}
    texts = {name: edited(source, name, edits) for name, edits in ABLATIONS.items()}
    if None in texts.values():
        return 1
    variants.update(build_variants(_cuda, texts, "fwd"))

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
    del y_exp, h_exp
    stream = torch.cuda.current_stream().cuda_stream
    for name, (so, log, _) in variants.items():
        call = checked(so.repro_selective_scan_bf16, bare_args(x, dt, a, bm, cm, d, y, h, stream))
        print(f"forward, {name}: {time_us(call):.2f} us ({ptxas_of(log)}; x ({b}, {s}, {di}) "
              f"bf16, N {n}; {card})", flush=True)
    return 0


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def backward(_cuda, sk, ref, source: str, parent: Path | None, card: str) -> int:
    variants = {"whole backward": (_cuda.library("selective_scan"),
                                   _cuda.build_log("selective_scan"),
                                   _cuda.library_path("selective_scan"))}
    texts = {name: edited(source, name, edits) for name, edits in BWD_ABLATIONS.items()}
    parent_whole = "the parent's whole backward"
    if parent is not None:
        psource = (parent / "src/repro_torch/kernels/csrc/selective_scan.cu").read_text()
        texts[parent_whole] = psource
        texts.update({f"the parent's backward, {name}": edited(psource, name, edits)
                      for name, edits in PARENT_BWD_ABLATIONS.items()})
    if None in texts.values():
        return 1
    variants.update(build_variants(_cuda, texts, "bwd"))

    b, s, di, n, groups = BWD_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = randn(b, s, di, scale=0.5).bfloat16()
    dt = torch.nn.functional.softplus(randn(b, s, di))
    a0 = -torch.exp(randn(di, n, scale=0.3))
    a = torch.stack([a0 * (1 + 0.05 * k) for k in range(groups)])
    bm, cm, d0 = randn(b, s, n), randn(b, s, n), randn(di)
    d = torch.stack([d0 * (1 - 0.1 * k) for k in range(groups)])
    dy, dhf = randn(b, s, di).bfloat16(), randn(b, di, n)
    _, _, ck = sk.selective_scan_fwd(x, dt, a, bm, cm, d, groups=groups)
    got = sk.selective_scan_bwd(x, dt, a, bm, cm, d, ck, dy, dh_final=dhf, groups=groups)
    plain = ref.selective_scan_bwd(x, dt, a, bm, cm, d, dy, dh_final=dhf, groups=groups)
    errs = [rel_l2(g, p) for g, p in zip(got[:6], plain[:6])]
    if not (errs[0] <= 2 ** -8 and max(errs[1:]) <= 1e-5):
        print(f"scan_ablation: the whole backward disagrees with its plain version: {errs}",
              flush=True)
        return 1
    del got, plain
    outs = (torch.empty_like(x), torch.empty_like(dt), torch.empty_like(bm),
            torch.empty_like(cm), torch.empty_like(a), torch.empty_like(d))
    rows = (torch.empty((b, di, n), device="cuda"), torch.empty((b, di), device="cuda"))
    stream = torch.cuda.current_stream().cuda_stream

    def bare(name):  # the variant's arguments: its partials sized by its block
        chan = (128 if name.startswith("the parent's") else
                64 if name.startswith("256 threads") else sk.bwd_channels(n))
        part = torch.empty((-(-di // chan), b, s, 2, n), device="cuda")
        return bwd_bare_args((x, dt, a, bm, cm, d, dy, ck, dhf), outs, (part, *rows), groups,
                             stream)

    shape = f"x, dy ({b}, {s}, {di}) bf16, N {n}, G {groups}, a final-state cotangent"
    for name, (so, log, path) in variants.items():
        call = checked(getattr(so, _BWD_ENTRY), bare(name))
        print(f"backward, {name}: {time_us(call):.2f} us ({ptxas_of(log, 'selective_scan_bwd_kernel')}"
              f"; {blocks_per_sm(so)}; {sass_loops(path)}; {shape}; {card})", flush=True)
    if parent is not None:  # in turns: parent, this, this, parent
        this = checked(getattr(variants["whole backward"][0], _BWD_ENTRY), bare("whole backward"))
        prev = checked(getattr(variants[parent_whole][0], _BWD_ENTRY), bare(parent_whole))
        turns = [time_us(fn) for fn in (prev, this, this, prev)]
        print(f"backward in turns (parent, this tree, this tree, parent): "
              f"{' / '.join(f'{t:.2f}' for t in turns)} us ({shape}; {card})", flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an unpacked earlier tree whose backward is ablated and timed too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("scan_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels import selective_scan as sk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    source = (_cuda.CSRC / "selective_scan.cu").read_text()
    return (forward(_cuda, ops, ref, source, card)
            or backward(_cuda, sk, ref, source, args.parent, card))


if __name__ == "__main__":
    sys.exit(main())
