#!/usr/bin/env python3
"""Where the bf16 flash kernel's time goes, on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 flash_ablation.py

Builds copies of ``src/repro_torch/kernels/csrc/flash_attention.cu``, each
into its own library under ``build/flash_ablation/`` (the source stays as
it is), at qwen3-0.6b's prefill shape (B=8, S=1024, H=16, KV=8, D=128,
bf16):

- ablations: parts of the bf16 (wgmma) kernel taken out, each timed beside
  the whole kernel and scaled_dot_product_attention with CUDA events
  (median of 30 calls, each after a 512 MB memset that evicts L2), causal
  and not.  A copy without a part computes something else: only the whole
  kernel's output is checked (against the plain version, within 2e-2);
- a trace: the whole kernel with ``clock64`` read between the phases of a
  consumer's turn, summed over every CTA for thread 0 of each warpgroup
  (thread 0 of warpgroup 0 also loads), printed as shares of its cycles.

Prints one line per variant with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# name -> (text in the source, its replacement), applied in turn
ABLATIONS = {
    "no exp2 (softmax without the special function unit)": [
        ("sc[4 * ch + e] = exp2_ftz(fmaf(sc[4 * ch + e], sl, neg_m[e / 2]));",
         "sc[4 * ch + e] = fmaf(sc[4 * ch + e], sl, neg_m[e / 2]);")],
    "no softmax": [
        ("      online_softmax<kBK>(sc, m, l, alpha, edge,",
         "      alpha[0] = alpha[1] = 1.0f;\n      if (0) online_softmax<kBK>(sc, m, l, alpha, edge,")],
    "no S = Q.K^T": [
        ("          wgmma_ss<kBK>(sc, dq", "          if (0) wgmma_ss<kBK>(sc, dq")],
    "no P.V": [
        ("for (int jj = 0; jj < kBK / 16; ++jj) wgmma_rs<DP>",
         "for (int jj = 0; jj < 0; ++jj) wgmma_rs<DP>")],
    "loads only (no products, no softmax)": [
        ("          wgmma_ss<kBK>(sc, dq", "          if (0) wgmma_ss<kBK>(sc, dq"),
        ("for (int jj = 0; jj < kBK / 16; ++jj) wgmma_rs<DP>",
         "for (int jj = 0; jj < 0; ++jj) wgmma_rs<DP>"),
        ("      online_softmax<kBK>(sc, m, l, alpha, edge,",
         "      alpha[0] = alpha[1] = 1.0f;\n      if (0) online_softmax<kBK>(sc, m, l, alpha, edge,")],
}


# (text in the source, the same text with a clock64 tick after it): tick k
# ends phase k of a turn
PHASES = ("wait for K", "ask for S", "load (thread 0) and meet", "wait for S",
          "softmax", "wait for V", "ask for P.V", "wait for P.V", "epilogue",
          "item start and Q")
TRACE = [
    ("namespace {\n\nconstexpr int kWgBQ",
     "__device__ unsigned long long g_trace[2][10];\nnamespace {\n\nconstexpr int kWgBQ"),
    ("  int g = 0;  // tiles used so far, over all items\n",
     "  int g = 0;  // tiles used so far, over all items\n"
     "  unsigned long long tr[10] = {};\n  long long tt = clock64();\n"
     "#define TICK(k) { const long long now = clock64(); tr[k] += now - tt; tt = now; }\n"),
    ("    mbar_wait(q_full(j), (j / kQSlots) & 1);\n",
     "    mbar_wait(q_full(j), (j / kQSlots) & 1);\n    TICK(9)\n"),
    ("      mbar_wait(k_full(s), parity);\n", "      mbar_wait(k_full(s), parity);\n      TICK(0)\n"),
    ("                        dk + (p * kBK * 128 + kk * 32) / 16, p | kk);\n      wgmma_commit();\n",
     "                        dk + (p * kBK * 128 + kk * 32) / 16, p | kk);\n      wgmma_commit();\n"
     "      TICK(1)\n"),
    ("      if (wg == 0) asm volatile(\"bar.sync 1, 128;\\n\" ::: \"memory\");\n",
     "      if (wg == 0) asm volatile(\"bar.sync 1, 128;\\n\" ::: \"memory\");\n      TICK(2)\n"),
    ("      fence_regs(sc);\n", "      fence_regs(sc);\n      TICK(3)\n"),
    ("      pack_p<kBK>(sc, pf);\n", "      pack_p<kBK>(sc, pf);\n      TICK(4)\n"),
    ("      mbar_wait(v_full(s), parity);\n", "      mbar_wait(v_full(s), parity);\n      TICK(5)\n"),
    ("wgmma_rs<DP>(acc, pf[jj], dv + jj * 2048 / 16);\n      wgmma_commit();\n",
     "wgmma_rs<DP>(acc, pf[jj], dv + jj * 2048 / 16);\n      wgmma_commit();\n      TICK(6)\n"),
    ("      fence_regs(acc);\n", "      fence_regs(acc);\n      TICK(7)\n"),
    ("              __floats2bfloat162_rn(acc[4 * ch + 2 * r] * inv, acc[4 * ch + 2 * r + 1] * inv);\n"
     "      }\n    }\n",
     "              __floats2bfloat162_rn(acc[4 * ch + 2 * r] * inv, acc[4 * ch + 2 * r + 1] * inv);\n"
     "      }\n    }\n    TICK(8)\n"),
    ("  }\n}\n\nusing EncodeTiled",
     "  }\n  if (threadIdx.x % 128 == 0)\n"
     "    for (int k = 0; k < 10; ++k) atomicAdd(&g_trace[wg][k], tr[k]);\n}\n\nusing EncodeTiled"),
]
TRACE_READER = """
extern "C" int repro_flash_trace(unsigned long long* out) {  // read, then zero
  const unsigned long long zero[20] = {};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_trace, sizeof(zero));
  return static_cast<int>(err != cudaSuccess ? err : cudaMemcpyToSymbol(g_trace, zero, sizeof(zero)));
}
"""


def edited(source: str, name: str, edits) -> str | None:
    for old, new in edits:
        if source.count(old) != 1:
            print(f"flash_ablation: {name}: the source holds {old!r} {source.count(old)} times",
                  flush=True)
            return None
        source = source.replace(old, new)
    return source


def build_variant(_cuda, name: str, text: str) -> ctypes.CDLL:
    out = _cuda.BUILD_DIR.parent / "flash_ablation"
    out.mkdir(parents=True, exist_ok=True)
    stem = "".join(c if c.isalnum() else "_" for c in name)[:40]
    src, lib = out / f"{stem}.cu", out / f"{stem}.so"
    src.write_text(text)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True, timeout=600)
    so = ctypes.CDLL(str(lib))
    fn = so.repro_flash_attention_bf16
    fn.argtypes = _cuda.SIGNATURES["flash_attention"]["repro_flash_attention_bf16"]
    fn.restype = ctypes.c_int
    return so


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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda, ops, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    source = (_cuda.CSRC / "flash_attention.cu").read_text()
    b, s, h, kv, d = 8, 1024, 16, 8, 128
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, s, kv, d, generator=gen, device="cuda").bfloat16()
    v = torch.randn(b, s, kv, d, generator=gen, device="cuda").bfloat16()
    o = torch.empty_like(q)
    err = float((ops.flash_attention(q, k, v).float() - ref.attention(q, k, v).float())
                .abs().max())
    if err > 2e-2:
        print(f"flash_ablation: the whole kernel is {err} from its plain version", flush=True)
        return 1
    stream = torch.cuda.current_stream().cuda_stream

    def runner(so, causal):
        fn = so.repro_flash_attention_bf16
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, b, s, s, h, kv, d,
                int(causal), -1, 0, float(d ** -0.5), stream)

        def call():
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"launch failed with cudaError_t {rc}")
        return call

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    for causal in (True, False):
        sdpa = time_us(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        print(f"scaled_dot_product_attention, causal {causal}: {sdpa:.2f} us ({card})",
              flush=True)
    variants = {"whole kernel": _cuda.library("flash_attention")}
    for name, edits in ABLATIONS.items():
        text = edited(source, name, edits)
        if text is None:
            return 1
        variants[name] = build_variant(_cuda, name, text)
    for name, so in variants.items():
        times = {c: time_us(runner(so, c)) for c in (True, False)}
        print(f"{name}: causal {times[True]:.2f} us, not causal {times[False]:.2f} us "
              f"(q ({b}, {s}, {h}, {d}), k/v ({b}, {s}, {kv}, {d}) bf16; {card})", flush=True)

    text = edited(source, "trace", TRACE)
    if text is None:
        return 1
    so = build_variant(_cuda, "trace", text + TRACE_READER)
    so.repro_flash_trace.argtypes = (ctypes.c_void_p,)
    counts = (ctypes.c_ulonglong * 20)()
    for causal in (True, False):
        call = runner(so, causal)
        call()
        torch.cuda.synchronize()
        if so.repro_flash_trace(ctypes.addressof(counts)):  # zero the warm-up's counts
            raise RuntimeError("reading the trace failed")
        call()
        torch.cuda.synchronize()
        if so.repro_flash_trace(ctypes.addressof(counts)):
            raise RuntimeError("reading the trace failed")
        for w in range(2):
            row = counts[10 * w:10 * w + 10]
            total = sum(row)
            shares = ", ".join(f"{p} {100 * c / total:.1f}%" for p, c in zip(PHASES, row))
            print(f"trace, causal {causal}, warpgroup {w} (thread {128 * w}): {shares} "
                  f"of {total} cycles ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
