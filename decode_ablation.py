#!/usr/bin/env python3
"""Where the decode attention kernel's time goes, on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 decode_ablation.py

Builds copies of ``src/repro_torch/kernels/csrc/decode_attention.cu``, each
into its own library under ``build/decode_ablation/`` (the source stays as
it is), with parts of the kernel taken out, and times each beside the
whole kernel and scaled_dot_product_attention with CUDA events (median of
30 calls, each after a 512 MB memset that evicts L2) at qwen3-0.6b's
decode shape (B=8, S=2048, H=16, KV=8, D=128, bf16, a linear cache at
position 1040) and at the Jamba slice's head shape (H=64), at the
wrapper's split count.  The whole kernel is also timed at 4 CTAs an SM.
A copy without a part computes something else: only the whole kernel's
output is checked (against the plain version, within 2e-2).

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
_COMPUTE_FROM = "      const int64_t slot = static_cast<int64_t>(list[i]) * kBK + sr;\n"
_COMPUTE_TO = "      }\n    }\n    cp_async_wait<0>();\n"
_NO_COMPUTE = [(_COMPUTE_FROM, _COMPUTE_FROM + "#if 0\n"),
               (_COMPUTE_TO, "      }\n#endif\n    }\n    cp_async_wait<0>();\n")]
_NO_LOADS = [
    ("      if (i + kStages - 1 < n_list) load_tile((i + kStages - 1) % kStages, "
     "list[i + kStages - 1]);\n", ""),
    ("      if (st < n_list) load_tile(st, list[st]);\n", ""),
]
# name -> (text in the source, its replacement), applied in turn
ABLATIONS = {
    "no arithmetic (cache copies, waits and barriers)": _NO_COMPUTE,
    "no cache reads (arithmetic on whatever the ring holds)": _NO_LOADS,
    "neither (launch, mask passes, barriers, partials, combine)": _NO_COMPUTE + _NO_LOADS,
    "no combine kernel": [
        ("  cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attention_combine_kernel<T>,",
         "  cudaError_t err = cudaSuccess;\n"
         "  if (0) err = cudaLaunchKernelEx(&cfg, decode_attention_combine_kernel<T>,")],
    "every tile read (no mask passes: twice the bytes)": [
        ("  for (int64_t t0 = 0; t0 < tiles; t0 += kThreads) {\n"
         "    const int64_t t = t0 + tid;\n"
         "    const bool f = t < tiles && tile_has_valid<kBK>(vrow, t, s);\n",
         "  for (int64_t t0 = 0; t0 < 0; t0 += kThreads) {\n"
         "    const int64_t t = t0 + tid;\n"
         "    const bool f = t < tiles && tile_has_valid<kBK>(vrow, t, s);\n")],
}


def edited(source: str, name: str, edits) -> str | None:
    for old, new in edits:
        if source.count(old) != 1:
            print(f"decode_ablation: {name}: the source holds {old!r} {source.count(old)} times",
                  flush=True)
            return None
        source = source.replace(old, new)
    return source


def build_variant(_cuda, name: str, text: str) -> ctypes.CDLL:
    out = _cuda.BUILD_DIR.parent / "decode_ablation"
    out.mkdir(parents=True, exist_ok=True)
    stem = "".join(c if c.isalnum() else "_" for c in name)[:40]
    src, lib = out / f"{stem}.cu", out / f"{stem}.so"
    src.write_text(text)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True, timeout=600)
    so = ctypes.CDLL(str(lib))
    fn = so.repro_decode_attention_bf16
    fn.argtypes = _cuda.SIGNATURES["decode_attention"]["repro_decode_attention_bf16"]
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
        print("decode_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.kernels import decode_attention as dk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    source = (_cuda.CSRC / "decode_attention.cu").read_text()
    variants = {"whole kernel": _cuda.library("decode_attention")}
    for name, edits in ABLATIONS.items():
        text = edited(source, name, edits)
        if text is None:
            return 1
        variants[name] = build_variant(_cuda, name, text)

    b, s, kv, d, pos = 8, 2048, 8, 128, 1040
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    stream = torch.cuda.current_stream().cuda_stream
    valid = (torch.arange(s, device="cuda") <= pos)[None].expand(b, s).contiguous()
    kc = torch.randn(b, s, kv, d, generator=gen, device="cuda").bfloat16()
    vc = torch.randn(b, s, kv, d, generator=gen, device="cuda").bfloat16()
    times: dict[str, dict[str, float]] = {name: {} for name in variants}
    for shape, h in (("qwen3", 16), ("Jamba head shape", 64)):
        q = torch.randn(b, h, d, generator=gen, device="cuda").bfloat16()
        err = float((ops.decode_attention(q, kc, vc, kv_valid=valid).float()
                     - ref.decode_attention(q, kc, vc, kv_valid=valid).float()).abs().max())
        if err > 2e-2:
            print(f"decode_ablation: the whole kernel is {err} from its plain version", flush=True)
            return 1
        splits = dk.default_splits(b, kv, -(-s // dk.tile_slots(128, 2)), sms)
        o = torch.empty_like(q)
        ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32, device="cuda")
        for name, so in variants.items():
            fn = so.repro_decode_attention_bf16
            args = (q.data_ptr(), kc.data_ptr(), vc.data_ptr(), valid.data_ptr(), o.data_ptr(),
                    ws.data_ptr(), b, s, h, kv, d, splits, ws.numel(), float(d ** -0.5), stream)

            def call(fn=fn, args=args):
                rc = fn(*args)
                if rc:
                    raise RuntimeError(f"launch failed with cudaError_t {rc}")
            times[name][shape] = time_us(call)
        splits4 = -(-4 * sms // (b * kv))
        times.setdefault(f"whole kernel at {splits4} splits (4 CTAs an SM)", {})[shape] = time_us(
            lambda: dk.decode_attention(q, kc, vc, kv_valid=valid, splits=splits4))
        qt, kt, vt = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        times.setdefault("scaled_dot_product_attention", {})[shape] = time_us(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=valid[:, None, None, :], enable_gqa=True))
    for name, t in times.items():
        print(f"{name}: qwen3 {t['qwen3']:.2f} us, Jamba head shape {t['Jamba head shape']:.2f} "
              f"us (q (8, 16 or 64, 128), caches ({b}, {s}, {kv}, {d}) bf16, {pos + 1} valid "
              f"slots, {splits} splits; {card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
