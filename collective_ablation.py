#!/usr/bin/env python3
"""Design trials of the int8 mesh collective's kernels
(``collective_absmax``, ``collective_pack``, ``collective_unpack``), on one
NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 collective_ablation.py [--parent DIR]

Builds copies of ``src/repro_torch/kernels/csrc/collective_quant.cu``,
each into its own library under ``build/collective_ablation/`` (the source
stays as it is; one nvcc a copy, all started together), with one design
choice changed, and times each variant's three bare launches beside the
kernels as they are with CUDA events (median of 30 calls) at the head
model's five leaves as the mesh round step hands them over: views of one
flat decode at JAX's leaf offsets (head.w1 and head.w2 start 12 bytes past
a 16-byte boundary), residual rows in one flat buffer, a weight, no mask.
Every variant computes the same function, so its outputs are checked
bitwise against the kernels as they are.  Every time is taken twice: after
a 512 MB memset before each call (the eviction ``chip_smoke.py`` uses,
which leaves L2 full of dirty lines that the timed call must write back)
and after a 512 MB read (L2 full of clean lines).  Beside them: the same
leaves as separate 16-byte-aligned tensors (every load 16 B a lane), a
read of the absmax's input bytes (``torch.amax`` of a flat buffer of that
size) and a device copy of each other kernel's bytes (half read, half
written); and, with ``--parent DIR`` (an unpacked earlier tree of this
repository whose collective kernels take one vector and the scales), that
tree's per-leaf composition (its ``CompressedPsum.psum`` once a leaf: ~50
eager ops around its kernels) against this tree's three launches, in turns
(earlier, this, this, earlier), checked bitwise against each other.

Prints one line per variant and eviction with its ptxas registers and
spills and the card's name and power limit.
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
# the head model's leaves in JAX's order: base.w, head.b1, head.b2, head.w1, head.w2
SIZES = (1_638_400, 256, 31, 327_680, 7_936)
KERNELS = ("collective_absmax", "collective_pack", "collective_unpack")

_LOAD4 = """\
  if (left >= 4) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0)
      return __ldg(reinterpret_cast<const float4*>(p + i));
    return make_float4(__ldg(p + i), __ldg(p + i + 1), __ldg(p + i + 2), __ldg(p + i + 3));
  }"""
_LOAD4_CS = _LOAD4.replace("__ldg(", "__ldcs(")
_GRID = "  return grid < cap ? grid : cap;\n"
_THREADS = "constexpr int kThreads = 256;"

# name -> [(text in the source, its replacement), ...]
ABLATIONS = {
    "values and residuals loaded evict-first (__ldcs)": [(_LOAD4, _LOAD4_CS)],
    "grid not capped at the resident CTAs": [(_GRID, "  return grid;\n")],
    "128-thread CTAs": [(_THREADS, "constexpr int kThreads = 128;")],
}


def edited(source: str, name: str, edits) -> str | None:
    for old, new in edits:
        if source.count(old) != 1:
            print(f"collective_ablation: {name}: the source holds {old!r} "
                  f"{source.count(old)} times", flush=True)
            return None
        source = source.replace(old, new)
    return source


def ptxas(log: str) -> str:
    """ptxas' registers and spills per kernel."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in KERNELS if f"{k}_kernel" in line), None)
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out.append(f"{name} {m[1]} registers")
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            out.append(f"{name} {m[1]}/{m[2]} bytes spilled")
    return ", ".join(out)


def build_variants(_cuda, texts: dict[str, str], signatures: dict[str, dict]):
    """One nvcc a source, all started together; each library with its entry
    points' argument types set, and ptxas' report."""
    out = _cuda.BUILD_DIR.parent / "collective_ablation"
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
            raise RuntimeError(f"collective_ablation: {name} did not build:\n{log}")
        dll = ctypes.CDLL(str(lib))
        for fn_name, argtypes in signatures[name].items():
            fn = getattr(dll, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        built[name] = (dll, ptxas(log))
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


def leaf_inputs(rng):
    """The leaves (views of one flat decode at JAX's offsets), residual rows
    (views of one flat buffer at their first blocks) and the weight."""
    from repro_torch.kernels.collective_quant import first_blocks

    n = sum(SIZES)
    flat = torch.from_numpy((rng.normal(size=n) * 1e-3).astype(np.float32)).cuda()
    ds = list(torch.split(flat, SIZES))
    starts = first_blocks(SIZES)
    r_flat = torch.from_numpy((rng.normal(size=starts[-1] * BLOCK) * 1e-6).astype(np.float32))
    r_flat = r_flat.cuda()
    rs = [r_flat[BLOCK * b:BLOCK * b + k] for b, k in zip(starts, SIZES)]
    return ds, rs, torch.full((1,), 123.0, device="cuda")


def launches(dll, ds, rs, wf, outs):
    """The three bare launches of library ``dll`` on the leaves, into
    ``outs`` (absmax, codes, scales, residuals, totals)."""
    from repro_torch.kernels.collective_quant import _table

    table, nb = _table(ds, rs)
    am, q, s, r, t = outs
    return {
        "collective_absmax": checked(dll.repro_collective_absmax, table, len(ds), wf.data_ptr(),
                                     None, am.data_ptr(), nb),
        "collective_pack": checked(dll.repro_collective_pack, table, len(ds), wf.data_ptr(),
                                   None, am.data_ptr(), 1, q.data_ptr(), s.data_ptr(),
                                   r.data_ptr(), nb),
        "collective_unpack": checked(dll.repro_collective_unpack, q.data_ptr(), s.data_ptr(),
                                     t.data_ptr(), nb),
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an unpacked earlier tree whose collective_quant.cu is timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("collective_ablation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    from repro_torch.kernels import _cuda, ops
    from torch_kernel_models import collective_per_leaf

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    source = (_cuda.CSRC / "collective_quant.cu").read_text()
    texts = {name: edited(source, name, edits) for name, edits in ABLATIONS.items()}
    if None in texts.values():
        return 1
    signatures = dict.fromkeys(texts, _cuda.SIGNATURES["collective_quant"])
    parent = "the earlier tree's kernels"
    if args.parent is not None:  # one vector and its scales a call
        texts[parent] = (args.parent / "src/repro_torch/kernels/csrc/collective_quant.cu").read_text()
        signatures[parent] = {name: (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_void_p)
                              for name in ("repro_collective_pack", "repro_collective_unpack")}
    this = (_cuda.library("collective_quant"), ptxas(_cuda.build_log("collective_quant")))
    variants = {"as it is": this, **build_variants(_cuda, texts, signatures)}

    rng = np.random.default_rng(22)
    ds, rs, wf = leaf_inputs(rng)
    nb = ops.first_blocks(SIZES)[-1]
    absmax = ops.collective_absmax(ds, wf, rs)
    want = (absmax, *ops.collective_pack_leaves(ds, wf, rs, absmax))
    want = (*want, ops.collective_unpack(want[1], want[2]))

    def outs():
        return (torch.empty(nb, device="cuda"), torch.empty(nb * BLOCK, dtype=torch.int32,
                                                            device="cuda"),
                torch.empty(nb, device="cuda"), torch.empty(nb * BLOCK, device="cuda"),
                torch.empty(nb * BLOCK, device="cuda"))

    def same(got) -> bool:
        return all(torch.equal(a, b) for a, b in zip(got, want, strict=True))

    # each input read once and each output written once
    nbytes = {"collective_absmax": 8 * sum(SIZES) + 4 + 4 * nb,
              "collective_pack": 8 * sum(SIZES) + 4 + 8 * nb + 8 * nb * BLOCK,
              "collective_unpack": 8 * nb * BLOCK + 4 * nb}
    floor = {"collective_absmax": ("a read of the same bytes (torch.amax)",
                                   torch.empty(nbytes["collective_absmax"] // 4, device="cuda"))}
    for name in ("collective_pack", "collective_unpack"):
        src = torch.empty(nbytes[name] // 2, dtype=torch.uint8, device="cuda")
        floor[name] = ("a device copy of the same bytes", (src, torch.empty_like(src)))
    failed = False
    for name in KERNELS:
        label, t = floor[name]
        call = (lambda t=t: torch.amax(t)) if name == "collective_absmax" else (
            lambda t=t: t[1].copy_(t[0]))
        times = " / ".join(f"{time_us(call, ev):.2f}" for ev in ("memset", "read"))
        print(f"[{name}, {nbytes[name] / 1e6:.2f} MB] {label}: {times} us (memset / read "
              f"eviction) ({card})", flush=True)
    for aligned in (False, True):
        if aligned:
            ds = [d.clone() for d in ds]
        for vname, (dll, regs) in variants.items():
            if vname == parent:
                continue
            o = outs()
            calls = launches(dll, ds, rs, wf, o)
            for call in calls.values():
                call()
            torch.cuda.synchronize()
            ok = same(o)
            failed |= not ok
            where = "every leaf 16-byte aligned" if aligned else "head.w1, head.w2 unaligned"
            for name, call in calls.items():
                times = " / ".join(f"{time_us(call, ev):.2f}" for ev in ("memset", "read"))
                print(f"[{name}, {where}] {vname}: bare launch {times} us (memset / read "
                      f"eviction), bitwise {ok} ({regs}; {card})", flush=True)
            if aligned:
                break  # the layout alone, the kernels as they are
    if args.parent is None:
        return 1 if failed else 0

    dll = variants[parent][0]

    def earlier(fn_name, out_dtype):
        def call(x, s):
            o = torch.empty(x.shape[0], dtype=out_dtype, device="cuda")
            checked(getattr(dll, fn_name), x.data_ptr(), s.data_ptr(), o.data_ptr(),
                    x.shape[0] // BLOCK)()
            return o
        return call

    pack = earlier("repro_collective_pack", torch.int32)
    unpack = earlier("repro_collective_unpack", torch.float32)
    ds, rs, wf = leaf_inputs(rng)

    def earlier_path():
        """The earlier tree's per-leaf psum: its round step's call, leaf by leaf."""
        return collective_per_leaf(ds, wf, rs, None, pack, unpack)

    def this_path():
        a = ops.collective_absmax(ds, wf, rs)
        q, s, r = ops.collective_pack_leaves(ds, wf, rs, a)
        return a, q, s, r, ops.collective_unpack(q, s)

    got_e, (a, q, s, r, t) = earlier_path(), this_path()
    starts = ops.first_blocks(SIZES)
    ok = all(torch.equal(a[i:j], am) and torch.equal(s[i:j], sc)
             and torch.equal(q[BLOCK * i:BLOCK * j], code)
             and torch.equal(t[BLOCK * i:BLOCK * i + n], tot)
             and torch.equal(r[BLOCK * i:BLOCK * i + n], row)
             for (am, sc, code, tot, row), i, j, n in zip(got_e, starts, starts[1:], SIZES))
    failed |= not ok
    for ev in ("memset", "read"):
        times = [time_us(earlier_path, ev), time_us(this_path, ev), time_us(this_path, ev),
                 time_us(earlier_path, ev)]
        print(f"[the head model's 5 leaves, {ev}] the earlier tree's per-leaf psum composition "
              f"{times[0]:.2f} / {times[3]:.2f} us, this tree's three launches {times[1]:.2f} / "
              f"{times[2]:.2f} us (earlier, this, this, earlier), bitwise {ok} ({card})",
              flush=True)
    for n, leaf in ((SIZES[0], "base.w"), (nb * BLOCK, "Np")):
        x = torch.from_numpy((rng.normal(size=n) * 1e-3).astype(np.float32)).cuda()
        am = x.abs().reshape(-1, BLOCK).amax(dim=1)
        sc = torch.where(am == 0, torch.ones_like(am), am / torch.full_like(am, 127.0))
        codes = ops.collective_pack(x, sc)
        pairs = {"pack": (lambda: pack(x, sc), lambda: ops.collective_pack(x, sc)),
                 "unpack": (lambda: unpack(codes, sc), lambda: ops.collective_unpack(codes, sc))}
        for kname, (e_call, t_call) in pairs.items():
            same_out = torch.equal(e_call(), t_call())
            failed |= not same_out
            times = [time_us(e_call, "memset"), time_us(t_call, "memset"),
                     time_us(t_call, "memset"), time_us(e_call, "memset")]
            print(f"[single-vector {kname}, {leaf}, memset] the earlier tree's {times[0]:.2f} / "
                  f"{times[3]:.2f} us, this tree's {times[1]:.2f} / {times[2]:.2f} us (earlier, "
                  f"this, this, earlier; through the wrappers), bitwise {same_out} ({card})",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
