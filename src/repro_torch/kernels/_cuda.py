"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under ``build/`` at the
repository root, on first use, and loaded with ``ctypes``: seconds per
file, against minutes for a source that includes PyTorch's headers.  The
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and never confused with a stale library.

``--use_fast_math`` stays off: the Int8 codes are bitwise the plain
version's only with IEEE division, and the attention kernels' softmax
and the selective scan use ``expf``, not the approximate ``__expf``.

Nothing here runs at import: CPU-only machines import every module, and
``nvcc`` is needed only when a CUDA tensor arrives.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# library -> {C entry point: argtypes}; every entry point returns the
# cudaError_t of its launch (or query) as an int
SIGNATURES = {
    "fedavg_reduce": {
        "repro_fedavg_reduce_f32": (_P, _P, _P, _I64, _I64, _I64, _P),
        "repro_fedavg_reduce_bf16": (_P, _P, _P, _I64, _I64, _I64, _P),
    },
    "quantize": {
        "repro_quantize_int8": (_P, _P, _P, _I64, _I64, _P),
        "repro_dequantize_int8": (_P, _P, _P, _I64, _P),
    },
    "dequant_reduce": {
        "repro_dequant_reduce": (_P, _P, _P, _P, _I64, _I64, _I64, _P),
    },
    "topk_scatter_reduce": {
        "repro_topk_scatter_reduce": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P),
    },
    "collective_quant": {
        "repro_collective_absmax": (_P, _I64, _P, _P, _P, _I64, _P),
        "repro_collective_pack": (_P, _I64, _P, _P, _P, _I64, _P, _P, _P, _I64, _P),
        "repro_collective_unpack": (_P, _P, _P, _I64, _P),
    },
    "flash_attention": {
        "repro_flash_attention_f32": (*(_P,) * 5, *(_I64,) * 9, _F, _P),
        "repro_flash_attention_bf16": (*(_P,) * 5, *(_I64,) * 9, _F, _P),
        "repro_flash_attention_bwd_f32": (*(_P,) * 10, *(_I64,) * 9, _F, _P),
        "repro_flash_attention_bwd_bf16": (*(_P,) * 10, *(_I64,) * 9, _F, _P),
        "repro_flash_attention_bwd_bf16_parts": (*(_P,) * 10, *(_I64,) * 9, _F, _I64, _P),
    },
    "decode_attention": {
        "repro_decode_attention_f32": (*(_P,) * 6, *(_I64,) * 7, _F, _P),
        "repro_decode_attention_bf16": (*(_P,) * 6, *(_I64,) * 7, _F, _P),
    },
    "selective_scan": {
        "repro_selective_scan_f32": (*(_P,) * 10, *(_I64,) * 6, _P),
        "repro_selective_scan_bf16": (*(_P,) * 10, *(_I64,) * 6, _P),
        "repro_selective_scan_bwd_f32": (*(_P,) * 19, *(_I64,) * 7, _P),
        "repro_selective_scan_bwd_bf16": (*(_P,) * 19, *(_I64,) * 7, _P),
        "repro_selective_scan_bwd_blocks_per_sm": (_I64, _I64, ctypes.POINTER(_I64)),
    },
}

# launches per kernel wrapper: each wrapper adds one where it launches its
# kernel and nowhere else (read through ops.launch_counts)
LAUNCHES = {
    "fedavg_reduce": 0, "quantize_int8": 0, "dequantize_int8": 0,
    "dequant_reduce": 0, "topk_scatter_reduce": 0,
    "collective_absmax": 0, "collective_pack": 0, "collective_unpack": 0,
    "flash_attention": 0, "flash_attention_bwd": 0, "decode_attention": 0,
    "selective_scan": 0, "selective_scan_bwd": 0,
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, dict]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns, per library
    compiled here, its build seconds and nvcc's output (``-Xptxas=-v``:
    registers, shared memory, spills), which also stays beside the library
    (``build_log``).  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, out, time.perf_counter())
    report, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)  # before the library: a reader finds both
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
        report[name] = {"seconds": seconds, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def build_log(name: str) -> str:
    """nvcc's output for the built library ``name`` (ptxas' registers,
    shared memory and spills per kernel), kept beside it."""
    return library_path(name).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def launch(lib_name: str, fn_name: str, counter: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device``'s current stream; raise on a
    refused launch; count it."""
    fn = getattr(library(lib_name), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with cudaError_t {rc}")
    LAUNCHES[counter] += 1


def check_tensor(t: torch.Tensor, name: str, *, device, dtypes, ndim: int,
                 align: int = 0) -> None:
    """Raise on what a kernel does not take: another device, dtype or rank,
    a non-contiguous layout, or (for vector loads) a misaligned start."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if align and t.data_ptr() % align:
        raise ValueError(f"{name} must start {align}-byte aligned")
