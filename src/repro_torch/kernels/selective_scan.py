"""Mamba selective scan on the card (``csrc/selective_scan.cu``).

The twin of ``repro.kernels.selective_scan``: x, dt (B,S,Di); A (Di,N);
B, C (B,S,N); D (Di,); an optional initial state (B,Di,N) -> (y (B,S,Di)
in x's dtype, final state (B,Di,N) fp32).  x is fp32 or bf16; the rest is
cast to fp32 here, as the Pallas body casts each tile.  Unlike the TPU
dispatch, any B, S, Di >= 1 run (the ragged tails are written), with N up
to 64.  CUDA tensors only; ``ops`` routes CPU tensors to ``ref``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._cuda import launch

_ENTRY = {
    torch.float32: "repro_selective_scan_f32",
    torch.bfloat16: "repro_selective_scan_bf16",
}
MAX_N = 64  # the states a thread keeps in registers (the Pallas kernel's VMEM_ASSUMES["n"])
N_BUCKETS = (8, 16, 32, MAX_N)  # the kernel's N_MAX builds; B and C rows are padded to one
ROW_ALIGN = 8  # x and dt rows are padded to a multiple of this many elements


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, D: torch.Tensor, *,
                   init_state: torch.Tensor | None = None):
    dev = x.device
    if x.dtype not in _ENTRY:
        raise TypeError(f"x has dtype {x.dtype}, expected one of {tuple(_ENTRY)}")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"selective_scan takes x (B,S,Di) and A (Di,N); got "
                         f"{tuple(x.shape)} and {tuple(A.shape)}")
    b, s, di = x.shape
    n = A.shape[1]
    want = {"dt": (dt, (b, s, di)), "A": (A, (di, n)), "Bm": (Bm, (b, s, n)),
            "Cm": (Cm, (b, s, n)), "D": (D, (di,))}
    if init_state is not None:
        want["init_state"] = (init_state, (b, di, n))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != dev:
            raise ValueError(f"selective_scan: {name} is on {t.device}, x on {dev}")
    if min(b, s, di) < 1 or not 1 <= n <= MAX_N or b > 65535:
        raise ValueError(f"selective_scan's kernel takes B, S, Di >= 1, 1 <= N <= {MAX_N} "
                         f"and B <= 65535; got B={b}, S={s}, Di={di}, N={n}")
    if dev.type != "cuda":
        raise ValueError(f"selective_scan's kernel takes CUDA tensors, got {dev}")
    f32 = {name: t.to(torch.float32).contiguous() for name, (t, _) in want.items()}
    h0 = f32.get("init_state")
    y = torch.empty((b, s, di), dtype=x.dtype, device=dev)
    h_out = torch.empty((b, di, n), dtype=torch.float32, device=dev)
    # the kernel streams rows 16 bytes at a time: x and dt padded to ld, a
    # multiple of 8 columns, B and C to the state bucket N_MAX with zeros,
    # and every streamed tensor starting 16-byte aligned
    ld = -(-di // ROW_ALIGN) * ROW_ALIGN
    n_max = next(m for m in N_BUCKETS if n <= m)
    xk, dtk = (F.pad(t, (0, ld - di)) if ld != di else t.contiguous() for t in (x, f32["dt"]))
    bk, ck = (F.pad(t, (0, n_max - n)) if n_max != n else t for t in (f32["Bm"], f32["Cm"]))
    xk, dtk, bk, ck = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (xk, dtk, bk, ck))
    launch("selective_scan", _ENTRY[x.dtype], "selective_scan", dev,
           xk.data_ptr(), dtk.data_ptr(), f32["A"].data_ptr(), bk.data_ptr(), ck.data_ptr(),
           f32["D"].data_ptr(), None if h0 is None else h0.data_ptr(),
           y.data_ptr(), h_out.data_ptr(), b, s, di, n, ld)
    return y, h_out
