"""Mamba selective scan on the card (``csrc/selective_scan.cu``).

The twin of ``repro.kernels.selective_scan``: x, dt (B,S,Di); A (Di,N);
B, C (B,S,N); D (Di,); an optional initial state (B,Di,N) -> (y (B,S,Di)
in x's dtype, final state (B,Di,N) fp32).  x is fp32 or bf16; the rest is
cast to fp32 here, as the Pallas body casts each tile.  Unlike the TPU
dispatch, any B, S, Di >= 1 run (the ragged tails are written), with N up
to 64.  With ``groups`` G, A is (G,Di,N) and D (G,Di), and batch row b
reads group b // (B / G): a vmapped cohort of G clients folded into B.

Training runs ``selective_scan_fwd``, which also writes the state every
``CHECKPOINT_EVERY`` steps, and ``selective_scan_bwd``, the hand-written
backward that recomputes the states from those checkpoints (the JAX
package has no backward kernel: it differentiates its oracle).  CUDA
tensors only; ``ops`` routes CPU tensors to ``ref``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._cuda import launch

_ENTRY = {
    torch.float32: "repro_selective_scan_f32",
    torch.bfloat16: "repro_selective_scan_bf16",
}
_BWD_ENTRY = {
    torch.float32: "repro_selective_scan_bwd_f32",
    torch.bfloat16: "repro_selective_scan_bwd_bf16",
}
MAX_N = 64  # the states a thread keeps in registers (the Pallas kernel's VMEM_ASSUMES["n"])
N_BUCKETS = (8, 16, 32, MAX_N)  # the kernel's N_MAX builds; B and C rows are padded to one
ROW_ALIGN = 8  # x and dt rows are padded to a multiple of this many elements
CHECKPOINT_EVERY = 8  # the kernel's kSeg: steps between the states the forward keeps


def bwd_channels(n: int) -> int:
    """Channels a backward block takes: 512 threads, 4 of a channel's
    states a thread (so N_MAX / 4 threads a channel: 256 channels at N <= 8,
    128 at N <= 16, 64 at N <= 32, 32 at N <= 64)."""
    n_max = next(m for m in N_BUCKETS if n <= m)
    return 512 // (n_max // 4)


def _check(x, dt, A, Bm, Cm, D, init_state, groups, extra=()):
    """Raise on what the kernels do not take -> (B, S, Di, N).  A and D are
    (Di, N) and (Di,) at one group, else (G, Di, N) and (G, Di)."""
    dev = x.device
    if x.dtype not in _ENTRY:
        raise TypeError(f"x has dtype {x.dtype}, expected one of {tuple(_ENTRY)}")
    if x.dim() != 3 or A.dim() not in (2, 3) or (A.dim() == 2 and groups != 1):
        raise ValueError(f"selective_scan takes x (B,S,Di) and A (Di,N), or (G,Di,N) with "
                         f"groups=G; got {tuple(x.shape)}, {tuple(A.shape)} and "
                         f"groups={groups}")
    b, s, di = x.shape
    n = A.shape[-1]
    g = groups
    want = {"dt": (dt, (b, s, di)), "A": (A, (di, n) if A.dim() == 2 else (g, di, n)),
            "Bm": (Bm, (b, s, n)), "Cm": (Cm, (b, s, n)),
            "D": (D, (di,) if A.dim() == 2 else (g, di))}
    if init_state is not None:
        want["init_state"] = (init_state, (b, di, n))
    want.update(extra)
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"selective_scan: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.device != dev:
            raise ValueError(f"selective_scan: {name} is on {t.device}, x on {dev}")
    if min(b, s, di) < 1 or not 1 <= n <= MAX_N or b > 65535 or g < 1 or b % g:
        raise ValueError(f"selective_scan's kernel takes B, S, Di >= 1, 1 <= N <= {MAX_N}, "
                         f"B <= 65535 and groups dividing B; got B={b}, S={s}, Di={di}, N={n}, "
                         f"groups={g}")
    if dev.type != "cuda":
        raise ValueError(f"selective_scan's kernel takes CUDA tensors, got {dev}")
    return b, s, di, n


def _streamed(x, dt, Bm, Cm, di, n):
    """The kernels stream rows 16 bytes at a time: x and dt padded to ld, a
    multiple of 8 columns, B and C to the state bucket N_MAX with zeros,
    and every streamed tensor starting 16-byte aligned."""
    ld = -(-di // ROW_ALIGN) * ROW_ALIGN
    n_max = next(m for m in N_BUCKETS if n <= m)
    xk, dtk = (F.pad(t, (0, ld - di)) if ld != di else t.contiguous() for t in (x, dt))
    bk, ck = (F.pad(t, (0, n_max - n)) if n_max != n else t for t in (Bm, Cm))
    return (*(t if t.data_ptr() % 16 == 0 else t.clone() for t in (xk, dtk, bk, ck)), ld)


def _forward(x, dt, A, Bm, Cm, D, init_state, groups, keep: bool):
    dev = x.device
    b, s, di, n = _check(x, dt, A, Bm, Cm, D, init_state, groups)
    f32 = {name: t.to(torch.float32).contiguous() for name, t in
           (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("D", D))}
    h0 = None if init_state is None else init_state.to(torch.float32).contiguous()
    y = torch.empty((b, s, di), dtype=x.dtype, device=dev)
    h_out = torch.empty((b, di, n), dtype=torch.float32, device=dev)
    ckpt = (torch.empty((b, -(-s // CHECKPOINT_EVERY), n, di), dtype=torch.float32,
                        device=dev) if keep else None)
    xk, dtk, bk, ck, ld = _streamed(x, f32["dt"], f32["Bm"], f32["Cm"], di, n)
    launch("selective_scan", _ENTRY[x.dtype], "selective_scan", dev,
           xk.data_ptr(), dtk.data_ptr(), f32["A"].data_ptr(), bk.data_ptr(), ck.data_ptr(),
           f32["D"].data_ptr(), None if h0 is None else h0.data_ptr(),
           y.data_ptr(), h_out.data_ptr(), None if ckpt is None else ckpt.data_ptr(),
           b, s, di, n, ld, groups)
    return y, h_out, ckpt


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, D: torch.Tensor, *,
                   init_state: torch.Tensor | None = None, groups: int = 1):
    """-> (y, final state): the serving forward, which keeps no checkpoint."""
    return _forward(x, dt, A, Bm, Cm, D, init_state, groups, keep=False)[:2]


def selective_scan_fwd(x, dt, A, Bm, Cm, D, *, init_state=None, groups: int = 1):
    """-> (y, final state, checkpoints (B, ceil(S / 8), N, Di) fp32): the
    training forward, the same launch writing the state entering every
    8th step for ``selective_scan_bwd`` (N before Di: a warp's stores and
    loads of one state are neighbours)."""
    return _forward(x, dt, A, Bm, Cm, D, init_state, groups, keep=True)


def selective_scan_bwd(x, dt, A, Bm, Cm, D, ckpt, dy, *, init_state=None, dh_final=None,
                       groups: int = 1):
    """The backward from ``selective_scan_fwd``'s checkpoints: dy (B,S,Di)
    in x's dtype and the final state's cotangent ``dh_final`` (B,Di,N) or
    None -> (dx in x's dtype, ddt, dA, dB, dC, dD, dh0 or None), all but dx
    fp32, dA and dD in A's and D's shapes (each group's rows summed).  One
    launch of the backward kernel and of its fixed-order sums; no atomics,
    so two calls are bitwise equal."""
    dev = x.device
    bsd = tuple(x.shape)
    b, s, di, n = _check(x, dt, A, Bm, Cm, D, init_state, groups, extra={
        "dy": (dy, bsd), "ckpt": (ckpt, (bsd[0], -(-bsd[1] // CHECKPOINT_EVERY), A.shape[-1],
                                          bsd[2]))})
    if dh_final is not None and (tuple(dh_final.shape) != (b, di, n) or dh_final.device != dev):
        raise ValueError(f"selective_scan_bwd: dh_final {tuple(dh_final.shape)} on "
                         f"{dh_final.device}, expected {(b, di, n)} on {dev}")
    if dy.dtype != x.dtype or ckpt.dtype != torch.float32:
        raise TypeError(f"selective_scan_bwd: dy {dy.dtype} and ckpt {ckpt.dtype}, expected "
                        f"{x.dtype} and torch.float32")
    f32 = {name: t.to(torch.float32).contiguous() for name, t in
           (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("D", D))}
    dhf = None if dh_final is None else dh_final.to(torch.float32).contiguous()
    xk, dtk, bk, ck, ld = _streamed(x, f32["dt"], f32["Bm"], f32["Cm"], di, n)
    dyk = F.pad(dy, (0, ld - di)) if ld != di else dy.contiguous()
    ckpt = ckpt.contiguous()
    blocks = -(-di // bwd_channels(n))
    n_max = next(m for m in N_BUCKETS if n <= m)
    dx = torch.empty((b, s, di), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, di), dtype=torch.float32, device=dev)
    dbm = torch.empty((b, s, n), dtype=torch.float32, device=dev)
    dcm = torch.empty_like(dbm)
    da = torch.empty(A.shape, dtype=torch.float32, device=dev)
    dd = torch.empty(D.shape, dtype=torch.float32, device=dev)
    dh0 = None if init_state is None else torch.empty((b, di, n), dtype=torch.float32,
                                                      device=dev)
    part = torch.empty((blocks, b, s, 2, n_max), dtype=torch.float32, device=dev)
    arow = torch.empty((b, di, n), dtype=torch.float32, device=dev)
    drow = torch.empty((b, di), dtype=torch.float32, device=dev)
    launch("selective_scan", _BWD_ENTRY[x.dtype], "selective_scan_bwd", dev,
           xk.data_ptr(), dtk.data_ptr(), f32["A"].data_ptr(), bk.data_ptr(), ck.data_ptr(),
           f32["D"].data_ptr(), dyk.data_ptr(), ckpt.data_ptr(),
           None if dhf is None else dhf.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
           dbm.data_ptr(), dcm.data_ptr(), da.data_ptr(), dd.data_ptr(),
           None if dh0 is None else dh0.data_ptr(), part.data_ptr(), arow.data_ptr(),
           drow.data_ptr(), b, s, di, n, ld, groups, blocks)
    return dx, ddt, da, dbm, dcm, dd, dh0
