"""Plain-torch models of the order in which two of the port's CUDA kernels
round, for the tests to hold against the JAX package on the CPU
(``test_torch_kernels.py``, ``test_torch_selective_scan.py``) and against
the kernels themselves on the card (``test_torch_cuda_kernels.py``).
Imports torch only."""
import math

import torch


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf, elementwise: a * b + c rounded once to fp32.  In float64 the
    product is exact and the sum's rounding error is known exactly
    (TwoSum); that error decides a float64 sum that lands on the midpoint
    of two fp32 neighbours, where rounding it again would not."""
    a, b, c = (t.to(torch.float64) for t in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    e = (p - (s - bv)) + (c - bv)
    r = s.to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, math.inf)).to(torch.float64)
    down = torch.nextafter(r, torch.full_like(r, -math.inf)).to(torch.float64)
    r64 = r.to(torch.float64)
    lo, hi = torch.where(r64 <= s, r64, down), torch.where(r64 <= s, up, r64)
    tie = (s == (lo + hi) / 2) & (e != 0)
    return torch.where(tie, torch.where(e > 0, hi, lo), r64).to(torch.float32)


def fedavg_one_launch(u: torch.Tensor, w: torch.Tensor, *, normalize: bool = True):
    """``csrc/fedavg_reduce.cu``'s arithmetic: the fp32 weight sum in client
    order (0 -> 1), wn = w / ws, one fmaf chain over the clients from 0,
    rounded to u's dtype; with ``normalize=False`` that mean times ws
    rounded to u's dtype, rounded again."""
    wf = w.to(torch.float32)
    ws = torch.zeros((), dtype=torch.float32, device=w.device)
    for c in range(wf.shape[0]):
        ws = ws + wf[c]
    ws = torch.where(ws == 0, torch.ones_like(ws), ws)
    wn = wf / ws
    acc = torch.zeros(u.shape[1], dtype=torch.float32, device=u.device)
    for c in range(u.shape[0]):
        acc = fma32(wn[c], u[c].to(torch.float32), acc)
    mean = acc.to(u.dtype)
    return mean if normalize else (mean.float() * ws.to(u.dtype).float()).to(u.dtype)


def scan_kernel_order(x, dt, A, Bm, Cm, D, *, init_state=None):
    """``csrc/selective_scan.cu``'s order: the state as the plain version
    rounds it (each product and sum on its own), the states padded with
    zeros to the kernel's bucket N_MAX (8, 16, 32 or 64), and y's sum over
    them as four partial sums -- state j into partial j % 4, in order of j
    -- added as (p0 + p1) + (p2 + p3), then D x added."""
    bsz, s, di = x.shape
    n = A.shape[-1]
    n_max = next(m for m in (8, 16, 32, 64) if n <= m)
    f32 = torch.float32

    def pad(t):
        return torch.nn.functional.pad(t.to(f32), (0, n_max - n))

    a, bm, cm, d = pad(A), pad(Bm), pad(Cm), D.to(f32)
    h = (pad(init_state) if init_state is not None
         else torch.zeros((bsz, di, n_max), dtype=f32, device=x.device))
    y = torch.empty_like(x)
    for t in range(s):
        x_t, dt_t = x[:, t].to(f32), dt[:, t].to(f32)
        h = torch.exp(dt_t[..., None] * a) * h + (dt_t * x_t)[..., None] * bm[:, t, None, :]
        prod = h * cm[:, t, None, :]
        part = [prod[..., r] for r in range(4)]
        for q in range(1, n_max // 4):
            part = [part[r] + prod[..., 4 * q + r] for r in range(4)]
        y[:, t] = (((part[0] + part[1]) + (part[2] + part[3])) + d * x_t).to(x.dtype)
    return y, h[..., :n].contiguous()
