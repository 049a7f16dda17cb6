"""int8 pack/unpack of the compressed mesh collective on the card
(``csrc/collective_quant.cu``).

The twin of ``repro.kernels.collective_quant``: ``collective_pack`` is
clip(round_half_even(x / scale), +-127) per 256-block against a scale
that is an INPUT (agreed across the reducing ranks), in an int32
container, the all-reduce's accumulator type; ``collective_unpack`` is
code * scale per block, for one rank's codes or their sum over ranks.
Any N % 256 == 0 is taken (the JAX dispatch's extra ``N % 1024`` gate,
``repro/kernels/ops.py:207,218``, is a TPU tiling quirk).

The round step's collective runs over every model leaf at once:
``collective_absmax`` and ``collective_pack_leaves`` take a list of leaves
(each (n_i,) fp32, contiguous, any 4-byte start) with their residuals,
the rank's weight and whether it takes part, and lay the leaves out in
flat buffers, leaf i from slot ``256 * first_block(sizes)[i]``; the
summed codes go through the one ``collective_unpack``.  The leaf table
travels as a kernel parameter (at most ``MAX_LEAVES`` leaves).

These wrappers take CUDA tensors only; ``ops`` routes CPU tensors to
``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda import check_tensor, launch

BLOCK = 256
MAX_LEAVES = 96  # csrc/collective_quant.cu's kMaxLeaves


def first_blocks(sizes) -> list[int]:
    """Leaf i's first block in the flat buffers, and the total blocks last:
    each leaf padded to a block multiple."""
    out = [0]
    for n in sizes:
        out.append(out[-1] + -(-int(n) // BLOCK))
    return out


def _check(vals: torch.Tensor, name: str, dtype, scales: torch.Tensor) -> int:
    dev = vals.device
    check_tensor(vals, name, device=dev, dtypes=(dtype,), ndim=1, align=16)
    check_tensor(scales, "scales", device=dev, dtypes=(torch.float32,), ndim=1)
    n = vals.shape[0]
    if dev.type != "cuda" or n % BLOCK or scales.shape[0] != n // BLOCK:
        raise ValueError(
            f"the collective kernels take a CUDA (N,) {name} with N % {BLOCK} == 0 "
            f"and N/{BLOCK} scales, got {n} and {scales.shape[0]}"
        )
    return n


def _table(ds, rs):
    """The C entry points' leaf table, (leaves, 3) int64 rows on the host:
    values pointer, residual pointer (0: none), length.  Returns it and the
    total blocks."""
    if not ds or len(ds) > MAX_LEAVES:
        raise ValueError(f"the collective kernels take 1 to {MAX_LEAVES} leaves, got {len(ds)}")
    if rs is not None and len(rs) != len(ds):
        raise ValueError(f"{len(ds)} leaves but {len(rs)} residuals")
    dev = ds[0].device
    if dev.type != "cuda":
        raise ValueError(f"the collective kernels take CUDA tensors, got one on {dev}")
    rows = []
    for i, d in enumerate(ds):
        check_tensor(d, f"leaf {i}", device=dev, dtypes=(torch.float32,), ndim=1)
        r_ptr = 0
        if rs is not None:
            check_tensor(rs[i], f"residual {i}", device=dev, dtypes=(torch.float32,), ndim=1)
            if rs[i].shape != d.shape:
                raise ValueError(f"leaf {i} has {d.shape[0]} values, its residual "
                                 f"{rs[i].shape[0]}")
            r_ptr = rs[i].data_ptr()
        rows += [d.data_ptr(), r_ptr, d.shape[0]]
    return (ctypes.c_int64 * len(rows))(*rows), first_blocks(d.shape[0] for d in ds)[-1]


def _fold(dev, wf, live):
    """The weight's and the live flag's pointers (None: no fold, a rank
    that takes part), read by the kernel on the card: no host sync."""
    ptrs = []
    for t, name, dtype in ((wf, "wf", torch.float32), (live, "live", torch.bool)):
        if t is None:
            ptrs.append(None)
            continue
        if t.device != dev or t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"{name} must be one {dtype} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        ptrs.append(t.data_ptr())
    return ptrs


def collective_pack(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x: (N,) fp32 CUDA, scales: (N/256,) fp32 -> codes int32 (N,), every
    value in [-127, 127]: the leaf-table pack with x its one leaf, no fold,
    the scales given."""
    n = _check(x, "x", torch.float32, scales)
    q = torch.empty(n, dtype=torch.int32, device=x.device)
    table, n_blocks = _table([x], None)
    launch("collective_quant", "repro_collective_pack", "collective_pack", x.device,
           table, 1, None, None, scales.data_ptr(), 0, q.data_ptr(), None, None, n_blocks)
    return q


def collective_unpack(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: (N,) int32 CUDA (one rank's codes or their sum), scales:
    (N/256,) fp32 -> (N,) fp32."""
    n = _check(q, "q", torch.int32, scales)
    x = torch.empty(n, dtype=torch.float32, device=q.device)
    launch("collective_quant", "repro_collective_unpack", "collective_unpack", q.device,
           q.data_ptr(), scales.data_ptr(), x.data_ptr(), n // BLOCK)
    return x


def collective_absmax(ds, wf, rs, live=None) -> torch.Tensor:
    """Every leaf's eff = fl(fl(d * wf) + r) (0 where ``live`` is False)
    padded with zeros to a block multiple -> the (Nb,) fp32 block absmax
    over all leaves in order, NaN kept."""
    table, n_blocks = _table(ds, rs)
    dev = ds[0].device
    wf_p, live_p = _fold(dev, wf, live)
    absmax = torch.empty(n_blocks, dtype=torch.float32, device=dev)
    launch("collective_quant", "repro_collective_absmax", "collective_absmax", dev,
           table, len(ds), wf_p, live_p, absmax.data_ptr(), n_blocks)
    return absmax


def collective_pack_leaves(ds, wf, rs, absmax, live=None):
    """The leaves as for ``collective_absmax`` and their agreed (Nb,)
    absmax -> (codes (Np,) int32, scales (Nb,) fp32, new residuals (Np,)
    fp32): scale = absmax / 127 (0 -> 1), the codes of each eff, and
    eff - code * scale, a masked rank's residual carried as it was."""
    table, n_blocks = _table(ds, rs)
    dev = ds[0].device
    check_tensor(absmax, "absmax", device=dev, dtypes=(torch.float32,), ndim=1)
    if absmax.shape[0] != n_blocks:
        raise ValueError(f"the leaves have {n_blocks} blocks, absmax {absmax.shape[0]}")
    wf_p, live_p = _fold(dev, wf, live)
    q = torch.empty(n_blocks * BLOCK, dtype=torch.int32, device=dev)
    scales = torch.empty(n_blocks, dtype=torch.float32, device=dev)
    new_r = torch.empty(n_blocks * BLOCK, dtype=torch.float32, device=dev)
    launch("collective_quant", "repro_collective_pack", "collective_pack", dev,
           table, len(ds), wf_p, live_p, absmax.data_ptr(), 1, q.data_ptr(), scales.data_ptr(),
           new_r.data_ptr(), n_blocks)
    return q, scales, new_r
