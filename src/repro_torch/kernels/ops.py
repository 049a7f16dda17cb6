"""Public kernel entry points: CPU tensor -> plain version, CUDA tensor ->
hand-written kernel or raise.

The route is decided by where the tensors lie, nothing else: there is no
switch and no fallback, so a CUDA tensor can never reach ``ref``.  Each
kernel wrapper counts its launches (``launch_counts``), which is how a run
shows that its main path went through the kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.utils.pytree import safe_weight_sum

from . import _cuda, ref
from .collective_quant import collective_absmax as _absmax_kernel
from .collective_quant import collective_pack as _pack_kernel
from .collective_quant import collective_pack_leaves as _pack_leaves_kernel
from .collective_quant import collective_unpack as _unpack_kernel
from .collective_quant import first_blocks
from .decode_attention import decode_attention as _decode_kernel
from .dequant_reduce import dequant_reduce as _dequant_reduce_kernel
from .fedavg_reduce import fedavg_reduce as _fedavg_reduce_kernel
from .flash_attention import flash_attention as _flash_kernel
from .flash_attention import flash_attention_bwd as _flash_bwd_kernel
from .flash_attention import flash_attention_fwd as _flash_fwd_kernel
from .quantize import BLOCK, dequantize_int8 as _dequantize_kernel
from .quantize import quantize_int8 as _quantize_kernel
from .scatter_reduce import topk_scatter_reduce as _topk_kernel
from .selective_scan import selective_scan as _scan_kernel
from .selective_scan import selective_scan_bwd as _scan_bwd_kernel
from .selective_scan import selective_scan_fwd as _scan_fwd_kernel


def _on_card(*tensors: torch.Tensor) -> bool:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}: expected one device")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {dev}")


def _check_block(block: int) -> None:
    if block != BLOCK:
        raise ValueError(f"the CUDA kernels quantize in blocks of {BLOCK}, got {block}")


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return dict(_cuda.LAUNCHES)


def reset_launch_counts() -> None:
    for name in _cuda.LAUNCHES:
        _cuda.LAUNCHES[name] = 0


def _denormalize(out: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Undo the reduces' safe_weight_sum normalization: the weighted mean
    back into the weighted SUM, the group-partial form the grouped wire
    reduce combines under ONE fleet-wide denominator.  Exact for all-zero
    weights (0 * 1 == 0)."""
    return out * safe_weight_sum(weights.to(torch.float32)).to(out.dtype)


# ---------------- FL aggregation ----------------
def fedavg_reduce(updates, weights, *, normalize=True):
    """(C, N) x (C,) -> (N,) weighted mean (or weighted sum with
    ``normalize=False``), in the updates' dtype."""
    if _on_card(updates, weights):  # one launch: the weight sum and normalize inside
        return _fedavg_reduce_kernel(updates, weights, normalize=normalize)
    out = ref.fedavg_reduce(updates, weights)
    return out if normalize else _denormalize(out, weights)


def dequant_reduce(q, scales, weights, block: int = 256, *, normalize=True):
    """Fused server-side decode: int8 payload (C,N) + scales -> (N,) mean
    (or weighted sum with ``normalize=False``)."""
    if _on_card(q, scales, weights):  # one launch: the weight sum and normalize inside
        _check_block(block)
        return _dequant_reduce_kernel(q, scales, weights, normalize=normalize)
    out = ref.dequant_reduce(q, scales, weights, block=block)
    return out if normalize else _denormalize(out, weights)


def topk_scatter_reduce(idx, val, weights, n_params: int, *, normalize=True):
    """Sparse TopK aggregation: (C,k) idx/val + (C,) weights -> (N,) fp32
    mean (or weighted sum with ``normalize=False``), O(C*k), never a dense
    (C, N).  On the card ``idx`` must be int32 (TopKCodec's wire)."""
    if _on_card(idx, val, weights):  # one launch: the weight sum and normalize inside
        return _topk_kernel(idx, val.to(torch.float32).contiguous(), weights, n_params,
                            normalize=normalize)
    out = ref.topk_scatter_reduce(idx, val, weights, n_params)
    return out if normalize else _denormalize(out, weights)


# ---------------- int8 codec ----------------
def quantize_int8(x, block: int = 256):
    """(N,) fp32, any N -> (q int8 (Np,), scales fp32 (Np/block,)): the
    codes of x padded with zeros to Np, a block multiple (on the card the
    pad is inside the one launch)."""
    if _on_card(x):
        _check_block(block)
        return _quantize_kernel(x)
    pad = (-x.shape[0]) % block
    return ref.quantize_int8(F.pad(x, (0, pad)) if pad else x, block=block)


def dequantize_int8(q, scale, block: int = 256):
    if _on_card(q, scale):
        _check_block(block)
        return _dequantize_kernel(q, scale)
    return ref.dequantize_int8(q, scale, block=block)


# ---------------- compressed collective (the mesh all-reduce's wire) ----------------
def collective_pack(x, scales):
    """One rank's partial weighted sum against the SHARED per-256-block
    scales (agreed by a MAX all-reduce) -> int32 codes in [-127, 127]."""
    if _on_card(x, scales):
        return _pack_kernel(x, scales)
    return ref.collective_pack(x, scales, block=BLOCK)


def collective_unpack(q, scales):
    """int32 codes (one rank's, or their all-reduced sum) x shared
    per-256-block scales -> fp32: the one dequant after the last hop."""
    if _on_card(q, scales):
        return _unpack_kernel(q, scales)
    return ref.collective_unpack(q, scales, block=BLOCK)


def _leaf_tensors(ds, wf, rs, live):
    return [*ds, *rs, *(t for t in (wf, live) if t is not None)]


def collective_absmax(ds, wf, rs, live=None):
    """A rank's operand over every model leaf -> its per-256-block absmax,
    (Nb,) fp32, the blocks of all leaves in order (``first_blocks``), NaN
    kept.  Leaf i's eff is ``ds[i] * wf + rs[i]`` (``wf`` None: no
    multiply), padded with zeros to a block multiple; with ``live``
    False the rank sends nothing, its eff is 0.  ``wf`` and ``live`` are
    one-element tensors beside the leaves (the kernel reads them there)."""
    if _on_card(*_leaf_tensors(ds, wf, rs, live)):
        return _absmax_kernel(ds, wf, rs, live)
    return ref.collective_absmax(ds, wf, rs, live, block=BLOCK)


def collective_pack_leaves(ds, wf, rs, absmax, live=None):
    """The leaves as for ``collective_absmax`` and the absmax every rank
    agreed on (the MAX all-reduce of theirs) -> (codes int32 (Np,), scales
    (Nb,), new residuals fp32 (Np,)); leaf i's codes and residual fill
    slots [256 b_i, 256 b_i + n_i) with b_i = ``first_blocks(sizes)[i]``.
    A masked rank (``live`` False) sends zero codes and carries its
    residual."""
    if _on_card(absmax, *_leaf_tensors(ds, wf, rs, live)):
        return _pack_leaves_kernel(ds, wf, rs, absmax, live)
    return ref.collective_pack_leaves(ds, wf, rs, absmax, live, block=BLOCK)


# ---------------- attention (the transformer's prefill, training and decode) ----------------
_ITEM = "ROADMAP.md queue 1 item 15"


def _traced(*tensors: torch.Tensor) -> bool:
    """Whether autograd or a ``torch.func`` transform sees these tensors:
    an input that needs a gradient, or a functorch wrapper (``vmap``'s
    batched or ``grad``'s tracking tensor), whose data pointer a ctypes
    launch cannot read."""
    grad_on = torch.is_grad_enabled()
    return any((grad_on and t.requires_grad) or torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in tensors)


def _refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """A card kernel without a backward: raise where autograd or a
    transform would reach it, instead of a detached result or a failed
    pointer read."""
    if _traced(*tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel: training through it on the card is not "
            f"ported yet ({_ITEM})")


def _fold(x: torch.Tensor, dim: int | None, n: int) -> torch.Tensor:
    """A vmapped input as a plain batch: the mapped dim ``dim`` (None:
    unmapped, expanded) moved to the front and folded into B."""
    x = x.unsqueeze(0).expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()


def _unfold(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) -> (out, lse): the forward that saves what its backward,
    ``_FlashAttentionBwd``, reads.  Under ``torch.func.vmap`` the mapped
    dimension is folded into B (``vmap`` below), so the innermost call gets
    plain tensors and a vmapped cohort makes one launch; ``generate_vmap_rule``
    would hand the launch functorch wrappers instead."""

    @staticmethod
    def forward(q, k, v, causal, window, q_offset):
        if _on_card(q, k, v):
            return _flash_fwd_kernel(q, k, v, causal=causal, window=window, q_offset=q_offset)
        return ref.attention_with_lse(q, k, v, causal=causal, window=window, q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_offset = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.mask = (causal, window, q_offset)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, out, lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, out, lse, dout, *ctx.mask)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, q_offset):
        n = info.batch_size
        qf, kf, vf = (_fold(t, d, n) for t, d in zip((q, k, v), in_dims[:3]))
        out, lse = _FlashAttention.apply(qf, kf, vf, causal, window, q_offset)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class _FlashAttentionBwd(torch.autograd.Function):
    """(q, k, v, out, lse, dout) -> (dq, dk, dv): the hand-written backward
    on the card, ``ref.attention_bwd`` on the CPU.  It has no backward of
    its own: a double backward raises."""

    @staticmethod
    def forward(q, k, v, out, lse, dout, causal, window, q_offset):
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        if _on_card(q, k, v, out, lse, dout):
            return _flash_bwd_kernel(q, k, v, out, lse, dout.contiguous(), **kw)
        return ref.attention_bwd(q, k, v, out, lse, dout, **kw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash attention's backward has no backward: double backward "
                           "(a gradient of a gradient) through attention is not supported")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, dout, causal, window, q_offset):
        n = info.batch_size
        folded = [_fold(t, d, n) for t, d in zip((q, k, v, out, lse, dout), in_dims[:6])]
        grads = _FlashAttentionBwd.apply(*folded, causal, window, q_offset)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention(q, k, v, *, causal=True, window=None, q_offset=0):
    """q (B,Sq,H,D), k/v (B,Skv,KV,D) -> (B,Sq,H,D): causal and/or
    sliding-window GQA attention, q[:, 0] at absolute position ``q_offset``.
    Differentiable: where autograd or a ``torch.func`` transform sees the
    inputs it runs through ``_FlashAttention`` (the forward with lse, the
    backward kernel after); otherwise (serving, ``torch.inference_mode``)
    the forward alone, which saves nothing and writes no lse."""
    on_card = _on_card(q, k, v)
    if _traced(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)[0]
    if on_card:
        return _flash_kernel(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, *, kv_valid):
    """One token q (B,H,D) against caches (B,S,KV,D) where ``kv_valid``
    (B,S) holds -> (B,H,D).  Serving only on the card: no backward."""
    if _on_card(q, k_cache, v_cache, kv_valid):
        _refuse_autograd("decode_attention", q, k_cache, v_cache)
        return _decode_kernel(q, k_cache, v_cache, kv_valid=kv_valid)
    return ref.decode_attention(q, k_cache, v_cache, kv_valid=kv_valid)


# ---------------- mamba scan (the hybrid transformer's prefill and training) ----------------
def _scan_tensors(*tensors):
    return tuple(t for t in tensors if t is not None)


class _SelectiveScan(torch.autograd.Function):
    """(x, dt, A (G,Di,N), B, C, D (G,Di), h0 or None) -> (y, final state,
    checkpoints): the forward that keeps what its backward,
    ``_SelectiveScanBwd``, reads.  The final state is differentiable (its
    cotangent seeds the reverse recurrence); the checkpoints are not.  On
    the CPU the plain forward runs and keeps no checkpoint (an empty
    (B, 0, N, Di)): ``ref.selective_scan_bwd`` recomputes every state.
    Under ``torch.func.vmap`` the mapped dimension is folded into B and
    the groups (``vmap`` below): a vmapped cohort is one launch, whether A
    and D are mapped per client or shared."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm, D, h0, groups):
        if _on_card(*_scan_tensors(x, dt, A, Bm, Cm, D, h0)):
            return _scan_fwd_kernel(x, dt, A, Bm, Cm, D, init_state=h0, groups=groups)
        y, h = ref.selective_scan(x, dt, A, Bm, Cm, D, init_state=h0, groups=groups)
        return y, h, h.new_empty((x.shape[0], 0, h.shape[2], h.shape[1]))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dt, A, Bm, Cm, D, h0, groups = inputs
        ckpt = output[2]
        ctx.mark_non_differentiable(ckpt)
        ctx.groups = groups
        if any(ctx.needs_input_grad[:7]):
            ctx.save_for_backward(x, dt, A, Bm, Cm, D, h0, ckpt)

    @staticmethod
    def backward(ctx, dy, dh, _dckpt):
        x, dt, A, Bm, Cm, D, h0, ckpt = ctx.saved_tensors
        grads = _SelectiveScanBwd.apply(x, dt, A, Bm, Cm, D, h0, ckpt, dy, dh, ctx.groups)
        dh0 = grads[6] if h0 is not None else None
        return (*(g.to(t.dtype) for g, t in zip(grads[:6], (x, dt, A, Bm, Cm, D))), dh0, None)

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bm, Cm, D, h0, groups):
        n = info.batch_size
        folded = [None if t is None else _fold(t, d, n)
                  for t, d in zip((x, dt, A, Bm, Cm, D, h0), in_dims[:7])]
        out = _SelectiveScan.apply(*folded, groups * n)
        return tuple(_unfold(t, n) for t in out), (0, 0, 0)


class _SelectiveScanBwd(torch.autograd.Function):
    """(x, dt, A, B, C, D, h0, checkpoints, dy, dh_final) -> (dx, ddt, dA,
    dB, dC, dD[, dh0]): the hand-written backward on the card,
    ``ref.selective_scan_bwd`` on the CPU.  It has no backward of its own:
    a double backward raises."""

    @staticmethod
    def forward(x, dt, A, Bm, Cm, D, h0, ckpt, dy, dh, groups):
        kw = dict(init_state=h0, dh_final=dh, groups=groups)
        if _on_card(*_scan_tensors(x, dt, A, Bm, Cm, D, h0, ckpt, dy, dh)):
            grads = _scan_bwd_kernel(x, dt, A, Bm, Cm, D, ckpt, dy.to(x.dtype), **kw)
        else:
            grads = ref.selective_scan_bwd(x, dt, A, Bm, Cm, D, dy, **kw)
        return grads if h0 is not None else grads[:6]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("selective_scan's backward has no backward: double backward "
                           "(a gradient of a gradient) through the scan is not supported")

    @staticmethod
    def vmap(info, in_dims, x, dt, A, Bm, Cm, D, h0, ckpt, dy, dh, groups):
        n = info.batch_size
        folded = [None if t is None else _fold(t, d, n)
                  for t, d in zip((x, dt, A, Bm, Cm, D, h0, ckpt, dy, dh), in_dims[:10])]
        grads = _SelectiveScanBwd.apply(*folded, groups * n)
        return tuple(_unfold(g, n) for g in grads), (0,) * len(grads)


def selective_scan(x, dt, A, B, C, D, *, init_state=None):
    """x, dt (B,S,Di); A (Di,N); B, C (B,S,N); D (Di,); optional initial
    state (B,Di,N) -> (y (B,S,Di) in x's dtype, final state fp32).  Any S:
    the TPU dispatch's S % 128 gate is not copied.  Differentiable: where
    autograd or a ``torch.func`` transform sees the inputs it runs through
    ``_SelectiveScan`` (the forward with checkpoints, the backward kernel
    after; the final state's gradient included); otherwise (serving,
    ``torch.inference_mode``) the forward alone, which keeps nothing."""
    tensors = _scan_tensors(x, dt, A, B, C, D, init_state)
    on_card = _on_card(*tensors)
    if _traced(*tensors):
        y, h, _ = _SelectiveScan.apply(x, dt, A.unsqueeze(0), B, C, D.unsqueeze(0),
                                       init_state, 1)
        return y, h
    if on_card:
        return _scan_kernel(x, dt, A, B, C, D, init_state=init_state)
    return ref.selective_scan(x, dt, A, B, C, D, init_state=init_state)


selective_scan_step = ref.selective_scan_step  # one token: plain ops, JAX has no kernel for it
