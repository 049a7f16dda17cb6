"""Plain PyTorch versions of the port's kernels.

Each function here computes what one hand-written CUDA kernel computes, in
the same arithmetic as ``repro.kernels.ref``.  ``ops`` takes these for CPU
tensors only; a CUDA tensor always goes to the kernel.  On the card
``chip_smoke.py`` calls them directly to hold each kernel against its plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import safe_weight_sum


def fedavg_reduce(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(C, N) x (C,) -> (N,): sum_c w_c * u_c / sum_c w_c, fp32 accumulate,
    output in the input dtype."""
    wf = weights.to(torch.float32)
    acc = torch.einsum("c,cn->n", wf, updates.to(torch.float32))
    return (acc / safe_weight_sum(wf)).to(updates.dtype)


def topk_scatter_reduce(
    idx: torch.Tensor,      # (C, k) int sparse positions
    val: torch.Tensor,      # (C, k) fp sparse values
    weights: torch.Tensor,  # (C,) aggregation weights
    n_params: int,
) -> torch.Tensor:
    """One scatter-add of every client's weighted payload into a zero (N,)
    fp32 accumulator, divided by ``safe_weight_sum``: the dense (C, N)
    matrix is never built.  Duplicates accumulate; out-of-range indices are
    dropped -- masked to index 0 with value 0, so a negative index never
    wraps into a valid coordinate.  k = 0 or C = 0 gives zeros."""
    c, k = idx.shape
    wf = weights.to(torch.float32)
    if k == 0 or c == 0:
        return torch.zeros(n_params, dtype=torch.float32, device=idx.device)
    valid = (idx >= 0) & (idx < n_params)
    safe_idx = torch.where(valid, idx, torch.zeros_like(idx))
    contrib = torch.where(valid, val.to(torch.float32), torch.zeros((), device=val.device)) * wf[:, None]
    acc = torch.zeros(n_params, dtype=torch.float32, device=idx.device).index_add_(
        0, safe_idx.reshape(-1), contrib.reshape(-1)
    )
    return acc / safe_weight_sum(wf)


def quantize_int8(x: torch.Tensor, block: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (N,) fp -> (values int8 (N,), scales fp32 (N/block,)). N % block == 0.

    Per block: scale = absmax / 127 (0 -> 1), q = clip(round_half_even(x /
    scale), -127, 127).  Both divisions are true IEEE divisions by a tensor:
    PyTorch's CUDA ``tensor / python_scalar`` multiplies by the reciprocal,
    which can move a scale by one ulp and flip a code."""
    xf = x.to(torch.float32).reshape(-1, block)
    absmax = xf.abs().amax(dim=1)
    scale = absmax / torch.full_like(absmax, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(xf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q.reshape(-1), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, block: int = 256) -> torch.Tensor:
    qf = q.reshape(-1, block).to(torch.float32)
    return (qf * scale[:, None]).reshape(-1)


def collective_pack(x: torch.Tensor, scales: torch.Tensor, block: int = 256) -> torch.Tensor:
    """(N,) fp32 x (N/block,) shared scales -> int32 (N,):
    clip(round_half_even(x / scale), -127, 127) per block, the scale an
    input (never derived from x), the division a true IEEE division by a
    tensor.  int32 is the all-reduce's accumulator type; the values fit
    int8."""
    xf = x.to(torch.float32).reshape(-1, block)
    q = torch.round(xf / scales.to(torch.float32)[:, None]).clamp(-127, 127)
    return q.reshape(-1).to(torch.int32)


def collective_unpack(q: torch.Tensor, scales: torch.Tensor, block: int = 256) -> torch.Tensor:
    """int32 (N,) codes (one rank's or their sum) x (N/block,) scales ->
    fp32 (N,)."""
    qf = q.reshape(-1, block).to(torch.float32)
    return (qf * scales.to(torch.float32)[:, None]).reshape(-1)


def collective_eff(d: torch.Tensor, wf, r: torch.Tensor, live=None,
                   block: int = 256) -> torch.Tensor:
    """One leaf of a rank's collective operand: eff = d * wf + r (wf None:
    no multiply), zero for a masked rank (``live`` False: it sends
    nothing, not even its residual), padded with zeros to a block
    multiple.  The reference's order: ``(d * wf) + r``, each one rounding."""
    eff = d.to(torch.float32)
    if wf is not None:
        eff = eff * wf
    eff = eff + r
    if live is not None:
        eff = torch.where(live, eff, torch.zeros_like(eff))
    pad = (-eff.shape[0]) % block
    return torch.nn.functional.pad(eff, (0, pad)) if pad else eff


def collective_absmax(ds, wf, rs, live=None, block: int = 256) -> torch.Tensor:
    """Every leaf's padded ``collective_eff`` -> the per-block max |eff| of
    all leaves in order, (Nb,) fp32; ``torch.amax`` keeps NaN."""
    return torch.cat([collective_eff(d, wf, r, live, block).abs().reshape(-1, block).amax(dim=1)
                      for d, r in zip(ds, rs, strict=True)])


def collective_pack_leaves(ds, wf, rs, absmax, live=None, block: int = 256):
    """The leaves' agreed (Nb,) absmax -> (codes int32 (Np,), scales (Nb,),
    new residuals fp32 (Np,)), leaf by leaf: scale = absmax / 127 (a
    division by a tensor) with 0 -> 1, ``collective_pack`` of the padded
    eff, and eff - ``collective_unpack`` of its codes; a masked rank's
    residual carried as it was.  Leaf i fills its blocks of the flat
    outputs, the pad slots included."""
    scales = torch.where(absmax == 0.0, torch.ones_like(absmax),
                         absmax / torch.full_like(absmax, 127.0))
    qs, news, b = [], [], 0
    for d, r in zip(ds, rs, strict=True):
        effp = collective_eff(d, wf, r, live, block)
        nb = effp.shape[0] // block
        s = scales[b:b + nb]
        q = collective_pack(effp, s, block)
        new = effp - collective_unpack(q, s, block)
        if live is not None:
            carried = torch.nn.functional.pad(r, (0, effp.shape[0] - r.shape[0]))
            new = torch.where(live, new, carried)
        qs.append(q)
        news.append(new)
        b += nb
    return torch.cat(qs), scales, torch.cat(news)


def dequant_reduce(
    q: torch.Tensor,        # (C, N) int8 wire payload
    scales: torch.Tensor,   # (C, N/block) fp32 block scales
    weights: torch.Tensor,  # (C,) aggregation weights
    block: int = 256,
) -> torch.Tensor:
    """Dequantize every client row, then the weighted mean (fp32)."""
    c, n = q.shape
    x = q.to(torch.float32).reshape(c, n // block, block) * (
        scales.to(torch.float32)[:, :, None]
    )
    wf = weights.to(torch.float32)
    acc = torch.einsum("c,cn->n", wf, x.reshape(c, n))
    return acc / safe_weight_sum(wf)


# ---------------- attention ----------------
NEG_INF = -1e30  # masked scores: finite, so a row with no valid key is a uniform mean, not NaN


def _attention_scores(q, k, v, causal, window, q_offset):
    """-> (the scaled, masked fp32 scores (B,H,Sq,Skv), V repeated over the
    groups (B,H,Skv,D) fp32, the mask (Sq,Skv))."""
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape
    groups = h // kv
    scale = d ** -0.5
    qg = (q.to(torch.float32) * scale).transpose(1, 2)                      # (B,H,Sq,D)
    kf = torch.repeat_interleave(k.to(torch.float32), groups, dim=2).transpose(1, 2)
    vf = torch.repeat_interleave(v.to(torch.float32), groups, dim=2).transpose(1, 2)
    scores = torch.matmul(qg, kf.transpose(-1, -2))                          # (B,H,Sq,Skv)
    mask = attention_mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    return scores, vf, mask


def attention_mask(sq: int, skv: int, *, causal: bool, window: int | None, q_offset: int,
                   device) -> torch.Tensor:
    """(Sq, Skv) bool: key j attends to query i iff (not causal or j <= i +
    q_offset) and (window is None or j > i + q_offset - window)."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention(
    q: torch.Tensor,           # (B, Sq, H, D)
    k: torch.Tensor,           # (B, Skv, KV, D)
    v: torch.Tensor,           # (B, Skv, KV, D)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,         # absolute position of q[0]
) -> torch.Tensor:
    """GQA attention with one dense score matrix: query head h reads KV head
    h // G; key j attends to query i iff (not causal or j <= i + q_offset)
    and (window is None or j > i + q_offset - window).  Scores in fp32 with
    q scaled by D**-0.5 before the product; the output in q's dtype.  The
    JAX oracle's banded and streamed paths compute the same function."""
    scores, vf, _ = _attention_scores(q, k, v, causal, window, q_offset)
    out = torch.matmul(torch.softmax(scores, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype)


def attention_with_lse(q, k, v, *, causal=True, window=None, q_offset=0):
    """``attention`` (bitwise) and each row's log-sum-exp of the same
    scaled, masked scores, lse (B, H, Sq) fp32: the flash backward's
    input.  A row with no valid key gets -1e30 + log(Skv), which is -1e30
    in fp32."""
    scores, vf, _ = _attention_scores(q, k, v, causal, window, q_offset)
    out = torch.matmul(torch.softmax(scores, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype), torch.logsumexp(scores, dim=-1)


def attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=None, q_offset=0):
    """The gradient of ``attention`` by the flash backward's formulas, from
    its output and lse: delta = rowsum(dO * O), P = exp(S - lse), dV =
    sum over the group of P^T . dO, dS = P * (dO . V^T - delta), dQ =
    scale * dS . K, dK = scale * sum over the group of dS^T . Q.  Sums in
    fp32, (dq, dk, dv) in the inputs' dtypes.  Masked pairs pass no
    gradient to the scores (dS = 0, as autograd through ``attention``'s
    where()); a row with no valid key took the mean of V, so it adds dO /
    Skv to every key's dV and nothing to dQ or dK: zeros, never NaN.  V may
    be narrower than Q and K (MLA's unpadded V), as in ``attention``."""
    b, sq, h, d = q.shape
    _, skv, kv, _ = k.shape
    groups = h // kv
    scale = d ** -0.5
    f32 = torch.float32
    qs = (q.to(f32) * scale).transpose(1, 2)                                  # (B,H,Sq,D)
    kf = torch.repeat_interleave(k.to(f32), groups, dim=2).transpose(1, 2)   # (B,H,Skv,D)
    vf = torch.repeat_interleave(v.to(f32), groups, dim=2).transpose(1, 2)
    do = dout.to(f32).transpose(1, 2)
    mask = attention_mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    delta = (do * out.to(f32).transpose(1, 2)).sum(-1, keepdim=True)         # (B,H,Sq,1)
    s = torch.matmul(qs, kf.transpose(-1, -2))
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    p = torch.where(mask.any(-1, keepdim=True), p, torch.full((), 1.0 / skv, device=q.device))
    ds = torch.where(mask, p * (torch.matmul(do, vf.transpose(-1, -2)) - delta),
                     torch.zeros((), device=q.device))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs).reshape(b, kv, groups, skv, d).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), do).reshape(b, kv, groups, skv, -1).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def decode_attention(
    q: torch.Tensor,           # (B, H, D): the one new token
    k_cache: torch.Tensor,     # (B, S, KV, D)
    v_cache: torch.Tensor,     # (B, S, KV, D)
    *,
    kv_valid: torch.Tensor,    # (B, S) bool: which cache slots attend
) -> torch.Tensor:
    """One query token per head against the cache, GQA grouped (the cache
    is never repeated).  As the JAX oracle does, ``q * D**-0.5`` and the
    probabilities are rounded to the cache's dtype before their products,
    which accumulate in fp32; the output is in q's dtype."""
    b, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    groups = h // kv
    scale = d ** -0.5
    qg = (q.to(torch.float32) * scale).to(k_cache.dtype).reshape(b, kv, groups, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.to(torch.float32), k_cache.to(torch.float32))
    scores = torch.where(kv_valid[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(torch.float32), v_cache.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)


# ---------------- mamba selective scan ----------------
def _scan_rows(A: torch.Tensor, D: torch.Tensor, bsz: int, groups: int):
    """A, D in fp32 as each batch row reads them: (Di, N) and (Di,) as
    given when ``groups`` is 1 and A has two dims; else A (G, Di, N) and
    D (G, Di) repeated to (B, Di, N) and (B, Di), row b taking group
    b // (B / G)."""
    f32 = torch.float32
    if A.dim() == 2:
        if groups != 1:
            raise ValueError(f"selective_scan: A (Di, N) has one group, got groups={groups}")
        return A.to(f32), D.to(f32)
    if A.shape[0] != groups or D.shape[0] != groups or bsz % groups:
        raise ValueError(f"selective_scan: A {tuple(A.shape)} and D {tuple(D.shape)} for "
                         f"groups={groups} over B={bsz}")
    rows = bsz // groups
    return (A.to(f32).repeat_interleave(rows, dim=0), D.to(f32).repeat_interleave(rows, dim=0))


def _scan_step(h, x_t, dt_t, a, b_t):
    """One step of the recurrence, fp32: exp(dt A) h + (dt x) B."""
    return torch.exp(dt_t[..., None] * a) * h + (dt_t * x_t)[..., None] * b_t[:, None, :]


def selective_scan(
    x: torch.Tensor,    # (B, S, Di)  input sequence
    dt: torch.Tensor,   # (B, S, Di)  softplus'd step sizes
    A: torch.Tensor,    # (Di, N)     negative-real state matrix; (G, Di, N) with groups
    Bm: torch.Tensor,   # (B, S, N)   input -> state projection
    Cm: torch.Tensor,   # (B, S, N)   state -> output projection
    D: torch.Tensor,    # (Di,)       skip; (G, Di) with groups
    *,
    init_state: torch.Tensor | None = None,  # (B, Di, N)
    groups: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,  y_t = h_t C_t + D x_t:
    the literal recurrence, one step at a time in the Pallas kernel's
    arithmetic (``repro/kernels/selective_scan.py:42-51``), the (B, Di, N)
    state in fp32.  Returns (y in x's dtype, final state fp32).  JAX's
    oracle sums the same terms by a chunked associative scan instead.
    With ``groups`` G, A is (G, Di, N) and D (G, Di), and batch row b reads
    group b // (B / G): G clients' batches folded into one (the vmapped
    cohort)."""
    bsz, s, di = x.shape
    f32 = torch.float32
    a, d = _scan_rows(A, D, bsz, groups)
    h = (init_state.to(f32) if init_state is not None
         else torch.zeros((bsz, di, A.shape[-1]), dtype=f32, device=x.device))
    y = torch.empty_like(x)
    for t in range(s):
        x_t = x[:, t].to(f32)                                   # (B, Di)
        dt_t = dt[:, t].to(f32)
        b_t, c_t = Bm[:, t].to(f32), Cm[:, t].to(f32)           # (B, N)
        h = _scan_step(h, x_t, dt_t, a, b_t)
        y[:, t] = ((h * c_t[:, None, :]).sum(-1) + d * x_t).to(x.dtype)
    return y, h


def selective_scan_bwd(x, dt, A, Bm, Cm, D, dy, *, init_state=None, dh_final=None,
                       groups: int = 1):
    """The gradient of ``selective_scan`` (the hand-written backward's
    plain version): given dy (B, S, Di) and the final state's cotangent
    ``dh_final`` (B, Di, N) or None, -> (dx in x's dtype, ddt, dA, dB, dC,
    dD, dh0 or None), all but dx fp32, by the reverse recurrence

        g_{S-1} = dh_S + dy_{S-1} C_{S-1},  g_{t-1} = a_t g_t + dy_{t-1} C_{t-1}
        du_t = sum_n g_t B_t,  dx_t = dt_t du_t + D dy_t,
        ddt_t = x_t du_t + sum_n A a_t h_{t-1} g_t,
        dB_t = sum_d u_t g_t,  dC_t = sum_d dy_t h_t,
        dA = sum_{b in g, t} dt_t a_t h_{t-1} g_t,  dD = sum_{b in g, t} dy_t x_t,
        dh0 = a_0 g_0,

    a_t = exp(dt_t A), u_t = dt_t x_t, sums in fp32.  The states are
    recomputed by ``selective_scan``'s own steps, so h_{t-1} is bitwise the
    forward's.  dA, dD have A's and D's shapes (summed over each group's
    rows); dh0 is None without an initial state."""
    bsz, s, di = x.shape
    f32 = torch.float32
    a, d = _scan_rows(A, D, bsz, groups)
    h = (init_state.to(f32) if init_state is not None
         else torch.zeros((bsz, di, A.shape[-1]), dtype=f32, device=x.device))
    states = [h]                                                # states[t] = h_{t-1}
    for t in range(s):
        states.append(_scan_step(states[-1], x[:, t].to(f32), dt[:, t].to(f32), a,
                                 Bm[:, t].to(f32)))
    g = (dh_final.to(f32) if dh_final is not None else torch.zeros_like(h))
    dx = torch.empty((bsz, s, di), dtype=f32, device=x.device)
    ddt = torch.empty_like(dx)
    dbm = torch.empty((bsz, s, A.shape[-1]), dtype=f32, device=x.device)
    dcm = torch.empty_like(dbm)
    da_rows = torch.zeros_like(h)
    dd_rows = torch.zeros((bsz, di), dtype=f32, device=x.device)
    for t in reversed(range(s)):
        x_t, dt_t, dy_t = x[:, t].to(f32), dt[:, t].to(f32), dy[:, t].to(f32)
        b_t, c_t = Bm[:, t].to(f32), Cm[:, t].to(f32)
        g = g + dy_t[..., None] * c_t[:, None, :]               # g_t
        a_t = torch.exp(dt_t[..., None] * a)
        du = (g * b_t[:, None, :]).sum(-1)
        dx[:, t] = dt_t * du + d * dy_t
        sens = a_t * states[t] * g                              # a_t h_{t-1} g_t
        ddt[:, t] = x_t * du + (a * sens).sum(-1)
        da_rows += dt_t[..., None] * sens
        dbm[:, t] = ((dt_t * x_t)[..., None] * g).sum(1)
        dcm[:, t] = (dy_t[..., None] * states[t + 1]).sum(1)
        dd_rows += dy_t * x_t
        g = a_t * g                                             # a_t g_t
    if A.dim() == 2:
        da, dd = da_rows.sum(0), dd_rows.sum(0)
    else:
        da = da_rows.reshape(groups, bsz // groups, di, -1).sum(1)
        dd = dd_rows.reshape(groups, bsz // groups, di).sum(1)
    return (dx.to(x.dtype), ddt, da, dbm, dcm, dd, g if init_state is not None else None)


def selective_scan_step(
    x: torch.Tensor,      # (B, Di)
    dt: torch.Tensor,     # (B, Di)
    A: torch.Tensor,      # (Di, N)
    Bm: torch.Tensor,     # (B, N)
    Cm: torch.Tensor,     # (B, N)
    D: torch.Tensor,      # (Di,)
    state: torch.Tensor,  # (B, Di, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """One token's recurrent step (decode), in JAX's step arithmetic
    (``repro/kernels/ref.py:229``): (dt B) x for the input term, the
    output an einsum over N.  Returns (y in x's dtype, new state fp32)."""
    f32 = torch.float32
    xf, dtf = x.to(f32), dt.to(f32)
    new_state = torch.exp(dtf[..., None] * A.to(f32)[None]) * state.to(f32) + (
        dtf[..., None] * Bm[:, None, :].to(f32) * xf[..., None]
    )
    y = torch.einsum("bn,bdn->bd", Cm.to(f32), new_state) + D[None].to(f32) * xf
    return y.to(x.dtype), new_state
