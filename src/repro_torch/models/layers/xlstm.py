"""xLSTM blocks [arXiv:2405.04517], the twin of ``repro.models.layers.xlstm``:
mLSTM (matrix memory) and sLSTM (scalar memory).

The mLSTM's prefill is the stabilized quadratic form in fp32, evaluated in
query chunks of 256 (one chunk where 256 does not divide S), and returns
the final (C, n, m) state beside its output, as ``mamba_forward`` returns
its state (JAX computes that state in ``repro/models/transformer.py``'s
``xlstm_lib_prefill_mlstm``).  Its decode is the O(1) recurrent step on
that state.  The sLSTM has a hidden-to-hidden recurrence with no parallel
form: it steps through time, one fp32 cell a position, with block-diagonal
recurrent weights per head.  Neither reaches a Pallas kernel in JAX: the
products here are ``torch.matmul``, in fp32 where JAX's are.

A decode step writes the layer's cache in place, as the attention layer
writes its KV cache.  Params and caches keep JAX's keys, shapes and
dtypes (``w_gates``, ``b_gates``, ``o_norm``, ``r``, ``b`` and every cache
leaf in fp32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .embeddings import normal
from .mlp import silu
from .norms import rmsnorm as _headwise_rms  # JAX's _headwise_rms: fp32, 1 + scale, eps 1e-6

# the running max's floor and its initial state, as JAX writes them
_M_FLOOR = -1e30
# jax.nn.log_sigmoid is -softplus(-x) = min(x, 0) - log1p(exp(-|x|)):
# F.logsigmoid's formula
_log_sigmoid = F.logsigmoid


# ============================== mLSTM ==============================
def _mlstm_dims(cfg):
    d_inner = 2 * cfg.d_model
    return d_inner, cfg.n_heads, d_inner // cfg.n_heads


def init_mlstm(gen: torch.Generator, cfg, dtype, *, lead=(), device=None) -> dict:
    """JAX's leaves, with the port's own draws; ``lead`` = (L,) draws L
    layers' stacked leaves at once."""
    d = cfg.d_model
    di, h, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    # forget-gate bias ~ +3..6 keeps early memories (the xLSTM paper)
    b_gates = torch.stack([torch.zeros(h, dtype=f32, device=device),
                           torch.linspace(3.0, 6.0, h, dtype=f32, device=device)], dim=-1)
    return {
        "up_proj": normal(gen, (*lead, d, 2 * di), d, dtype, device),
        "wq": normal(gen, (*lead, di, h, hd), di, dtype, device),
        "wk": normal(gen, (*lead, di, h, hd), di, dtype, device),
        "wv": normal(gen, (*lead, di, h, hd), di, dtype, device),
        "w_gates": normal(gen, (*lead, di, h, 2), di, f32, device),
        "b_gates": b_gates.expand(*lead, h, 2).contiguous(),
        "o_norm": torch.zeros((*lead, h, hd), dtype=f32, device=device),
        "down_proj": normal(gen, (*lead, di, d), di, dtype, device),
    }


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): (B,S,di) @ (di,H,K) -> (B,S,H,K)."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def _mlstm_qkv_gates(cfg, params: dict, x_in: torch.Tensor):
    """x_in (B,S,di) -> q, k, v (B,S,H,hd) in the model dtype; the raw
    input-gate logit and the log forget gate (B,S,H), fp32: the gate
    product takes x_in up to fp32, never w_gates down."""
    q, k, v = (_heads(x_in, params[w]) for w in ("wq", "wk", "wv"))
    gates = _heads(x_in.to(torch.float32), params["w_gates"]) + params["b_gates"]
    return q, k, v, gates[..., 0], _log_sigmoid(gates[..., 1])


def mlstm_parallel(q, k, v, ig, lf, *, chunk: int = 256) -> torch.Tensor:
    """Stabilized quadratic mLSTM, chunked over queries.

    q, k, v: (B,S,H,D); ig, lf: (B,S,H) fp32.  Returns (B,S,H,D) in q's
    dtype.  D_ij = exp(F_i - F_j + ig_j) for j <= i, F the cumulative log
    forget gate; each row is stabilized by its max (floored at -1e30) and
    divided by max(|sum_j scores_ij|, exp(-m_i))."""
    b, s, h, d = q.shape
    if s % chunk != 0:
        chunk = s  # a single tile for short or ragged sequences
    to_heads = lambda t: t.to(torch.float32).transpose(1, 2)  # noqa: E731  (B,H,S,·)
    qf = to_heads(q) * d ** -0.5
    kf, vf = to_heads(k), to_heads(v)
    fc = torch.cumsum(lf, dim=1).transpose(1, 2)   # (B,H,S) cumulative log forget
    igt = ig.transpose(1, 2)
    kpos = torch.arange(s, device=q.device)
    outs = []
    for c0 in range(0, s, chunk):
        qpos = kpos[c0:c0 + chunk]
        # logD_ij = F_i - F_j + ig_j, in JAX's order
        log_d = fc[..., c0:c0 + chunk, None] - fc[..., None, :] + igt[..., None, :]
        log_d = log_d.masked_fill(kpos[None, :] > qpos[:, None], -torch.inf)  # (B,H,L,S)
        m = log_d.amax(dim=-1, keepdim=True).clamp_min(_M_FLOOR)
        scores = torch.matmul(qf[..., c0:c0 + chunk, :], kf.transpose(-1, -2)) \
            * torch.exp(log_d - m)
        denom = torch.maximum(scores.sum(-1).abs(), torch.exp(-m[..., 0]))   # (B,H,L)
        outs.append(torch.matmul(scores, vf) / denom[..., None])
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)


def _mlstm_final_state(k, v, ig, lf) -> dict:
    """The prefill's (C, n, m): C_S = sum_j exp(F_S - F_j + ig_j - m) k_j
    v_j^T with m = max_j(F_S - F_j + ig_j), not the decode recurrence run
    over the prompt (JAX's ``xlstm_lib_prefill_mlstm``)."""
    fc = torch.cumsum(lf, dim=1)                    # (B,S,H)
    w_log = fc[:, -1:] - fc + ig
    m = w_log.amax(dim=1)                           # (B,H)
    w = torch.exp(w_log - m[:, None]).transpose(1, 2)[..., None]   # (B,H,S,1)
    wk = w * k.to(torch.float32).transpose(1, 2)    # (B,H,S,K)
    c = torch.matmul(wk.transpose(-1, -2), v.to(torch.float32).transpose(1, 2))
    return {"C": c, "n": wk.sum(dim=2), "m": m}


def _mlstm_out(cfg, params: dict, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """h (B,S,H,hd) in the model dtype -> the head-wise norm, the z gate
    and the down projection: (B,S,d)."""
    h = _headwise_rms(h, params["o_norm"]).reshape(z.shape)
    return torch.matmul(h * silu(z), params["down_proj"])


def mlstm_forward(cfg, params: dict, x: torch.Tensor):
    """x: (B,S,d) -> (out (B,S,d), state {"C", "n", "m"} fp32): the output
    and the state a decode continues from."""
    x_in, z = torch.chunk(torch.matmul(x, params["up_proj"]), 2, dim=-1)
    q, k, v, ig, lf = _mlstm_qkv_gates(cfg, params, x_in)
    out = _mlstm_out(cfg, params, mlstm_parallel(q, k, v, ig, lf), z)
    return out, _mlstm_final_state(k, v, ig, lf)


def init_mlstm_cache(cfg, batch: int, *, lead=(), device=None) -> dict:
    _, h, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    return {"C": torch.zeros((*lead, batch, h, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((*lead, batch, h, hd), dtype=f32, device=device),
            "m": torch.full((*lead, batch, h), _M_FLOOR, dtype=f32, device=device)}


def mlstm_decode(cfg, params: dict, x: torch.Tensor, cache: dict):
    """x: (B,1,d) -> (out (B,1,d), cache): the stabilized recurrent step,
    C <- f C + (i k) v^T and n <- f n + i k written into the cache in place."""
    _, _, hd = _mlstm_dims(cfg)
    x_in, z = torch.chunk(torch.matmul(x, params["up_proj"]), 2, dim=-1)
    q, k, v, ig, lf = _mlstm_qkv_gates(cfg, params, x_in)
    qf = q[:, 0].to(torch.float32) * hd ** -0.5     # (B,H,D)
    kf, vf = k[:, 0].to(torch.float32), v[:, 0].to(torch.float32)
    ig, lf = ig[:, 0], lf[:, 0]                     # (B,H)

    lf_m = lf + cache["m"]
    m_new = torch.maximum(lf_m, ig)
    f_sc = torch.exp(lf_m - m_new)[..., None]       # (B,H,1)
    i_sc = torch.exp(ig - m_new)[..., None]
    c = cache["C"].mul_(f_sc[..., None]).addcmul_((i_sc * kf)[..., None], vf[..., None, :])
    n = cache["n"].mul_(f_sc).add_(i_sc * kf)
    cache["m"].copy_(m_new)
    num = torch.matmul(qf[..., None, :], c)[..., 0, :]                   # (B,H,Dv)
    den = torch.maximum(torch.matmul(qf[..., None, :], n[..., None])[..., 0, 0].abs(),
                        torch.exp(-m_new))
    out = (num / den[..., None]).to(x.dtype)[:, None]                    # (B,1,H,Dv)
    return _mlstm_out(cfg, params, out, z), cache


# ============================== sLSTM ==============================
def _slstm_dims(cfg):
    return cfg.n_heads, cfg.d_model // cfg.n_heads


def init_slstm(gen: torch.Generator, cfg, dtype, *, lead=(), device=None) -> dict:
    """JAX's leaves, with the port's own draws; ``lead`` = (L,) draws L
    layers' stacked leaves at once."""
    d = cfg.d_model
    h, hd = _slstm_dims(cfg)
    f32 = torch.float32
    b = torch.zeros((*lead, 4, h, hd), dtype=f32, device=device)
    b[..., 1, :, :] = 3.0  # the forget gate's bias
    return {
        # input weights for the 4 gates (i, f, z, o)
        "w_in": normal(gen, (*lead, d, 4, h, hd), d, dtype, device),
        # block-diagonal recurrent weights per head
        "r": normal(gen, (*lead, 4, h, hd, hd), hd, f32, device),
        "b": b,
        "o_norm": torch.zeros((*lead, h, hd), dtype=f32, device=device),
        "up": normal(gen, (*lead, d, 2 * cfg.d_model), d, dtype, device),
        "down": normal(gen, (*lead, cfg.d_model, d), cfg.d_model, dtype, device),
    }


def init_slstm_cache(cfg, batch: int, *, lead=(), device=None) -> dict:
    h, hd = _slstm_dims(cfg)
    z = lambda: torch.zeros((*lead, batch, h, hd), dtype=torch.float32, device=device)  # noqa: E731
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((*lead, batch, h, hd), _M_FLOOR, dtype=torch.float32,
                            device=device)}


def _slstm_cell(r_heads: torch.Tensor, bias: torch.Tensor, carry: dict,
                gates_in: torch.Tensor) -> dict:
    """One timestep, fp32.  gates_in: (B,4,H,D) fp32 pre-activations from
    the input path; ``r_heads`` the recurrent weights as (H, D, 4·E)."""
    c, n, h_prev, m_prev = carry["c"], carry["n"], carry["h"], carry["m"]
    bsz, heads, hd = h_prev.shape
    # einsum("bhd,ghde->bghe"): one (B,D) @ (D,4E) product a head
    rec = torch.bmm(h_prev.transpose(0, 1), r_heads).view(heads, bsz, 4, hd).permute(1, 2, 0, 3)
    pre = gates_in + rec + bias
    i_t, f_t, z_t, o_t = pre.unbind(1)

    lf_m = _log_sigmoid(f_t) + m_prev
    m_new = torch.maximum(lf_m, i_t)
    i_sc = torch.exp(i_t - m_new)
    f_sc = torch.exp(lf_m - m_new)
    c_new = f_sc * c + i_sc * torch.tanh(z_t)
    n_new = f_sc * n + i_sc
    h_new = torch.sigmoid(o_t) * c_new / n_new.clamp_min(1.0)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_forward(cfg, params: dict, x: torch.Tensor, cache: dict | None = None):
    """x: (B,S,d) -> (out (B,S,d), the carry after the last position): the
    recurrence steps through time from ``cache`` (a fresh state if None),
    which it does not write."""
    b, s, d = x.shape
    h, hd = _slstm_dims(cfg)
    gates = torch.matmul(x, params["w_in"].reshape(d, -1)).view(b, s, 4, h, hd)
    gates = gates.to(torch.float32)               # (B,S,4,H,D)
    carry = cache if cache is not None else init_slstm_cache(cfg, b, device=x.device)
    r_heads = params["r"].permute(1, 2, 0, 3).reshape(h, hd, 4 * hd)   # (H, D, 4·E)
    hs = []
    for t in range(s):
        carry = _slstm_cell(r_heads, params["b"], carry, gates[:, t])
        hs.append(carry["h"])
    hs = _headwise_rms(torch.stack(hs, dim=1), params["o_norm"]).reshape(b, s, d)
    a, g = torch.chunk(torch.matmul(hs.to(x.dtype), params["up"]), 2, dim=-1)
    return torch.matmul(a * silu(g), params["down"]), carry


def slstm_decode(cfg, params: dict, x: torch.Tensor, cache: dict):
    """x: (B,1,d) -> (out (B,1,d), cache): ``slstm_forward`` at S = 1 from
    the cache, the new carry written into it in place."""
    out, carry = slstm_forward(cfg, params, x, cache)
    for key, t in carry.items():
        cache[key].copy_(t)
    return out, cache
