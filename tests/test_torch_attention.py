"""The port's plain attention (``repro_torch.kernels.ref``: the CPU route of
``ops.flash_attention`` / ``ops.decode_attention``, and what the CUDA
kernels are held against on the card) against the JAX package: its jnp
oracle and its Pallas bodies run with ``interpret=True``, on the same numpy
inputs.

Tolerances are ``tests/test_kernels.py``'s: 2e-5 in fp32 (the summation
order of the softmax and of the products differs), 2e-2 in bf16 (one
rounding of the output to bf16 can land on either side of a tie).  The
Pallas bodies need tiles of 128, so ragged shapes are held against the
oracle alone.  The kernel wrappers' own checks run here as well: they
raise before any launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode_pallas
from repro.kernels.flash_attention import flash_attention as jflash_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import flash_attention as flash_kernel

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    """numpy normals, rounded to ``dtype`` once, as both packages' arrays."""
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.normal(size=s).astype(np.float32), JDT[dtype]) for s in shapes]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(TDT[dtype]) for x in jx]
    return jx, tx


def _close(port, jax_out, tol):
    np.testing.assert_allclose(port.to(torch.float32).numpy(), np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,kv,d,window",
    [
        (1, 128, 4, 4, 64, None),      # MHA
        (2, 256, 8, 2, 64, None),      # GQA 4:1
        (1, 256, 4, 1, 128, None),     # MQA
        (2, 256, 4, 4, 64, 64),        # sliding window
        (1, 384, 6, 3, 32, 128),       # non-pow2 heads, window
    ],
)
def test_attention_matches_jax(b, s, h, kv, d, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(s + d, [(b, s, h, d), (b, s, kv, d), (b, s, kv, d)],
                                         dtype)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert out.dtype == TDT[dtype] and out.shape == (b, s, h, d)
    _close(out, jref.attention(jq, jk, jv, causal=True, window=window), TOL[dtype])
    _close(out, jflash_pallas(jq, jk, jv, causal=True, window=window, interpret=True),
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 96])
def test_attention_q_offset_matches_jax(dtype, window):
    """A prefill chunk: 128 queries at positions 128..255 against 256 keys."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(7, [(2, 128, 4, 64), (2, 256, 2, 64),
                                             (2, 256, 2, 64)], dtype)
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window, q_offset=128)
    exp = jref.attention(jq, jk, jv, causal=True, window=window, q_offset=128)
    _close(out, exp, TOL[dtype])
    _close(out, jflash_pallas(jq, jk, jv, causal=True, window=window, q_offset=128,
                              interpret=True), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,sq,skv,h,kv,d,window,q_offset,causal",
    [
        (2, 17, 17, 4, 2, 32, None, 0, True),     # ragged, shorter than a tile
        (1, 100, 100, 6, 3, 40, 32, 0, True),     # ragged, D % 32 != 0, window
        (2, 17, 45, 4, 1, 64, None, 28, True),    # ragged chunk at an offset
        (1, 33, 33, 2, 2, 48, None, 0, False),    # not causal
        (1, 8, 8, 2, 1, 32, 3, 20, True),         # rows with no valid key: uniform mean
    ],
)
def test_attention_ragged_matches_jax_oracle(b, sq, skv, h, kv, d, window, q_offset, causal,
                                             dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(sq * skv, [(b, sq, h, d), (b, skv, kv, d),
                                                    (b, skv, kv, d)], dtype)
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window, q_offset=q_offset)
    exp = jref.attention(jq, jk, jv, causal=causal, window=window, q_offset=q_offset)
    _close(out, exp, TOL[dtype])


def _tensor_core_roundings(q, k, v, *, causal, window, q_offset, bk):
    """The bf16 flash kernel's arithmetic in plain torch: bf16 q and k
    multiplied with fp32 sums, the fp32 scores scaled after the product (in
    log2 units, for exp2) and masked before the max; over key tiles of
    ``bk`` an online softmax whose probabilities are rounded to bf16 for
    P . V while their fp32 values feed the row sums; out = acc / max(l,
    1e-30) rounded to bf16."""
    b, sq, h, d = q.shape
    skv, groups = k.shape[1], h // k.shape[2]
    qf = q.float().transpose(1, 2)                                      # (B,H,Sq,D)
    kf = k.float().repeat_interleave(groups, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(groups, dim=2).transpose(1, 2)
    scale = torch.tensor(d ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    qpos = torch.arange(sq)[:, None] + q_offset
    m = torch.full((b, h, sq, 1), -1e30)
    l, acc = torch.zeros(b, h, sq, 1), torch.zeros(b, h, sq, d)
    for k0 in range(0, skv, bk):
        s = (qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * scale
        kpos = torch.arange(k0, min(k0 + bk, skv))[None, :]
        mask = torch.ones(sq, kpos.shape[1], dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + bk]
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tensor_core_roundings_within_bf16_tolerance_of_jax(d):
    """The card's bf16 route rounds P to bf16 before P . V, where JAX's
    kernel multiplies fp32 operands: emulated here on the CPU, that
    rounding stays within the bf16 tolerance of JAX's oracle, over several
    key tiles (128 keys; 32 at D 256), a ragged Skv and a q_offset."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(d, [(2, 200, 4, d), (2, 333, 2, d), (2, 333, 2, d)],
                                         "bfloat16")
    out = _tensor_core_roundings(tq, tk, tv, causal=True, window=None, q_offset=133,
                                 bk=32 if d == 256 else 128)
    _close(out, jref.attention(jq, jk, jv, causal=True, q_offset=133), TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d", [(2, 256, 8, 4, 64), (1, 128, 4, 1, 128),
                                        (2, 100, 4, 2, 40)])
def test_decode_attention_matches_jax(b, s, h, kv, d, dtype):
    """Against the oracle (both round q * scale and the probabilities to
    the cache dtype) and, where S % 128 == 0, the Pallas body (which keeps
    them in fp32: the bf16 tolerance covers it).  Batch row 0 has a
    linear-cache mask, row 1 a random one."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(s + h, [(b, h, d), (b, s, kv, d), (b, s, kv, d)],
                                         dtype)
    rng = np.random.default_rng(s)
    valid = rng.random((b, s)) > 0.25
    valid[0] = np.arange(s) <= s // 2
    valid[:, 0] = True
    out = ops.decode_attention(tq, tk, tv, kv_valid=torch.from_numpy(valid))
    assert out.dtype == TDT[dtype] and out.shape == (b, h, d)
    _close(out, jref.decode_attention(jq, jk, jv, kv_valid=jnp.asarray(valid)), TOL[dtype])
    if s % 128 == 0:
        _close(out, jdecode_pallas(jq, jk, jv, kv_valid=jnp.asarray(valid), interpret=True),
               TOL[dtype])


def test_decode_attention_all_invalid_row_is_uniform_mean():
    """A row with no valid slot takes the mean of V over every slot, as
    JAX's -1e30 (never -inf) masking gives."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(3, [(1, 2, 32), (1, 64, 1, 32), (1, 64, 1, 32)],
                                         "float32")
    valid = np.zeros((1, 64), bool)
    out = ops.decode_attention(tq, tk, tv, kv_valid=torch.from_numpy(valid))
    _close(out, jref.decode_attention(jq, jk, jv, kv_valid=jnp.asarray(valid)), 2e-5)
    torch.testing.assert_close(out[0, 0], tv[0, :, 0].mean(0), rtol=2e-5, atol=2e-5)


def _split_decode(q, k, v, valid, *, bk, splits):
    """The card's split decode in plain torch, fp32: cache tiles of ``bk``
    slots; a batch row's tiles holding a valid slot (all its tiles if none
    does) shared among ``splits`` by rank, split i taking ranks i * n //
    splits .. (i + 1) * n // splits - 1; in each split an online softmax
    over its tiles from m = -1e30, l = 0, acc = 0 (an empty split keeps
    them) with slots past S at -inf and invalid slots at -1e30; then the
    splits combined in index order, w_i = exp(m_i - max m), out = sum w_i
    acc_i / max(sum w_i l_i, 1e-30)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qs = (q.float() * torch.tensor(d ** -0.5)).reshape(b, kv, g, d)
    tiles = -(-s // bk)
    out = torch.empty(b, kv, g, d)
    for bi in range(b):
        take = [t for t in range(tiles) if valid[bi, t * bk:(t + 1) * bk].any()]
        take = take or list(range(tiles))
        for j in range(kv):
            parts = []
            for sp in range(splits):
                m, l, acc = torch.full((g,), -1e30), torch.zeros(g), torch.zeros(g, d)
                for t in take[sp * len(take) // splits:(sp + 1) * len(take) // splits]:
                    slots = torch.arange(t * bk, (t + 1) * bk)
                    inside = slots < s
                    kt = torch.where(inside[:, None], k[bi, slots.clamp(max=s - 1), j].float(), 0.0)
                    vt = torch.where(inside[:, None], v[bi, slots.clamp(max=s - 1), j].float(), 0.0)
                    sc = torch.where(valid[bi, slots.clamp(max=s - 1)], qs[bi, j] @ kt.T,
                                     torch.tensor(-1e30))
                    sc = torch.where(inside, sc, torch.tensor(-torch.inf))
                    m_new = torch.maximum(m, sc.amax(1))
                    p, alpha = torch.exp(sc - m_new[:, None]), torch.exp(m - m_new)
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + p @ vt
                    m = m_new
                parts.append((m, l, acc))
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            lsum, asum = torch.zeros(g), torch.zeros(g, d)
            for m, l, acc in parts:
                w = torch.exp(m - mx)
                lsum = lsum + w * l
                asum = asum + w[:, None] * acc
            out[bi, j] = asum / lsum.clamp_min(1e-30)[:, None]
    return out.reshape(b, h, d)


@pytest.mark.parametrize("case,b,s,h,kv,d,bk,splits", [
    ("splits with no valid slot", 2, 512, 4, 2, 64, 64, 6),
    ("an all-invalid row", 2, 256, 4, 2, 32, 64, 3),
    ("ragged S", 3, 333, 4, 2, 40, 64, 4),
    ("G = 8", 2, 300, 16, 2, 64, 32, 5),
])
def test_split_decode_arithmetic_matches_jax_oracle(case, b, s, h, kv, d, bk, splits):
    """The split-and-combine arithmetic of the card's decode kernel (plain
    torch, fp32) against JAX's decode oracle at 1e-5: row 0 is a linear
    cache at position 0, so every split but the first has no valid slot
    (or, in the all-invalid case, no valid slot at all), row 1 a ring arc
    with whole tiles invalid before and after it, any further row random."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(s + h, [(b, h, d), (b, s, kv, d), (b, s, kv, d)],
                                         "float32")
    rng = np.random.default_rng(s)
    valid = rng.random((b, s)) > 0.5
    valid[0] = np.arange(s) == 0
    valid[1] = (np.arange(s) >= s // 3) & (np.arange(s) < s // 3 + bk + 7)
    if case == "an all-invalid row":
        valid[0] = False
    out = _split_decode(tq, tk, tv, torch.from_numpy(valid), bk=bk, splits=splits)
    _close(out, jref.decode_attention(jq, jk, jv, kv_valid=jnp.asarray(valid)), 1e-5)


def test_cpu_route_launches_no_kernel():
    before = ops.launch_counts()
    _, (tq, tk, tv) = _inputs(1, [(1, 16, 2, 32), (1, 16, 1, 32), (1, 16, 1, 32)], "float32")
    ops.flash_attention(tq, tk, tv)
    ops.decode_attention(tq[:, 0], tk, tv, kv_valid=torch.ones(1, 16, dtype=torch.bool))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("d", [4, 12, 264])
def test_kernel_wrappers_raise_on_head_dims_they_do_not_take(d):
    """No shape gate, no fallback: a head dim the kernels do not take
    raises before any launch (the wrappers check shapes first)."""
    q, k = torch.zeros(1, 8, 2, d), torch.zeros(1, 8, 1, d)
    with pytest.raises(ValueError, match="head dim"):
        flash_kernel.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        decode_kernel.decode_attention(q[:, 0], k, k,
                                       kv_valid=torch.ones(1, 8, dtype=torch.bool))


def test_kernel_wrappers_raise_off_the_card_and_on_bad_inputs():
    q, k = torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 2, 32)
    valid = torch.ones(1, 8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        decode_kernel.decode_attention(q[:, 0], k, k, kv_valid=valid)
    with pytest.raises(ValueError, match="group"):
        flash_kernel.flash_attention(torch.zeros(1, 8, 3, 32), k, k)
    with pytest.raises(ValueError, match=">= 0"):
        flash_kernel.flash_attention(q, k, k, window=-2)
    with pytest.raises(TypeError):
        flash_kernel.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        decode_kernel.decode_attention(q[:, 0], k, k, kv_valid=valid.int())
    with pytest.raises(ValueError, match="contiguous"):
        decode_kernel.decode_attention(q[:, 0], k, k,
                                       kv_valid=torch.ones(1, 16, dtype=torch.bool)[:, ::2])


@pytest.mark.parametrize("splits", [0, 65_536, 2.0, True, "4"])
def test_decode_kernel_wrapper_raises_on_bad_splits(splits):
    q, k = torch.zeros(1, 4, 32), torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="splits"):
        decode_kernel.decode_attention(q, k, k, kv_valid=torch.ones(1, 8, dtype=torch.bool),
                                       splits=splits)


@pytest.mark.parametrize("splits", [None, 1, 3, 65_535])
def test_decode_kernel_wrapper_raises_off_the_card_with_any_splits(splits):
    q, k = torch.zeros(1, 4, 32), torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        decode_kernel.decode_attention(q, k, k, kv_valid=torch.ones(1, 8, dtype=torch.bool),
                                       splits=splits)


def test_decode_split_sizing():
    """Tiles as the .cu source sizes them (64 slots, fewer where a K tile
    passes 16 KB) and the default split count: one wave of 2 CTAs an SM on
    a 132-SM card, at least one split, at most one a tile."""
    assert [decode_kernel.tile_slots(dp, 2) for dp in (64, 128, 256)] == [64, 64, 32]
    assert [decode_kernel.tile_slots(dp, 4) for dp in (64, 128, 256)] == [64, 32, 16]
    splits = decode_kernel.default_splits(8, 8, 2048 // 64, 132)
    assert splits == 4 and 8 * 8 * splits <= 2 * 132 < 8 * 8 * (splits + 1)
    assert decode_kernel.default_splits(1, 1, 1, 132) == 1          # S = 1: one tile
    assert decode_kernel.default_splits(64, 16, 256, 132) == 1      # B*KV alone fills the card
    assert decode_kernel.default_splits(1, 1, 10**6, 132) == 264
