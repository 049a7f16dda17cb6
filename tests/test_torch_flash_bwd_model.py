"""The flash backward's bf16 route (``kernels/csrc/flash_attention.cu``,
two wgmma kernels) modelled on the CPU: ``tests/torch_kernel_models.py``'s
plain copies of the two kernels' tile walks and of their transposed
arithmetic.

For every mask of ``FLASH_BWD_CASES``: each valid (query, key) pair is
visited exactly once by each walk (by each pass of the dK / dV walk), a
row with no valid key reaches every key in the dK / dV walk, and the
items run heaviest first (globally, so on every persistent CTA too).  The
arithmetic model (P^T, dS^T and dS rounded to bf16 before their products,
fp32 sums) against ``ref.attention_bwd`` and JAX's gradient of its
attention oracle within the bf16 tolerance, 2e-2 of each tensor's
max-abs, the card tests' (``ATTN_TOL``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from torch_kernel_models import (FLASH_BWD_CASES, flash_bwd_bf16_model, flash_bwd_dkv_walk,
                                 flash_bwd_dq_walk)

BF16_TOL = 2e-2


def _valid(sq, skv, window, q_offset, causal):
    return ref.attention_mask(sq, skv, causal=causal, window=window, q_offset=q_offset,
                              device="cpu").numpy()


def _tile_pairs(valid, rows, cols):
    """(query tiles, key tiles) bool: whether the block holds a valid pair."""
    sq, skv = valid.shape
    padded = np.zeros((-(-sq // rows) * rows, -(-skv // cols) * cols), bool)
    padded[:sq, :skv] = valid
    return padded.reshape(padded.shape[0] // rows, rows, -1, cols).any(axis=(1, 3))


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=[c[0] for c in FLASH_BWD_CASES])
def test_dq_walk_visits_each_valid_pair_once_heaviest_first(case):
    _, b, sq, skv, h, kv, d, _, window, q_off, causal = case
    ctas = flash_bwd_dq_walk(b, sq, skv, h, kv, d, window, q_off, causal)
    items = [it for cta in ctas for it in cta]
    assert sorted((bb, hh, qt) for bb, hh, qt, _, _ in items) == [
        (bb, hh, qt) for bb in range(b) for hh in range(h) for qt in range(-(-sq // 128))]
    bk = 32 if d > 128 else 64
    need = _tile_pairs(_valid(sq, skv, window, q_off, causal), 128, bk)
    for bb, hh, qt, kts, _ in items:
        assert len(set(kts)) == len(kts) and all(0 <= kt < need.shape[1] for kt in kts)
        assert need[qt].nonzero()[0].tolist() == [kt for kt in kts if need[qt, kt]]
    # in item order over the grid (w = CTA + j * grid), weights never grow
    grid = len(ctas)
    order = [ctas[w % grid][w // grid][4] for w in range(len(items))]
    assert order == sorted(order, reverse=True)


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=[c[0] for c in FLASH_BWD_CASES])
def test_dkv_walk_visits_each_valid_pair_once_heaviest_first(case):
    _, b, sq, skv, h, kv, d, _, window, q_off, causal = case
    ctas = flash_bwd_dkv_walk(b, sq, skv, h, kv, d, window, q_off, causal)
    items = [it for cta in ctas for it in cta]
    n_kt = -(-skv // 128)
    assert sorted((bb, kvh, kt) for bb, kvh, kt, _, _ in items) == [
        (bb, kvh, kt) for bb in range(b) for kvh in range(kv) for kt in range(n_kt)]
    bq, passes = (32, 4) if d > 128 else (64, 1)
    valid = _valid(sq, skv, window, q_off, causal)
    need = _tile_pairs(valid, bq, 128)
    # the query tiles holding a row with no valid key reach every key tile
    empty = np.zeros(need.shape[0], bool)
    np.logical_or.at(empty, np.arange(sq) // bq, ~valid.any(1))
    g = h // kv
    for bb, kvh, kt, tiles, _ in items:
        for p in range(passes):
            walked = [(head, qt) for pp, head, qt in tiles if pp == p]
            assert len(set(walked)) == len(walked)
            heads = range(kvh * g, (kvh + 1) * g)
            for head in heads:
                qts = {qt for hd, qt in walked if hd == head}
                assert set(need[:, kt].nonzero()[0]) <= qts
                assert set(empty.nonzero()[0]) <= qts
            assert {hd for hd, _ in walked} <= set(heads)
    if empty.any():
        assert any(tiles for *_, tiles, _ in items)
    grid = len(ctas)
    order = [ctas[w % grid][w // grid][4] for w in range(len(items))]
    assert order == sorted(order, reverse=True)


# label, B, Sq, Skv, H, KV, D, window, q_offset, causal: the masks of
# FLASH_BWD_CASES at a CPU size
MODEL_CASES = [
    ("GQA causal", 2, 40, 40, 4, 2, 16, None, 0, True),
    ("window at q_offset", 1, 24, 56, 4, 2, 16, 9, 32, True),
    ("ragged, not causal", 1, 37, 45, 2, 2, 24, None, 0, False),
    ("rows with no valid key", 1, 8, 24, 2, 1, 40, 3, 20, True),
]


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_bf16_arithmetic_model_is_the_gradient(case):
    _, b, sq, skv, h, kv, d, window, q_off, causal = case
    kw = dict(causal=causal, window=window, q_offset=q_off)
    rng = np.random.default_rng(sq + d)
    q, k, v, dout = (torch.tensor(rng.normal(size=s), dtype=torch.bfloat16) for s in
                     ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d), (b, sq, h, d)))
    out, lse = ref.attention_with_lse(q, k, v, **kw)
    got = flash_bwd_bf16_model(q, k, v, out, lse, dout, **kw)
    plain = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
    grad = jax.jit(jax.grad(lambda a, bb, c, do: jnp.sum(jref.attention(a, bb, c, **kw) * do),
                            argnums=(0, 1, 2)))
    auto = grad(*(jnp.asarray(t.float().numpy()) for t in (q, k, v, dout)))
    for g, p, a in zip(got, plain, auto, strict=True):
        assert g.dtype == torch.bfloat16 and g.shape == p.shape
        a = torch.from_numpy(np.array(a, np.float32))
        for want in (p.float(), a):
            err = float((g.float() - want).abs().max()) / float(want.abs().max())
            assert err <= BF16_TOL, err
