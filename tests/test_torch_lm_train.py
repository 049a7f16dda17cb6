"""The port's dense transformer training against the JAX package on the
CPU: the LM data (bitwise), the flash backward's plain version and its
autograd wiring (``ops._FlashAttention`` / ``_FlashAttentionBwd`` under
``torch.func.vmap(grad_and_value)``), ``cross_entropy`` and ``loss_fn`` with
every leaf's gradient against ``jax.value_and_grad``, two rounds of
``make_round_step`` against the JAX engine, and the LLM fine-tune example's
twin.  Inputs come from numpy seeds; params cross as numpy arrays.

Tolerances, stated with their reasons:
- attention gradients within 1e-5 of each tensor's max-abs: the plain
  versions compute in fp32 whatever the input dtype (fp64 inputs too), and
  the flash formulas sum in another order than autograd's softmax backward;
- fp32 loss within 1e-5 relative and every gradient leaf within 1e-4 of its
  max-abs: both packages run fp32 matmuls that sum in another order
  (observed ~3e-6 relative);
- bf16 loss within 1e-3 relative, gradient leaves within 4e-2 of their
  max-abs (observed up to 2.4e-4 and 1.8e-2): both round activations to
  bf16 at the same steps, but a bf16 ulp (2**-8) in a different place on
  either side moves the 2-layer backward's products by a few ulps;
- the round step's globals and residuals within 1e-6 absolute (the
  engine's own tolerance in ``tests/test_torch_rounds.py``), LoRA on its
  first round only: QR rounds differently in the two packages, so later
  LoRA rounds compress differently rounded residuals (the LoRA basis itself
  is JAX's, patched in as ``tests/test_torch_segments.py`` does).
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

import repro.core as J
import repro.data.loader as jloader
import repro.data.synthetic as jsyn
from repro.configs.base import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm
from repro.optim import sgd as jsgd
import repro_torch.core as T
import repro_torch.core.compression as tcomp
import repro_torch.data.loader as tloader
import repro_torch.data.synthetic as tsyn
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_leaves, tree_size

ITEM = "item 15"
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------- the LM data ----------------
@pytest.mark.parametrize("seed", [0, 7, (3, 2), (1234, 8)])
def test_lm_data_is_bitwise_the_reference(seed):
    kw = dict(n_tokens=500, vocab_size=97, seed=seed)
    np.testing.assert_array_equal(tsyn.make_lm_tokens(**kw), jsyn.make_lm_tokens(**kw))
    kw = dict(n_batches=3, batch=2, seq_len=16, vocab_size=97, seed=seed)
    for t, j in zip(tsyn.make_lm_batches(**kw), jsyn.make_lm_batches(**kw), strict=True):
        assert t.keys() == j.keys()
        for key in t:
            assert t[key].dtype == j[key].dtype
            np.testing.assert_array_equal(t[key], j[key])
    kw = dict(n_clients=3, steps=2, batch_size=2, seq_len=12, vocab_size=97, seed=seed)
    t, j = tloader.lm_round_batch(**kw), jloader.lm_round_batch(**kw)
    assert t["tokens"].shape == (3, 2, 2, 12)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(t[key], j[key])


def test_stack_client_batches_is_bitwise_the_reference():
    from repro.data.federated import ClientDataset as JClient
    from repro_torch.data.federated import ClientDataset as TClient

    rng = np.random.default_rng(5)
    x, y = rng.normal(size=(10, 3)).astype(np.float32), rng.integers(0, 4, 10).astype(np.int32)
    t = tloader.stack_client_batches([TClient(i, x, y) for i in range(2)], steps=3,
                                     batch_size=4)
    j = jloader.stack_client_batches([JClient(i, x, y) for i in range(2)], steps=3,
                                     batch_size=4)
    for key in ("x", "y"):
        assert t[key].shape == j[key].shape
        np.testing.assert_array_equal(t[key], j[key])


# ---------------- the flash backward ----------------
# label, B, Sq, Skv, H, KV, D, causal, window, q_offset
ATTN_CASES = [
    ("GQA causal", 2, 24, 24, 4, 2, 16, True, None, 0),
    ("MHA not causal", 1, 9, 13, 2, 2, 8, False, None, 0),
    ("window 5 at q_offset 20", 2, 16, 40, 4, 1, 16, True, 5, 20),
    ("ragged S", 1, 37, 37, 4, 4, 8, True, None, 0),
    # rows from position 26 on have no valid key (the window ends past Skv)
    ("fully masked rows", 1, 8, 24, 2, 1, 8, True, 3, 20),
]


def _attn_inputs(dtype, b, sq, skv, h, kv, d, seed=0, clients=None):
    rng = np.random.default_rng(seed)
    lead = () if clients is None else (clients,)
    shapes = ((*lead, b, sq, h, d), (*lead, b, skv, kv, d), (*lead, b, skv, kv, d),
              (*lead, b, sq, h, d))
    return [torch.tensor(rng.normal(size=s), dtype=dtype) for s in shapes]


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_attention_bwd_is_autograd_of_the_plain_attention(case, dtype):
    _, b, sq, skv, h, kv, d, causal, window, q_off = case
    kw = dict(causal=causal, window=window, q_offset=q_off)
    q, k, v, dout = _attn_inputs(dtype, b, sq, skv, h, kv, d)
    out, lse = ref.attention_with_lse(q, k, v, **kw)
    assert torch.equal(out, ref.attention(q, k, v, **kw))  # bitwise: serving does not move
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref.attention(qr, kr, vr, **kw).backward(dout)
    grads = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
    for got, want in zip(grads, (qr.grad, kr.grad, vr.grad), strict=True):
        assert got.dtype == dtype and torch.isfinite(got).all()
        assert _rel_err(got, want) <= 1e-5
    if case[0] == "fully masked rows":
        qpos = np.arange(sq) + q_off
        empty = torch.from_numpy(qpos >= 26)
        assert empty.any() and not empty.all()
        assert not grads[0][:, empty].any()  # no gradient through a fully masked row's scores


def test_attention_bwd_matches_jax_grad_of_its_oracle():
    """The plain backward against JAX's gradient of its own attention
    oracle: GQA, a window and q_offset."""
    b, sq, skv, h, kv, d, window, q_off = 2, 16, 40, 4, 2, 16, 9, 24
    q, k, v, dout = _attn_inputs(torch.float32, b, sq, skv, h, kv, d, seed=3)
    kw = dict(causal=True, window=window, q_offset=q_off)
    out, lse = ref.attention_with_lse(q, k, v, **kw)
    grads = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
    jout, vjp = jax.vjp(lambda a, bb, c: jref.attention(a, bb, c, **kw),
                        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for got, want in zip(grads, vjp(jnp.asarray(dout.numpy())), strict=True):
        assert _rel_err(got, torch.from_numpy(np.array(want))) <= 1e-5


@pytest.fixture
def counted(monkeypatch):
    """Calls of the plain forward-with-lse and backward that ops reaches."""
    calls = {"fwd": 0, "bwd": 0}

    def wrap(name, key):
        fn = getattr(ref, name)

        def counting(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(ref, name, counting)

    wrap("attention_with_lse", "fwd")
    wrap("attention_bwd", "bwd")
    return calls


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
def test_flash_pair_under_vmap_grad_is_autograd_of_the_plain_attention(case, dtype, counted):
    """The round engine's wiring: vmap over 3 clients of grad_and_value,
    K and V per client, Q once unmapped and once mapped: one forward and
    one backward call for the whole cohort (the mapped dim folded into B)."""
    _, b, sq, skv, h, kv, d, causal, window, q_off = case
    kw = dict(causal=causal, window=window, q_offset=q_off)
    q, k, v, w = _attn_inputs(dtype, b, sq, skv, h, kv, d, seed=1, clients=3)

    def loss(attend):
        def f(kv_pair, qq):
            return (attend(qq, *kv_pair, **kw) * w[0]).sum()
        return f

    for q_dim, qq in ((0, q), (None, q[0])):
        run = torch.func.vmap(torch.func.grad_and_value(loss(ops.flash_attention), argnums=(0, 1)),
                              in_dims=((0, 0), q_dim))
        counted.update(fwd=0, bwd=0)
        (gkv, gq), val = run((k, v), qq)
        assert counted == {"fwd": 1, "bwd": 1}
        plain = torch.func.vmap(torch.func.grad_and_value(loss(ref.attention), argnums=(0, 1)),
                                in_dims=((0, 0), q_dim))
        (pkv, pq), pval = plain((k, v), qq)
        assert torch.equal(val, pval)
        for got, want in zip((*gkv, gq), (*pkv, pq), strict=True):
            assert got.shape == want.shape and torch.isfinite(got).all()
            assert _rel_err(got, want) <= 1e-5


def test_flash_without_autograd_saves_nothing_and_double_backward_raises(counted):
    q, k, v, dout = _attn_inputs(torch.float32, 1, 8, 8, 2, 1, 8)
    with torch.inference_mode():
        out = ops.flash_attention(q, k, v)
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, v)
    assert counted == {"fwd": 0, "bwd": 0} and torch.equal(out, ref.attention(q, k, v))
    qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
    (g,) = torch.autograd.grad((ops.flash_attention(qq, kk, vv) * dout).sum(), qq,
                               create_graph=True)
    assert counted == {"fwd": 1, "bwd": 1}
    with pytest.raises(RuntimeError, match="double backward"):
        g.sum().backward()


def test_serving_kernels_refuse_autograd_on_the_card():
    """decode_attention has no backward: on the card, ``ops._refuse_autograd``
    raises for an input that needs a gradient or a functorch wrapper,
    naming item 15 (the check itself runs on the CPU)."""
    x = torch.ones(2, 3)
    ops._refuse_autograd("decode_attention", x, x)  # plain tensors pass
    with torch.no_grad():
        ops._refuse_autograd("decode_attention", x.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match=f"decode_attention has no backward.*{ITEM}"):
        ops._refuse_autograd("decode_attention", x, x.clone().requires_grad_())

    def under_vmap(row):
        ops._refuse_autograd("decode_attention", row)
        return row

    with pytest.raises(NotImplementedError, match=f"decode_attention has no backward.*{ITEM}"):
        torch.func.vmap(under_vmap)(x)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        torch.func.grad(lambda r: under_vmap(r).sum())(x)


# ---------------- cross_entropy and loss_fn ----------------
DENSE = ("qwen3-0.6b", "granite-8b", "stablelm-3b")


@functools.cache
def _models(arch, dtype="float32", scan=True, **kw):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype, scan_layers=scan, **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, scan_layers=scan, **kw)
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _lm_batch(vocab, b=2, s=32, seed=0, masked=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}
    if masked:
        batch["labels"][0, :5] = -1
        batch["labels"][1, -3:] = -1
    return batch


def _f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(
        jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("chunk", [0, 8, 32, 12])  # 32 = S and 12 do not chunk
def test_cross_entropy_matches_jax(chunk):
    jm, tm, jp, tp = _models("qwen3-0.6b")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, tm.arch.d_model)).astype(np.float32)
    labels = _lm_batch(tm.arch.vocab_size)["labels"]
    labels[1, :] = -1  # a row with nothing to predict
    jce = jtfm.cross_entropy(jm.cfg, jp, jnp.asarray(x), jnp.asarray(labels), chunk=chunk)
    tce = tfm.cross_entropy(tm.arch, tp, torch.from_numpy(x), torch.from_numpy(labels),
                            chunk=chunk)
    np.testing.assert_allclose(float(tce), float(jce), rtol=1e-6)
    none = np.full_like(labels, -1)  # no token at all: 0 / max(0, 1) = 0
    assert float(tfm.cross_entropy(tm.arch, tp, torch.from_numpy(x), torch.from_numpy(none),
                                   chunk=chunk)) == 0.0


def _check_loss_and_grads(jm, tm, jp, tp, batch, loss_tol, grad_tol):
    (jl, jmet), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tg, (tl, tmet) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(tp, tb)
    assert set(tmet) == set(jmet)
    np.testing.assert_allclose(float(tl), float(jl), rtol=loss_tol)
    np.testing.assert_allclose(float(tmet["ce"]), float(jmet["ce"]), rtol=loss_tol)
    jleaves, tleaves = jax.tree.leaves(jg), tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for jleaf, tleaf in zip(jleaves, tleaves):
        assert tuple(tleaf.shape) == jleaf.shape and tleaf.dtype == TDT[str(jleaf.dtype)]
        a, b = _f32(tleaf), _f32(jleaf)
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= grad_tol * np.abs(b).max()


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "per-layer"])
@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_and_every_gradient_match_jax(arch, scan):
    jm, tm, jp, tp = _models(arch, scan=scan)
    _check_loss_and_grads(jm, tm, jp, tp, _lm_batch(tm.arch.vocab_size), 1e-5, 1e-4)


def test_loss_fn_with_a_sliding_window_and_chunked_ce_matches_jax():
    jm, tm, jp, tp = _models("qwen3-0.6b", sliding_window=8)
    jm = jbuild_model(jm.cfg, ce_chunk=8)
    tm = build_model(tm.arch, device="cpu", ce_chunk=8)
    _check_loss_and_grads(jm, tm, jp, tp, _lm_batch(tm.arch.vocab_size, seed=2), 1e-5, 1e-4)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "stablelm-3b"])
def test_loss_fn_in_bf16_matches_jax(arch):
    jm, tm, jp, tp = _models(arch, dtype="bfloat16", scan=False)
    _check_loss_and_grads(jm, tm, jp, tp, _lm_batch(tm.arch.vocab_size, seed=4), 1e-3, 4e-2)


# ---------------- the round engine ----------------
C, STEPS = 2, 2
WEIGHTS = np.asarray([1.0, 3.0], np.float32)
BUDGETS = np.asarray([2, 1], np.int32)


@pytest.fixture
def jax_basis(monkeypatch):
    """LoRA's basis carried across: the port draws JAX's q."""
    def basis(seed, seg, n, r):
        key = jax.random.fold_in(jax.random.key(seed), seg.offset)
        return torch.from_numpy(np.asarray(jax.random.normal(key, (n, r), jnp.float32)).copy())

    monkeypatch.setattr(tcomp, "segment_basis", basis)


def _codecs(name, jparams, tparams):
    if name == "lora":
        return (J.LoRACodec(rank=2, factor_codec=J.Int8Codec(), fallback=J.Int8Codec())
                .with_segments(J.SegmentMap.from_tree(jparams)),
                T.LoRACodec(rank=2, factor_codec=T.Int8Codec(), fallback=T.Int8Codec())
                .with_segments(T.SegmentMap.from_tree(tparams)))
    return getattr(J, name)(), getattr(T, name)()


def _flat(leaves):
    return np.concatenate([_f32(x).reshape(-1) for x in leaves])


@pytest.mark.parametrize("codec", ["NullCodec", "Int8Codec", "lora"])
@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_round_step_on_the_transformer_matches_jax(mode, codec, jax_basis):
    """Two rounds of ``make_round_step`` on qwen3-0.6b.reduced() (fp32, 2
    clients, 2 local steps, client 1 cut to 1 by its budget) against JAX's
    jitted engine on the same params and batches: the nested param dict of
    stacked leaves runs under ``torch.func.vmap`` (parallel) and one client
    at a time (sequential).  JAX's second round starts from the port's
    state, so each round compares one round's work from equal inputs."""
    jm, tm, jp, tp = _models("qwen3-0.6b")
    n = tree_size(tp)
    jc, tc = _codecs(codec, jp, tp)
    spec = dict(max_steps=STEPS, execution_mode=mode)
    jrs = jax.jit(J.make_round_step(jm.loss_fn, jsgd(0.1), J.FedAvg(),
                                    J.RoundSpec(**spec, codec=jc)))
    trs = T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(), T.RoundSpec(**spec, codec=tc))
    jg, jst = jp, jc.init_client_state(C, n)
    tg, tst = tp, tc.init_client_state(C, n, device="cpu")
    for rnd in (1, 2):
        batch = jloader.lm_round_batch(n_clients=C, steps=STEPS, batch_size=1, seq_len=16,
                                       vocab_size=tm.arch.vocab_size, seed=(11, rnd))
        if rnd == 2:
            jg = jax.tree.unflatten(jax.tree.structure(jp),
                                    [jnp.asarray(x.numpy()) for x in tree_leaves(tg)])
            jst = jax.tree.unflatten(jax.tree.structure(jst),
                                     [jnp.asarray(x.numpy()) for x in tree_leaves(tst)])
        before = _flat(tree_leaves(tg))
        jg, _, jst, jmet = jrs(jg, (), jst, jax.tree.map(jnp.asarray, batch),
                               jnp.asarray(WEIGHTS), jnp.asarray(BUDGETS), rnd)
        tg, _, tst, tmet = trs(tg, (), tst, {k: torch.from_numpy(v) for k, v in batch.items()},
                               torch.from_numpy(WEIGHTS), torch.from_numpy(BUDGETS), rnd)
        assert set(tmet) == set(jmet)
        np.testing.assert_allclose(float(tmet["client_loss_mean"]),
                                   float(jmet["client_loss_mean"]), rtol=1e-5)
        assert int(tmet["steps_total"]) == int(jmet["steps_total"]) == 3
        assert all(torch.isfinite(x).all() for x in tree_leaves(tg))
        if codec == "lora" and rnd == 2:
            continue
        new = _flat(jax.tree.leaves(jg))
        # sequential: deltas meet in a bf16 accumulator, whose rounding a
        # last-bit difference in a delta can flip: one bf16 step (2**-7 of
        # the round's largest update, for two clients)
        step = 2.0**-7 * np.abs(new - before).max() if mode == "sequential" else 0.0
        _close_up_to_roundings(_flat(tree_leaves(tg)), new,
                               [(_f32(t), _f32(j)) for t, j in
                                zip(tree_leaves(tst), jax.tree.leaves(jst), strict=True)],
                               step)


MAX_FLIP_SHARE = 1e-3


def _close_up_to_roundings(tglobal, jglobal, states, bf16_step, tol=1e-6):
    """Globals and residual rows within ``tol``, except where a rounding
    came out one apart between the packages (their deltas differ in the
    last bits): an Int8 code on its rounding edge moves its residual entry
    by a block scale, and the global by at most that; the sequential
    mode's bf16 accumulator moves a global entry by at most ``bf16_step``.
    At most ``MAX_FLIP_SHARE`` of the residual entries, and of the global
    entries beyond those, may."""
    gaps = np.concatenate([np.abs(t - j).reshape(-1) for t, j in states] or [np.zeros(0)])
    flips = gaps > tol
    assert flips.sum() <= MAX_FLIP_SHARE * max(flips.size, 1), flips.sum()
    off = np.abs(tglobal - jglobal)
    extra = MAX_FLIP_SHARE * off.size if bf16_step else 0
    assert (off > tol).sum() <= flips.sum() + extra, (off > tol).sum()
    assert off.max() <= max(tol, gaps.max(initial=0.0), bf16_step), off.max()


# ---------------- the example ----------------
TINY = ["--rounds", "2", "--layers", "1", "--d-model", "64", "--seq", "16", "--batch", "1",
        "--clients", "2", "--local-steps", "2", "--device", "cpu"]


def _example():
    return importlib.import_module("repro_torch.examples.federated_llm_finetune")


@pytest.mark.parametrize("codec", [["--codec", "fp32"], ["--codec", "lora", "--rank", "2"]],
                         ids=["fp32", "lora"])
def test_llm_finetune_twin_smoke(codec, capsys):
    params, loss = _example().main(TINY + codec)
    assert np.isfinite(loss) and tree_leaves(params)
    assert all(torch.isfinite(x).all() for x in tree_leaves(params))
    out = capsys.readouterr().out
    assert "round  2  mean client CE loss" in out and "vs int8 dense" in out


def test_llm_finetune_twin_lora_wire_beats_int8_10x():
    cfg = get_config("qwen3-0.6b").reduced(n_layers=1, d_model=64)
    params = build_model(cfg, device="cpu").init(0)
    n = tree_size(params)
    lora, int8 = _example().build_codec("lora", params, rank=4)
    assert int8.wire_bytes(n) >= 10 * lora.wire_bytes(n)
    jparams = jbuild_model(jget_config("qwen3-0.6b").reduced(n_layers=1, d_model=64)).init(
        jax.random.key(0))
    jlora = J.LoRACodec(rank=4, factor_codec=J.Int8Codec(), fallback=J.Int8Codec()
                        ).with_segments(J.SegmentMap.from_tree(jparams))
    assert lora.wire_bytes(n) == jlora.wire_bytes(n)
    with pytest.raises(ValueError, match="unknown codec"):
        _example().build_codec("zstd", params, rank=4)


# each family whose training is not ported, and the gap its refusal names
# (the MoE family trains: tests/test_torch_moe_train.py; MLA and the frontend
# tokens: tests/test_torch_mla_train.py; the hybrid Mamba stack:
# tests/test_torch_mamba_train.py)
UNPORTED = [("xlstm-1.3b", "xLSTM")]


@pytest.mark.parametrize("arch,gap", UNPORTED, ids=[a for a, _ in UNPORTED])
def test_llm_finetune_twin_refuses_an_unported_family(arch, gap):
    with pytest.raises(NotImplementedError, match=f"{gap}.*{ITEM}"):
        _example().main(TINY + ["--arch", arch, "--codec", "lora", "--rank", "2"])
