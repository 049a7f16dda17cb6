"""Port parity for the round engine without a mesh (``core/rounds.py``):
``make_round_step`` against the JAX package's jitted round step, for the
parallel and sequential modes with the Null, Int8 and TopK codecs, on the
same JAX-initialized params and numpy batches, for the head model and the
reduced ResNet (whose tolerance ``test_resnet_round_step_matches_jax``
states).

Tolerances: local SGD is fp32 on both sides but its matmuls sum in another
order, so params differ in the last bits (observed ~3e-8 after two rounds):
``atol=1e-6`` for the new globals and residuals.  That leaves an Int8 code
or a TopK selection on its rounding edge free to differ between the
packages; none did on these inputs, and the tests say so where it would
matter: an identical delta fed to both packages' ``aggregate_batch`` must
give bitwise codes and indices, and in the full rounds every TopK index
that differs may move the global only by its |value| x weight share.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

import repro.core as J
from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import sgd as jsgd
import repro_torch.core as T
from repro_torch.configs.base import get_config
from repro_torch.core.rounds import make_multi_round_step
from repro_torch.launch import ClientMesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_leaves

C, STEPS, B = 3, 2, 8
WEIGHTS = np.asarray([1.0, 2.0, 0.5], np.float32)
BUDGETS = np.asarray([2, 1, 2], np.int32)  # the tau cutoff: client 1 stops after one step
DROP_1 = np.asarray([1.0, 0.0, 1.0], np.float32)
CODECS = ["NullCodec", "Int8Codec", "TopKCodec"]
MAX_FLIP_SHARE = 1e-2  # Int8 codes / TopK selections that may differ (restart)


@functools.cache
def _models():
    jm = jbuild_model(jget_config("mobilenet-head-office31").reduced())
    jparams = jm.init(jax.random.key(0))
    tm = build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")
    return jm, jparams, tm


def _torch_round_step(mode, codec_name, microbatches=1, **kw):
    _, _, tm = _models()
    spec = T.RoundSpec(max_steps=STEPS, execution_mode=mode, microbatches=microbatches,
                       codec=getattr(T, codec_name)())
    return T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(), spec, **kw)


def _batches(seed=0, c=C, steps=STEPS, b=B):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(c, steps, b, 64)).astype(np.float32),
        "y": rng.integers(0, 31, (c, steps, b)).astype(np.int32),
    }


def _torch_params():
    _, jparams, _ = _models()
    return params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _n_params():
    return sum(x.size for x in jax.tree.leaves(_models()[1]))


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _flat(tree, jax_side):
    leaves = jax.tree.leaves(tree) if jax_side else [x.numpy() for x in tree_leaves(tree)]
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


def _check_round_step(models, batch, mode, codec_name, tol=1e-6, restart=False):
    """Two rounds of the port's round step against JAX's from the same
    params and batches: the first with every client (the port passes
    ``mask=None``, JAX an all-ones mask: the contract says they are the
    same bits), the second with client 1 dropped.  New globals and
    residuals within ``atol=tol``.

    With ``restart``, JAX's second round starts from the state the port's
    started from (params and residual rows), so no difference carries, and
    a code or selection on its edge may differ between the packages: an
    Int8 code moves its residual entry by one block scale, a TopK
    selection moves its value between wire and residual.  At most
    ``MAX_FLIP_SHARE`` of the entries may, each moving the global by its
    residual gap times the client's weight share."""
    jm, jparams, tm = models
    spec = dict(max_steps=STEPS, execution_mode=mode)
    jrs = jax.jit(J.make_round_step(jm.loss_fn, jsgd(0.1), J.FedAvg(),
                                    J.RoundSpec(**spec, codec=getattr(J, codec_name)())))
    trs = T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(),
                            T.RoundSpec(**spec, codec=getattr(T, codec_name)()))
    n = sum(x.size for x in jax.tree.leaves(jparams))
    jc, tc = getattr(J, codec_name)(), getattr(T, codec_name)()
    jg, jst = jparams, jc.init_client_state(C, n)
    tg = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tst = tc.init_client_state(C, n, device="cpu")
    for rnd, mask in enumerate((np.ones(C, np.float32), DROP_1)):
        if restart and rnd:
            jg = jax.tree.unflatten(jax.tree.structure(jparams),
                                    [jnp.asarray(x.numpy()) for x in tree_leaves(tg)])
            jst = jst if codec_name == "NullCodec" else jnp.asarray(tst.numpy())
        tst_in = tst
        jg, _, jst, jmet = jrs(jg, (), jst, jax.tree.map(jnp.asarray, batch),
                               jnp.asarray(WEIGHTS), jnp.asarray(BUDGETS), rnd, jnp.asarray(mask))
        tg, _, tst, tmet = trs(tg, (), tst, _t(batch), torch.from_numpy(WEIGHTS),
                               torch.from_numpy(BUDGETS), rnd,
                               None if rnd == 0 else torch.from_numpy(mask))
        atol, flips = tol, False
        if codec_name != "NullCodec":
            gap = np.abs(tst.numpy() - np.asarray(jst))
            flips = gap > tol
            if codec_name == "TopKCodec":
                flips = flips & ((np.asarray(jst) == 0) != (tst.numpy() == 0))
            assert flips.sum() <= (MAX_FLIP_SHARE * flips.size if restart else 0), flips.sum()
            share = (WEIGHTS * mask / (WEIGHTS * mask).sum())[:, None]
            atol = atol + (flips * gap * share).sum(axis=0)
        assert np.all(np.abs(_flat(tg, False) - _flat(jg, True)) <= atol)
        if codec_name != "NullCodec":
            np.testing.assert_allclose(np.where(flips, 0, tst.numpy()),
                                       np.where(flips, 0, np.asarray(jst)), rtol=0, atol=tol)
            if rnd == 1:  # the dropped client's residual row: bitwise unchanged
                assert torch.equal(tst[1], tst_in[1])
        else:
            assert tst == () and jst == ()
        assert set(tmet) == set(jmet)
        # |d mean of row norms| <= the mean of the rows' gap norms
        met_atol = {}
        if restart and codec_name != "NullCodec":
            met_atol["residual_norm_mean"] = float(
                np.mean(np.linalg.norm(np.where(flips, gap, tol), axis=1)))
        for key in jmet:
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5,
                                       atol=met_atol.get(key, 1e-7), err_msg=key)
    assert int(tmet["steps_total"]) == 4  # budgets 2 + 2; the dropped client's step left out


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_round_step_matches_jax(mode, codec_name):
    _check_round_step(_models(), _batches(), mode, codec_name)


@functools.cache
def _resnet_models():
    jm = jbuild_model(jget_config("resnet18-cifar10").reduced())
    tm = build_model(get_config("resnet18-cifar10").reduced(), device="cpu")
    return jm, jm.init(jax.random.key(0)), tm


@pytest.mark.parametrize("codec_name", CODECS)
@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_resnet_round_step_matches_jax(mode, codec_name):
    """The reduced ResNet (20 leaves, 19,994 values; NHWC images of 32 x
    32) through both modes: ``torch.func.vmap`` maps its convs, pads and
    GroupNorm over the clients.  ``atol=1e-4``: two SGD steps at lr 0.1 on
    conv gradients summed over 32 x 32 pixels in another order (vmap maps
    a conv to a grouped one) leave one client's params (up to ~1) up to
    6.1e-5 apart, the mean 8.7e-6 in a round and 2.0e-5 over two; so each
    round starts from the port's state (``restart``).  Where a client's
    delta is small, that gap is a fifth of its Int8 step: 132 of the
    59,982 codes (0.22%) differed in one parallel round."""
    rng = np.random.default_rng(6)
    batch = {"x": rng.normal(size=(C, STEPS, 4, 32, 32, 3)).astype(np.float32),
             "y": rng.integers(0, 10, (C, STEPS, 4)).astype(np.int32)}
    _check_round_step(_resnet_models(), batch, mode, codec_name, tol=1e-4, restart=True)


@pytest.mark.parametrize("codec_name", ["Int8Codec", "TopKCodec"])
def test_aggregate_batch_bitwise_wire_on_identical_deltas(codec_name):
    """The same (C, N) deltas and residuals into both packages'
    ``aggregate_batch``: the same codes / indices bit for bit, the same
    residuals, and means within the reduces' summation-order tolerance."""
    rng = np.random.default_rng(4)
    deltas = (rng.normal(size=(C, 7199)) * 1e-2).astype(np.float32)
    state = (rng.normal(size=(C, 7199)) * 1e-4).astype(np.float32)
    deltas[0, :40] = 0.25  # equal magnitudes across the TopK cut
    jc, tc = getattr(J, codec_name)(), getattr(T, codec_name)()
    jmean, jst = jc.aggregate_batch(jnp.asarray(deltas), jnp.asarray(WEIGHTS), jnp.asarray(state))
    tmean, tst = tc.aggregate_batch(torch.from_numpy(deltas), torch.from_numpy(WEIGHTS),
                                    torch.from_numpy(state))
    jenc = jc.encode_batch(jnp.asarray(deltas + state))
    tenc = tc.encode_batch(torch.from_numpy(deltas) + torch.from_numpy(state))
    for key in ("idx", "val") if codec_name == "TopKCodec" else ("q", "scale"):
        np.testing.assert_array_equal(tenc[key].numpy(), np.asarray(jenc[key]))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-6, atol=1e-6)


def test_microbatching_matches_jax_and_one_batch():
    """Gradient accumulation over 4 bf16 microbatches: the JAX engine's
    result (to bf16's rounding of the gradient, 2**-8 relative, on a 0.1
    step), and close to the single-batch step."""
    _, jparams, _ = _models()
    batch = _batches(seed=3, c=2, steps=1)
    w, bud = np.ones(2, np.float32), np.ones(2, np.int32)
    jrs = jax.jit(J.make_round_step(
        _models()[0].loss_fn, jsgd(0.1), J.FedAvg(),
        J.RoundSpec(max_steps=1, execution_mode="parallel", microbatches=4)))
    jg, *_ = jrs(jparams, (), (), jax.tree.map(jnp.asarray, batch), jnp.asarray(w), jnp.asarray(bud), 0)
    outs = {}
    for mb in (1, 4):
        _, _, tm = _models()
        trs = T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(),
                                T.RoundSpec(max_steps=1, execution_mode="parallel", microbatches=mb))
        outs[mb], *_ = trs(_torch_params(), (), (), _t(batch), torch.from_numpy(w),
                           torch.from_numpy(bud), 0)
    init = _flat(jparams, True)
    step = np.abs(_flat(jg, True) - init).max()
    np.testing.assert_allclose(_flat(outs[4], False), _flat(jg, True), rtol=0, atol=step * 2**-8)
    np.testing.assert_allclose(_flat(outs[4], False), _flat(outs[1], False), rtol=0, atol=step * 2**-6)


def test_prox_term_matches_jax():
    """FedProx's proximal term (``prox_mu``) in the local loss: the JAX
    engine's new global, with the atol of the parity test above."""
    _, jparams, tm = _models()
    jm = _models()[0]
    batch = _batches(seed=5)
    jrs = jax.jit(J.make_round_step(jm.loss_fn, jsgd(0.1), J.FedAvg(),
                                    J.RoundSpec(max_steps=STEPS, execution_mode="parallel", prox_mu=0.5)))
    trs = T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(),
                            T.RoundSpec(max_steps=STEPS, execution_mode="parallel", prox_mu=0.5))
    jg, *_ = jrs(jparams, (), (), jax.tree.map(jnp.asarray, batch), jnp.asarray(WEIGHTS),
                 jnp.asarray(BUDGETS), 0)
    tg, *_ = trs(_torch_params(), (), (), _t(batch), torch.from_numpy(WEIGHTS),
                 torch.from_numpy(BUDGETS), 0)
    np.testing.assert_allclose(_flat(tg, False), _flat(jg, True), rtol=0, atol=1e-6)


# ---------------- the port's own contract ----------------
@pytest.mark.parametrize("codec_name", ["NullCodec", "TopKCodec"])
@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_mask_none_is_all_ones_bitwise(mode, codec_name):
    trs = _torch_round_step(mode, codec_name)
    codec = getattr(T, codec_name)()
    outs = []
    for mask in (None, torch.ones(C)):
        st = codec.init_client_state(C, _n_params(), device="cpu")
        outs.append(trs(_torch_params(), (), st, _t(_batches()), torch.from_numpy(WEIGHTS),
                        torch.from_numpy(BUDGETS), 0, mask))
    (g0, _, s0, m0), (g1, _, s1, m1) = outs
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s0), tree_leaves(s1)))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_all_zero_weights_and_zero_budgets_are_noops(mode):
    """Every client at zero weight, or every budget 0 (nobody steps): the
    global comes back finite and unchanged."""
    trs = _torch_round_step(mode, "NullCodec")
    p = _torch_params()
    for w, bud in ((torch.zeros(C), torch.from_numpy(BUDGETS)),
                   (torch.from_numpy(WEIGHTS), torch.zeros(C, dtype=torch.int32))):
        new, _, _, met = trs(p, (), (), _t(_batches()), w, bud, 0)
        for a, b in zip(tree_leaves(new), tree_leaves(p)):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert int(met["steps_total"]) == 0


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_fully_masked_round_reports_nan_loss_and_keeps_residuals(mode):
    trs = _torch_round_step(mode, "TopKCodec")
    st = T.TopKCodec().init_client_state(C, _n_params(), device="cpu") + 1e-3
    p = _torch_params()
    new, _, new_st, met = trs(p, (), st, _t(_batches()), torch.from_numpy(WEIGHTS),
                              torch.from_numpy(BUDGETS), 0, torch.zeros(C))
    assert torch.isnan(met["client_loss_mean"]) and torch.isnan(met["client_loss_max"])
    assert int(met["steps_total"]) == 0 and torch.equal(new_st, st)
    for a, b in zip(tree_leaves(new), tree_leaves(p)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_trainable_mask_freezes_the_base():
    _, _, tm = _models()
    p = _torch_params()
    trs = T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(),
                            T.RoundSpec(max_steps=STEPS, execution_mode="parallel"),
                            trainable_mask=tm.trainable_mask(p))
    new, *_ = trs(p, (), (), _t(_batches()), torch.from_numpy(WEIGHTS), torch.from_numpy(BUDGETS), 0)
    assert torch.equal(new["base"]["w"], p["base"]["w"])
    assert not torch.equal(new["head"]["w1"], p["head"]["w1"])


@pytest.mark.parametrize("codec_name", CODECS)
def test_batch_codec_agrees_with_vector_codec(codec_name):
    """The (C, N) surface against the one-client surface, as in
    tests/test_compressed_rounds.py: decode_batch rows = decode(encode(row)),
    reduce = the weighted mean of the decoded rows, transmit_tree =
    encode -> decode with the residual the difference."""
    codec = getattr(T, codec_name)() if codec_name != "TopKCodec" else T.TopKCodec(frac=0.1)
    assert codec.carries_client_state(700) == (codec_name != "NullCodec")
    rng = np.random.default_rng(3)
    deltas = torch.from_numpy((rng.normal(size=(3, 700)) * 0.01).astype(np.float32))
    enc = codec.encode_batch(deltas)
    dec = codec.decode_batch(enc)
    for i in range(3):
        torch.testing.assert_close(dec[i], codec.decode(codec.encode(deltas[i])), rtol=1e-6, atol=1e-6)
    w = torch.from_numpy((rng.random(3) + 0.1).astype(np.float32))
    torch.testing.assert_close(codec.reduce(enc, w), (w @ dec) / w.sum(), rtol=1e-5, atol=1e-5)
    tree = {"a": deltas[0, :600].reshape(40, 15), "b": deltas[0, 600:]}
    if codec_name == "NullCodec":
        out, row = codec.transmit_tree(tree, ())
        assert out is tree and row == ()
        return
    dec_tree, row = codec.transmit_tree(tree, torch.zeros(700))
    dec_vec = codec.decode(codec.encode(deltas[0]))
    torch.testing.assert_close(torch.cat([dec_tree["a"].reshape(-1), dec_tree["b"]]), dec_vec)
    torch.testing.assert_close(row, deltas[0] - dec_vec, rtol=0, atol=1e-7)


def test_unported_paths_raise_with_their_roadmap_item():
    _, _, tm = _models()

    def build(mesh=None, **spec):
        spec = {"max_steps": 1, "execution_mode": "parallel", **spec}
        return T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(), T.RoundSpec(**spec), mesh=mesh)

    # the mesh path is ported; what of queue 1 item 13 stays raises: a model
    # axis inside a client, fsdp, the sequential mode on a mesh
    inside = ClientMesh(axes=(("data", 2), ("model", 2)), rank=0,
                        groups={"data": None, "model": None})
    flat = ClientMesh(axes=(("data", 2),), rank=0, groups={"data": None})
    for kw in ({"mesh": inside}, {"execution_mode": "fsdp"},
               {"mesh": flat, "execution_mode": "sequential"}):
        with pytest.raises(NotImplementedError, match="item 13"):
            build(**kw)
    with pytest.raises(NotImplementedError, match="mesh"):  # int8 without a mesh
        build(collective="int8")
    # a MixedCodec builds without a mesh; the mesh refuses it, as JAX's does
    mixed = T.MixedCodec(codecs=(T.NullCodec(),), assignment=(0,))
    assert callable(build(codec=mixed))
    with pytest.raises(NotImplementedError, match="MixedCodec is not supported on the mesh"):
        build(mesh=flat, codec=mixed)
    # the scanned trainer is ported; on a mesh it stays item 13
    with pytest.raises(NotImplementedError, match="item 13"):
        make_multi_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(), T.RoundSpec(1, "parallel"), 2,
                              mesh=flat)
    with pytest.raises(ValueError):
        build(collective="bf16")
