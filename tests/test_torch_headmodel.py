"""Port parity: the frozen-base/2-layer-head model, its data and its
optimizer, started from the JAX package's init.

``params_from_numpy`` carries JAX-initialized params into the port (torch
and JAX RNGs differ, so nothing is re-drawn); loss, accuracy and gradients
must then agree at the reduced (64/32) and at the full (1280/256/31) width.
fp32 on both sides; the tolerance covers matmul summation order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

from repro.configs.base import get_config as jget_config
from repro.data.federated import dirichlet_partition as jdirichlet
from repro.data.synthetic import make_features as jmake_features
from repro.models import build_model as jbuild_model
from repro.optim import sgd as jsgd
from repro.utils.pytree import tree_flatten_to_vector as jflatten
from repro_torch.configs.base import get_config
from repro_torch.data.federated import dirichlet_partition
from repro_torch.data.synthetic import make_features
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import sgd
from repro_torch.utils.pytree import (
    tree_flatten_to_vector, tree_leaves, tree_unflatten,
    tree_unflatten_from_vector,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def _models(reduced: bool):
    jarch, tarch = jget_config("mobilenet-head-office31"), get_config("mobilenet-head-office31")
    if reduced:
        jarch, tarch = jarch.reduced(), tarch.reduced()
    jm, tm = jbuild_model(jarch), build_model(tarch, device="cpu")
    jparams = jm.init(jax.random.key(0))
    return jm, tm, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_loss_acc_grads_match_jax(reduced):
    jm, tm, jparams, tparams = _models(reduced)
    assert (tm.cfg.feature_dim, tm.cfg.hidden_dim, tm.cfg.num_classes) == (
        jm.cfg.feature_dim, jm.cfg.hidden_dim, jm.cfg.num_classes
    )
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, jm.cfg.feature_dim)).astype(np.float32)
    y = rng.integers(0, jm.cfg.num_classes, 32).astype(np.int32)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jparams, {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    )
    leaves = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(tparams)]
    tp = tree_unflatten(tparams, leaves)
    tl, tmet = tm.loss_fn(tp, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    assert float(tmet["acc"]) == float(jmet["acc"])
    for a, b in zip(jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-6)


def test_params_carry_over_in_jax_leaf_order():
    """Flattening matches bitwise: JAX leaf order is sorted keys
    (base.w, head.b1, head.b2, head.w1, head.w2)."""
    jm, tm, jparams, tparams = _models(reduced=True)
    np.testing.assert_array_equal(
        tree_flatten_to_vector(tparams).numpy(), np.asarray(jflatten(jparams))
    )
    back = tree_unflatten_from_vector(tree_flatten_to_vector(tparams), tparams)
    for a, b in zip(tree_leaves(back), tree_leaves(tparams)):
        assert torch.equal(a, b)
    assert tm.trainable_mask(tparams) == jm.trainable_mask(jparams)
    assert [tuple(t.shape) for t in tree_leaves(tparams)] == [
        (64, 64), (32,), (31,), (64, 32), (32, 31)
    ]


def test_config_matches_jax():
    """The port's config carries the JAX config's fields for the head
    family, full and reduced, and the same head widths."""
    from repro.configs.mobilenet_head_office31 import HEAD_CONFIG as JHEAD
    from repro_torch.configs.mobilenet_head_office31 import HEAD_CONFIG

    j, t = jget_config("mobilenet-head-office31"), get_config("mobilenet-head-office31")
    for a, b in ((t, j), (t.reduced(), j.reduced())):
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert dataclasses.asdict(HEAD_CONFIG) == dataclasses.asdict(JHEAD)
    assert dataclasses.asdict(HEAD_CONFIG.reduced()) == dataclasses.asdict(JHEAD.reduced())


def test_build_model_runs_on_the_card_unless_asked():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model("mobilenet-head-office31")
    with pytest.raises(ValueError, match="unknown model family 'rnn'"):  # every family is ported
        build_model(dataclasses.replace(
            get_config("mobilenet-head-office31"), name="rnn", family="rnn"
        ), device="cpu")


def test_init_params_runs_on_the_card_unless_asked():
    from repro_torch.configs.mobilenet_head_office31 import HEAD_CONFIG
    from repro_torch.models import headmodel

    cfg = HEAD_CONFIG.reduced()
    params = headmodel.init_params(cfg, seed=3, device="cpu")
    assert all(t.device.type == "cpu" for t in tree_leaves(params))
    assert params["head"]["w1"].shape == (cfg.feature_dim, cfg.hidden_dim)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            headmodel.init_params(cfg, seed=3)


def test_data_shards_and_batch_stream_bitwise():
    """Same seed -> bitwise the same features, Dirichlet shards and
    per-client batch stream (the numpy parts are copies)."""
    jd = jmake_features(n=300, num_classes=31, feature_dim=16, seed=3)
    td = make_features(n=300, num_classes=31, feature_dim=16, seed=3)
    np.testing.assert_array_equal(jd.x, td.x)
    np.testing.assert_array_equal(jd.y, td.y)
    js, ts = jdirichlet(jd, n_clients=4, alpha=1.0, seed=3), dirichlet_partition(td, n_clients=4, alpha=1.0, seed=3)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a.x, b.x)
        for _ in range(5):
            ba, bb = a.next_batch(16), b.next_batch(16)
            np.testing.assert_array_equal(ba["x"], bb["x"])
            np.testing.assert_array_equal(ba["y"], bb["y"])


def test_sgd_step_matches_jax():
    rng = np.random.default_rng(2)
    p = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=4).astype(np.float32)}
    g = {"a": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=4).astype(np.float32)}
    for kw in ({}, {"momentum": 0.9}, {"momentum": 0.9, "nesterov": True, "weight_decay": 0.01}):
        jo, to = jsgd(0.1, **kw), sgd(0.1, **kw)
        jpp, tpp = jax.tree.map(jnp.asarray, p), {k: torch.from_numpy(v) for k, v in p.items()}
        js, ts = jo.init(jpp), to.init(tpp)
        for step in range(2):
            jpp, js = jo.update(jax.tree.map(jnp.asarray, g), jpp, js, step)
            tpp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, tpp, ts, step)
        for k in p:
            np.testing.assert_allclose(tpp[k].numpy(), np.asarray(jpp[k]), rtol=1e-6, atol=1e-7)


def test_pytree_helpers_match_jax():
    from repro.utils import pytree as jpt
    from repro_torch.utils import pytree as tpt

    rng = np.random.default_rng(4)
    a = {"z": rng.normal(size=(3, 2)).astype(np.float32), "a": [rng.normal(size=4).astype(np.float32)]}
    b = jax.tree.map(lambda x: x + 1.0, a)
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta, tb = params_from_numpy(a, "cpu"), params_from_numpy(b, "cpu")
    np.testing.assert_allclose(float(tpt.tree_sq_norm(ta)), float(jpt.tree_sq_norm(ja)), rtol=1e-6)
    for mask in (True, False):
        jw = jpt.tree_where(jnp.asarray(mask), ja, jb)
        tw = tpt.tree_where(torch.tensor(mask), ta, tb)
        for x, y in zip(jax.tree.leaves(jw), tpt.tree_leaves(tw)):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert (tpt.tree_size(ta), tpt.tree_bytes(ta)) == (jpt.tree_size(ja), jpt.tree_bytes(ja))
    for w in ([0.0, 0.0], [1.5, 2.0]):
        assert float(tpt.safe_weight_sum(torch.tensor(w))) == float(jpt.safe_weight_sum(jnp.asarray(w)))


def test_schedule_and_clip_match_jax():
    from repro.optim import Schedule as JSchedule, chain_clip_by_global_norm as jclip
    from repro_torch.optim import Schedule, chain_clip_by_global_norm

    js, ts = JSchedule(0.1, warmup_steps=2, decay_steps=4), Schedule(0.1, warmup_steps=2, decay_steps=4)
    for step in range(8):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)
    rng = np.random.default_rng(6)
    p = {"a": rng.normal(size=(4, 3)).astype(np.float32)}
    g = {"a": (rng.normal(size=(4, 3)) * 5).astype(np.float32)}
    jo, to = jclip(jsgd(0.1), 0.5), chain_clip_by_global_norm(sgd(0.1), 0.5)
    jp, _ = jo.update(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, p), (), 0)
    tp, _ = to.update(params_from_numpy(g, "cpu"), params_from_numpy(p, "cpu"), (), 0)
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), rtol=1e-6, atol=1e-7)
