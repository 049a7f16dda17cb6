"""The port's MoE training against the JAX package on the CPU: the MoE
layer's gradient (capacity drops included), ``loss_fn`` with every leaf's
gradient against ``jax.value_and_grad`` for ``mixtral-8x7b`` and
``deepseek-moe-16b`` (reduced, scanned and per layer), the layer under
``torch.func.vmap(grad)`` against a loop of ``grad`` a client, two rounds of
``make_round_step`` against JAX's jitted engine, the segment map and wire
of an MoE tree, and the LLM fine-tune example's twin on an MoE arch.
Inputs come from numpy seeds; params cross as numpy arrays
(``params_from_numpy``).

Every comparison of gradients first compares the routings: each MoE
layer's chosen experts, recorded call by call inside both gradient
computations (JAX's through an ordered debug callback, so its scanned
stack reports too), and the kept mask the capacity dispatch derives from
them.  A gradient is compared only where the two packages route alike.

Tolerances, stated with their reasons:
- fp32: routings equal (a flip fails the test); loss and metrics within
  1e-5 relative; every gradient leaf within 1e-4 of its max-abs.  Both
  packages run the same fp32 ops but sum products in other orders
  (observed up to 3e-6 of the max-abs; the MoE's top-k and dispatch move
  no value, they select).
- bf16 (per-layer stack): loss within 1e-3 relative, gradient leaves within
  4e-2 of their max-abs, as the dense family's bf16 test
  (``tests/test_torch_lm_train.py``): both round at the same steps, but a
  bf16 ulp in another place moves the backward's products by a few ulps.
  A routing may flip only at a near-tie, where JAX's k-th / (k+1)-th
  router-logit gap is at most twice that token's largest logit difference
  between the packages; flips are counted and reported, and a run with a
  flip compares no gradient.
- ``vmap(grad)`` against a loop of ``grad``: bitwise (the same CPU ops).
- scanned against per-layer stack (the port alone): loss and gradients
  within 1e-6 of their max-abs (the same ops on views or on separate
  leaves).
- the round step: globals and residuals within 1e-6 absolute up to the
  rounding edges ``tests/test_torch_lm_train.py`` states, LoRA on its
  first round only (its reasons are stated there).
"""
import dataclasses
import functools
import importlib
import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

import repro.core as J
import repro.data.loader as jloader
from repro.configs import base as jbase
from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm
from repro.models.layers import moe as jmoe
from repro.optim import sgd as jsgd
import repro_torch.core as T
from repro_torch.configs.base import MoEConfig, get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.layers import moe as tmoe
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_size
from test_torch_lm_train import (  # noqa: F401 (jax_basis is a fixture)
    BUDGETS, STEPS, WEIGHTS, C, _close_up_to_roundings, _codecs, _f32, _flat, jax_basis,
)

ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _moe_cfgs(e, k, shared):
    return (jbase.MoEConfig(n_experts=e, top_k=k, d_expert=128, n_shared_experts=shared),
            MoEConfig(n_experts=e, top_k=k, d_expert=128, n_shared_experts=shared))


def _cfgs(arch, dtype="float32", scan=True, moe=None):
    """Both packages' reduced ``arch``; ``moe`` = (experts, top-k, shared)
    replaces the router's shape."""
    kw = dict(dtype=dtype, scan_layers=scan)
    jkw, tkw = dict(kw), dict(kw)
    if moe is not None:
        jkw["moe"], tkw["moe"] = _moe_cfgs(*moe)
    return (dataclasses.replace(jget_config(arch).reduced(), **jkw),
            dataclasses.replace(get_config(arch).reduced(), **tkw))


@functools.cache
def _models(arch, dtype="float32", scan=True, moe=None):
    """``_cfgs``' models and JAX's init carried across."""
    jcfg, tcfg = _cfgs(arch, dtype, scan, moe)
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _lm_batch(vocab, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    return batch


class Routes:
    """Each MoE layer's chosen experts and fp32 router logits in both
    packages, call by call, recorded inside the gradient computations."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        jax_router, port_router = jmoe.router_topk, tmoe.router_topk

        def jax_wrapped(cfg, params, x):
            topv, topi, aux = jax_router(cfg, params, x)
            logits = jnp.einsum("td,de->te", x.astype(jnp.float32), params["router"])
            jax.debug.callback(lambda i, lg: self.jax.append((np.asarray(i), np.asarray(lg))),
                               topi, logits, ordered=True)
            return topv, topi, aux

        def port_wrapped(cfg, params, x):
            topv, topi, aux = port_router(cfg, params, x)
            self.port.append((topi, torch.matmul(x.float(), params["router"]).detach()))
            return topv, topi, aux

        monkeypatch.setattr(jmoe, "router_topk", jax_wrapped)
        monkeypatch.setattr(tmoe, "router_topk", port_wrapped)

    def flips(self, cfg, b: int, s: int, cf: float = 1.25) -> int:
        """Routings equal but at near-ties (JAX's k-th / (k+1)-th logit gap
        at most twice the token's largest logit difference), and the kept
        masks of equal routings equal -> the count of tokens routed
        differently."""
        jax.effects_barrier()
        assert len(self.jax) == len(self.port) > 0
        e, k = cfg.moe.n_experts, cfg.moe.top_k
        cap = tmoe.capacity_of(s, k, e, cf)
        flips = 0
        for (ji, jl), (ti, tl) in zip(self.jax, self.port, strict=True):
            ti, tl = ti.numpy(), tl.float().numpy()
            top = -np.sort(-jl, axis=-1)
            gap = top[:, k - 1] - top[:, k]
            differ = (np.sort(ji, -1) != np.sort(ti, -1)).any(-1)
            assert not np.any(differ & (gap > 2 * np.abs(jl - tl).max(-1)))
            flips += int(differ.sum())
            if not differ.any():
                zero = np.zeros((b, s, 1), np.float32)
                jkeep = jax.vmap(partial(jmoe._dispatch_one, e=e, k=k, capacity=cap))(
                    jnp.asarray(zero), jnp.asarray(ji.reshape(b, s, k)),
                    jnp.zeros((b, s, k), jnp.float32))[-1]
                tkeep = tmoe.dispatch(torch.from_numpy(zero), torch.from_numpy(ti).view(b, s, k),
                                      torch.zeros((b, s, k)), e=e, k=k, capacity=cap)[-1]
                np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        return flips


def _leaves_close(tleaves, jleaves, tol):
    assert len(tleaves) == len(jleaves)
    for tleaf, jleaf in zip(tleaves, jleaves, strict=True):
        assert tuple(tleaf.shape) == jleaf.shape and tleaf.dtype == TDT[str(jleaf.dtype)]
        a, b = _f32(tleaf), _f32(jleaf)
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= tol * np.abs(b).max()


def _check_loss_and_grads(models, batch, routes, loss_tol, grad_tol, *, strict=True):
    """``loss_fn``'s loss, metrics and every gradient leaf against
    ``jax.value_and_grad`` (jitted in fp32; op by op in bf16, where XLA's
    fusions would drop roundings) -> the routing flips (0 where ``strict``)."""
    jm, tm, jp, tp = models
    grad = jax.value_and_grad(jm.loss_fn, has_aux=True)
    if tm.arch.dtype == "float32":
        grad = jax.jit(grad)
    (jl, jmet), jg = grad(jp, batch)
    tg, (tl, tmet) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    b, s = batch["tokens"].shape
    flips = routes.flips(tm.arch, b, s)
    assert flips == 0 or not strict, f"{flips} routings flipped"
    assert set(tmet) == set(jmet) == {"ce", "moe_aux", "moe_z", "moe_drop_frac"}
    np.testing.assert_allclose(float(tl), float(jl), rtol=loss_tol)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=loss_tol, atol=1e-7)
    # the loss is CE plus moe_loss of the aux terms summed over the layers
    np.testing.assert_allclose(float(tl) - float(tmet["ce"]),
                               float(tmoe.moe_loss(tmet, tm.arch)), rtol=1e-3, atol=1e-7)
    if flips == 0:
        _leaves_close(tree_leaves(tg), jax.tree.leaves(jg), grad_tol)
    return flips, float(tmet["moe_drop_frac"])


# ---------------- the layer ----------------
def _leaning(rng, shape, router: np.ndarray) -> np.ndarray:
    """Normal tokens whose second sequence leans towards expert 0, so that
    it overflows that expert's capacity."""
    x = rng.normal(size=shape)
    x[1] += 2.0 * router[:, 0] / np.linalg.norm(router[:, 0]) * np.sqrt(shape[-1])
    return x


def _layer_loss(moe_lib, cfg, cf):
    """The MoE layer's training loss: its output against a fixed weight,
    plus ``moe_loss`` -> (loss, the drop fraction)."""
    def loss(params, x, w):
        out, aux = moe_lib.moe_forward(cfg, params, x, capacity_factor=cf)
        return (out * w).mean() + moe_lib.moe_loss(aux, cfg), aux["moe_drop_frac"]
    return loss


# (label, experts, top-k, shared, capacity factor): 64 experts top-6 with the
# leaning sequence's drops, and shared experts beside them; Mixtral's router
# shape at a capacity that drops nothing
LAYER_CASES = [("e64-k6 drops", 64, 6, 0, 1.25), ("e64-k6 + 2 shared", 64, 6, 2, 1.25),
               ("e8-k2, no drops", 8, 2, 0, 4.0)]


@pytest.mark.parametrize("case", LAYER_CASES, ids=[c[0] for c in LAYER_CASES])
def test_moe_layer_gradient_matches_jax(case, monkeypatch):
    """``moe_forward`` + ``moe_loss`` differentiated for params and input:
    routings and kept masks equal, drops where the case has them (their
    pairs' scale gets no gradient on either side), every gradient within
    1e-4 of its max-abs."""
    _, e, k, shared, cf = case
    jcfg, tcfg = _cfgs("deepseek-moe-16b", moe=(e, k, shared))
    jp = jmoe.init_moe(jax.random.key(1), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(3)
    x = _leaning(rng, (3, 40, tcfg.d_model), np.asarray(jp["router"])).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    routes = Routes(monkeypatch)
    (jl, jdrop), jg = jax.jit(jax.value_and_grad(_layer_loss(jmoe, jcfg, cf), argnums=(0, 1),
                                                 has_aux=True))(jp, jnp.asarray(x),
                                                                jnp.asarray(w))
    tg, (tl, tdrop) = torch.func.grad_and_value(_layer_loss(tmoe, tcfg, cf), argnums=(0, 1),
                                                has_aux=True)(tp, torch.from_numpy(x),
                                                              torch.from_numpy(w))
    assert routes.flips(tcfg, 3, 40, cf) == 0
    np.testing.assert_allclose(float(tdrop), float(jdrop), rtol=1e-5, atol=1e-7)
    assert (float(tdrop) > 0) == (cf < 2)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _leaves_close(tree_leaves(tg), jax.tree.leaves(jg), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_vmap_grad_is_a_loop_of_grad(arch):
    """The round engine's wiring: ``vmap`` over 3 clients of
    ``grad_and_value`` of the layer, with the params shared (a round's
    first step) and per client (later steps), bitwise the loop of one
    client's ``grad`` at a time; the leaning client drops pairs."""
    tcfg = _cfgs(arch)[1]
    gen = torch.Generator().manual_seed(5)
    params = tmoe.init_moe(gen, tcfg, torch.float32)
    rng = np.random.default_rng(5)
    x = _leaning(rng, (3, 40, tcfg.d_model), params["router"].numpy()).reshape(3, 2, 20, -1)
    x, w = torch.from_numpy(x).float(), torch.from_numpy(rng.normal(size=x.shape)).float()
    per_client = tree_map(lambda t: torch.stack([t, 1.01 * t, 0.99 * t]), params)
    grad = torch.func.grad_and_value(_layer_loss(tmoe, tcfg, 1.25), argnums=(0, 1),
                                     has_aux=True)
    for p, p_dim in ((params, None), (per_client, 0)):
        got, (loss, drop) = torch.func.vmap(grad, in_dims=(p_dim, 0, 0))(p, x, w)
        assert float(drop.max()) > 0
        for c in range(3):
            pc = p if p_dim is None else tree_map(lambda t: t[c], p)
            want, (wl, wd) = grad(pc, x[c], w[c])
            assert torch.equal(loss[c], wl) and torch.equal(drop[c], wd)
            for g, h in zip(tree_leaves(got), tree_leaves(want), strict=True):
                assert torch.equal(g[c], h)


# ---------------- loss_fn ----------------
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "per-layer"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_every_gradient_match_jax(arch, scan, monkeypatch):
    models = _models(arch, scan=scan)
    routes = Routes(monkeypatch)
    flips, drop = _check_loss_and_grads(models, _lm_batch(models[1].arch.vocab_size), routes,
                                        1e-5, 1e-4)
    assert len(routes.port) == models[1].arch.n_layers and drop > 0


def test_loss_fn_with_64_experts_and_drops_matches_jax(monkeypatch):
    """deepseek's router shape (64 experts, top-6, 2 shared) in the reduced
    stack: capacity 4 a sequence of 32 drops pairs in both layers."""
    models = _models("deepseek-moe-16b", moe=(64, 6, 2))
    routes = Routes(monkeypatch)
    _, drop = _check_loss_and_grads(models, _lm_batch(models[1].arch.vocab_size, seed=1),
                                    routes, 1e-5, 1e-4)
    assert drop > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_in_bf16_matches_jax(arch, monkeypatch, capsys):
    models = _models(arch, dtype="bfloat16", scan=False)
    routes = Routes(monkeypatch)
    flips, _ = _check_loss_and_grads(models, _lm_batch(models[1].arch.vocab_size, seed=4),
                                     routes, 1e-3, 4e-2, strict=False)
    with capsys.disabled():
        print(f"\n{arch} bf16: {flips} of {sum(len(i) for i, _ in routes.jax)} routings "
              f"flipped")


@pytest.mark.parametrize("arch", ARCHS)
def test_scanned_and_per_layer_stacks_agree(arch):
    """The same params stacked (``scan_layers``) and as per-layer leaves:
    equal loss and metrics, the stacked gradient the per-layer ones
    stacked."""
    jm, tm, _, tp = _models(arch, scan=True)
    per_layer = dataclasses.replace(tm.arch, scan_layers=False)
    n = tm.arch.n_layers
    tp1 = {**tp, "blocks": tuple(tree_map(lambda t, i=i: t[i].clone(), tp["blocks"][0])
                                 for i in range(n))}
    batch = {k: torch.from_numpy(v) for k, v in _lm_batch(tm.arch.vocab_size, seed=2).items()}
    g, (loss, met) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(tp, batch)
    g1, (loss1, met1) = torch.func.grad_and_value(build_model(per_layer, device="cpu").loss_fn,
                                                  has_aux=True)(tp1, batch)
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-6)
    for key in met:
        np.testing.assert_allclose(float(met[key]), float(met1[key]), rtol=1e-6)
    g1 = {**g1, "blocks": (tree_map(lambda *ts: torch.stack(ts), *g1["blocks"]),)}
    for a, b in zip(tree_leaves(g), tree_leaves(g1), strict=True):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


# ---------------- the round engine ----------------
ROUND_CASES = [("deepseek-moe-16b", "parallel", "Int8Codec"),
               ("mixtral-8x7b", "parallel", "lora"),
               ("deepseek-moe-16b", "sequential", "NullCodec")]


@pytest.mark.parametrize("arch,mode,codec", ROUND_CASES, ids=["-".join(c) for c in ROUND_CASES])
def test_round_step_on_an_moe_matches_jax(arch, mode, codec, jax_basis):
    """Two rounds of ``make_round_step`` on the reduced MoE stack (fp32, 2
    clients, 2 local steps, client 1 cut to 1) against JAX's jitted engine
    from the same params and batches; JAX's second round starts from the
    port's state.  The metrics carry JAX's key set."""
    jm, tm, jp, tp = _models(arch)
    n = tree_size(tp)
    jc, tc = _codecs(codec, jp, tp)
    spec = dict(max_steps=STEPS, execution_mode=mode)
    jrs = jax.jit(J.make_round_step(jm.loss_fn, jsgd(0.1), J.FedAvg(),
                                    J.RoundSpec(**spec, codec=jc)))
    trs = T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(), T.RoundSpec(**spec, codec=tc))
    jg, jst = jp, jc.init_client_state(C, n)
    tg, tst = tp, tc.init_client_state(C, n, device="cpu")
    for rnd in (1, 2):
        batch = jloader.lm_round_batch(n_clients=C, steps=STEPS, batch_size=2, seq_len=16,
                                       vocab_size=tm.arch.vocab_size, seed=(13, rnd))
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
        step = 2.0**-7 * np.abs(new - before).max() if mode == "sequential" else 0.0
        _close_up_to_roundings(_flat(tree_leaves(tg)), new,
                               [(_f32(t), _f32(j)) for t, j in
                                zip(tree_leaves(tst), jax.tree.leaves(jst), strict=True)],
                               step)


# ---------------- the wire ----------------
@pytest.mark.parametrize("arch", ARCHS)
def test_segment_map_and_wire_of_an_moe_tree_match_jax(arch):
    """``SegmentMap.from_tree`` of the stacked MoE tree: JAX's names,
    shapes and offsets; the stacked expert leaves (L, E, d, f) / (L, E, f,
    d) fold to (L*E*d, f) / (L*E*f, d); each codec's wire bytes and LoRA's
    choice of segments equal JAX's."""
    _, _, jp, tp = _models(arch)
    jmap, tmap = J.SegmentMap.from_tree(jp), T.SegmentMap.from_tree(tp)
    assert [(s.name, s.shape, s.offset) for s in tmap] == [
        (s.name, s.shape, s.offset) for s in jmap]
    experts = [s for s in tmap if s.name.endswith(("['w_gate']", "['w_up']", "['w_down']"))
               and "['ffn']" in s.name and "shared" not in s.name]
    assert len(experts) == 3
    for seg in experts:
        n_l, e, a, b = seg.shape
        assert seg.matrix_shape == (n_l * e * a, b)
    n = tree_size(tp)
    for name in ("NullCodec", "Int8Codec", "lora"):
        jc, tc = _codecs(name, jp, tp)
        assert tc.wire_bytes(n) == jc.wire_bytes(n), name
    jl, tl = _codecs("lora", jp, tp)
    assert [tl._use_lora(s) for s in tmap] == [jl._use_lora(s) for s in jmap]
    assert all(tl._use_lora(s) for s in experts)


def test_chip_phase_18_parameter_count_is_jaxs():
    """The count ``chip_smoke.py``'s phase 18 holds deepseek-moe-16b at
    its depth cut to is the JAX package's, from its init shapes (nothing
    allocated); the cut is a cut of depth alone."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    full = jget_config(chip_smoke.MOE_FT_ARCH)
    cfg = dataclasses.replace(full, n_layers=chip_smoke.MOE_FT_LAYERS)
    assert cfg.n_layers < full.n_layers
    shapes = jax.eval_shape(lambda k: jtfm.init_params(k, cfg), jax.random.key(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == chip_smoke.MOE_FT_PARAMS


# ---------------- the example ----------------
TINY = ["--rounds", "2", "--layers", "1", "--d-model", "64", "--seq", "16", "--batch", "1",
        "--clients", "2", "--local-steps", "2", "--device", "cpu"]


@pytest.mark.parametrize("arch,codec", [("mixtral-8x7b", ["--codec", "lora", "--rank", "2"]),
                                        ("deepseek-moe-16b", ["--codec", "int8"])],
                         ids=["mixtral-lora", "deepseek-int8"])
def test_llm_finetune_twin_trains_an_moe_arch(arch, codec, capsys):
    """The reference's documented MoE case
    (``tests/test_examples.py::test_llm_finetune_lora_moe_arch``): the
    stacked experts fold into LoRA segments inside the round."""
    example = importlib.import_module("repro_torch.examples.federated_llm_finetune")
    params, loss = example.main(TINY + ["--arch", arch] + codec)
    assert np.isfinite(loss) and all(torch.isfinite(x).all() for x in tree_leaves(params))
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and "round  2  mean client CE loss" in out
