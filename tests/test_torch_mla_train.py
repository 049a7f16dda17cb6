"""The port's MLA and frontend-token training against the JAX package on
the CPU: ``mla_forward``'s gradient to its input and every leaf against
``jax.grad`` of the reference's (with and without a window), the padded-V
attention's gradient against the unpadded one, the layer under
``torch.func.vmap(grad)``, ``loss_fn`` with every leaf's gradient against
``jax.value_and_grad`` for reduced ``minicpm3-4b`` (MLA, scanned and per
layer), ``paligemma-3b`` and ``musicgen-medium`` (frontend tokens), the
reference smoke test's SGD step, one round of ``make_round_step`` on the MLA
stack against JAX's jitted engine, the segment map and wire of an MLA tree,
and the LLM fine-tune example's twin.  Inputs come from numpy seeds; params
cross as numpy arrays (``params_from_numpy``); each JAX reference is jitted
and computed once a module.

The MLA held here has qk 32 + 16 over a v width of 32, so the zero-padded V
shows (``reduced()`` makes the widths equal).

Tolerances, stated with their reasons (as ``tests/test_torch_lm_train.py``):
- fp32: loss within 1e-5 relative, every gradient leaf within 1e-4 of its
  max-abs: both packages run fp32 matmuls that sum in other orders, and the
  port's attention backward uses the flash formulas where JAX
  differentiates its oracle (observed ~3e-6 of the max-abs).
- bf16: loss within 1e-3 relative (observed up to 2.2e-4), the frontend
  projection's gradient within 4e-2 of its max-abs: both round activations
  to bf16 at the same steps, but a bf16 ulp in another place moves the
  backward's products by a few ulps.
- the padded-V attention against the unpadded one: bitwise (the zero
  columns add exact zeros to every sum, on the same CPU ops).
- ``vmap(grad)`` against a loop of ``grad``: bitwise.
- scanned against per-layer stack (the port alone): within 1e-6 of the
  max-abs (the same ops on views or on separate leaves).
- the round step: as ``tests/test_torch_lm_train.py`` states it.
"""
import dataclasses
import functools
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)
import torch.nn.functional as F

import repro.core as J
import repro.data.loader as jloader
from repro.configs import base as jbase
from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm
from repro.models.layers import mla as jmla
from repro.optim import sgd as jsgd
import repro_torch.core as T
from repro_torch.configs.base import MLAConfig, get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import mla as tmla
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_size
from test_torch_lm_train import (  # noqa: F401 (jax_basis and counted are fixtures)
    BUDGETS, STEPS, WEIGHTS, C, _close_up_to_roundings, _codecs, _f32, _flat, counted,
    jax_basis,
)
from test_torch_moe_train import _leaves_close

MLA = dict(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
           v_head_dim=32)
ARCHS = ("minicpm3-4b", "paligemma-3b", "musicgen-medium")
FRONTEND = ("paligemma-3b", "musicgen-medium")


def _cfgs(arch, dtype="float32", scan=True):
    """Both packages' ``arch`` reduced to 2 layers at d_model 64; an MLA
    config takes ``MLA`` (v narrower than qk)."""
    kw = dict(dtype=dtype, scan_layers=scan)
    j = dataclasses.replace(jget_config(arch).reduced(n_layers=2, d_model=64), **kw)
    t = dataclasses.replace(get_config(arch).reduced(n_layers=2, d_model=64), **kw)
    if t.mla is not None:
        j = dataclasses.replace(j, mla=jbase.MLAConfig(**MLA))
        t = dataclasses.replace(t, mla=MLAConfig(**MLA))
    return j, t


@functools.cache
def _models(arch, dtype="float32"):
    """``_cfgs``' scanned models and JAX's init carried across."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, b=2, s=32, seed=0):
    """Tokens and labels (some -1) and, for a frontend config, the (B, F,
    frontend_dim) fp32 embeddings, as ``tests/test_models_smoke.py`` draws."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    batch["labels"][1, -3:] = -1
    if cfg.frontend_tokens:
        batch["frontend"] = rng.normal(
            size=(b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.cache
def _jax_loss_and_grads(arch, dtype="float32"):
    """JAX's jitted ``value_and_grad(loss_fn)`` on ``_batch`` -> (loss,
    metrics, gradient tree)."""
    jm, _, jp, _ = _models(arch, dtype)
    (loss, met), grads = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, _batch(jm.cfg))
    return float(loss), {k: float(v) for k, v in met.items()}, grads


@functools.cache
def _port_loss_and_grads(arch, dtype="float32"):
    _, tm, _, tp = _models(arch, dtype)
    return torch.func.grad_and_value(tm.loss_fn, has_aux=True)(tp, _torch_batch(
        _batch(tm.arch)))


# ---------------- the MLA layer ----------------
@functools.cache
def _mixer():
    """One MLA mixer's JAX params (norm scales drawn away from zero, so
    ``(1 + scale)`` is exercised), the port's copy, an input and the
    output's weight."""
    jcfg, tcfg = _cfgs("minicpm3-4b")
    jp = jmla.init_mla(jax.random.key(3), jcfg, jnp.float32)
    rng = np.random.default_rng(3)
    for k in ("q_norm", "kv_norm"):
        jp[k] = jnp.asarray(rng.normal(size=jp[k].shape) * 0.1, jnp.float32)
    x = rng.normal(size=(2, 24, tcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), x, w


def _port_layer_loss(cfg, window):
    def loss(params, x, w):
        return (tmla.mla_forward(cfg, params, x, window=window)[0] * w).sum()
    return loss


@pytest.mark.parametrize("window", [None, 8], ids=["causal", "window 8"])
def test_mla_forward_gradient_matches_jax(window):
    """``mla_forward``'s gradient to x and to every leaf (the norm scales,
    the rope key shared across heads by ``expand``, V zero-padded into the
    attention) against ``jax.grad`` of the reference's ``mla_forward``."""
    jcfg, tcfg, jp, tp, x, w = _mixer()

    def jloss(params, xx, ww):
        return jnp.sum(jmla.mla_forward(jcfg, params, xx, window=window) * ww)

    jl, (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jp, x, w)
    (tg, tgx), tl = torch.func.grad_and_value(_port_layer_loss(tcfg, window), argnums=(0, 1))(
        tp, torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    _leaves_close([tg[k] for k in sorted(tg)] + [tgx], [jg[k] for k in sorted(jg)] + [jgx],
                  1e-4)
    assert all(float(tg[k].abs().max()) > 0 for k in ("q_norm", "kv_norm"))


@pytest.mark.parametrize("mapped", [False, True], ids=["grad", "vmap(grad)"])
def test_padded_v_attention_gradient_is_bitwise_the_unpadded_one(mapped, counted):
    """MLA's attention: V zero-padded from 32 to the qk width 48 and the
    output's first 32 columns kept gives, on the CPU, bitwise the loss and
    gradients of the unpadded attention (``F.pad``'s backward drops the pad
    columns' gradient); under ``vmap`` over 3 clients one forward and one
    backward call each."""
    rng = np.random.default_rng(4)
    lead = (3,) if mapped else ()
    q, k = (torch.tensor(rng.normal(size=(*lead, 2, 24, 2, 48)), dtype=torch.float32)
            for _ in range(2))
    v, w = (torch.tensor(rng.normal(size=(*lead, 2, 24, 2, 32)), dtype=torch.float32)
            for _ in range(2))

    def padded(qq, kk, vv, ww):
        return (ops.flash_attention(qq, kk, F.pad(vv, (0, 16)), window=9)[..., :32] * ww).sum()

    def unpadded(qq, kk, vv, ww):
        return (ops.flash_attention(qq, kk, vv, window=9) * ww).sum()

    runs = []
    for loss in (padded, unpadded):
        fn = torch.func.grad_and_value(loss, argnums=(0, 1, 2))
        counted.update(fwd=0, bwd=0)
        runs.append(torch.func.vmap(fn)(q, k, v, w) if mapped else fn(q, k, v, w))
        assert counted == {"fwd": 1, "bwd": 1}
    (got, got_loss), (want, want_loss) = runs
    assert torch.equal(got_loss, want_loss)
    for g, h in zip(got, want, strict=True):
        assert g.shape == h.shape and torch.equal(g, h)


@pytest.mark.parametrize("shared", [True, False], ids=["params shared", "params per client"])
def test_mla_vmap_grad_is_a_loop_of_grad(shared, counted):
    """The round engine's wiring: ``vmap`` over 2 clients of the layer's
    ``grad_and_value`` (the ``expand`` and ``cat`` of the rope key, the
    pad) bitwise the loop of one client's ``grad``; one flash forward and
    one backward call for the cohort."""
    _, tcfg, _, tp, x, w = _mixer()
    xs, ws = torch.from_numpy(x).reshape(2, 1, 24, -1), torch.from_numpy(w).reshape(2, 1, 24, -1)
    params = tp if shared else tree_map(lambda t: torch.stack([t, 0.9 * t]), tp)
    grad = torch.func.grad_and_value(_port_layer_loss(tcfg, None), argnums=(0, 1))
    counted.update(fwd=0, bwd=0)
    (gp, gx), loss = torch.func.vmap(grad, in_dims=(None if shared else 0, 0, 0))(params, xs, ws)
    assert counted == {"fwd": 1, "bwd": 1}
    for c in range(2):
        pc = params if shared else tree_map(lambda t, c=c: t[c], params)
        (wp, wx), wl = grad(pc, xs[c], ws[c])
        assert torch.equal(loss[c], wl) and torch.equal(gx[c], wx)
        for key in wp:
            assert torch.equal(gp[key][c], wp[key]), key


# ---------------- loss_fn ----------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_every_gradient_match_jax(arch):
    """The scanned stack's loss, metrics and every gradient leaf
    (``frontend_proj.w`` included) against jitted ``jax.value_and_grad``."""
    jl, jmet, jg = _jax_loss_and_grads(arch)
    tg, (tl, tmet) = _port_loss_and_grads(arch)
    assert set(tmet) == set(jmet)
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), jmet[key], rtol=1e-5, atol=1e-7)
    _leaves_close(tree_leaves(tg), jax.tree.leaves(jg), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_layer_stack_matches_jax_and_the_scanned_one(arch):
    """The same params as per-layer leaves (``scan_layers=False``): the
    loss and the per-layer gradients, stacked, within 1e-6 of the scanned
    stack's and within the fp32 tolerance of JAX's."""
    _, tm, _, tp = _models(arch)
    n = tm.arch.n_layers
    per_layer = dataclasses.replace(tm.arch, scan_layers=False)
    tp1 = {**tp, "blocks": tuple(tree_map(lambda t, i=i: t[i].clone(), tp["blocks"][0])
                                 for i in range(n))}
    g1, (loss1, _) = torch.func.grad_and_value(build_model(per_layer, device="cpu").loss_fn,
                                               has_aux=True)(tp1, _torch_batch(_batch(tm.arch)))
    g1 = {**g1, "blocks": (tree_map(lambda *ts: torch.stack(ts), *g1["blocks"]),)}
    g, (loss, _) = _port_loss_and_grads(arch)
    np.testing.assert_allclose(float(loss1), float(loss), rtol=1e-6)
    for a, b in zip(tree_leaves(g), tree_leaves(g1), strict=True):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    jl, _, jg = _jax_loss_and_grads(arch)
    np.testing.assert_allclose(float(loss1), jl, rtol=1e-5)
    _leaves_close(tree_leaves(g1), jax.tree.leaves(jg), 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_sgd_step_gives_jaxs_params(arch):
    """``tests/test_models_smoke.py::test_reduced_train_step``'s step,
    p - 0.01 g, on both packages: the loss finite and positive, every new
    leaf finite and within the fp32 tolerance of JAX's (in the change)."""
    _, _, jp, tp = _models(arch)
    jl, _, jg = _jax_loss_and_grads(arch)
    tg, (tl, _) = _port_loss_and_grads(arch)
    assert np.isfinite(float(tl)) and float(tl) > 0
    jnew = jax.tree.map(lambda x, g: x - 0.01 * g.astype(x.dtype), jp, jg)
    tnew = tree_map(lambda x, g: x - 0.01 * g.to(x.dtype), tp, tg)
    for t, j, p in zip(tree_leaves(tnew), jax.tree.leaves(jnew), tree_leaves(tp), strict=True):
        a, b = _f32(t), _f32(j)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a - _f32(p), b - _f32(p), rtol=0,
                                   atol=1e-4 * max(np.abs(b - _f32(p)).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_in_bf16_matches_jax(arch):
    """bf16 params and activations: the loss within 1e-3 of JAX's; a
    frontend config's ``frontend_proj.w`` gradient (the fp32 embeddings
    cast to bf16 before the projection) finite, nonzero and within 4e-2 of
    JAX's."""
    jm, tm, jp, tp = _models(arch, "bfloat16")
    batch = _batch(tm.arch, seed=4)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, batch)
    tg, (tl, _) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(tp, _torch_batch(batch))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    if tm.arch.frontend_tokens:
        got, want = tg["frontend_proj"]["w"], jg["frontend_proj"]["w"]
        assert got.dtype == torch.bfloat16 and bool(got.abs().max() > 0)
        _leaves_close([got], [want], 4e-2)


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_positions_predict_nothing(arch):
    """The F frontend positions take the label -1: ``loss_fn``'s CE is
    ``cross_entropy`` over the text positions alone, its count the text's
    unmasked labels; a label at a frontend position would change it."""
    _, tm, _, tp = _models(arch)
    batch = _torch_batch(_batch(tm.arch, seed=5))
    f = tm.arch.frontend_tokens
    with torch.no_grad():
        loss, met = tm.loss_fn(tp, batch)
        x = tfm._run_stack(tm.arch, tp, tfm._embed_inputs(tm.arch, tp, batch))[0]
        x = tfm.apply_norm(tm.arch, tp["final_norm"], x)
        text = tfm.cross_entropy(tm.arch, tp, x[:, f:], batch["labels"])
        logits = tfm._logits(tm.arch, tp, x).float()
    assert x.shape[1] == f + batch["tokens"].shape[1]
    assert torch.equal(met["ce"], loss)
    np.testing.assert_allclose(float(loss), float(text), rtol=1e-6)
    # the same sum by hand: the gold logits of the unmasked text labels only
    y = batch["labels"]
    keep = y >= 0
    nll = torch.logsumexp(logits[:, f:], -1) - torch.gather(
        logits[:, f:], -1, y.clamp(min=0).long()[..., None])[..., 0]
    np.testing.assert_allclose(float(loss), float(nll[keep].sum() / keep.sum()), rtol=1e-5)


# ---------------- the round engine ----------------
@pytest.mark.parametrize("codec", ["Int8Codec", "lora"])
def test_round_step_on_mla_matches_jax(codec, jax_basis):
    """One round of ``make_round_step`` (parallel, fp32, 2 clients, 2 local
    steps, client 1 cut to 1) on reduced minicpm3-4b against JAX's jitted
    engine from the same params and batches."""
    jm, tm, jp, tp = _models("minicpm3-4b")
    n = tree_size(tp)
    jc, tc = _codecs(codec, jp, tp)
    spec = dict(max_steps=STEPS, execution_mode="parallel")
    jrs = jax.jit(J.make_round_step(jm.loss_fn, jsgd(0.1), J.FedAvg(),
                                    J.RoundSpec(**spec, codec=jc)))
    trs = T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(), T.RoundSpec(**spec, codec=tc))
    batch = jloader.lm_round_batch(n_clients=C, steps=STEPS, batch_size=1, seq_len=16,
                                   vocab_size=tm.arch.vocab_size, seed=(17, 1))
    jg, _, jst, jmet = jrs(jp, (), jc.init_client_state(C, n), jax.tree.map(jnp.asarray, batch),
                           jnp.asarray(WEIGHTS), jnp.asarray(BUDGETS), 1)
    tg, _, tst, tmet = trs(tp, (), tc.init_client_state(C, n, device="cpu"), _torch_batch(batch),
                           torch.from_numpy(WEIGHTS), torch.from_numpy(BUDGETS), 1)
    assert set(tmet) == set(jmet)
    np.testing.assert_allclose(float(tmet["client_loss_mean"]), float(jmet["client_loss_mean"]),
                               rtol=1e-5)
    assert int(tmet["steps_total"]) == int(jmet["steps_total"]) == 3
    assert all(torch.isfinite(x).all() for x in tree_leaves(tg))
    _close_up_to_roundings(_flat(tree_leaves(tg)), _flat(jax.tree.leaves(jg)),
                           [(_f32(t), _f32(j)) for t, j in
                            zip(tree_leaves(tst), jax.tree.leaves(jst), strict=True)], 0.0)


# ---------------- the wire ----------------
def test_segment_map_and_wire_of_an_mla_tree_match_jax():
    """``SegmentMap.from_tree`` of the stacked MLA tree: JAX's names, shapes
    and offsets; the 3-D projections fold their leading axes into rows
    (``wq_b`` (L, r, H, qk) -> (L r H, qk), ``wo`` (L, H, v, d) -> (L H v,
    d)); each codec's wire bytes and LoRA's choice of segments equal JAX's."""
    _, tm, jp, tp = _models("minicpm3-4b")
    jmap, tmap = J.SegmentMap.from_tree(jp), T.SegmentMap.from_tree(tp)
    assert [(s.name, s.shape, s.offset) for s in tmap] == [
        (s.name, s.shape, s.offset) for s in jmap]
    m, h, n_l = tm.arch.mla, tm.arch.n_heads, tm.arch.n_layers
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    folds = {"wq_b": (n_l * m.q_lora_rank * h, qk),
             "wk_b": (n_l * m.kv_lora_rank * h, m.qk_nope_head_dim),
             "wv_b": (n_l * m.kv_lora_rank * h, m.v_head_dim),
             "wo": (n_l * h * m.v_head_dim, tm.arch.d_model)}
    seen = {s.name.split("'")[-2]: s for s in tmap if "['mixer']" in s.name}
    for key, shape in folds.items():
        assert seen[key].ndim == 4 and seen[key].matrix_shape == shape, key
    n = tree_size(tp)
    for name in ("NullCodec", "Int8Codec", "lora"):
        jc, tc = _codecs(name, jp, tp)
        assert tc.wire_bytes(n) == jc.wire_bytes(n), name
    jl, tl = _codecs("lora", jp, tp)
    assert [tl._use_lora(s) for s in tmap] == [jl._use_lora(s) for s in jmap]
    assert all(tl._use_lora(seen[key]) for key in folds)


# ---------------- the chip phase and the example ----------------
def test_chip_phase_19_parameter_counts_are_jaxs():
    """The counts ``chip_smoke.py``'s phase 19 holds its models to are the
    JAX package's, from its init shapes (nothing allocated): minicpm3-4b
    and the 2-layer card-against-CPU cuts are cuts of depth alone,
    paligemma-3b is whole."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cases = [(chip_smoke.MLA_FT_ARCH, chip_smoke.MLA_FT_LAYERS, chip_smoke.MLA_FT_PARAMS),
             (chip_smoke.VLM_FT_ARCH, None, chip_smoke.VLM_FT_PARAMS)]
    cases += [(arch, chip_smoke.FRONTEND_CPU_LAYERS, n)
              for arch, n in chip_smoke.FRONTEND_CPU_PARAMS.items()]
    for arch, layers, want in cases:
        full = jget_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
        assert layers is None or layers < full.n_layers
        shapes = jax.eval_shape(lambda k, cfg=cfg: jtfm.init_params(k, cfg), jax.random.key(0))
        assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == want, arch


TINY = ["--rounds", "2", "--layers", "1", "--d-model", "64", "--seq", "16", "--batch", "1",
        "--clients", "2", "--local-steps", "2", "--device", "cpu"]


def _example():
    return importlib.import_module("repro_torch.examples.federated_llm_finetune")


def test_llm_finetune_twin_trains_mla(capsys):
    """``--arch minicpm3-4b --codec lora --rank 2``: MLA's 3-D projections
    fold into LoRA segments inside the round."""
    params, loss = _example().main(TINY + ["--arch", "minicpm3-4b", "--codec", "lora",
                                           "--rank", "2"])
    assert np.isfinite(loss) and all(torch.isfinite(x).all() for x in tree_leaves(params))
    out = capsys.readouterr().out
    assert "arch=minicpm3-4b-reduced" in out and "round  2  mean client CE loss" in out


@pytest.mark.parametrize("arch", FRONTEND)
def test_llm_finetune_twin_has_no_frontend_stream(arch):
    """The example's stream carries tokens alone, as the reference's does:
    a frontend arch fails with the port's own ``ValueError`` for want of
    ``batch['frontend']``."""
    with pytest.raises(ValueError, match=r"takes batch\['frontend'\]"):
        _example().main(TINY + ["--arch", arch])


def test_plain_attention_backward_takes_a_narrower_v():
    """``ref.attention_bwd`` with V narrower than Q and K (MLA's unpadded
    V) is autograd of ``ref.attention`` within 1e-5 of each gradient's
    max-abs."""
    rng = np.random.default_rng(6)
    q, k = (torch.tensor(rng.normal(size=(1, 12, 4, 24)), dtype=torch.float32) for _ in range(2))
    v, dout = (torch.tensor(rng.normal(size=(1, 12, 4, 16)), dtype=torch.float32)
               for _ in range(2))
    out, lse = ref.attention_with_lse(q, k, v)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    ref.attention(qr, kr, vr).backward(dout)
    for got, want in zip(ref.attention_bwd(q, k, v, out, lse, dout), (qr.grad, kr.grad, vr.grad),
                         strict=True):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
