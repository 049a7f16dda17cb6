"""The port's hybrid serving path (the mamba mixer in
``repro_torch.models.layers.mamba`` and the attention/mamba stack of
``repro_torch.models.transformer``) against the JAX package, at
``jamba-1.5-large-398b.reduced()`` without its experts (``moe=None``:
d_model 128, di 256, N 8, plan [mamba, attn]) on the CPU: the same
JAX-drawn params carried across by ``params_from_numpy``, the same numpy
tokens.

JAX runs with ``repro.kernels.ops.set_impl("pallas")`` (restored after),
so its Pallas selective scan, flash and decode bodies run in interpret
mode where their tiles fit (a 128-token prompt, context 256), through
fresh, unjitted calls.  The port runs its plain versions.

Tolerances, stated with their reasons:
- the mixer in fp32 within 2e-4 of its output's scale, the state within
  2e-4 (``tests/test_kernels.py``'s bound for the Pallas scan against the
  oracle: the scans sum in other orders, the CPU ``exp``s differ by an
  ulp); in bf16 within 2e-2 of the scale (one bf16 rounding of y and of
  each product can land on either side of a tie, and a flipped bf16 input
  moves the fp32 state by up to 2**-8 of a term);
- model logits and caches: fp32 within 1e-4 relative to their scale (the
  scan's 2e-4 on terms far below the logits' scale); bf16 within 4e-2,
  twice ``tests/test_torch_transformer.py``'s 2e-2 for qwen3, because JAX
  does not round the mamba mixer at one set of places: its stacked stack
  runs each layer as a compiled ``lax.scan`` body, where XLA fuses the
  mixer's bf16 elementwise chains and drops roundings that its op-by-op
  run makes.  On these inputs JAX's jitted and op-by-op per-layer decode
  steps differ by 2.3e-2 of the logits' scale; the port rounds where the
  op-by-op run rounds (5e-3 from it), and JAX's Pallas decode body keeps
  the fp32 probabilities that the port's plain decode rounds to bf16.
  fp32 greedy tokens are identical; in bf16 both sides decode JAX's
  tokens, so a near-tie cannot send them down different paths.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

from repro.configs.base import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm
from repro.models.layers import mamba as jmamba
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import generate
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.layers import mamba as tmamba
from repro_torch.utils.pytree import tree_leaves

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MIXER_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
# 4 decode steps: each reaches the decode path and the next slot; the
# Pallas-interpret JAX side costs ~1 s a stacked step
PROMPT, CONTEXT, STEPS = 128, 256, 4
ARCH = "jamba-1.5-large-398b"


@pytest.fixture
def pallas_impl():
    jops.set_impl("pallas")
    try:
        yield
    finally:
        jops.set_impl("auto")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _scaled_close(port, ref, tol, what):
    a, b = _f32(port), _f32(ref)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _configs(dtype="float32", scan=False, **kw):
    cfg = dict(moe=None, dtype=dtype, scan_layers=scan, **kw)
    return (dataclasses.replace(jget_config(ARCH).reduced(), **cfg),
            dataclasses.replace(get_config(ARCH).reduced(), **cfg))


def _models(dtype, scan, seed=0, n_layers=4):
    """Two periods of the reduced plan, so the stacked leaves hold 2 layers."""
    jcfg, tcfg = _configs(dtype, scan, n_layers=n_layers)
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _mixer_params(dtype, seed=3):
    jcfg, tcfg = _configs(dtype)
    jp = jmamba.init_mamba(jax.random.key(seed), jcfg, JDT[dtype])
    # a nonzero conv bias and D, so both reach the output
    rng = np.random.default_rng(seed)
    jp["conv_b"] = jnp.asarray(rng.normal(size=jp["conv_b"].shape) * 0.1, jnp.float32)
    jp["D"] = jnp.asarray(1 + rng.normal(size=jp["D"].shape) * 0.1, jnp.float32)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _both(arr: np.ndarray, dtype: str):
    j = jnp.asarray(arr, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


# ---------------- config ----------------
@pytest.mark.parametrize("variant", ["full", "reduced", "slice"])
def test_jamba_config_matches_jax(variant):
    """Field for field with the plan and its period: as registered, its
    ``reduced()``, and the chip's slice (one 8-layer period, no experts)."""
    j, t = jget_config(ARCH), get_config(ARCH)
    if variant == "reduced":
        j, t = j.reduced(), t.reduced()
    elif variant == "slice":
        j = dataclasses.replace(j, n_layers=8, moe=None)
        t = dataclasses.replace(t, n_layers=8, moe=None)
        assert [s.kind for s in t.layer_plan()] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
        assert t.plan_period == 8 and t.scan_layers and t.dtype == "bfloat16"
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.plan_period == j.plan_period
    assert [dataclasses.asdict(x) for x in t.layer_plan()] == [
        dataclasses.asdict(x) for x in j.layer_plan()]


def test_chip_slice_parameter_count_is_jaxs():
    """The count ``chip_smoke.py`` holds the card's 8-layer slice to is the
    JAX package's, from its init shapes (nothing allocated)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    cfg = dataclasses.replace(jget_config(ARCH), n_layers=8, moe=None)
    shapes = jax.eval_shape(lambda k: jtfm.init_params(k, cfg), jax.random.key(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == \
        chip_smoke.JAMBA_SLICE_PARAMS


# ---------------- the mixer ----------------
def test_init_mamba_has_jax_leaves():
    jcfg, tcfg = _configs()
    jp = jmamba.init_mamba(jax.random.key(0), jcfg, jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    for lead in ((), (3,)):
        tp = tmamba.init_mamba(gen, tcfg, torch.bfloat16, lead=lead)
        assert sorted(tp) == sorted(jp)
        for k in jp:
            assert tuple(tp[k].shape) == lead + tuple(jp[k].shape), k
            assert str(tp[k].dtype).removeprefix("torch.") == str(jp[k].dtype), k
        # the deterministic leaves equal JAX's; dt_bias is softplus^-1 of [1e-3, 1e-1]
        for k in ("conv_b", "A_log", "D"):
            np.testing.assert_allclose(_f32(tp[k]), np.broadcast_to(_f32(jp[k]), tp[k].shape),
                                       rtol=1e-6)
        dt = np.log1p(np.exp(_f32(tp["dt_bias"])))
        assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)


@pytest.mark.parametrize("s", [PROMPT, 100, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_and_prefill_state_match_jax(dtype, s, pallas_impl):
    """The mixer's output and the state it leaves for decode, against
    JAX's ``_mamba_prefill`` (Pallas at S = 128, the oracle else); at S = 2
    the conv state keeps a row of the zero padding."""
    jcfg, tcfg, jp, tp = _mixer_params(dtype)
    ju, tu = _both(np.random.default_rng(s).normal(size=(2, s, 128)), dtype)
    jout, jstate = jtfm._mamba_prefill(jcfg, jp, ju)
    with torch.inference_mode():
        tout, tstate = tmamba.mamba_forward(tcfg, tp, tu)
    _scaled_close(tout, jmamba.mamba_forward(jcfg, jp, ju), MIXER_TOL[dtype], "mamba_forward")
    _scaled_close(tout, jout, MIXER_TOL[dtype], "prefill output")
    assert tstate["conv"].dtype == TDT[dtype] and tstate["ssm"].dtype == torch.float32
    # the conv state is the raw rows x: in bf16 one in_proj rounding apart
    _scaled_close(tstate["conv"], jstate["conv"], MIXER_TOL[dtype], "conv state")
    _scaled_close(tstate["ssm"], jstate["ssm"], MIXER_TOL[dtype], "ssm state")
    if s < 3:
        assert not tstate["conv"][:, : 3 - s].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_matches_jax(dtype):
    """4 recurrent steps from a prefill state, each against JAX's
    ``mamba_decode``; the port writes the state in place."""
    jcfg, tcfg, jp, tp = _mixer_params(dtype)
    rng = np.random.default_rng(11)
    ju, tu = _both(rng.normal(size=(2, 16, 128)), dtype)
    _, jc = jtfm._mamba_prefill(jcfg, jp, ju)
    with torch.inference_mode():
        _, tc = tmamba.mamba_forward(tcfg, tp, tu)
        tc = {k: v.clone() for k, v in tc.items()}
    for step in range(STEPS):
        ju, tu = _both(rng.normal(size=(2, 1, 128)), dtype)
        jout, jc = jmamba.mamba_decode(jcfg, jp, ju, jc)
        with torch.inference_mode():
            tout, tc2 = tmamba.mamba_decode(tcfg, tp, tu, tc)
        assert tc2 is tc
        _scaled_close(tout, jout, MIXER_TOL[dtype], f"decode step {step}")
        _scaled_close(tc["conv"], jc["conv"], MIXER_TOL[dtype], f"conv state, step {step}")
        _scaled_close(tc["ssm"], jc["ssm"], MIXER_TOL[dtype], f"ssm state, step {step}")


# ---------------- the stack ----------------
@pytest.mark.parametrize("scan", [False, True], ids=["per_layer", "stacked"])
def test_params_and_caches_carry_across(scan):
    """``params_from_numpy`` carries the hybrid tree (mamba and attention
    leaves, stacked and per layer) and a cache of both kinds unchanged;
    the port's own init and init_cache give JAX's structure, shapes and
    dtypes."""
    jm, tm, jp, tp = _models("bfloat16", scan)
    for jtree, ttree in ((jp, tp), (jm.init_cache(2, CONTEXT), tm.init_cache(2, CONTEXT)),
                         (jp, tm.init(5))):
        jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
        tl = tree_leaves(ttree)
        assert jax.tree.structure(jtree) == jax.tree.structure(jax.tree.map(lambda t: 0, ttree))
        for (path, j), t in zip(jl, tl, strict=True):
            where = jax.tree_util.keystr(path)
            assert tuple(j.shape) == tuple(t.shape), where
            assert str(j.dtype) == str(t.dtype).removeprefix("torch."), where
            if ttree is tp:
                assert np.array_equal(_f32(t), _f32(j)), where
    kinds = [set(c) for c in tm.init_cache(2, CONTEXT)["layers"]]
    assert kinds[:2] == [{"conv", "ssm"}, {"k", "v"}]


@pytest.mark.parametrize("prompt", [PROMPT, 100])
@pytest.mark.parametrize("scan", [False, True], ids=["per_layer", "stacked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype, scan, prompt, pallas_impl):
    """prefill's logits and both cache kinds, a decode step from JAX's
    converted cache, then 4 greedy steps' logits and the caches after
    them, against JAX's ``prefill`` / ``decode_step``.  A 128-token prompt
    reaches JAX's Pallas scan and flash bodies, a 100-token one its
    oracles."""
    jm, tm, jp, tp = _models(dtype, scan)
    toks = np.random.default_rng(6).integers(0, jm.cfg.vocab_size, (2, prompt)).astype(np.int32)
    tol = MODEL_TOL[dtype]
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, CONTEXT)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, CONTEXT)
    _scaled_close(tl, jl, tol, "prefill logits")
    assert int(tc["pos"]) == int(jc["pos"]) == prompt
    for j, t in zip(jax.tree.leaves(jc["layers"]), tree_leaves(tc["layers"]), strict=True):
        _scaled_close(t, j, tol, "prefill cache")

    jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    with torch.inference_mode():
        cl, _ = tm.decode_step(tp, {"tokens": torch.from_numpy(np.array(jt))},
                               params_from_numpy(jax.tree.map(np.asarray, jc), "cpu"), CONTEXT)
    _scaled_close(cl, jm.decode_step(jp, {"tokens": jt}, jc, CONTEXT)[0], tol,
                  "decode from JAX's converted cache")
    for step in range(STEPS):
        if dtype == "float32":
            assert np.array_equal(np.asarray(jt), tt.numpy()), f"token of step {step}"
        else:
            tt = torch.from_numpy(np.array(jt))
        jl, jc = jm.decode_step(jp, {"tokens": jt}, jc, CONTEXT)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, {"tokens": tt}, tc, CONTEXT)
        _scaled_close(tl, jl, tol, f"decode step {step} logits")
        assert int(tc["pos"]) == int(jc["pos"]) == prompt + step + 1
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    for j, t in zip(jax.tree.leaves(jc["layers"]), tree_leaves(tc["layers"]), strict=True):
        _scaled_close(t, j, tol, "cache after decoding")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.15)])
def test_decode_continues_prefill(dtype, tol):
    """prefill(t[:s]) then decode(t[s]) gives prefill(t[:s+1])'s last
    logits, on the port alone, at ``tests/test_models_smoke.py``'s bounds
    in bf16 (atol = rtol = 0.15) and 1e-5 in fp32."""
    _, tm, _, tp = _models(dtype, True, seed=1)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (1, 17)).astype(np.int32))
    with torch.inference_mode():
        full, _ = tm.prefill(tp, {"tokens": toks}, 64)
        _, cache = tm.prefill(tp, {"tokens": toks[:, :-1]}, 64)
        step, cache = tm.decode_step(tp, {"tokens": toks[:, -1:]}, cache, 64)
    np.testing.assert_allclose(_f32(step[:, -1]), _f32(full[:, -1]), atol=tol, rtol=tol)
    assert int(cache["pos"]) == 17


def test_generate_matches_jax_serve_loop():
    """``launch.serve.generate`` against the loop of ``repro.launch.serve``
    (jitted prefill, argmax, jitted decode steps), fp32: the same tokens."""
    jm, tm, jp, tp = _models("float32", False)
    toks = np.random.default_rng(8).integers(0, jm.cfg.vocab_size, (2, 32)).astype(np.int32)
    n_tokens, ctx = 16, 128
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, ctx))
    decode = jax.jit(lambda p, b, c: jm.decode_step(p, b, c, ctx))
    logits, cache = prefill(jp, {"tokens": jnp.asarray(toks)})
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    want = [np.asarray(tok)]
    for _ in range(n_tokens - 1):
        logits, cache = decode(jp, {"tokens": tok}, cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
    got = generate(tm, tp, torch.from_numpy(toks), n_tokens=n_tokens, context_len=ctx)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_a_stack_without_attention_decodes():
    """A plan of mamba layers only builds no attention mask: decode reads
    no KV cache and still continues the prefill."""
    _, tcfg = _configs(attn_layer_period=4, attn_layer_offset=3, n_layers=3)
    assert {s.kind for s in tcfg.layer_plan()} == {"mamba"}
    tm = build_model(tcfg, device="cpu")
    tp = tm.init(0)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 9)).astype(np.int32))
    with torch.inference_mode():
        full, _ = tm.prefill(tp, {"tokens": toks}, 32)
        _, cache = tm.prefill(tp, {"tokens": toks[:, :-1]}, 32)
        step, _ = tm.decode_step(tp, {"tokens": toks[:, -1:]}, cache, 32)
    torch.testing.assert_close(step, full, atol=1e-5, rtol=1e-5)
