"""The port's dense transformer serving path (``repro_torch.models``,
``launch.serve``) against the JAX package, at ``qwen3-0.6b.reduced()`` on
the CPU: the same JAX-drawn params carried across by ``params_from_numpy``,
the same numpy tokens.  The serving tests also run ``minicpm3-4b`` (MLA,
at a v width of 32 under a qk width of 32 + 16: ``reduced()`` makes the two
equal) and the frontend configs ``paligemma-3b`` and ``musicgen-medium``
(numpy-drawn fp32 frontend embeddings before the tokens).

JAX runs with ``repro.kernels.ops.set_impl("pallas")`` (restored to "auto"
after), so its Pallas flash and decode bodies run in interpret mode where
their tiles fit (prompt 128, context 256), through fresh, unjitted calls:
no trace made under "auto" is reused.  The port runs its plain versions.

Tolerances, stated with their reasons:
- fp32 layers within 1e-6; RoPE's cos/sin within 1e-6 + p * 2**-22 at
  position p: XLA's CPU ``exp`` is one ulp off the correctly rounded
  value at some frequencies, and one ulp of a frequency f < 1 moves the
  angle p * f by at most p * 2**-24, its rounding by at most p * 2**-23
  more (cos and sin move by no more than their angle);
- bf16 layers within one bf16 ulp (rtol 2**-7): both packages round at
  the same steps (the port's silu is XLA's exp / add / reciprocal /
  multiply chain), sums may order differently;
- model logits and caches: fp32 within 1e-5 relative to their scale;
  bf16 within 2e-2 relative to their scale (the port's plain decode
  rounds q * scale and the probabilities to bf16 as JAX's oracle does,
  JAX's Pallas decode body keeps them in fp32).  fp32 greedy tokens are
  identical; in bf16 both sides decode JAX's tokens, so a near-tie cannot
  send them down different paths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

from repro.configs.base import get_config as jget_config
from repro.kernels import ops as jops
from repro.models import build_model as jbuild_model
from repro.models.layers import attention as jattn
from repro.models.layers import embeddings as jemb
from repro.models.layers import mlp as jmlp
from repro.models.layers import norms as jnorms
from repro_torch.configs.base import MLAConfig, MoEConfig, SSMConfig
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import generate
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import embeddings as temb
from repro_torch.models.layers import mlp as tmlp
from repro_torch.models.layers import norms as tnorms
from repro_torch.utils.pytree import tree_leaves

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LAYER_TOL = {"float32": dict(rtol=1e-6, atol=1e-6), "bfloat16": dict(rtol=2**-7, atol=1e-6)}
MODEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# 4 decode steps: each reaches the decode path and the next slot; the
# Pallas-interpret JAX side costs ~1 s a stacked step
PROMPT, CONTEXT, STEPS = 128, 256, 4


@pytest.fixture
def pallas_impl():
    """JAX's dispatch forced onto the Pallas bodies (interpret mode on the
    CPU) for the test, "auto" again after it."""
    jops.set_impl("pallas")
    try:
        yield
    finally:
        jops.set_impl("auto")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))  # a writable copy


def _both(arr: np.ndarray, dtype: str):
    """One numpy array, rounded to ``dtype`` once, as both packages' arrays."""
    j = jnp.asarray(arr, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _scaled_close(port, ref, tol, what):
    a, b = _f32(port), _f32(ref)
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


# the MLA the serving tests hold minicpm3-4b to: v width 32 under a qk width of
# 32 + 16, so the prefill's zero-padded V is exercised
MLA_VQK = MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                    qk_rope_head_dim=16, v_head_dim=32)
ARCH_KW = {"minicpm3-4b": dict(mla=MLA_VQK)}
NEW_ARCHS = ("minicpm3-4b", "paligemma-3b", "musicgen-medium")


def _configs(dtype: str, scan: bool, arch: str = "qwen3-0.6b", **kw):
    cfg = dict(dtype=dtype, scan_layers=scan, **ARCH_KW.get(arch, {}), **kw)
    jcfg = dict(cfg)
    if "mla" in cfg:
        from repro.configs import base as jbase

        jcfg["mla"] = jbase.MLAConfig(**dataclasses.asdict(cfg["mla"]))
    return (dataclasses.replace(jget_config(arch).reduced(), **jcfg),
            dataclasses.replace(get_config(arch).reduced(), **cfg))


def _models(dtype, scan, seed=0, arch: str = "qwen3-0.6b", **kw):
    jcfg, tcfg = _configs(dtype, scan, arch, **kw)
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _prompt(cfg, rng, b: int, s: int) -> dict:
    """A numpy batch of S positions in all: S - F tokens after a config's F
    frontend embeddings (fp32 normals, as ``launch/serve.py`` draws them)."""
    f = cfg.frontend_tokens
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - f)).astype(np.int32)}
    if f:
        fd = cfg.frontend_dim or cfg.d_model
        batch["frontend"] = rng.normal(size=(b, f, fd)).astype(np.float32)
    return batch


def _jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------- config ----------------
def test_qwen3_config_matches_jax():
    """Field for field, full and reduced; sub-configs included."""
    j, t = jget_config("qwen3-0.6b"), get_config("qwen3-0.6b")
    for a, b in ((t, j), (t.reduced(), j.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.resolved_head_dim == b.resolved_head_dim
        assert a.plan_period == b.plan_period
        assert [dataclasses.asdict(x) for x in a.layer_plan()] == [
            dataclasses.asdict(x) for x in b.layer_plan()]
    # reduced() of configs with every sub-config, as JAX gives them
    kw = dict(mla=MLAConfig(), moe=MoEConfig(d_expert=64), ssm=SSMConfig(),
              attn_layer_period=4, attn_layer_offset=3, sliding_window=4096,
              frontend_tokens=256)
    from repro.configs import base as jbase
    jkw = dict(mla=jbase.MLAConfig(), moe=jbase.MoEConfig(d_expert=64), ssm=jbase.SSMConfig(),
               **{k: v for k, v in kw.items() if k not in ("mla", "moe", "ssm")})
    a = dataclasses.replace(t, family="hybrid", **kw)
    b = dataclasses.replace(j, family="hybrid", **jkw)
    assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
    assert [dataclasses.asdict(x) for x in a.layer_plan()] == [
        dataclasses.asdict(x) for x in b.layer_plan()]
    assert a.plan_period == b.plan_period


# ---------------- layers ----------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.normal(size=(2, 16, 128)) * 3, dtype)
    s = rng.normal(size=(128,)).astype(np.float32) * 0.1
    bias = rng.normal(size=(128,)).astype(np.float32) * 0.1
    tol = LAYER_TOL[dtype]
    np.testing.assert_allclose(_f32(tnorms.rmsnorm(tx, torch.from_numpy(s))),
                               _f32(jnorms.rmsnorm(jx, jnp.asarray(s))), **tol)
    np.testing.assert_allclose(
        _f32(tnorms.layernorm(tx, torch.from_numpy(s), torch.from_numpy(bias))),
        _f32(jnorms.layernorm(jx, jnp.asarray(s), jnp.asarray(bias))), **tol)
    np.testing.assert_allclose(_f32(tattn._qk_norm(tx, torch.from_numpy(s))),
                               _f32(jattn._qk_norm(jx, jnp.asarray(s))), **tol)
    for norm in ("rmsnorm", "layernorm"):
        cfg = dataclasses.replace(get_config("qwen3-0.6b"), norm=norm)
        p = tnorms.init_norm(cfg, 128)
        assert sorted(p) == sorted(jnorms.init_norm(cfg, 128))
        torch.testing.assert_close(tnorms.apply_norm(cfg, p, tx).float(),
                                   torch.from_numpy(_f32(jnorms.apply_norm(
                                       cfg, jnorms.init_norm(cfg, 128), jx))), **tol)


@pytest.mark.parametrize("theta", [1e6, 1e4])
def test_rope_matches_jax(theta):
    pos = np.arange(PROMPT + 2 * STEPS)[None]
    jc, js = jemb.rope_angles(jnp.asarray(pos), 128, theta)
    tc, ts = temb.rope_angles(torch.from_numpy(pos), 128, theta)
    angle_tol = 1e-6 + pos[0, :, None] * 2.0 ** -22
    assert np.all(np.abs(_f32(tc) - _f32(jc))[0] <= angle_tol)
    assert np.all(np.abs(_f32(ts) - _f32(js))[0] <= angle_tol)
    # the rotation itself, from the same angles: half-split, not interleaved
    rng = np.random.default_rng(2)
    for dtype in ("float32", "bfloat16"):
        jx, tx = _both(rng.normal(size=(1, pos.shape[1], 4, 128)), dtype)
        np.testing.assert_allclose(_f32(temb.apply_rope(tx, torch.from_numpy(_f32(jc)),
                                                        torch.from_numpy(_f32(js)))),
                                   _f32(jemb.apply_rope(jx, jc, js)), **LAYER_TOL[dtype])


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_jax(dtype, act):
    rng = np.random.default_rng(3)
    shapes = {"w_gate": (128, 256), "w_up": (128, 256), "w_down": (256, 128)}
    w = {k: rng.normal(size=s) / np.sqrt(s[0]) for k, s in shapes.items()}
    jw = {k: _both(v, dtype)[0] for k, v in w.items()}
    tw = {k: _both(v, dtype)[1] for k, v in w.items()}
    jx, tx = _both(rng.normal(size=(2, 16, 128)), dtype)
    np.testing.assert_allclose(_f32(tmlp.mlp_forward(tw, tx, act)),
                               _f32(jmlp.mlp_forward(jw, jx, act)), **LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_qkv_matches_jax(dtype):
    """Projections in JAX's (d, h, hd) layout, QK-norm and RoPE at theta 1e6,
    positions 0..15: within the layer tolerance (the RoPE term is < 1e-6
    there)."""
    jcfg, tcfg = _configs(dtype, False)
    jp = jattn.init_attention(jax.random.key(4), jcfg, JDT[dtype])
    rng = np.random.default_rng(4)
    jp["q_scale"] = jnp.asarray(rng.normal(size=32) * 0.1, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jx, tx = _both(rng.normal(size=(2, 16, 128)), dtype)
    pos = np.arange(16)[None]
    for a, b in zip(tattn._project_qkv(tcfg, tp, tx, torch.from_numpy(pos)),
                    jattn._project_qkv(jcfg, jp, jx, jnp.asarray(pos)), strict=True):
        np.testing.assert_allclose(_f32(a), _f32(b), **LAYER_TOL[dtype])


# ---------------- the model ----------------
@pytest.mark.parametrize("scan", [False, True], ids=["per_layer", "stacked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_has_jax_tree_shapes_and_dtypes(dtype, scan):
    jm, tm, jp, _ = _models(dtype, scan)
    tp = tm.init(5)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = tree_leaves(tp)
    assert len(jflat) == len(tflat)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda t: 0, tp))
    for (path, j), t in zip(jflat, tflat, strict=True):
        assert tuple(j.shape) == tuple(t.shape), jax.tree_util.keystr(path)
        assert str(j.dtype) == str(t.dtype).removeprefix("torch."), jax.tree_util.keystr(path)
        assert t.device.type == "cpu"


@pytest.mark.parametrize("window", [None, 8])
def test_forward_matches_jax(window, pallas_impl):
    """Full-sequence logits (B, S, V), with and without a window passed in."""
    jm, tm, jp, tp = _models("float32", True)
    toks = np.random.default_rng(9).integers(0, jm.cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    from repro.models import transformer as jtfm

    jl, _ = jtfm.forward(jm.cfg, jp, {"tokens": jnp.asarray(toks)}, window=window)
    with torch.inference_mode():
        tl, aux = tfm.forward(tm.cfg, tp, {"tokens": torch.from_numpy(toks)}, window=window)
    assert all(float(v) == 0.0 for v in aux.values())  # no MoE layer
    assert tuple(tl.shape) == tuple(jl.shape) == (2, PROMPT, jm.cfg.vocab_size)
    _scaled_close(tl, jl, MODEL_TOL["float32"], "forward logits")


def _layout(scan: bool) -> str:
    return "stacked" if scan else "per_layer"


@pytest.mark.parametrize("arch,dtype,scan", [
    pytest.param("qwen3-0.6b", dtype, scan, id=f"{dtype}-{_layout(scan)}")
    for dtype in ("float32", "bfloat16") for scan in (False, True)] + [
    # the new configs in both dtypes and both layouts, not every pairing
    pytest.param(arch, dtype, scan, id=f"{arch}-{dtype}-{_layout(scan)}")
    for arch in NEW_ARCHS for dtype, scan in (("float32", True), ("bfloat16", False))])
def test_prefill_and_decode_match_jax(arch, dtype, scan, pallas_impl):
    """prefill's next-token logits and its whole cache, a decode step from
    JAX's cache converted by ``params_from_numpy``, then 4 greedy decode
    steps' logits, against JAX's ``prefill`` / ``decode_step``.  A
    frontend config's 128 positions are its 16 frontend embeddings and 112
    tokens, so JAX's Pallas flash body runs on them too."""
    jm, tm, jp, tp = _models(dtype, scan, arch=arch)
    batch = _prompt(jm.cfg, np.random.default_rng(6), 2, PROMPT)
    tol = MODEL_TOL[dtype]
    jl, jc = jm.prefill(jp, _jax_batch(batch), CONTEXT)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, _torch_batch(batch), CONTEXT)
    _scaled_close(tl, jl, tol, "prefill logits")
    assert int(tc["pos"]) == int(jc["pos"]) == PROMPT
    assert jax.tree.structure(jc) == jax.tree.structure(jax.tree.map(lambda t: 0, tc))
    for j, t in zip(jax.tree.leaves(jc["layers"]), tree_leaves(tc["layers"]), strict=True):
        assert tuple(j.shape) == tuple(t.shape) and t.dtype == TDT[dtype]
        _scaled_close(t, j, tol, "prefill cache")

    jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    # JAX's cache carried across by the same conversion as the params
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
        assert int(tc["pos"]) == int(jc["pos"]) == PROMPT + step + 1
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    for j, t in zip(jax.tree.leaves(jc["layers"]), tree_leaves(tc["layers"]), strict=True):
        _scaled_close(t, j, tol, "cache after decoding")


@pytest.mark.parametrize("prompt", [PROMPT, 100])
def test_ring_cache_matches_jax_step_by_step(prompt, pallas_impl):
    """A sliding window of 64 under a context of 256: a ring cache of 64
    slots, filled by the prefill past its length, then 80 decode steps that
    wrap it again; fp32, tokens identical every step.  A 128-token prompt
    runs JAX's Pallas flash body; a 100-token one leaves positions 36..99
    in slots 36..63, 0..35, so prefill's ring arrangement is a rotation."""
    jm, tm, jp, tp = _models("float32", False, sliding_window=64)
    toks = np.random.default_rng(7).integers(0, jm.cfg.vocab_size, (1, prompt)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, CONTEXT)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, CONTEXT)
    assert tc["layers"][0]["k"].shape[1] == 64
    _scaled_close(tl, jl, MODEL_TOL["float32"], "prefill logits")
    for j, t in zip(jax.tree.leaves(jc["layers"]), tree_leaves(tc["layers"]), strict=True):
        _scaled_close(t, j, MODEL_TOL["float32"], "ring cache after prefill")
    for step in range(80):
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
        assert np.array_equal(np.asarray(jt), tt.numpy()), f"token of step {step}"
        jl, jc = jm.decode_step(jp, {"tokens": jt}, jc, CONTEXT)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, {"tokens": tt}, tc, CONTEXT)
        _scaled_close(tl, jl, MODEL_TOL["float32"], f"decode step {step} logits")
    for j, t in zip(jax.tree.leaves(jc["layers"]), tree_leaves(tc["layers"]), strict=True):
        _scaled_close(t, j, MODEL_TOL["float32"], "ring cache after 80 steps")


@pytest.mark.parametrize("arch,dtype,tol", [
    pytest.param(arch, dtype, tol,
                 id=("" if arch == "qwen3-0.6b" else f"{arch}-") + f"{dtype}-{tol}")
    for arch in ("qwen3-0.6b", "granite-8b", "stablelm-3b") + NEW_ARCHS
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 0.15))])
def test_decode_continues_prefill(arch, dtype, tol):
    """prefill(t[:s]) then decode(t[s]) gives prefill(t[:s+1])'s last
    logits: ``tests/test_models_smoke.py``'s check on the port, at its
    bounds in bf16 (atol = rtol = 0.15) and 1e-5 in fp32, for the dense
    configs it checks that the port has, minicpm3-4b's MLA (its absorbed
    fp32 decode against the padded-V prefill) and the frontend configs
    (both prefills after the same frontend embeddings, the cache's
    position counting them)."""
    _, tm, _, tp = _models(dtype, True, seed=1, arch=arch)
    f = tm.cfg.frontend_tokens
    batch = _torch_batch(_prompt(tm.cfg, np.random.default_rng(1), 1, 17 + f))
    toks = batch["tokens"]
    with torch.inference_mode():
        full, _ = tm.prefill(tp, batch, 64)
        _, cache = tm.prefill(tp, {**batch, "tokens": toks[:, :-1]}, 64)
        step, cache = tm.decode_step(tp, {"tokens": toks[:, -1:]}, cache, 64)
    np.testing.assert_allclose(_f32(step[:, -1]), _f32(full[:, -1]), atol=tol, rtol=tol)
    assert int(cache["pos"]) == 17 + f


def _generate_matches_jax_serve_loop(arch: str) -> None:
    jm, tm, jp, tp = _models("float32", False, arch=arch)
    batch = _prompt(jm.cfg, np.random.default_rng(8), 2, 32 + jm.cfg.frontend_tokens)
    n_tokens, ctx = 16, 128
    prefill = jax.jit(lambda p, b: jm.prefill(p, b, ctx))
    decode = jax.jit(lambda p, b, c: jm.decode_step(p, b, c, ctx))
    logits, cache = prefill(jp, _jax_batch(batch))
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    want = [np.asarray(tok)]
    for _ in range(n_tokens - 1):
        logits, cache = decode(jp, {"tokens": tok}, cache)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
    tb = _torch_batch(batch)
    got = generate(tm, tp, tb["tokens"], n_tokens=n_tokens, context_len=ctx,
                   frontend=tb.get("frontend"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_generate_matches_jax_serve_loop():
    """``launch.serve.generate`` against the loop of ``repro.launch.serve``
    (jitted prefill, argmax, jitted decode steps), reduced, fp32: the same
    tokens."""
    _generate_matches_jax_serve_loop("qwen3-0.6b")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_generate_matches_jax_serve_loop_with_mla_and_frontends(arch):
    """As above for minicpm3-4b (MLA, v width under the qk width) and the
    frontend configs, ``generate(..., frontend=)`` given the serve loop's
    frontend batch."""
    _generate_matches_jax_serve_loop(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_with_a_frontend_matches_jax(dtype):
    """paligemma-3b reduced: the frontend (B, 16, 1152) fp32, cast to the
    model dtype, projected by ``frontend_proj`` and prepended to the token
    embeddings; after prefill the cache's position counts the frontend's 16
    positions; a batch without the frontend is refused.  bf16 within the
    layer tolerance; fp32 within the error of a 1152-term dot summed in
    another order, 1152 * 2**-24 * sum_i |fe_i w_i| an entry."""
    from repro.models import transformer as jtfm

    jm, tm, jp, tp = _models(dtype, True, arch="paligemma-3b")
    s, f = 24, jm.cfg.frontend_tokens
    batch = _prompt(jm.cfg, np.random.default_rng(10), 2, s + f)
    want = jtfm._embed_inputs(jm.cfg, jp, _jax_batch(batch))
    got = tfm._embed_inputs(tm.cfg, tp, _torch_batch(batch))
    assert tuple(got.shape) == tuple(want.shape) == (2, s + f, jm.cfg.d_model)
    assert got.dtype == TDT[dtype]
    if dtype == "bfloat16":
        np.testing.assert_allclose(_f32(got), _f32(want), **LAYER_TOL[dtype])
    else:
        fd = jm.cfg.frontend_dim
        dot_abs = np.abs(batch["frontend"]) @ np.abs(np.asarray(jp["frontend_proj"]["w"]))
        assert np.all(np.abs(_f32(got)[:, :f] - _f32(want)[:, :f]) <= fd * 2.0 ** -24 * dot_abs)
        np.testing.assert_array_equal(_f32(got)[:, f:], _f32(want)[:, f:])  # the table rows
    with torch.inference_mode():
        _, cache = tm.prefill(tp, _torch_batch(batch), 64)
        with pytest.raises(ValueError, match="frontend"):
            tm.prefill(tp, {"tokens": _torch_batch(batch)["tokens"]}, 64)
    assert int(cache["pos"]) == s + f == int(jm.prefill(jp, _jax_batch(batch), 64)[1]["pos"])


def test_serve_main_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--batch", "1", "--prompt-len", "8", "--tokens", "4",
                "--context", "16"])
    out = capsys.readouterr().out
    assert "generated (1, 4) tokens" in out and "on cpu" in out


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_main_runs_mla_and_frontends_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--device", "cpu", "--batch", "1", "--prompt-len", "8",
                "--tokens", "4", "--context", "32"])
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced generated (1, 4) tokens" in out and "on cpu" in out


# ---------------- building, and what is not ported ----------------
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_mla_and_frontend_configs_build_on_the_cpu(arch):
    """MLA and the frontend tokens are ported: minicpm3-4b (dense, MLA),
    paligemma-3b (vlm) and musicgen-medium (audio) build reduced on the
    CPU, with JAX's mixer and frontend leaves (xlstm-1.3b's build:
    ``tests/test_torch_xlstm.py``)."""
    m = build_model(get_config(arch).reduced(), device="cpu")
    p = m.init(0)
    mixer = p["blocks"][0]["mixer"]
    if arch == "minicpm3-4b":
        assert sorted(mixer) == ["kv_norm", "q_norm", "wk_b", "wkv_a", "wo", "wq_a", "wq_b",
                                 "wv_b"]
        assert "frontend_proj" not in p
    else:
        assert "wq" in mixer and m.arch.frontend_tokens == 16
        assert tuple(p["frontend_proj"]["w"].shape) == (m.arch.frontend_dim, m.arch.d_model)
    assert all(t.device.type == "cpu" for t in tree_leaves(p))


def test_mamba_layers_need_an_ssm_config():
    """A mamba layer in a config without ``ssm`` (qwen3's) is refused with
    what is missing, not an AttributeError from inside the init."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), attn_layer_period=2,
                              alt_kind="mamba")
    with pytest.raises(ValueError, match="needs cfg.ssm"):
        build_model(cfg, device="cpu")


# (arch, config change): one config of each family whose training waits;
# the dense, MoE, MLA, frontend-token and hybrid Mamba families train
# (tests/test_torch_lm_train.py, tests/test_torch_moe_train.py,
# tests/test_torch_mla_train.py, tests/test_torch_mamba_train.py)
UNTRAINED = {
    "xLSTM": ("xlstm-1.3b", {}),
}


@pytest.mark.parametrize("family", list(UNTRAINED))
def test_training_is_not_ported_and_the_card_is_the_default(family):
    """``loss_fn`` refuses each family whose training is not ported, saying
    what it lacks and naming item 15, before it reads the batch."""
    arch, change = UNTRAINED[family]
    cfg = dataclasses.replace(get_config(arch).reduced(), **change)
    m = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=f"loss_fn.*missing here: {family}.*item 15"):
        m.loss_fn({}, {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(arch)
