"""The port's Multi-head Latent Attention (``repro_torch.models.layers.mla``)
against ``repro.models.layers.mla`` on the CPU: the same JAX-drawn weights
carried across by ``params_from_numpy``, the same numpy inputs.

The MLA held here has a v width (32) other than its qk width (32 + 16):
``reduced()`` makes the two equal, which would hide the prefill's
zero-padded V.  On the CPU the prefill's attention is ``kernels/ref.py``'s,
as on the card it is the flash kernel.

Tolerances, as ``tests/test_torch_transformer.py`` states them: layers
within ``LAYER_TOL`` (fp32 1e-6; bf16 one ulp, rtol 2**-7); a whole
attention pass, decode step or model logits within ``MODEL_TOL`` of their
scale (fp32 1e-5, bf16 2e-2): both packages round at the same steps, and
their fp32 sums (the attention's scores, the absorbed decode's products)
run in other orders.
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
import torch.nn.functional as F

from repro.configs import base as jbase
from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm
from repro.models.layers import mla as jmla
from repro_torch.configs.base import MLAConfig, get_config
from repro_torch.kernels import ref
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import mla as tmla
from repro_torch.utils.pytree import tree_leaves

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LAYER_TOL = {"float32": dict(rtol=1e-6, atol=1e-6), "bfloat16": dict(rtol=2**-7, atol=1e-6)}
MODEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MLA = dict(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
           v_head_dim=32)
ARCH = "minicpm3-4b"
NEW_ARCHS = ("minicpm3-4b", "paligemma-3b", "musicgen-medium")


def _configs(dtype: str = "float32", **kw):
    """minicpm3-4b reduced with the MLA above, in both packages."""
    return (dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype,
                                mla=jbase.MLAConfig(**MLA), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype, mla=MLAConfig(**MLA),
                                **kw))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _both(arr: np.ndarray, dtype: str):
    j = jnp.asarray(arr, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _scaled_close(port, want, tol, what):
    a, b = _f32(port), _f32(want)
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _mixer(dtype: str, seed: int = 0):
    """One MLA mixer's JAX params (norm scales drawn away from zero) and
    the port's copy."""
    jcfg, tcfg = _configs(dtype)
    jp = jmla.init_mla(jax.random.key(seed), jcfg, JDT[dtype])
    rng = np.random.default_rng(seed)
    for k in ("q_norm", "kv_norm"):
        jp[k] = jnp.asarray(rng.normal(size=jp[k].shape) * 0.1, jnp.float32)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# ---------------- configs and params ----------------
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_jax(arch):
    """Field for field, full and reduced, with the same plan and period."""
    j, t = jget_config(arch), get_config(arch)
    for a, b in ((t, j), (t.reduced(), j.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.plan_period == b.plan_period and a.resolved_head_dim == b.resolved_head_dim
        assert [dataclasses.asdict(x) for x in a.layer_plan()] == [
            dataclasses.asdict(x) for x in b.layer_plan()]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_chip_legs_have_the_jax_parameter_counts(arch):
    """The counts ``chip_smoke.py``'s phase 15 holds each full-width card
    model to are JAX's, from its init shapes."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    (n_params,) = [n for _, a, n in chip_smoke.MLA_FRONTEND_LEGS if a == arch]
    shapes = jax.eval_shape(lambda k: jtfm.init_params(k, jget_config(arch)),
                            jax.random.key(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == n_params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mla_has_jax_leaves_per_layer_and_stacked(dtype):
    """JAX's keys, shapes and dtypes (the norm scales fp32 zeros), one
    layer and the stacked leaves of JAX's scanned init."""
    jcfg, tcfg = _configs(dtype, n_layers=3, scan_layers=True)
    one = jmla.init_mla(jax.random.key(0), jcfg, JDT[dtype])
    stacked = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg), jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    for lead, want in (((), one), ((3,), stacked["blocks"][0]["mixer"])):
        got = tmla.init_mla(gen, tcfg, TDT[dtype], lead=lead)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k
        for k in ("q_norm", "kv_norm"):
            assert got[k].dtype == torch.float32 and not got[k].any()


# ---------------- the layer ----------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_latents_match_jax(dtype):
    """q_nope, rotated q_rope, normed c_kv and the shared rotated k_rope, at
    positions 0..15: within the layer tolerance."""
    jcfg, tcfg, jp, tp = _mixer(dtype)
    jx, tx = _both(np.random.default_rng(1).normal(size=(2, 16, 128)), dtype)
    pos = np.arange(16)[None]
    got = tmla._latents(tcfg, tp, tx, torch.from_numpy(pos))
    want = jmla._latents(jcfg, jp, jx, jnp.asarray(pos))
    for a, b, name in zip(got, want, ("q_nope", "q_rope", "c_kv", "k_rope"), strict=True):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == TDT[dtype], name
        np.testing.assert_allclose(_f32(a), _f32(b), err_msg=name, **LAYER_TOL[dtype])


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches_jax(dtype, window):
    """The prefill's output (B, S, d) against JAX's ``mla_forward`` within
    the model tolerance, with and without a window; the latents it returns
    for the cache are ``_latents``' (what JAX's prefill projects again)."""
    jcfg, tcfg, jp, tp = _mixer(dtype)
    jx, tx = _both(np.random.default_rng(2).normal(size=(2, 40, 128)), dtype)
    out, c_kv, k_rope = tmla.mla_forward(tcfg, tp, tx, window=window)
    want = jmla.mla_forward(jcfg, jp, jx, window=window)
    assert tuple(out.shape) == tuple(want.shape) == (2, 40, 128) and out.dtype == TDT[dtype]
    _scaled_close(out, want, MODEL_TOL[dtype], "mla_forward")
    _, _, jc, jk = jmla._latents(jcfg, jp, jx, jnp.arange(40)[None])
    np.testing.assert_allclose(_f32(c_kv), _f32(jc), **LAYER_TOL[dtype])
    np.testing.assert_allclose(_f32(k_rope), _f32(jk), **LAYER_TOL[dtype])


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_v_attention_is_the_unpadded_one(dtype, window):
    """V zero-padded from 32 to the qk width 48, then the first 32 output
    columns: bitwise the unpadded attention on the CPU, at the qk width's
    scale; the padded columns are exact zeros."""
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(size=(2, 24, 4, 48))).to(TDT[dtype]) for _ in "qk")
    v = torch.from_numpy(rng.normal(size=(2, 24, 4, 32))).to(TDT[dtype])
    padded = ref.attention(q, k, F.pad(v, (0, 16)), causal=True, window=window)
    assert torch.equal(padded[..., :32], ref.attention(q, k, v, causal=True, window=window))
    assert not padded[..., 32:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax(dtype):
    """The absorbed decode from JAX's prefill cache, 6 steps at positions
    40..45 of a 64-slot linear cache: each step's output within the model
    tolerance, the cache written in place equal to JAX's functional one."""
    jcfg, tcfg, jp, tp = _mixer(dtype)
    rng = np.random.default_rng(4)
    jx, _ = _both(rng.normal(size=(2, 40, 128)), dtype)
    _, _, jc, jk = jmla._latents(jcfg, jp, jx, jnp.arange(40)[None])
    jcache = jmla.init_mla_cache(jcfg, 2, 64, JDT[dtype])
    jcache = {"c_kv": jcache["c_kv"].at[:, :40].set(jc), "k_rope": jcache["k_rope"].at[:, :40].set(jk)}
    tcache = params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    for pos in range(40, 46):
        jt, tt = _both(rng.normal(size=(2, 1, 128)), dtype)
        want, jcache = jmla.mla_decode(jcfg, jp, jt, jcache, pos, ring=False)
        valid = tattn.kv_valid(2, 64, pos, ring=False, device="cpu")
        got, tcache2 = tmla.mla_decode(tcfg, tp, tt, tcache, pos, ring=False, valid=valid)
        assert tcache2 is tcache and got.dtype == TDT[dtype]
        _scaled_close(got, want, MODEL_TOL[dtype], f"mla_decode at {pos}")
        for key in ("c_kv", "k_rope"):
            np.testing.assert_allclose(_f32(tcache[key]), _f32(jcache[key]), err_msg=key,
                                       **LAYER_TOL[dtype])


def test_init_mla_cache_has_jax_leaves():
    jcfg, tcfg = _configs("bfloat16")
    want = jmla.init_mla_cache(jcfg, 2, 16, jnp.bfloat16)
    for lead in ((), (3,)):
        got = tmla.init_mla_cache(tcfg, 2, 16, torch.bfloat16, lead=lead)
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == lead + tuple(want[k].shape) and not got[k].any()
            assert got[k].dtype == torch.bfloat16


def test_a_v_wider_than_qk_is_refused():
    _, tcfg = _configs()
    tcfg = dataclasses.replace(tcfg, mla=MLAConfig(**{**MLA, "v_head_dim": 64}))
    p = tmla.init_mla(torch.Generator().manual_seed(0), tcfg, torch.float32)
    with pytest.raises(ValueError, match="v_head_dim 64"):
        tmla.mla_forward(tcfg, p, torch.zeros(1, 4, 128))


# ---------------- the stack's ring cache ----------------
def test_mla_ring_cache_matches_jax_step_by_step():
    """A sliding window of 8 under a context of 64: an 8-slot ring of
    latents filled by a 12-token prefill past its length (positions 4..11
    in slots 4..7, 0..3), then 20 decode steps that wrap it again; fp32,
    the stack's logits and both latent caches against JAX every step, the
    tokens identical."""
    jcfg, tcfg = _configs(sliding_window=8)
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(7))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 64)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, 64)
    assert tuple(tc["layers"][0]["c_kv"].shape) == (2, 8, MLA["kv_lora_rank"])
    for step in range(21):
        _scaled_close(tl, jl, MODEL_TOL["float32"], f"logits after step {step}")
        for j, t in zip(jax.tree.leaves(jc["layers"]), tree_leaves(tc["layers"]), strict=True):
            _scaled_close(t, j, MODEL_TOL["float32"], f"ring cache after step {step}")
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
        assert np.array_equal(np.asarray(jt), tt.numpy()), f"token of step {step}"
        if step == 20:
            break
        jl, jc = jm.decode_step(jp, {"tokens": jt}, jc, 64)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, {"tokens": tt}, tc, 64)
        assert int(tc["pos"]) == int(jc["pos"]) == 13 + step
