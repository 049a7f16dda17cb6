"""The port's MoE feed-forward (``repro_torch.models.layers.moe``) and the
serving path of the MoE family against the JAX package on the CPU: the
same JAX-drawn params carried across by ``params_from_numpy``, the same
numpy inputs.

- The router, the dispatch and the combine: the dispatch and the combine
  are fed JAX's own routing and held bitwise (fp32 and bf16); the
  router's indices equal JAX's, ties included (``jax.lax.top_k`` takes the
  lower index first); its probabilities and aux terms within 1e-6.
- ``moe_forward`` on identical inputs: fp32 within 1e-5 of the output's
  scale, bf16 within one bf16 ulp of the scale (both round at the same
  steps; the batched products may sum in another order).
- ``forward``'s aux terms summed over the layers, as JAX's; the serving
  driver on the CPU for the MoE and dense-family configs.  The stack's
  prefill and decode against JAX are ``tests/test_torch_moe_stack.py``.
"""
import dataclasses
import importlib.util
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

from repro.configs import base as jbase
from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm
from repro.models.layers import moe as jmoe
from repro_torch.configs.base import MoEConfig, get_config
from repro_torch.launch import serve
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import moe as tmoe
from repro_torch.utils.pytree import tree_leaves

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAMBA = "jamba-1.5-large-398b"
MOE_ARCHS = ("deepseek-moe-16b", "mixtral-8x7b", JAMBA)
MODEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JAMBA_TOL = {"float32": 1e-4, "bfloat16": 4e-2}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _both(arr: np.ndarray, dtype: str):
    j = jnp.asarray(arr, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _scaled_close(port, ref, tol, what):
    a, b = _f32(port), _f32(ref)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _configs(arch: str, **kw):
    """The reduced config in both packages (Jamba at 4 layers: two periods
    of [mamba, attn + MoE])."""
    if arch == JAMBA:
        kw.setdefault("n_layers", 4)
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _moe_configs(e: int, k: int, d: int, *, shared: int = 0, dtype="float32"):
    """deepseek's reduced stack with an (e, k) router at width d."""
    jcfg, tcfg = _configs("deepseek-moe-16b", d_model=d, dtype=dtype)
    return (dataclasses.replace(jcfg, moe=jbase.MoEConfig(n_experts=e, top_k=k, d_expert=d,
                                                          n_shared_experts=shared)),
            dataclasses.replace(tcfg, moe=MoEConfig(n_experts=e, top_k=k, d_expert=d,
                                                    n_shared_experts=shared)))


def _layer(arch: str, dtype: str, seed: int = 0):
    jcfg, tcfg = _configs(arch, dtype=dtype)
    jp = jmoe.init_moe(jax.random.key(seed), jcfg, JDT[dtype])
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# ---------------- configs ----------------
@pytest.mark.parametrize("arch", ["granite-8b", "stablelm-3b", "deepseek-moe-16b",
                                  "mixtral-8x7b"])
def test_config_matches_jax(arch):
    """Field for field, as registered and reduced, with the plan and its
    period; ``build_model`` builds each on the CPU when asked."""
    j, t = jget_config(arch), get_config(arch)
    for a, b in ((t, j), (t.reduced(), j.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.resolved_head_dim == b.resolved_head_dim and a.plan_period == b.plan_period
        assert [dataclasses.asdict(x) for x in a.layer_plan()] == [
            dataclasses.asdict(x) for x in b.layer_plan()]
    assert build_model(t.reduced(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b", "granite-8b",
                                  "stablelm-3b"])
def test_chip_phase_14_parameter_counts_are_jaxs(arch):
    """The counts ``chip_smoke.py``'s phase 14 holds each card model to
    (Mixtral at its 16-layer cut) are the JAX package's, from its init
    shapes (nothing allocated)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    (depth, n_params), = [(depth, n) for _, a, depth, n in chip_smoke.SERVING_LEGS if a == arch]
    cfg = jget_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    shapes = jax.eval_shape(lambda k: jtfm.init_params(k, cfg), jax.random.key(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == n_params


# ---------------- init ----------------
@pytest.mark.parametrize("scan", [False, True], ids=["per_layer", "stacked"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", JAMBA])
def test_init_has_jax_tree_shapes_and_dtypes(arch, scan):
    """The port's own init gives JAX's tree (the router fp32, the shared
    experts where the config has them, the MoE leaves on the plan's MoE
    positions only), and ``params_from_numpy`` carries JAX's draw across
    bit for bit."""
    jcfg, tcfg = _configs(arch, scan_layers=scan)
    jp = jbuild_model(jcfg).init(jax.random.key(0))
    tp = build_model(tcfg, device="cpu").init(5)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert jax.tree.structure(jp) == jax.tree.structure(jax.tree.map(lambda t: 0, tp))
    for (path, j), t in zip(jflat, tree_leaves(tp), strict=True):
        where = jax.tree_util.keystr(path)
        assert tuple(j.shape) == tuple(t.shape), where
        assert str(j.dtype) == str(t.dtype).removeprefix("torch."), where
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for (path, j), t in zip(jflat, tree_leaves(carried), strict=True):
        assert np.array_equal(_f32(t), _f32(j)), jax.tree_util.keystr(path)
    ffn = [set(b["ffn"]) for b in tp["blocks"] if "ffn" in b]
    moe_keys = {"router", "w_gate", "w_up", "w_down"}
    assert any(f >= moe_keys for f in ffn)
    assert ("shared" in set().union(*ffn)) == (arch == "deepseek-moe-16b")


# ---------------- the router ----------------
def _router_case(case: str):
    """(JAX cfg, port cfg, router (d, E) fp32, tokens (T, d) fp32)."""
    rng = np.random.default_rng(21)
    if case in ("deepseek-moe-16b", "mixtral-8x7b"):
        jcfg, tcfg = _configs(case)
    else:
        jcfg, tcfg = _moe_configs(64, 6, 64)
    d, e = tcfg.d_model, tcfg.moe.n_experts
    w = (rng.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32)
    if case == "ties":
        w[:, 1::2] = w[:, 0::2]  # every expert has a twin: exact ties in the probabilities
    return jcfg, tcfg, w, rng.normal(size=(512, d)).astype(np.float32)


@pytest.mark.parametrize("case", ["deepseek-moe-16b", "mixtral-8x7b", "e64-k6", "ties"])
def test_router_topk_matches_jax(case):
    """Indices equal, the renormalized probabilities and the aux terms
    within 1e-6; with duplicated router columns the tied probabilities
    are bitwise equal in both packages and both take the lower index."""
    jcfg, tcfg, w, x = _router_case(case)
    jv, ji, ja = jmoe.router_topk(jcfg, {"router": jnp.asarray(w)}, jnp.asarray(x))
    tv, ti, ta = tmoe.router_topk(tcfg, {"router": torch.from_numpy(w)}, torch.from_numpy(x))
    assert ti.dtype == torch.int64 and tuple(ti.shape) == tuple(ji.shape)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    assert set(ta) == set(ja) == {"moe_aux", "moe_z"}
    for k in ja:
        np.testing.assert_allclose(float(ta[k]), float(ja[k]), rtol=1e-6)
    if case == "ties":
        probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w), -1)
        assert torch.equal(probs[:, 0::2], probs[:, 1::2])
        twins = ti.numpy() // 2
        # where a pair of twins is chosen, the lower index comes first
        for row, pair in zip(ti.numpy(), twins):
            for j in range(1, len(row)):
                if pair[j] == pair[j - 1]:
                    assert row[j] == row[j - 1] + 1


def test_top_k_breaks_ties_as_jax():
    """``jax.lax.top_k``'s order on a row of ties and on many rows of small
    integers (ties everywhere); ``torch.topk`` need not give it."""
    p = np.array([[0.1, 0.3, 0.3, 0.3]], np.float32)
    assert tmoe.top_k(torch.from_numpy(p), 2)[1].tolist() == [[1, 2]]
    q = np.random.default_rng(3).integers(0, 4, (256, 64)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(q), 6)
    tv, ti = tmoe.top_k(torch.from_numpy(q), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------- dispatch and combine ----------------
def _leaning(rng, shape, router: np.ndarray) -> np.ndarray:
    """Normal tokens whose second sequence leans towards expert 0, so that
    it overflows that expert's capacity at S > 1."""
    x = rng.normal(size=shape)
    x[1] += 2.0 * router[:, 0] / np.linalg.norm(router[:, 0]) * np.sqrt(shape[-1])
    return x


def _jax_routing(case: str, s: int, dtype: str):
    """x (B, S, d) in both packages and JAX's own routing of it."""
    jcfg, tcfg, w, _ = _router_case(case)
    jx, tx = _both(_leaning(np.random.default_rng(s), (3, s, tcfg.d_model), w), dtype)
    topv, topi, _ = jmoe.router_topk(jcfg, {"router": jnp.asarray(w)},
                                     jx.reshape(-1, tcfg.d_model))
    k = tcfg.moe.top_k
    return tcfg, jx, tx, topv.reshape(3, s, k), topi.reshape(3, s, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,cf", [(40, 1.25), (1, 2.0)], ids=["prefill-drops", "decode"])
@pytest.mark.parametrize("case", ["deepseek-moe-16b", "e64-k6"])
def test_dispatch_and_combine_bitwise_given_jax_routing(case, s, cf, dtype):
    """Fed JAX's ``topi`` / ``topv``: the buffer, ``dst``, ``scale``,
    ``src_tok`` and ``keep`` equal JAX's vmapped ``_dispatch_one``, and the
    combine of one expert-output buffer equals JAX's ``.at[].add``, bit for
    bit; the leaning sequence drops pairs at cf 1.25, and drops keep JAX's
    zero row."""
    tcfg, jx, tx, topv, topi = _jax_routing(case, s, dtype)
    e, k = tcfg.moe.n_experts, tcfg.moe.top_k
    cap = tmoe.capacity_of(s, k, e, cf)
    assert cap == max(1, int(np.ceil(s * k * cf / e)))
    jbuf, jdst, jscale, jsrc, jkeep = jax.vmap(
        partial(jmoe._dispatch_one, e=e, k=k, capacity=cap))(jx, topi, topv)
    tbuf, tdst, tscale, tsrc, tkeep = tmoe.dispatch(
        tx, torch.from_numpy(np.array(topi)).long(), torch.from_numpy(np.array(topv)),
        e=e, k=k, capacity=cap)
    assert tuple(tbuf.shape) == (e, 3, cap, tcfg.d_model) and tbuf.dtype == TDT[dtype]
    assert np.array_equal(_f32(tbuf.transpose(0, 1)), _f32(jbuf))
    for t, j in ((tdst, jdst), (tscale, jscale), (tsrc, jsrc), (tkeep, jkeep)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if s > 1 and cf == 1.25:
        assert not tkeep[1].all()  # the leaning sequence overflows

    ob = np.random.default_rng(7).normal(size=(3, e * cap, tcfg.d_model))
    job, tob = _both(ob, dtype)
    job = jnp.concatenate([job, jnp.zeros((3, 1, tcfg.d_model), job.dtype)], axis=1)

    def one(o, dst, scale, src):
        g = o[dst] * scale[:, None].astype(o.dtype)
        return jnp.zeros((s, tcfg.d_model), o.dtype).at[src].add(g)

    want = jax.vmap(one)(job, jdst, jscale, jsrc)
    got = tmoe.combine(tob.view(3, e, cap, -1).transpose(0, 1).contiguous(), tdst, tscale,
                       tsrc, s=s)
    assert got.dtype == TDT[dtype]
    assert np.array_equal(_f32(got), _f32(want))


def test_bf16_combine_is_a_sequential_fold():
    """XLA's bf16 ``.at[].add`` adds a token's k = 6 products one by one in
    bf16; the port's combine matches it bit for bit, where an fp32 sum
    rounded once differs from both."""
    tcfg, jx, tx, topv, topi = _jax_routing("e64-k6", 40, "bfloat16")
    e, k = 64, 6
    cap = tmoe.capacity_of(40, k, e, 2.0)
    _, tdst, tscale, tsrc, _ = tmoe.dispatch(
        tx, torch.from_numpy(np.array(topi)).long(), torch.from_numpy(np.array(topv)),
        e=e, k=k, capacity=cap)
    ob = torch.randn((e, 3, cap, tcfg.d_model), generator=torch.Generator().manual_seed(0))
    got = tmoe.combine(ob.to(torch.bfloat16), tdst, tscale, tsrc, s=40)
    job = jnp.asarray(ob.transpose(0, 1).reshape(3, e * cap, -1).numpy(), jnp.bfloat16)
    job = jnp.concatenate([job, jnp.zeros((3, 1, tcfg.d_model), job.dtype)], axis=1)
    jdst, jscale, jsrc = (jnp.asarray(t.numpy()) for t in (tdst, tscale, tsrc))
    want = jax.vmap(lambda o, d, sc, sr: jnp.zeros((40, tcfg.d_model), o.dtype).at[sr].add(
        o[d] * sc[:, None].astype(o.dtype)))(job, jdst, jscale, jsrc)
    assert np.array_equal(_f32(got), _f32(want))
    once = jax.vmap(lambda o, d, sc, sr: jnp.zeros((40, tcfg.d_model), jnp.float32).at[sr].add(
        (o[d] * sc[:, None].astype(o.dtype)).astype(jnp.float32)))(job, jdst, jscale, jsrc)
    assert not np.array_equal(_f32(once.astype(jnp.bfloat16)), _f32(want))


# ---------------- the layer ----------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_jax(arch, dtype):
    """``moe_forward`` on identical inputs at both capacity factors (1.25
    drops pairs here, 2.0 does not): routings equal, the output within
    1e-5 of its scale (fp32) or one bf16 ulp of it, the aux terms within
    1e-5."""
    jcfg, tcfg, jp, tp = _layer(arch, dtype)
    jx, tx = _both(_leaning(np.random.default_rng(5), (3, 40, tcfg.d_model),
                            np.asarray(jp["router"])), dtype)
    for cf in (1.25, 2.0):
        jo, ja = jmoe.moe_forward(jcfg, jp, jx, capacity_factor=cf)
        with torch.inference_mode():
            to, ta = tmoe.moe_forward(tcfg, tp, tx, capacity_factor=cf)
        assert to.dtype == TDT[dtype] and tuple(to.shape) == tuple(jo.shape)
        scale = float(np.abs(_f32(jo)).max())
        tol = 1e-5 * scale if dtype == "float32" else _bf16_ulp(scale)
        assert np.abs(_f32(to) - _f32(jo)).max() <= tol, f"cf {cf}"
        assert set(ta) == set(ja) == set(tfm.AUX_KEYS)
        for k in ja:
            np.testing.assert_allclose(float(ta[k]), float(ja[k]), rtol=1e-5, atol=1e-7)
        assert (float(ta["moe_drop_frac"]) > 0) == (cf == 1.25)


def test_moe_loss_matches_jax():
    jcfg, tcfg, jp, tp = _layer("deepseek-moe-16b", "float32")
    jx, tx = _both(np.random.default_rng(6).normal(size=(2, 24, tcfg.d_model)), "float32")
    _, ja = jmoe.moe_forward(jcfg, jp, jx)
    _, ta = tmoe.moe_forward(tcfg, tp, tx)
    np.testing.assert_allclose(float(tmoe.moe_loss(ta, tcfg)), float(jmoe.moe_loss(ja, jcfg)),
                               rtol=1e-6)


# ---------------- the stack ----------------
def test_forward_returns_jaxs_aux():
    """``forward`` -> (logits, the aux terms summed over the MoE layers), as
    JAX's: deepseek's 2 MoE layers, Jamba's 2 of 4; a dense stack's zeros."""
    for arch in ("deepseek-moe-16b", JAMBA, "granite-8b"):
        jcfg, tcfg = _configs(arch, dtype="float32")
        jp = jbuild_model(jcfg).init(jax.random.key(2))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
        jl, ja = jax.jit(lambda p, b, cfg=jcfg: jtfm.forward(cfg, p, b))(
            jp, {"tokens": jnp.asarray(toks)})
        with torch.inference_mode():
            tl, ta = tfm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
        _scaled_close(tl, jl, (JAMBA_TOL if arch == JAMBA else MODEL_TOL)["float32"],
                      f"{arch} forward logits")
        assert set(ta) == set(ja) == set(tfm.AUX_KEYS)
        for k in ja:
            assert ta[k].dtype == torch.float32 and ta[k].shape == ()
            np.testing.assert_allclose(float(ta[k]), float(ja[k]), rtol=1e-5, atol=1e-7)
        assert (float(ta["moe_aux"]) > 0) == (tcfg.moe is not None)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b", "granite-8b",
                                  "stablelm-3b"])
def test_serve_main_runs_on_the_cpu_when_asked(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--batch", "1", "--prompt-len", "8",
                "--tokens", "4", "--context", "16"])
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced generated (1, 4) tokens" in out and "on cpu" in out
