"""The port's MoE and dense-family serving stacks against the JAX package
on the CPU: the same JAX-drawn params carried across by
``params_from_numpy``, the same numpy tokens.

``prefill`` plus 4 decode steps for ``deepseek-moe-16b``,
``mixtral-8x7b`` (window 64 under a context of 256: the ring cache) and
Jamba with its experts (mamba + MoE, period 2, 4 layers), reduced, per
layer and stacked, fp32 and bf16.  Every MoE layer's routing (the
chosen set of experts) is recorded in both packages, call by call: 528
routings a test.  A routing may differ only where JAX's k-th/(k+1)-th
router-logit gap is at most twice the largest difference between the
two packages' logits of that token (the stated margin): a near-tie that
the packages' roundings can break either way.  In fp32 none differs
(the smallest gap on these inputs is 2.4e-4, the logits at most 6.8e-6
apart), and the logits are held at the dense stack's tolerances (1e-5;
Jamba 1e-4, ``tests/test_torch_hybrid.py``'s).  In bf16 the router
inputs are bf16 roundings apart (JAX's stacked run compiles each layer
as a ``lax.scan`` body whose fused bf16 chains drop roundings its
op-by-op run makes; JAX's Pallas decode body keeps fp32 probabilities
that the port rounds), the logits up to 4.7e-2 apart, and a few routings
flip under the margin (0 to 9 of 544 at 8 decode steps): the flips are
counted, and the
logits are held (2e-2; Jamba 4e-2) with the port fed JAX's routing.
granite-8b (GQA, theta 1e7) and stablelm-3b (MHA, LayerNorm), reduced,
at the dense stack's tolerances.  JAX runs its Pallas bodies in interpret
mode (``set_impl("pallas")``), through fresh, unjitted calls; the port
its plain versions.  The layer itself is ``tests/test_torch_moe.py``.
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
from repro.models.layers import moe as jmoe
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import generate
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.layers import moe as tmoe
from repro_torch.utils.pytree import tree_leaves

JAMBA = "jamba-1.5-large-398b"
MOE_ARCHS = ("deepseek-moe-16b", "mixtral-8x7b", JAMBA)
MODEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JAMBA_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
# 4 decode steps: each reaches the decode path and the next slot (mixtral:
# the ring holds 64 of the 128 prompt positions); the Pallas-interpret JAX
# side costs ~1-2 s a stacked step
PROMPT, CONTEXT, STEPS = 128, 256, 4


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


def _configs(arch: str, **kw):
    """The reduced config in both packages (Jamba at 4 layers: two periods
    of [mamba, attn + MoE])."""
    if arch == JAMBA:
        kw.setdefault("n_layers", 4)
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


class Routings:
    """Each MoE layer's routing in both packages, call by call (JAX's
    through an ordered debug callback, so its scanned stack reports too).
    With ``force`` the port is fed JAX's routing of the same call."""

    def __init__(self, monkeypatch, force: bool):
        self.jax, self.port, self.force = [], [], force
        jax_router, port_router = jmoe.router_topk, tmoe.router_topk

        def jax_wrapped(cfg, params, x):
            topv, topi, aux = jax_router(cfg, params, x)
            logits = jnp.einsum("td,de->te", x.astype(jnp.float32), params["router"])
            jax.debug.callback(lambda *a: self.jax.append(tuple(map(np.asarray, a))),
                               topv, topi, logits, ordered=True)
            return topv, topi, aux

        def port_wrapped(cfg, params, x):
            topv, topi, aux = port_router(cfg, params, x)
            self.port.append((topi.numpy(), torch.matmul(x.float(), params["router"]).numpy()))
            if self.force:
                jv, ji, _ = self.jax[len(self.port) - 1]
                return torch.from_numpy(jv.copy()), torch.from_numpy(np.array(ji)).long(), aux
            return topv, topi, aux

        monkeypatch.setattr(jmoe, "router_topk", jax_wrapped)
        monkeypatch.setattr(tmoe, "router_topk", port_wrapped)

    def check(self) -> tuple[int, float]:
        """Routings equal wherever JAX's k-th/(k+1)-th logit gap exceeds
        twice that token's largest logit difference -> (flips, smallest
        gap)."""
        jax.effects_barrier()
        assert len(self.jax) == len(self.port) > 0
        flips, smallest = 0, np.inf
        for (_, ji, jl), (ti, tl) in zip(self.jax, self.port, strict=True):
            k = ji.shape[-1]
            diff = np.abs(jl - tl).max(-1)
            top = -np.sort(-jl, axis=-1)
            gap = top[:, k - 1] - top[:, k]
            # the chosen set: the order within it moves no pair of the dispatch
            differ = (np.sort(ji, -1) != np.sort(ti, -1)).any(-1)
            assert not np.any(differ & (gap > 2 * diff)), (
                f"a routing differs at a gap {gap[differ].min()} above twice the logits' "
                f"difference {diff[differ].max()}")
            flips += int(differ.sum())
            smallest = min(smallest, float(gap.min()))
        return flips, smallest


@pytest.mark.parametrize("scan", [False, True], ids=["per_layer", "stacked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, scan, pallas_impl, monkeypatch):
    """prefill's next-token logits and cache, then 4 greedy decode steps'
    logits and the cache after them, against JAX's, with every routing
    checked (the module docstring states the margin).  Mixtral's ring
    holds 64 of the 128 prompt positions."""
    jcfg, tcfg = _configs(arch, dtype=dtype, scan_layers=scan)
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tol = (JAMBA_TOL if arch == JAMBA else MODEL_TOL)[dtype]
    routes = Routings(monkeypatch, force=dtype == "bfloat16")
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, CONTEXT)
    jax.effects_barrier()
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, CONTEXT)
    if arch == "mixtral-8x7b":
        assert tc["layers"][0]["k"].shape[-3] == 64
    _scaled_close(tl, jl, tol, "prefill logits")
    for j, t in zip(jax.tree.leaves(jc["layers"]), tree_leaves(tc["layers"]), strict=True):
        _scaled_close(t, j, tol, "prefill cache")
    jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    for step in range(STEPS):
        if dtype == "float32":
            assert np.array_equal(np.asarray(jt), tt.numpy()), f"token of step {step}"
        else:
            tt = torch.from_numpy(np.array(jt))
        jl, jc = jm.decode_step(jp, {"tokens": jt}, jc, CONTEXT)
        jax.effects_barrier()
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, {"tokens": tt}, tc, CONTEXT)
        _scaled_close(tl, jl, tol, f"decode step {step} logits")
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], -1)[:, None].to(torch.int32)
    for j, t in zip(jax.tree.leaves(jc["layers"]), tree_leaves(tc["layers"]), strict=True):
        _scaled_close(t, j, tol, "cache after decoding")
    moe_layers = sum(s.moe for s in tcfg.layer_plan())
    assert len(routes.port) == moe_layers * (1 + STEPS)
    flips, smallest = routes.check()
    if dtype == "float32":
        assert flips == 0, f"{flips} routings differ (smallest gap {smallest})"


def test_generate_matches_jax_serve_loop():
    """``launch.serve.generate`` on deepseek reduced against the loop of
    ``repro.launch.serve`` (jitted prefill, argmax, jitted decode steps),
    fp32: the same tokens."""
    jcfg, tcfg = _configs("deepseek-moe-16b", dtype="float32", scan_layers=False)
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
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
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


# ---------------- the rest of the dense family ----------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-8b", "stablelm-3b"])
def test_dense_family_prefill_and_decode_match_jax(arch, dtype, pallas_impl):
    """granite (GQA, theta 1e7) and stablelm (MHA, LayerNorm) reduced,
    stacked: prefill's logits and cache, 4 decode steps, at the dense
    stack's tolerances."""
    jcfg, tcfg = _configs(arch, dtype=dtype)
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tol = MODEL_TOL[dtype]
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, CONTEXT)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, CONTEXT)
    _scaled_close(tl, jl, tol, "prefill logits")
    for j, t in zip(jax.tree.leaves(jc["layers"]), tree_leaves(tc["layers"]), strict=True):
        _scaled_close(t, j, tol, "prefill cache")
    jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)
    for step in range(STEPS):
        jl, jc = jm.decode_step(jp, {"tokens": jt}, jc, CONTEXT)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(np.array(jt))}, tc, CONTEXT)
        _scaled_close(tl, jl, tol, f"decode step {step} logits")
        jt = jnp.argmax(jl[:, -1], -1)[:, None].astype(jnp.int32)


