"""The port's hybrid Mamba training against the JAX package on the CPU: the
selective scan's plain backward (``ref.selective_scan_bwd``) against
``jax.vjp`` of JAX's scan oracle and against torch autograd of the plain
forward, a model of the backward kernel's order
(``tests/torch_kernel_models.py``), the differentiable scan pair (``ops._SelectiveScan`` /
``_SelectiveScanBwd``) under ``torch.func.vmap(grad)`` with A and D shared
and per client, ``mamba_forward``'s gradient against ``jax.grad`` of JAX's,
``loss_fn`` with every leaf's gradient against ``jax.value_and_grad`` for
reduced ``jamba-1.5-large-398b`` (plan [mamba, attn], its 4 experts on the
attention layer), two rounds of ``make_round_step`` against JAX's jitted
engine, the reference smoke test's SGD step, the LLM fine-tune example's
twin, and the parameter counts of ``chip_smoke.py``'s phase 20.  Inputs
come from numpy seeds; params cross as numpy arrays (``params_from_numpy``);
each JAX reference is jitted once a module.

JAX differentiates its oracle (``repro/kernels/ref.py:169``, a chunked
associative scan under ``jax.checkpoint``): the Pallas scan has no VJP.

Tolerances, stated with their reasons:
- the scan's backward against ``jax.vjp``, fp32: relative L2 1e-5 for
  every gradient (observed up to 3.2e-7).  JAX's associative scan forms
  the states in another order (products of decays, then one sum), its
  einsum sums over N in another order, and XLA's CPU ``exp`` is not
  torch's; each of those moves a state by a few ulps, and the reverse
  recurrence carries them.  bf16 x: the same 1e-5 for every fp32 gradient;
  dx relative L2 2**-8 (one bf16 ulp; observed 2.8e-3): the port rounds dx
  to bf16 once, while JAX casts x to fp32 at two uses, so its dx is the
  bf16 sum of two bf16-rounded cotangents, three roundings of half an ulp.
- against torch autograd of ``ref.selective_scan`` (the same forward
  ops): relative L2 1e-6; autograd sums the same terms in another order.
- ``vmap(grad)`` against a loop of ``grad``: bitwise (the same CPU ops on
  a folded batch).
- the kernel's model (``tests/torch_kernel_models.py``'s
  ``scan_bwd_kernel_order``) against the plain backward: relative L2 1e-6
  (the kernel's fmaf and fixed reduction orders against torch's; observed
  ~1e-7), a bf16 dx 2**-8; its checkpoints and recomputed states bitwise
  the plain forward's.
- the mixer and ``loss_fn`` in fp32: loss within 1e-5 relative, every
  gradient leaf within 1e-4 of its max-abs (``tests/test_torch_lm_train.py``'s
  bound: fp32 matmuls sum in other orders, and the scan's as above).
- bf16 (per-layer stack): loss within 1e-3 relative, leaves within 4e-2 of
  their max-abs, as the dense and MoE families' bf16 tests: both round
  activations to bf16 at the same steps, but a bf16 ulp in another place
  moves the backward's products by a few ulps.  The MoE layer's routings
  are compared as ``tests/test_torch_moe_train.py`` does.
- the round step: as ``tests/test_torch_lm_train.py`` states it.
"""
import dataclasses
import functools
import importlib
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

import repro.core as J
import repro.data.loader as jloader
from repro.configs.base import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import transformer as jtfm
from repro.models.layers import mamba as jmamba
from repro.optim import sgd as jsgd
import repro_torch.core as T
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.selective_scan import CHECKPOINT_EVERY, bwd_channels
from repro_torch.models import params_from_numpy
from repro_torch.models.layers import mamba as tmamba
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_size
from test_torch_lm_train import (  # noqa: F401 (jax_basis is a fixture)
    BUDGETS, STEPS, WEIGHTS, C, _close_up_to_roundings, _codecs, _f32, _flat, jax_basis,
)
from test_torch_moe_train import Routes, _check_loss_and_grads, _leaves_close, _models
from torch_kernel_models import (
    SCAN_PER, SCAN_RANGE, SCAN_SEG, SCAN_THREADS, scan_bwd_kernel_order,
)

ARCH = "jamba-1.5-large-398b"
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------- the scan's backward ----------------
def _scan_inputs(b, s, di, n, dtype, *, init, dh, long_memory=False, groups=1, seed=0):
    """numpy inputs: x ~ 0.5 N in ``dtype`` (rounded through bf16 for
    bf16), dt = softplus(N) and A = -exp(0.3 N) -- or, with ``long_memory``,
    the model's dt (log-uniform in [1e-3, 1e-1]) and A = -(1..N) -- B, C, D
    ~ N, dy ~ N in x's dtype, an optional initial state and final-state
    cotangent; A (G, Di, N) and D (G, Di) with ``groups`` > 1."""
    rng = np.random.default_rng(seed)
    lead = () if groups == 1 else (groups,)
    x = (0.5 * rng.normal(size=(b, s, di))).astype(np.float32)
    if long_memory:
        dt = np.exp(rng.uniform(size=(b, s, di)) * (math.log(0.1) - math.log(1e-3))
                    + math.log(1e-3)).astype(np.float32)
        a = -np.broadcast_to(np.arange(1, n + 1, dtype=np.float32), (*lead, di, n)).copy()
    else:
        dt = np.log1p(np.exp(rng.normal(size=(b, s, di)))).astype(np.float32)
        a = -np.exp(0.3 * rng.normal(size=(*lead, di, n))).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    d = rng.normal(size=(*lead, di)).astype(np.float32)
    dy = rng.normal(size=(b, s, di)).astype(np.float32)
    if dtype == "bfloat16":  # values a bf16 tensor holds
        x, dy = (np.array(jnp.asarray(t, jnp.bfloat16).astype(jnp.float32)) for t in (x, dy))
    h0 = rng.normal(size=(b, di, n)).astype(np.float32) if init else None
    dhf = rng.normal(size=(b, di, n)).astype(np.float32) if dh else None
    return x, dt, a, bm, cm, d, dy, h0, dhf


@functools.cache
def _jax_scan_vjp(has_init: bool):
    """jit of ``jax.vjp`` of JAX's oracle -> (dx, ddt, dA, dB, dC, dD[, dh0])."""
    def vjp(x, dt, a, bm, cm, d, h0, dy, dh):
        def fwd(x, dt, a, bm, cm, d, h0):
            return jref.selective_scan(x, dt, a, bm, cm, d, init_state=h0 if has_init else None)
        _, pull = jax.vjp(fwd, x, dt, a, bm, cm, d, h0)
        return pull((dy, dh))
    return jax.jit(vjp)


# label, B, S, Di, N, x dtype, initial state, final-state cotangent, long memory
SCAN_CASES = [
    ("fp32", 2, 16, 16, 8, "float32", False, False, False),
    ("fp32, init and dh", 2, 16, 16, 16, "float32", True, True, False),
    ("bf16, dh", 2, 16, 16, 8, "bfloat16", False, True, False),
    ("bf16, init", 2, 16, 16, 8, "bfloat16", True, False, False),
    ("ragged S=37, Di=12, N=5, init and dh", 2, 37, 12, 5, "float32", True, True, False),
    ("long memory", 1, 256, 8, 16, "float32", False, True, True),
]


def _torch_scan(inputs, dtype):
    x, dt, a, bm, cm, d, dy, h0, dhf = inputs
    tt = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    return (tt(x).to(TDT[dtype]), tt(dt), tt(a), tt(bm), tt(cm), tt(d), tt(dy).to(TDT[dtype]),
            tt(h0), tt(dhf))


@pytest.mark.parametrize("case", SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_scan_backward_matches_jax_vjp_of_its_oracle(case):
    _, b, s, di, n, dtype, init, dh, long_memory = case
    inputs = _scan_inputs(b, s, di, n, dtype, init=init, dh=dh, long_memory=long_memory)
    x, dt, a, bm, cm, d, dy, h0, dhf = _torch_scan(inputs, dtype)
    got = ref.selective_scan_bwd(x, dt, a, bm, cm, d, dy, init_state=h0, dh_final=dhf)
    assert got[0].dtype == x.dtype and all(g.dtype == torch.float32 for g in got[1:6])
    assert (got[6] is None) == (not init)
    jx = jnp.asarray(inputs[0], JDT[dtype])
    jdy = jnp.asarray(inputs[6], JDT[dtype])
    zeros = np.zeros((b, di, n), np.float32)
    want = _jax_scan_vjp(init)(jx, *inputs[1:6], zeros if h0 is None else inputs[7], jdy,
                               zeros if dhf is None else inputs[8])
    for name, g, w in zip(NAMES, got, want):
        if g is None:
            continue
        assert tuple(g.shape) == w.shape and np.isfinite(_f32(g)).all(), name
        bound = 2.0 ** -8 if name == "dx" and dtype == "bfloat16" else 1e-5
        assert _rel_l2(_f32(g), _f32(w)) <= bound, (name, _rel_l2(_f32(g), _f32(w)))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("case", SCAN_CASES[1:5], ids=[c[0] for c in SCAN_CASES[1:5]])
def test_scan_backward_is_autograd_of_the_plain_forward(case, groups):
    """Every gradient, dh0 and the final state's cotangent included, with
    A and D in one group and in 2 (rows 0-1 and 2-3 of B = 4)."""
    _, _, s, di, n, dtype, init, dh, long_memory = case
    inputs = _scan_inputs(4, s, di, n, dtype, init=init, dh=dh, long_memory=long_memory,
                          groups=groups, seed=1)
    x, dt, a, bm, cm, d, dy, h0, dhf = _torch_scan(inputs, dtype)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm, d)]
    h0r = None if h0 is None else h0.clone().requires_grad_()
    y, h = ref.selective_scan(*leaves, init_state=h0r, groups=groups)
    loss = (y.float() * dy.float()).sum() + (0 if dhf is None else (h * dhf).sum())
    loss.backward()
    got = ref.selective_scan_bwd(x, dt, a, bm, cm, d, dy, init_state=h0, dh_final=dhf,
                                 groups=groups)
    want = [t.grad for t in leaves] + [None if h0r is None else h0r.grad]
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            continue
        assert g.shape == w.shape, name
        bound = 2.0 ** -8 if name == "dx" and dtype == "bfloat16" else 1e-6
        assert _rel_l2(_f32(g), _f32(w)) <= bound, (name, _rel_l2(_f32(g), _f32(w)))


def test_grouped_scan_is_each_groups_scan():
    """Groups fold clients: the grouped forward and backward equal G
    separate calls on each group's rows, bitwise; at G = 1 a (1, Di, N) A
    gives bitwise the (Di, N) A's results."""
    inputs = _scan_inputs(4, 21, 12, 8, "float32", init=True, dh=True, groups=2, seed=2)
    x, dt, a, bm, cm, d, dy, h0, dhf = _torch_scan(inputs, "float32")
    y, h = ref.selective_scan(x, dt, a, bm, cm, d, init_state=h0, groups=2)
    grads = ref.selective_scan_bwd(x, dt, a, bm, cm, d, dy, init_state=h0, dh_final=dhf,
                                   groups=2)
    for g in range(2):
        rows = slice(2 * g, 2 * g + 2)
        yg, hg = ref.selective_scan(x[rows], dt[rows], a[g], bm[rows], cm[rows], d[g],
                                    init_state=h0[rows])
        assert torch.equal(y[rows], yg) and torch.equal(h[rows], hg)
        one = ref.selective_scan_bwd(x[rows], dt[rows], a[g], bm[rows], cm[rows], d[g],
                                     dy[rows], init_state=h0[rows], dh_final=dhf[rows])
        for name, full, part in zip(NAMES, grads, one):
            want = full[g] if name in ("dA", "dD") else full[rows]
            assert torch.equal(want, part), name
    y1, h1 = ref.selective_scan(x, dt, a[0], bm, cm, d[0], init_state=h0)
    y3, h3 = ref.selective_scan(x, dt, a[:1], bm, cm, d[:1], init_state=h0, groups=1)
    assert torch.equal(y1, y3) and torch.equal(h1, h3)
    with pytest.raises(ValueError, match="groups"):
        ref.selective_scan(x, dt, a, bm, cm, d, groups=3)


# ---------------- the kernel's model ----------------
# B, S, Di, N, x dtype, groups, initial state, final-state cotangent: every
# N bucket (5 -> 8, 16, 32 and 64: 2, 4, 8 and 16 threads a channel, 256,
# 128, 64 and 32 channels a block), Di past a whole block (130 at N_MAX 16:
# 128 channels and 2; 70 at N_MAX 32; 300 at N_MAX 8: 256 and 44; 45 at
# N_MAX 64: 32 and 13), S ragged and S = 1, G = 1, 2, 4
MODEL_CASES = [
    (2, 37, 130, 5, "float32", 1, True, True),
    (4, 20, 12, 16, "bfloat16", 2, False, True),
    (4, 17, 70, 32, "float32", 4, True, False),
    (2, 9, 40, 64, "float32", 2, False, True),
    (2, 1, 12, 16, "float32", 1, True, True),
    (2, 19, 300, 7, "bfloat16", 2, True, True),
    (2, 11, 45, 64, "float32", 1, True, True),
]


@pytest.mark.parametrize("case", MODEL_CASES, ids=[f"N={c[3]}, G={c[5]}, S={c[1]}, {c[4]}"
                                                   for c in MODEL_CASES])
def test_scan_backward_kernel_model_matches_the_plain_backward(case):
    """``tests/torch_kernel_models.py``'s model of the backward kernel: its
    checkpoints are the plain forward's states entering every 8th step
    (bitwise: the same steps), its segment recomputes are bitwise the
    forward's states, and its gradients -- fmaf where the kernel calls it,
    the channel ranges', the ranges' and the blocks' fixed orders --
    within relative L2 1e-6 of ``ref.selective_scan_bwd``, which sums in
    torch's orders (observed ~1e-7)."""
    b, s, di, n, dtype, groups, init, dh = case
    x, dt, a, bm, cm, d, dy, h0, dhf = _torch_scan(
        _scan_inputs(b, s, di, n, dtype, init=init, dh=dh, groups=groups, seed=5), dtype)
    grads, ckpt, same = scan_bwd_kernel_order(x, dt, a, bm, cm, d, dy, init_state=h0,
                                              dh_final=dhf, groups=groups)
    assert same and ckpt.shape == (b, -(-s // CHECKPOINT_EVERY), n, di)
    for k in range(ckpt.shape[1]):
        want = (h0 if h0 is not None else torch.zeros(b, di, n)) if k == 0 else ref.selective_scan(
            x[:, :8 * k], dt[:, :8 * k], a, bm[:, :8 * k], cm[:, :8 * k], d, init_state=h0,
            groups=groups)[1]
        assert torch.equal(ckpt[:, k], want.transpose(1, 2))
    plain = ref.selective_scan_bwd(x, dt, a, bm, cm, d, dy, init_state=h0, dh_final=dhf,
                                   groups=groups)
    for name, g, w in zip(NAMES, grads, plain):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            bound = 2.0 ** -8 if g.dtype == torch.bfloat16 else 1e-6
            assert _rel_l2(_f32(g), _f32(w)) <= bound, (name, _rel_l2(_f32(g), _f32(w)))


def test_kernel_constants_are_the_wrappers_and_the_models():
    """The segment, block and channel counts the wrapper sizes its buffers
    by, and the model walks by, are the CUDA source's: the forward's 128
    threads a block; the backward's 512, 4 states a thread, so N_MAX / 4
    threads a channel and 512 / (N_MAX / 4) channels a block."""
    source = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
              / "selective_scan.cu").read_text()
    assert "constexpr int kChunk = 8;" in source and "constexpr int kSeg = kChunk;" in source
    assert "constexpr int kThreads = 128;" in source
    assert "constexpr int kBwdThreads = 512;" in source and "constexpr int kPer = 4;" in source
    assert "static constexpr int kSub = NMAX / kPer;" in source
    assert "static constexpr int kChan = kBwdThreads / kSub;" in source
    assert "constexpr int kRange = 16;" in source
    assert CHECKPOINT_EVERY == SCAN_SEG == 8 and SCAN_RANGE == 16
    assert SCAN_THREADS == 512 and SCAN_PER == 4
    assert [bwd_channels(n) for n in (1, 8, 9, 16, 17, 32, 33, 64)] == (
        [256] * 2 + [128] * 2 + [64] * 2 + [32] * 2)


# ---------------- the differentiable pair ----------------
def _pair_loss(A, D, x, dt, bm, cm, w, wh):
    y, h = ops.selective_scan(x, dt, A, bm, cm, D)
    return (y.float() * w).sum() + (h * wh).sum()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared A, D", "per-client A, D"])
def test_scan_vmap_grad_is_a_loop_of_grad(shared, dtype):
    """The round engine's wiring: ``vmap`` over 3 clients of ``grad`` of a
    loss of y and the final state, A and D unmapped (a round's first step)
    or mapped (later steps), bitwise the loop of one client's ``grad``; the
    grads have the inputs' dtypes."""
    rng = np.random.default_rng(7)
    c, b, s, di, n = 3, 2, 19, 12, 5
    x = torch.from_numpy(0.5 * rng.normal(size=(c, b, s, di))).float().to(TDT[dtype])
    dt = torch.from_numpy(np.log1p(np.exp(rng.normal(size=(c, b, s, di))))).float()
    bm, cm = (torch.from_numpy(rng.normal(size=(c, b, s, n))).float() for _ in range(2))
    w = torch.from_numpy(rng.normal(size=(c, b, s, di))).float()
    wh = torch.from_numpy(rng.normal(size=(c, b, di, n))).float()
    a = -torch.exp(0.3 * torch.from_numpy(rng.normal(size=(di, n))).float())
    d = torch.from_numpy(rng.normal(size=(di,))).float()
    if not shared:
        a, d = torch.stack([a, 1.01 * a, 0.99 * a]), torch.stack([d, 1.1 * d, 0.9 * d])
    grad = torch.func.grad(_pair_loss, argnums=(0, 1, 2, 3, 4, 5))
    dim = None if shared else 0
    got = torch.func.vmap(grad, in_dims=(dim, dim, 0, 0, 0, 0, 0, 0))(a, d, x, dt, bm, cm, w, wh)
    for k in range(c):
        ak, dk = (a, d) if shared else (a[k], d[k])
        want = grad(ak, dk, x[k], dt[k], bm[k], cm[k], w[k], wh[k])
        for g, h, t in zip(got, want, (ak, dk, x[k], dt[k], bm[k], cm[k]), strict=True):
            assert g[k].dtype == h.dtype == t.dtype and torch.equal(g[k], h)


def test_scan_pair_without_autograd_saves_nothing_and_double_backward_raises():
    """Untraced (serving) the plain forward runs alone, bitwise the traced
    forward's y and state; a gradient of a gradient through the scan
    raises."""
    x, dt, a, bm, cm, d, dy, h0, _ = _torch_scan(
        _scan_inputs(2, 9, 8, 5, "float32", init=True, dh=False), "float32")
    with torch.inference_mode():
        y0, h_0 = ops.selective_scan(x, dt, a, bm, cm, d, init_state=h0)
    xr = x.clone().requires_grad_()
    y1, h1 = ops.selective_scan(xr, dt, a, bm, cm, d, init_state=h0)
    assert torch.equal(y0, y1.detach()) and torch.equal(h_0, h1.detach())
    (g,) = torch.autograd.grad((y1 * dy).sum(), xr, create_graph=True)
    with pytest.raises(RuntimeError, match="double backward"):
        g.sum().backward()


# ---------------- the mixer ----------------
@functools.cache
def _mixer(dtype="float32"):
    """One mamba mixer of reduced Jamba: JAX's params and the port's copy,
    an input and the output's weight."""
    jcfg, tcfg = (dataclasses.replace(c.reduced(), dtype=dtype, moe=None)
                  for c in (jget_config(ARCH), get_config(ARCH)))
    jp = jmamba.init_mamba(jax.random.key(3), jcfg, JDT[dtype])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 24, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), x, w


def _port_mixer_loss(cfg):
    def loss(params, x, w):
        return (tmamba.mamba_forward(cfg, params, x)[0].float() * w).sum()
    return loss


def test_mamba_forward_gradient_matches_jax():
    """The conv's shifted sum, softplus, the fp32 casts of B and C and
    -exp(A_log) differentiate: the gradient to the input and every leaf
    within 1e-4 of its max-abs of ``jax.grad`` of JAX's mixer."""
    jcfg, tcfg, jp, tp, x, w = _mixer()
    jloss = lambda p, x, w: (jmamba.mamba_forward(jcfg, p, x).astype(jnp.float32)  # noqa: E731
                             * w).sum()
    jl, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x),
                                                                jnp.asarray(w))
    tg, tl = torch.func.grad_and_value(_port_mixer_loss(tcfg), argnums=(0, 1))(
        tp, torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert sorted(tg[0]) == sorted(jg[0])
    _leaves_close([tg[1]] + [tg[0][k] for k in sorted(jg[0])],
                  [jg[1]] + [jg[0][k] for k in sorted(jg[0])], 1e-4)
    assert all(float(tg[0][k].abs().max()) > 0 for k in tg[0])


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-client"])
def test_mamba_vmap_grad_is_a_loop_of_grad(shared):
    """The mixer under ``vmap(grad)`` over 2 clients (the cohort folded into
    the scan's B and groups), bitwise a loop of ``grad``."""
    _, tcfg, _, tp, x, w = _mixer()
    xs = torch.from_numpy(x).reshape(2, 1, *x.shape[1:])
    ws = torch.from_numpy(w).reshape(2, 1, *w.shape[1:])
    params = tp if shared else tree_map(lambda t: torch.stack([t, 1.01 * t]), tp)
    grad = torch.func.grad(_port_mixer_loss(tcfg))
    got = torch.func.vmap(grad, in_dims=(None if shared else 0, 0, 0))(params, xs, ws)
    for k in range(2):
        pk = params if shared else tree_map(lambda t: t[k], params)
        want = grad(pk, xs[k], ws[k])
        for key in want:
            assert torch.equal(got[key][k], want[key]), key


# ---------------- loss_fn ----------------
def _batch(vocab, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    return batch


def test_jamba_plan_is_mamba_then_attention_with_experts():
    _, tm, _, tp = _models(ARCH)
    assert [(s.kind, s.moe) for s in tm.arch.layer_plan()] == [("mamba", False), ("attn", True)]
    assert tm.arch.moe.n_experts == 4 and "A_log" in tp["blocks"][0]["mixer"]


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "per-layer"])
def test_loss_fn_and_every_gradient_match_jax(scan, monkeypatch):
    models = _models(ARCH, scan=scan)
    routes = Routes(monkeypatch)
    _check_loss_and_grads(models, _batch(models[1].arch.vocab_size), routes, 1e-5, 1e-4)
    assert len(routes.port) == 1


def test_loss_fn_in_bf16_matches_jax(monkeypatch, capsys):
    models = _models(ARCH, dtype="bfloat16", scan=False)
    routes = Routes(monkeypatch)
    flips, _ = _check_loss_and_grads(models, _batch(models[1].arch.vocab_size, seed=4),
                                     routes, 1e-3, 4e-2, strict=False)
    with capsys.disabled():
        print(f"\n{ARCH} bf16: {flips} routings flipped")


def test_reference_sgd_step_gives_jaxs_params():
    """``tests/test_models_smoke.py::test_reduced_train_step``'s step for
    Jamba (its ``_batch``: B = 2, S = 32, no masked label), p - 0.01 g on
    both packages: the loss finite and positive, every new leaf finite and
    its change within 1e-4 of JAX's change's max-abs, plus one fp32 ulp of
    the param: the update rounds to the param's grid, where a change far
    below the param's ulp (A_log's, D's) lands on either of two neighbours
    for gradients that differ in their last bits."""
    jm, tm, jp, tp = _models(ARCH, scan=False)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, tm.arch.vocab_size, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, batch)
    tg, (tl, _) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(tl)) and float(tl) > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jnew = jax.tree.map(lambda x, g: x - 0.01 * g.astype(x.dtype), jp, jg)
    tnew = tree_map(lambda x, g: x - 0.01 * g.to(x.dtype), tp, tg)
    for t, j, p in zip(tree_leaves(tnew), jax.tree.leaves(jnew), tree_leaves(tp), strict=True):
        a, b, p = _f32(t), _f32(j), _f32(p)
        assert np.isfinite(a).all()
        assert (np.abs(a - b) <= 1e-4 * np.abs(b - p).max() + np.spacing(np.abs(p))).all()


# ---------------- the round engine ----------------
ROUND_CASES = [("parallel", "Int8Codec"), ("parallel", "lora"), ("sequential", "NullCodec")]


@pytest.mark.parametrize("mode,codec", ROUND_CASES, ids=["-".join(c) for c in ROUND_CASES])
def test_round_step_on_jamba_matches_jax(mode, codec, jax_basis):
    """Two rounds of ``make_round_step`` on reduced Jamba (fp32, 2 clients,
    2 local steps, client 1 cut to 1) against JAX's jitted engine from the
    same params and batches; JAX's second round starts from the port's
    state.  Parallel: the cohort's scans fold into one launch's B and
    groups, A and D shared at the first local step and per client after."""
    jm, tm, jp, tp = _models(ARCH)
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
                                       vocab_size=tm.arch.vocab_size, seed=(19, rnd))
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


# ---------------- the chip phase and the example ----------------
def test_chip_phase_20_parameter_counts_are_jaxs():
    """The counts ``chip_smoke.py``'s phase 20 holds Jamba's cuts to are
    the JAX package's, from its init shapes (nothing allocated): 1 layer
    without experts ([mamba]), 2 layers by ``reduced()``'s plan rule
    ([mamba, attn]) and phase 9's 8-layer period, each at full width."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    full = jget_config(ARCH)
    for change, want, kinds in chip_smoke.HYBRID_CUTS:
        cfg = dataclasses.replace(full, **change)
        assert cfg.d_model == full.d_model and cfg.ssm == full.ssm
        assert [s.kind for s in cfg.layer_plan()] == kinds
        shapes = jax.eval_shape(lambda k, cfg=cfg: jtfm.init_params(k, cfg), jax.random.key(0))
        assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == want, change


TINY = ["--rounds", "2", "--layers", "2", "--d-model", "64", "--seq", "16", "--batch", "1",
        "--clients", "2", "--local-steps", "2", "--device", "cpu"]


def test_llm_finetune_twin_trains_jamba(capsys):
    """The example at ``--arch jamba-1.5-large-398b --codec lora --rank 2``:
    the reduced hybrid ([mamba, attn], 4 experts) trains on the round
    engine; finite loss and params."""
    example = importlib.import_module("repro_torch.examples.federated_llm_finetune")
    params, loss = example.main(TINY + ["--arch", ARCH, "--codec", "lora", "--rank", "2"])
    assert np.isfinite(loss) and all(torch.isfinite(x).all() for x in tree_leaves(params))
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced" in out and "round  2  mean client CE loss" in out
