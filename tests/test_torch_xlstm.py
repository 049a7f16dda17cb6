"""The port's xLSTM mixers (``repro_torch.models.layers.xlstm``: mLSTM and
sLSTM) and the ``xlstm-1.3b`` serving path against the JAX package on the
CPU: the same JAX-drawn weights carried across by ``params_from_numpy``,
the same numpy inputs.  The head-wise norm scales (``o_norm``) and the
gate biases are drawn away from JAX's init (zeros, and the fixed forget
biases), so a port that dropped either would show.

Tolerances, stated with their reasons.  Both packages round at the same
steps; their fp32 sums (the gate and q . k products, the cumulative log
forget gate, P . V, the recurrent products) run in other orders.
- A whole model's logits and caches within ``MODEL_TOL`` of their scale
  (fp32 1e-5, bf16 2e-2), as ``tests/test_torch_mla.py``'s.
- A mixer's outputs and fp32 states within ``MIXER_TOL`` of their scale
  (fp32 1e-5, bf16 2**-7), not ``tests/test_torch_mla.py``'s elementwise
  1e-6 / one ulp: an mLSTM output is a quotient of cancelling sums
  (scores of both signs over max(|sum scores|, exp(-m))), an sLSTM output
  has passed a recurrence, and a state is a sum of exponentially weighted
  terms, so a reordered fp32 sum moves each relative to the terms it is
  made of, not to itself (2e-6 of the scale on these inputs; up to 1.7e-6
  absolute on outputs near zero); in bf16 one flipped rounding of one of
  the down projection's 256 inputs moves an output by 2**-8 of a term
  (1.9e-3 of the scale at one decode step here).
- The quadratic form alone within 1e-5 of the float64 terms each output
  sums (``_quadratic_terms``), plus one bf16 ulp of the output in bf16.
- The bf16 stacked model is held to JAX's per-layer run of the same
  stacked weights: JAX's scanned stack compiles each period as one
  ``lax.scan`` body, where XLA fuses the bf16 elementwise chains and drops
  roundings that its per-layer run makes; on these inputs the two JAX runs
  differ by 2.5e-2 of an sLSTM state's scale, and the port, which rounds
  where the per-layer run rounds, is within 7e-3 of it.  fp32 is held to
  the scanned run itself.
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
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtfm
from repro.models.layers import xlstm as jxlstm
from repro_torch.configs.base import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import xlstm as txlstm
from repro_torch.utils.pytree import tree_leaves

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MIXER_TOL = {"float32": 1e-5, "bfloat16": 2**-7}
QUADRATIC_TOL = 1e-5
ARCH = "xlstm-1.3b"
XLSTM_PARAMS = 3_579_976_016


def _configs(dtype: str = "float32", **kw):
    """xlstm-1.3b reduced (d_model 128, 4 heads: the mLSTM at 4 x 64, the
    sLSTM at 4 x 32), in both packages."""
    return (dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype, **kw),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype, **kw))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _both(arr: np.ndarray, dtype: str):
    j = jnp.asarray(arr, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _scaled_close(port, want, tol, what):
    a, b = _f32(port), _f32(want)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _perturb(jp: dict, rng) -> dict:
    """The norm scales away from zero and the gate biases away from JAX's
    init, in place (fp32, as JAX keeps them)."""
    for k in ("o_norm", "b_gates", "b"):
        if k in jp:
            jp[k] = jnp.asarray(np.asarray(jp[k]) + rng.normal(size=jp[k].shape) * 0.5,
                                jnp.float32)
    return jp


def _mixer(kind: str, dtype: str, seed: int = 0):
    jcfg, tcfg = _configs(dtype)
    init = jxlstm.init_mlstm if kind == "mlstm" else jxlstm.init_slstm
    jp = _perturb(init(jax.random.key(seed), jcfg, JDT[dtype]), np.random.default_rng(seed))
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


# ---------------- configs and params ----------------
def test_config_matches_jax():
    """Field for field, full and reduced, with the same plan and period:
    at full width sLSTM at 0, 8, ..., 40, the rest mLSTM, period 8."""
    j, t = jget_config(ARCH), get_config(ARCH)
    for a, b in ((t, j), (t.reduced(), j.reduced())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.plan_period == b.plan_period
        assert [dataclasses.asdict(x) for x in a.layer_plan()] == [
            dataclasses.asdict(x) for x in b.layer_plan()]
    kinds = [s.kind for s in t.layer_plan()]
    assert t.scan_layers and t.plan_period == 8 and kinds.count("slstm") == 6
    assert kinds[:8] == ["slstm"] + ["mlstm"] * 7


def test_chip_leg_has_the_jax_parameter_count():
    """The count ``chip_smoke.py``'s phase 16 holds the full-width card
    model to is JAX's, from its init shapes."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    shapes = jax.eval_shape(lambda k: jtfm.init_params(k, jget_config(ARCH)), jax.random.key(0))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert n == chip_smoke.XLSTM_PARAMS == XLSTM_PARAMS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_has_jax_leaves_per_layer_and_stacked(dtype):
    """JAX's keys, shapes and dtypes for both mixers and their caches, one
    layer and the stacked leaves of JAX's scanned init (n_layers 4, an
    sLSTM every 2); o_norm zeros, the fixed gate biases and the -1e30
    initial m equal."""
    jcfg, tcfg = _configs(dtype, n_layers=4, xlstm_slstm_every=2, scan_layers=True)
    stacked = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg), jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    for pos, kind in enumerate(("slstm", "mlstm")):
        jinit = getattr(jxlstm, f"init_{kind}")
        tinit = getattr(txlstm, f"init_{kind}")
        one = jinit(jax.random.key(0), jcfg, JDT[dtype])
        for lead, want in (((), one), ((2,), stacked["blocks"][pos]["mixer"])):
            got = tinit(gen, tcfg, TDT[dtype], lead=lead)
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape), k
                assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k
        got = tinit(gen, tcfg, TDT[dtype])
        assert not got["o_norm"].any()
        bias = "b_gates" if kind == "mlstm" else "b"
        np.testing.assert_allclose(_f32(got[bias]), _f32(one[bias]), rtol=1e-6)
        jc = getattr(jxlstm, f"init_{kind}_cache")(jcfg, 3)
        tc = getattr(txlstm, f"init_{kind}_cache")(tcfg, 3)
        assert sorted(tc) == sorted(jc)
        for k in jc:
            assert tc[k].dtype == torch.float32 and tuple(tc[k].shape) == jc[k].shape, k
            np.testing.assert_array_equal(_f32(tc[k]), _f32(jc[k]))


# ---------------- the mLSTM ----------------
def _qkv_gates(dtype, s, seed=1):
    rng = np.random.default_rng(seed)
    b, h, d = 2, 4, 64
    q, k, v = (_both(rng.normal(size=(b, s, h, d)), dtype) for _ in range(3))
    ig = rng.normal(size=(b, s, h)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-(rng.normal(size=(b, s, h)) + 3)))).astype(np.float32)
    return q, k, v, (jnp.asarray(ig), torch.from_numpy(ig)), (jnp.asarray(lf),
                                                              torch.from_numpy(lf))


def _quadratic_terms(q, k, v, ig, lf) -> np.ndarray:
    """The size of the terms each output of the quadratic form is summed
    from, in float64: (sum_j |s_ij| |v_jd| + |out_id| sum_j |s_ij|) / den_i.
    Random q and k give scores of both signs, so both sums (P . V and the
    denominator) cancel; an fp32 error is relative to these terms, not to
    the cancelled value."""
    q, k, v, ig, lf = (np.asarray(_f32(a), np.float64) for a in (q, k, v, ig, lf))
    s, d = q.shape[1], q.shape[-1]
    fc = np.cumsum(lf, axis=1)
    log_d = fc[:, :, None] - fc[:, None] + ig[:, None]              # (B,L,S,H)
    log_d = np.where(np.tril(np.ones((s, s), bool))[None, :, :, None], log_d, -np.inf)
    m = log_d.max(axis=2, keepdims=True)
    scores = np.einsum("blhd,bshd->blsh", q * d ** -0.5, k) * np.exp(log_d - m)
    den = np.maximum(np.abs(scores.sum(2)), np.exp(-m[:, :, 0]))[..., None]
    out = np.einsum("blsh,bshd->blhd", scores, v) / den
    return (np.einsum("blsh,bshd->blhd", np.abs(scores), np.abs(v))
            + np.abs(out) * np.abs(scores).sum(2)[..., None]) / den


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 512], ids=["one-chunk", "two-chunks"])
def test_mlstm_parallel_matches_jax(dtype, s):
    """The chunked quadratic form at one chunk (S = 64) and at two of 256
    (S = 512): within 1e-5 of the terms each output sums (the cumulative
    log forget gate, ~25 at S = 512, is summed in another order by XLA's
    windowed cumsum: 6e-6 from the float64 sum against the port's 2e-6,
    and every term's weight exp(F_i - F_j + ig_j) moves with it), plus,
    in bf16, one ulp of the output."""
    args = _qkv_gates(dtype, s)
    want = jxlstm.mlstm_parallel(*(a[0] for a in args))
    got = txlstm.mlstm_parallel(*(a[1] for a in args))
    assert got.dtype == TDT[dtype]
    bound = QUADRATIC_TOL * _quadratic_terms(*(a[0] for a in args))
    if dtype == "bfloat16":
        bound = bound + 2**-7 * np.abs(_f32(want))
    assert np.all(np.abs(_f32(got) - _f32(want)) <= bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_prefill_and_state_match_jax(dtype):
    """``mlstm_forward``'s output against JAX's, and its (C, n, m) against
    ``xlstm_lib_prefill_mlstm``'s, at S = 40."""
    jcfg, tcfg, jp, tp = _mixer("mlstm", dtype)
    jx, tx = _both(np.random.default_rng(2).normal(size=(2, 40, 128)), dtype)
    want_out, want_state = jtfm.xlstm_lib_prefill_mlstm(jcfg, jp, jx)
    np.testing.assert_allclose(_f32(jxlstm.mlstm_forward(jcfg, jp, jx)), _f32(want_out))
    got_out, got_state = txlstm.mlstm_forward(tcfg, tp, tx)
    assert got_out.dtype == TDT[dtype]
    _scaled_close(got_out, want_out, MIXER_TOL[dtype], "output")
    assert sorted(got_state) == ["C", "m", "n"]
    for k in ("C", "n", "m"):
        assert got_state[k].dtype == torch.float32
        _scaled_close(got_state[k], want_state[k], MIXER_TOL["float32"], f"state {k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_matches_jax(dtype):
    """Three recurrent steps from JAX's prefill state: each output, and
    the cache the port writes in place against the one JAX returns."""
    jcfg, tcfg, jp, tp = _mixer("mlstm", dtype)
    rng = np.random.default_rng(3)
    jx, tx = _both(rng.normal(size=(2, 12, 128)), dtype)
    _, jcache = jtfm.xlstm_lib_prefill_mlstm(jcfg, jp, jx)
    tcache = {k: torch.from_numpy(_f32(v)) for k, v in jcache.items()}
    held = {k: v for k, v in tcache.items()}
    for i in range(3):
        jt, tt = _both(rng.normal(size=(2, 1, 128)), dtype)
        want, jcache = jxlstm.mlstm_decode(jcfg, jp, jt, jcache)
        got, tcache = txlstm.mlstm_decode(tcfg, tp, tt, tcache)
        _scaled_close(got, want, MIXER_TOL[dtype], f"step {i}")
        for k in ("C", "n", "m"):
            assert tcache[k] is held[k]   # written in place
            _scaled_close(tcache[k], jcache[k], MIXER_TOL["float32"], f"step {i} {k}")


# ---------------- the sLSTM ----------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_and_decode_match_jax(dtype):
    """The recurrence over 24 positions from a fresh state, then 3 decode
    steps from its carry, which decode writes in place."""
    jcfg, tcfg, jp, tp = _mixer("slstm", dtype)
    rng = np.random.default_rng(4)
    jx, tx = _both(rng.normal(size=(2, 24, 128)), dtype)
    want, jcarry = jxlstm.slstm_forward(jcfg, jp, jx)
    got, tcarry = txlstm.slstm_forward(tcfg, tp, tx)
    _scaled_close(got, want, MIXER_TOL[dtype], "output")
    for k in ("c", "n", "h", "m"):
        assert tcarry[k].dtype == torch.float32
        _scaled_close(tcarry[k], jcarry[k], MIXER_TOL["float32"], f"carry {k}")
    held = dict(tcarry)
    for i in range(3):
        jt, tt = _both(rng.normal(size=(2, 1, 128)), dtype)
        want, jcarry = jxlstm.slstm_decode(jcfg, jp, jt, jcarry)
        got, tcarry = txlstm.slstm_decode(tcfg, tp, tt, tcarry)
        _scaled_close(got, want, MIXER_TOL[dtype], f"step {i}")
        for k in ("c", "n", "h", "m"):
            assert tcarry[k] is held[k]
            _scaled_close(tcarry[k], jcarry[k], MIXER_TOL["float32"], f"step {i} {k}")


# ---------------- the model ----------------
def _models(dtype, seed=0, arch=ARCH, **kw):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype, **kw)
    jm, tm = jbuild_model(jcfg), build_model(tcfg, device="cpu")
    jp = jm.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    jp["blocks"] = tuple({**b, "mixer": _perturb(dict(b["mixer"]), rng)} for b in jp["blocks"])
    return jm, tm, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _per_layer(jm, jp):
    """JAX's model and params of a stacked config as its per-layer twin:
    the same weights, layer i the view i // period of position i % period."""
    cfg, period = jm.cfg, jm.cfg.plan_period
    blocks = tuple(jax.tree.map(lambda x, j=i // period: x[j], jp["blocks"][i % period])
                   for i in range(cfg.n_layers))
    return jbuild_model(dataclasses.replace(cfg, scan_layers=False)), {**jp, "blocks": blocks}


def _layer_leaves(cfg, layers, stacked: bool):
    """A cache's leaves in layer order: per layer from the stacked views."""
    if not stacked:
        return tree_leaves(layers)
    period = cfg.plan_period
    return tree_leaves(tuple({k: v[i // period] for k, v in layers[i % period].items()}
                             for i in range(cfg.n_layers)))


def _prefill_and_decode(jm, tm, jp, tp, dtype, b=2, s=24, ctx=64, steps=3):
    """Prefill and ``steps`` decode steps on both, both fed JAX's greedy
    tokens: logits and every cache leaf within the model tolerance (a
    stacked port held to a per-layer JAX run layer by layer)."""
    unstack = tm.arch.scan_layers and not jm.cfg.scan_layers
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jm.cfg.vocab_size, (b, s)).astype(np.int32)
    tol = MODEL_TOL[dtype]
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, ctx)
    with torch.inference_mode():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, ctx)
    assert int(tc["pos"]) == int(jc["pos"]) == s
    for i in range(steps + 1):
        _scaled_close(tl, jl, tol, f"logits {i}")
        for n, (a, w) in enumerate(zip(_layer_leaves(tm.arch, tc["layers"], unstack),
                                       jax.tree.leaves(jc["layers"]), strict=True)):
            _scaled_close(a, w, tol, f"cache leaf {n} after {i}")
        if i == steps:
            break
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jc, ctx)
        with torch.inference_mode():
            tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)}, tc, ctx)
    assert int(tc["pos"]) == s + steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(), dict(n_layers=4, xlstm_slstm_every=2,
                                             scan_layers=True)], ids=["2-layers", "4-stacked"])
def test_prefill_and_decode_match_jax(dtype, kw):
    """The reduced model (sLSTM, mLSTM; and stacked [sLSTM, mLSTM] x 2,
    views of the stacked leaves and caches) through prefill and 3 decode
    steps; in bf16 the stacked port against JAX's per-layer run."""
    jm, tm, jp, tp = _models(dtype, **kw)
    if tm.arch.scan_layers and dtype == "bfloat16":
        jm, jp = _per_layer(jm, jp)
    _prefill_and_decode(jm, tm, jp, tp, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_hybrid_matches_jax(dtype):
    """Jamba reduced without its experts, its mamba layers mLSTM (plan
    [mlstm, attn]): the attention + mLSTM hybrid builds and matches JAX
    (its attention on both sides' plain versions, as a 24-token prompt
    gives them)."""
    jm, tm, jp, tp = _models(dtype, arch="jamba-1.5-large-398b", moe=None, alt_kind="mlstm")
    assert [s.kind for s in tm.arch.layer_plan()] == ["mlstm", "attn"]
    _prefill_and_decode(jm, tm, jp, tp, dtype)


def test_decode_matches_prefill_logits():
    """The twin of ``tests/test_models_smoke.py``'s
    ``test_decode_matches_prefill_logits[xlstm-1.3b]``: prefill(t[:s]) then
    decode(t[s]) against prefill(t[:s+1]), bf16, the port's own init."""
    cfg = get_config(ARCH).reduced()
    m = build_model(cfg, device="cpu")
    params = m.init(1)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 17)).astype(np.int32))
    with torch.inference_mode():
        full, _ = m.prefill(params, {"tokens": toks}, 64)
        _, cache = m.prefill(params, {"tokens": toks[:, :-1]}, 64)
        step, _ = m.decode_step(params, {"tokens": toks[:, -1:]}, cache, 64)
    np.testing.assert_allclose(_f32(full[:, -1]), _f32(step[:, -1]), atol=0.15, rtol=0.15)


# ---------------- building and serving ----------------
def test_xlstm_builds_with_jax_leaves_on_the_cpu_and_needs_the_card_by_default():
    """The port's own xlstm-1.3b, reduced: JAX's tree of params, shapes
    and dtypes, on the CPU when asked; without a device it needs the card."""
    m = build_model(get_config(ARCH).reduced(), device="cpu")
    p = m.init(0)
    want = jax.eval_shape(lambda k: jtfm.init_params(k, jget_config(ARCH).reduced()),
                          jax.random.key(0))
    assert jax.tree.structure(jax.tree.map(lambda t: 0, p)) == jax.tree.structure(
        jax.tree.map(lambda t: 0, want))
    for t, w in zip(tree_leaves(p), jax.tree.leaves(want), strict=True):
        assert tuple(t.shape) == w.shape and str(t.dtype).removeprefix("torch.") == str(w.dtype)
        assert t.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(ARCH)


def test_ssm_family_builds_and_a_mamba_plan_needs_its_config():
    """Every transformer family builds: a pure-mamba ``ssm`` config with
    its ``SSMConfig`` prefills and decodes; without one it is refused with
    what is missing; an unknown family raises naming it."""
    from repro_torch.configs.base import SSMConfig

    base = get_config("qwen3-0.6b").reduced()
    m = build_model(dataclasses.replace(base, family="ssm", ssm=SSMConfig(d_state=8)),
                    device="cpu")
    assert {s.kind for s in m.arch.layer_plan()} == {"mamba"}
    p = m.init(0)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    with torch.inference_mode():
        logits, cache = m.prefill(p, {"tokens": toks}, 8)
        logits, cache = m.decode_step(p, {"tokens": toks[:, :1]}, cache, 8)
    assert bool(torch.isfinite(logits).all()) and int(cache["pos"]) == 5
    with pytest.raises(ValueError, match="needs cfg.ssm"):
        build_model(dataclasses.replace(base, family="ssm"), device="cpu")
    with pytest.raises(ValueError, match="unknown model family 'rnn'"):
        build_model(dataclasses.replace(base, family="rnn"), device="cpu")
    with pytest.raises(ValueError, match="unknown layer kind 'gru'"):
        tfm.check_ported(dataclasses.replace(base, family="ssm", alt_kind="gru"))


def test_serve_main_runs_xlstm_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "1", "--prompt-len", "8",
                "--tokens", "4", "--context", "32"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-reduced generated (1, 4) tokens" in out and "on cpu" in out


def test_serve_decode_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import serve_decode

    serve_decode.main(["--arch", ARCH, "--device", "cpu", "--batch", "1", "--prompt-len",
                       "8", "--tokens", "3", "--context", "16"])
    assert f"arch={ARCH}-reduced generated (1, 3) tokens" in capsys.readouterr().out
