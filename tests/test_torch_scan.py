"""Port parity for the scanned multi-round trainer: ``Server.run_scanned``,
``make_multi_round_step``, ``cohort_dispatch_mask``, the policies'
``plan_arrays`` and the (R, C) schedule matrices, against the JAX
package's (the twins of ``tests/test_scan.py``), on the reduced head model
with the same mixed fleet, Deadline and churn trace.  On the CPU the
port runs the R rounds eagerly; the card's captured graph is held against
the per-round driver in ``tests/test_torch_cuda_kernels.py``.

Tolerances: the schedule matrices, the masks, ``round_wall_s``,
``participants``, ``dispatched`` and History's wall, energy, comm, steps,
participants and dropped are bitwise or equal (numpy draws and float32
verdicts on both sides).  ``train_loss`` and the final globals come from
local SGD whose matmuls sum in another order: ``atol=1e-6``, with the
rounding-edge allowance of ``tests/test_torch_rounds.py``: an Int8 code or
a TopK selection on its edge may differ between the packages, so at most
``MAX_FLIP_SHARE`` of the globals may be off by more, each by at most one
int8 step of the run's largest move (``max|g - g0| / 127``).  The port's
scanned run against its own per-round driver is bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

import repro.core as J
from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import sgd as jsgd
import repro_torch.core as T
from repro_torch.configs.base import get_config
from repro_torch.launch import ClientMesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_leaves

FLEET = ["tpu-v5e-chip", "jetson-tx2-gpu", "jetson-tx2-gpu", "pixel-2", "pixel-2", "pixel-3"]
C, R, STEPS, B = len(FLEET), 6, 2, 4
MAX_FLIP_SHARE = 1e-2
CASES = {  # name -> (codec class, codec kwargs, cohort size)
    "null": ("NullCodec", {}, None),
    "int8": ("Int8Codec", {}, None),
    "topk-cohort": ("TopKCodec", {"frac": 0.05}, 4),
    "mixed": ("MixedCodec", {}, None),  # the fleet's codecs from BandwidthCodecPolicy
}
SHAPE_KEYS = ("participation_mask", "dispatch_mask", "round_wall_s", "participants", "dispatched")


@functools.cache
def _models():
    jm = jbuild_model(jget_config("mobilenet-head-office31").reduced())
    jparams = jm.init(jax.random.key(0))
    tm = build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")
    return jm, jparams, tm


def _torch_params():
    return params_from_numpy(jax.tree.map(np.asarray, _models()[1]), "cpu")


def _batches(rounds=R, seed=0):
    jm = _models()[0]
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(rounds, C, STEPS, B, jm.cfg.feature_dim)).astype(np.float32),
        "y": rng.integers(0, jm.cfg.num_classes, (rounds, C, STEPS, B)).astype(np.int32),
    }


def _server(pkg, *, cohort_size=None, strategy=None, **kw):
    """The reference fixture (tests/test_scan.py:40-62) in package ``pkg``:
    tau between the fast chip's and the phones' round time, the mobiles
    churning at 0.3, step jitter 0.1."""
    profiles = [pkg.PROFILES[n] for n in FLEET]
    n = sum(x.size for x in jax.tree.leaves(_models()[1]))
    cm = pkg.CostModel(profiles=profiles, update_bytes=4 * n)
    tau = 1.25 * cm.client_round_cost(1, STEPS).t_total_s
    trace = pkg.AvailabilityTrace.from_profiles(profiles, seed=0, mobile_dropout=0.3,
                                                jitter_std=0.1)
    if pkg is T:
        kw["device"] = "cpu"
    srv = pkg.Server(strategy=strategy or pkg.FedAvg(), clients=[], cost_model=cm,
                     policy=pkg.Deadline(tau=tau), availability=trace,
                     cohort_size=cohort_size, **kw)
    srv.logger.quiet = True
    return srv


def _spec(pkg, name, mode="parallel"):
    codec, kw, _ = CASES[name]
    if codec == "MixedCodec":
        codec = pkg.MixedCodec.from_policy(pkg.BandwidthCodecPolicy(),
                                           [pkg.PROFILES[n] for n in FLEET])
    else:
        codec = getattr(pkg, codec)(**kw)
    return pkg.RoundSpec(max_steps=STEPS, execution_mode=mode, codec=codec)


@functools.cache
def _jax_run(name, frozen=False):
    jm, jparams, _ = _models()
    srv = _server(J, cohort_size=CASES[name][2])
    return srv.run_scanned(
        jparams, R, loss_fn=jm.loss_fn, opt=jsgd(0.1), spec=_spec(J, name),
        batches=jax.tree.map(jnp.asarray, _batches()),
        trainable_mask=jm.trainable_mask(jparams) if frozen else None,
    )


@functools.cache
def _torch_run(name, reference=False, frozen=False, mode="parallel", strategy="FedAvg"):
    _, _, tm = _models()
    params = _torch_params()
    srv = _server(T, cohort_size=CASES[name][2], strategy=getattr(T, strategy)())
    return srv.run_scanned(
        params, R, loss_fn=tm.loss_fn, opt=sgd(0.1), spec=_spec(T, name, mode),
        batches=_batches(), reference=reference,
        trainable_mask=tm.trainable_mask(params) if frozen else None,
    )


def _flat(tree, jax_side):
    leaves = jax.tree.leaves(tree) if jax_side else [x.numpy() for x in tree_leaves(tree)]
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


def _assert_tree_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _assert_history_costs_equal(ha, hb, *, loss_atol=None):
    assert len(ha.rounds) == len(hb.rounds)
    for ra, rb in zip(ha.rounds, hb.rounds):
        assert (ra.rnd, ra.wall_time_s, ra.energy_j, ra.comm_bytes, ra.steps,
                ra.participants, ra.dropped) == (rb.rnd, rb.wall_time_s, rb.energy_j,
                                                 rb.comm_bytes, rb.steps, rb.participants,
                                                 rb.dropped)
        if loss_atol is None:
            assert ra.train_loss == rb.train_loss  # bitwise, not approx
        else:
            assert abs(ra.train_loss - rb.train_loss) <= loss_atol


# ---------------- the whole run against JAX's run_scanned ----------------
@pytest.mark.parametrize("name,frozen", [("null", False), ("int8", False),
                                         ("topk-cohort", False), ("null", True)],
                         ids=["null", "int8", "topk-cohort", "null-frozen-base"])
def test_run_scanned_matches_jax(name, frozen):
    gj, hj, sj = _jax_run(name, frozen)
    gt, ht, st = _torch_run(name, frozen=frozen)
    assert set(sj) == set(st)
    for k in SHAPE_KEYS:
        assert st[k].shape == np.asarray(sj[k]).shape
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    np.testing.assert_array_equal(st["steps_total"], np.asarray(sj["steps_total"]))
    for k in ("client_loss_mean", "client_loss_max", "residual_norm_mean"):
        if k in st:
            np.testing.assert_allclose(st[k], np.asarray(sj[k]), rtol=0, atol=1e-6, err_msg=k)
    _assert_history_costs_equal(hj, ht, loss_atol=1e-6)
    fj, ft = _flat(gj, True), _flat(gt, False)
    d = np.abs(fj - ft)
    step = np.abs(ft - _flat(_models()[1], True)).max() / 127
    over = d > 1e-6
    assert over.mean() <= MAX_FLIP_SHARE and d.max() <= 1e-6 + step, (int(over.sum()), d.max())
    if name == "null":
        assert not over.any()  # nothing rounds on a wire: no edge to flip


# ---------------- the port's scanned run against its per-round driver ----------------
@pytest.mark.parametrize("name,mode,strategy", [
    ("null", "parallel", "FedAvg"), ("int8", "parallel", "FedAvg"),
    ("topk-cohort", "parallel", "FedAvg"), ("int8", "sequential", "FedAvg"),
    ("null", "parallel", "FedAdam"),
], ids=["null", "int8", "topk-cohort", "sequential-int8", "fedadam-null"])
def test_scanned_matches_reference_driver_bitwise(name, mode, strategy):
    g_s, h_s, st_s = _torch_run(name, mode=mode, strategy=strategy)
    g_p, h_p, st_p = _torch_run(name, reference=True, mode=mode, strategy=strategy)
    _assert_tree_bitwise(g_s, g_p)
    assert set(st_s) == set(st_p)
    for k in st_s:
        assert st_s[k].dtype == st_p[k].dtype, k
        np.testing.assert_array_equal(st_s[k], st_p[k], err_msg=k)
    _assert_history_costs_equal(h_s, h_p)


def test_deadline_mask_is_nontrivial():
    """Churn and the deadline drop SOME clients in SOME rounds and keep
    others, so the parity above exercises the mask."""
    _, hist, stacked = _torch_run("null")
    assert sum(r.dropped for r in hist.rounds) > 0
    assert sum(r.participants for r in hist.rounds) > 0
    mask, disp = stacked["participation_mask"], stacked["dispatch_mask"]
    assert mask.shape == disp.shape == (R, C)
    assert np.any(mask < disp)  # a dispatched straggler missed tau


def test_cohort_mask_counts_and_availability():
    _, _, stacked = _torch_run("topk-cohort")
    disp = stacked["dispatch_mask"]
    assert np.all(disp.sum(axis=1) <= 4)
    assert np.any(disp.sum(axis=1) == 4)  # some full cohorts exist
    assert np.all((stacked["participation_mask"] > 0) <= (disp > 0))


def test_reused_batches_parity_with_stacked():
    """stacked_batches=False (one batch every round) equals a stack of R
    copies of it."""
    _, _, tm = _models()
    one = {k: v[0] for k, v in _batches(rounds=4).items()}
    tiled = {k: np.broadcast_to(v[None], (4,) + v.shape).copy() for k, v in one.items()}
    outs = []
    for b, flag in ((tiled, True), (one, False)):
        srv = _server(T)
        outs.append(srv.run_scanned(_torch_params(), 4, loss_fn=tm.loss_fn, opt=sgd(0.1),
                                    spec=_spec(T, "null"), batches=b, stacked_batches=flag))
    (g_a, h_a, _), (g_b, h_b, _) = outs
    _assert_tree_bitwise(g_a, g_b)
    _assert_history_costs_equal(h_a, h_b)


def test_caller_params_stay_valid_and_second_call_reproduces():
    """The caller's tensors are never written, a second call from the
    same params reproduces the first bitwise, and it reuses the built
    program (one memo entry)."""
    _, _, tm = _models()
    srv = _server(T)
    params = _torch_params()
    before = [x.clone() for x in tree_leaves(params)]
    kw = dict(loss_fn=tm.loss_fn, opt=sgd(0.1), spec=_spec(T, "int8"), batches=_batches(3))
    g1, h1, _ = srv.run_scanned(params, 3, **kw)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
    g2, h2, _ = srv.run_scanned(params, 3, **kw)
    _assert_tree_bitwise(g1, g2)
    _assert_history_costs_equal(h1, h2)
    assert len(srv._scan_fns) == 1


# ---------------- the schedule matrices ----------------
def test_schedule_matrices_match_jax_and_per_round_draws():
    rounds = range(1, 9)
    trace = {}
    for pkg in (J, T):
        trace[pkg] = pkg.AvailabilityTrace.from_profiles(
            [pkg.PROFILES[n] for n in FLEET], seed=3, mobile_dropout=0.4, jitter_std=0.2)
    for method in ("available_matrix", "step_jitter_matrix", "cohort_priority_matrix"):
        got, want = getattr(trace[T], method)(rounds), getattr(trace[J], method)(rounds)
        assert got.dtype == want.dtype and got.shape == (8, C)
        np.testing.assert_array_equal(got, want, err_msg=method)
    am, jm = trace[T].available_matrix(rounds), trace[T].step_jitter_matrix(rounds)
    for i, r in enumerate(rounds):
        np.testing.assert_array_equal(am[i], trace[T].available(r))
        np.testing.assert_array_equal(jm[i], trace[T].step_jitter(r))
    pm = trace[T].cohort_priority_matrix(rounds)
    assert np.all((pm >= 0.0) & (pm < 1.0)) and not np.array_equal(pm[0], pm[1])


@pytest.mark.parametrize("codec", [None, "Int8Codec", "TopKCodec"])
def test_fleet_time_matrix_matches_jax_and_client_round_cost(codec):
    n_params = 262_144
    cms, ups = {}, {}
    for pkg in (J, T):
        cms[pkg] = pkg.CostModel(profiles=[pkg.PROFILES[n] for n in FLEET],
                                 update_bytes=1 << 20)
        ups[pkg] = pkg.CostModel.fleet_uplink_bytes(
            None if codec is None else getattr(pkg, codec)(), n_params, C)
    assert ups[T] == ups[J]
    budgets = np.asarray([5, 4, 5, 3, 5, 2], np.int64)
    jitter = np.linspace(0.8, 1.2, 8 * C).reshape(8, C)
    cols = cms[T].fleet_columns(C, uplink_bytes=ups[T])
    want = cms[J].fleet_columns(C, uplink_bytes=ups[J])
    assert set(cols) == set(want)
    for k in cols:
        np.testing.assert_array_equal(cols[k], want[k], err_msg=k)
    tm = cms[T].fleet_time_matrix(budgets, jitter, uplink_bytes=ups[T])
    np.testing.assert_array_equal(tm, cms[J].fleet_time_matrix(budgets, jitter,
                                                                uplink_bytes=ups[J]))
    for r in (0, 7):
        for cid in range(C):
            up = None if ups[T] is None else ups[T][cid]
            ref = cms[T].client_round_cost(cid, int(budgets[cid]), uplink_bytes=up,
                                           jitter=float(jitter[r, cid]))
            assert tm[r, cid] == ref.t_total_s, (r, cid)


# ---------------- the on-device cohort and the policies' verdicts ----------------
def test_cohort_dispatch_mask_unit():
    pri = torch.tensor([0.3, 0.1, 0.9, 0.2, 0.5])
    avail = torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0])
    m = T.cohort_dispatch_mask(pri, avail, 2)
    # the two lowest priorities among AVAILABLE clients: ids 1 (0.1), 0 (0.3)
    assert m.tolist() == [1.0, 1.0, 0.0, 0.0, 0.0] and m.dtype == torch.float32
    # a cohort larger than the available fleet: everyone up, nobody else
    assert T.cohort_dispatch_mask(pri, avail, 5).tolist() == [1.0, 1.0, 1.0, 0.0, 1.0]
    # nobody up: nobody dispatched
    assert T.cohort_dispatch_mask(pri, torch.zeros(5), 3).tolist() == [0.0] * 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cohort_dispatch_mask_matches_jax(seed):
    """Random priorities with ties (a coarse grid), random availability,
    every cohort size from 0 to past the fleet: bitwise JAX's mask."""
    rng = np.random.default_rng(seed)
    n = 17
    pri = (rng.integers(0, 6, n) / 8).astype(np.float32)
    avail = (rng.random(n) < 0.7).astype(np.float32)
    for k in range(n + 3):
        got = T.cohort_dispatch_mask(torch.from_numpy(pri), torch.from_numpy(avail), k)
        want = np.asarray(J.cohort_dispatch_mask(jnp.asarray(pri), jnp.asarray(avail), k))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"cohort {k}")
        assert got.sum() == min(k, avail.sum())


def test_plan_arrays_matches_deadline_semantics():
    t = torch.tensor([1.0, 30.0, 5.0, 2.0])
    disp = torch.tensor([1.0, 1.0, 1.0, 0.0])
    mask, end = T.Deadline(tau=10.0).plan_arrays(disp, t, tau=10.0)
    assert mask.tolist() == [1.0, 0.0, 1.0, 0.0] and float(end) == 10.0
    mask2, end2 = T.Deadline(tau=10.0).plan_arrays(disp, torch.tensor([1.0, 6.0, 5.0, 2.0]),
                                                   tau=10.0)
    assert mask2.tolist() == [1.0, 1.0, 1.0, 0.0] and float(end2) == 6.0
    mask3, end3 = T.Deadline().plan_arrays(disp, t, tau=float("inf"))
    assert torch.equal(mask3, disp) and float(end3) == 30.0
    sm, se = T.SyncAll().plan_arrays(disp, t)
    assert torch.equal(sm, disp) and float(se) == 30.0
    assert end.dtype == se.dtype == torch.float32 and end.dim() == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_arrays_matches_jax_and_plan(seed):
    """Random dispatch sets and float32 finish times, tau inside them,
    on a float32 rounding edge (tau a double just below a finish time,
    which rounds up to it: the client reports) and infinite: masks and
    round ends bitwise JAX's, and the reporters and wall time of the
    event-driven ``plan`` at tau rounded to float32."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.1, 3.0, C).astype(np.float32)
    disp = (rng.random(C) < 0.8).astype(np.float32)
    disp[0] = 1.0
    edge = float(np.nextafter(np.float64(t[0]), -np.inf))  # rounds up to t[0] in float32
    for tau in (float(np.median(t)), edge, float("inf")):
        for policy in ("SyncAll", "Deadline"):
            kw = {} if policy == "SyncAll" else {"tau": tau}
            mask, end = getattr(T, policy)().plan_arrays(torch.from_numpy(disp),
                                                         torch.from_numpy(t), **kw)
            jmask, jend = getattr(J, policy)().plan_arrays(jnp.asarray(disp), jnp.asarray(t),
                                                           **kw)
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
            assert end.numpy().tobytes() == np.asarray(jend).tobytes()
            pol = getattr(T, policy)(**kw)
            pending = [T.Arrival(client_id=c, launch_rnd=1, launch_t=0.0,
                                 finish_t=float(np.float32(t[c])), cost=None)
                       for c in range(C) if disp[c] > 0]
            tau32 = float(np.float32(tau))  # the verdict's precision
            out = pol.plan(T.VirtualClock(), pending, 1) if policy == "SyncAll" else \
                T.Deadline(tau=tau32).plan(T.VirtualClock(), pending, 1)
            assert sorted(a.client_id for a in out.reported) == np.flatnonzero(
                mask.numpy() > 0).tolist()
            assert np.float32(out.wall_time_s) == end.numpy()


# ---------------- rejections and routing ----------------
def test_buffered_async_is_rejected_at_build_time():
    _, _, tm = _models()
    assert not T.BufferedAsync().traceable
    assert T.SyncAll().traceable and T.Deadline().traceable
    with pytest.raises(NotImplementedError, match="BufferedAsync"):
        T.make_multi_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(),
                                T.RoundSpec(max_steps=2, execution_mode="parallel"), 4,
                                policy=T.BufferedAsync())
    with pytest.raises(NotImplementedError):
        T.BufferedAsync().plan_arrays(torch.ones(2), torch.ones(2))


def test_run_scanned_rejects_population_mode():
    _, _, tm = _models()
    srv = T.Server(strategy=T.FedAvg(), clients=[], population=object(), cohort_size=2,
                   device="cpu")
    with pytest.raises(NotImplementedError, match="population"):
        srv.run_scanned(_torch_params(), 2, loss_fn=tm.loss_fn, opt=sgd(0.1),
                        spec=T.RoundSpec(max_steps=1, execution_mode="parallel"),
                        batches={"x": np.zeros((2, 2, 1, 1), np.float32)})


def test_multi_round_step_routes_by_device_and_rejects_unported_paths():
    _, _, tm = _models()
    spec = T.RoundSpec(max_steps=1, execution_mode="parallel")
    build = functools.partial(T.make_multi_round_step, tm.loss_fn, sgd(0.1), T.FedAvg())
    multi = build(spec, 2)
    assert isinstance(multi, T.MultiRoundStep)
    meta = {k: {kk: torch.empty(v.shape, device="meta") for kk, v in d.items()}
            for k, d in _torch_params().items()}
    z = torch.zeros((2, C), device="meta")
    with pytest.raises(ValueError, match="meta"):
        multi(meta, (), (), {}, torch.ones(C, device="meta"),
              torch.ones(C, dtype=torch.int32, device="meta"), z, z, z)
    flat = ClientMesh(axes=(("data", 2),), rank=0, groups={"data": None})
    with pytest.raises(NotImplementedError, match="item 13"):
        build(spec, 2, mesh=flat)
    with pytest.raises(NotImplementedError, match="item 13"):
        build(spec, 2, param_shardings={})
    # a MixedCodec builds, and its scanned run is the per-round driver's
    # bitwise and JAX's: masks and costs equal, the globals within the
    # rounding-edge allowance, the losses within 1e-5 (an Int8 code or TopK
    # selection that flips in one round moves the next rounds' losses)
    assert isinstance(build(_spec(T, "mixed"), 2), T.MultiRoundStep)
    test_scanned_matches_reference_driver_bitwise("mixed", "parallel", "FedAvg")
    gj, hj, sj = _jax_run("mixed")
    gt, ht, st = _torch_run("mixed")
    for k in SHAPE_KEYS + ("steps_total",):
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    _assert_history_costs_equal(hj, ht, loss_atol=1e-5)
    fj, ft = _flat(gj, True), _flat(gt, False)
    d = np.abs(fj - ft)
    step = np.abs(ft - _flat(_models()[1], True)).max() / 127
    assert (d > 1e-6).mean() <= MAX_FLIP_SHARE and d.max() <= 1e-6 + step
    assert multi.captures == 0  # the CPU never captures
