"""Port parity for population mode (``core/population.py``, the streamed
availability paths, ``sample_cohort`` / ``CostAwareSampling`` and the
population branches of ``Server.run``) against the JAX package.

Everything population mode decides is numpy: the packed codes, the
splitmix64 availability and jitter streams and the cohort draws must be
the reference's bit for bit.  ``CohortState`` keeps the reference's LRU
order and eviction count, and its rows are fp32 host tensors with storage
of their own.  The aggregates go through the port's plain kernel versions
here: with the fixed-delta clients and integer example counts the
population ``Server.run`` is bitwise JAX's, and the port's population
round at N == cohort size is bitwise its own legacy round, on
``Server.run`` and on the round engine.  One engine round against JAX
holds ``test_torch_rounds.py``'s ``atol=1e-6``.
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
from repro.core.cost_model import _stream_uniform as j_stream_uniform
from repro.models import build_model as jbuild_model
from repro.optim import sgd as jsgd
import repro_torch.core as T
from repro_torch.configs.base import get_config
from repro_torch.core.cost_model import _stream_uniform as t_stream_uniform
from repro_torch.data.federated import ClientDataset
from repro_torch.data.synthetic import make_features
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_leaves, tree_map

C, STEPS, B = 4, 2, 8
MIX = {"jetson-tx2-gpu": 0.2, "pixel-2": 0.5, "tpu-v5e-chip": 0.3}
# ids around the uint64 hash's edges: 0, 2^31, 2^32 and 10^6 - 1
EDGE_IDS = np.asarray([0, 1, 2, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 2**32,
                       2**32 + 1, 10**6 - 2, 10**6 - 1], np.int64)


@functools.cache
def _models():
    jm = jbuild_model(jget_config("mobilenet-head-office31").reduced())
    jparams = jm.init(jax.random.key(0))
    tm = build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")
    return jm, jparams, tm


def _torch_params():
    return params_from_numpy(jax.tree.map(np.asarray, _models()[1]), "cpu")


def _flat(tree, jax_side):
    leaves = jax.tree.leaves(tree) if jax_side else [t.numpy() for t in tree_leaves(tree)]
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


@functools.cache
def _million():
    return J.Population.synthetic(10**6, seed=3), T.Population.synthetic(10**6, seed=3)


# ---------------- the packed fleet ----------------
@pytest.mark.parametrize("n", [100, 100_000])
@pytest.mark.parametrize("mix", [None, MIX, ("pixel-4", "jetson-tx2-cpu")],
                         ids=["aws-farm", "dict", "names"])
def test_synthetic_population_bitwise(n, mix):
    jp, tp = J.Population.synthetic(n, mix=mix, seed=7), T.Population.synthetic(n, mix=mix, seed=7)
    assert tp.profile_codes.dtype == jp.profile_codes.dtype == np.uint8
    np.testing.assert_array_equal(tp.profile_codes, jp.profile_codes)
    assert [p.name for p in tp.table] == [p.name for p in jp.table]
    assert (len(tp), tp.n_profiles, tp.nbytes) == (len(jp), jp.n_profiles, jp.nbytes)
    if n == 100_000:
        assert tp.nbytes / len(tp) <= 2.0
    ids = np.asarray([0, 17, n - 1])
    for name in ("step_time_s", "idle_power_w", "uplink_mbps"):
        np.testing.assert_array_equal(tp.column(name, ids), jp.column(name, ids))
    assert [tp.profile(int(i)).name for i in ids] == [jp.profile(int(i)).name for i in ids]


def test_from_profiles_bitwise():
    names = ["pixel-4", "pixel-3", "pixel-4", "pixel-2", "tpu-v5e-chip", "pixel-3"]
    jp = J.Population.from_profiles([J.PROFILES[x] for x in names])
    tp = T.Population.from_profiles([T.PROFILES[x] for x in names])
    np.testing.assert_array_equal(tp.profile_codes, jp.profile_codes)
    assert tp.profile_codes.dtype == jp.profile_codes.dtype and tp.n_profiles == 4
    for i, x in enumerate(names):
        assert tp.profile(i) is T.PROFILES[x]


def test_expected_round_s_bitwise():
    jp, tp = _million()
    ids = np.random.default_rng(0).integers(0, 10**6, 4096)
    kw = dict(steps=20, up_bytes=4e6, down_bytes=7.9e6)
    np.testing.assert_array_equal(tp.expected_round_s(ids, **kw), jp.expected_round_s(ids, **kw))
    p = T.PROFILES["pixel-4"]
    assert T.link_time_s(1e6, 2e6, p.uplink_mbps, p.downlink_mbps) == p.comm_time_s(1e6, 2e6)


# ---------------- streamed availability ----------------
def test_stream_uniform_bitwise_at_hash_edges():
    for seed in (0, 11, 2**40 + 3):
        for rnd in (1, 5, 10_007):
            for stream in range(5):
                t = t_stream_uniform(seed, rnd, stream, EDGE_IDS)
                np.testing.assert_array_equal(t, j_stream_uniform(seed, rnd, stream, EDGE_IDS))
                assert t.dtype == np.float64 and ((t >= 0) & (t < 1)).all()


def test_streamed_availability_and_jitter_bitwise():
    jp, tp = _million()
    jt = J.AvailabilityTrace.from_profiles(jp, seed=11, jitter_std=0.2)
    tt = T.AvailabilityTrace.from_profiles(tp, seed=11, jitter_std=0.2)
    assert tt.class_dropout == jt.class_dropout and tt.population is tp
    ids = np.concatenate([EDGE_IDS[EDGE_IDS < 10**6],
                          np.random.default_rng(1).integers(0, 10**6, 2000)])
    for rnd in (1, 4, 9):
        up = tt.available_for(rnd, ids)
        np.testing.assert_array_equal(up, jt.available_for(rnd, ids))
        np.testing.assert_array_equal(tt.step_jitter_for(rnd, ids), jt.step_jitter_for(rnd, ids))
        # pool-independent: each id's verdict alone, reversed, or in the pool
        solo = np.asarray([tt.available_for(rnd, [int(c)])[0] for c in ids[:40]])
        np.testing.assert_array_equal(solo, up[:40])
        np.testing.assert_array_equal(tt.available_for(rnd, ids[::-1])[::-1], up)
    # jitter needs no codes: bitwise at the hash's edges too
    np.testing.assert_array_equal(tt.step_jitter_for(3, EDGE_IDS), jt.step_jitter_for(3, EDGE_IDS))
    assert 0.0 < 1.0 - tt.available_for(2, np.arange(10**6)).mean() < 0.2


def test_population_trace_surfaces_agree():
    jp, tp = J.Population.synthetic(300, seed=2), T.Population.synthetic(300, seed=2)
    jt = J.AvailabilityTrace.from_profiles(jp, seed=9, jitter_std=0.1)
    tt = T.AvailabilityTrace.from_profiles(tp, seed=9, jitter_std=0.1)
    all_ids = np.arange(300)
    for rnd in (1, 6):
        np.testing.assert_array_equal(tt.available(rnd), tt.available_for(rnd, all_ids))
        np.testing.assert_array_equal(tt.available(rnd), jt.available(rnd))
        np.testing.assert_array_equal(tt.step_jitter(rnd), tt.step_jitter_for(rnd, all_ids))
        np.testing.assert_array_equal(tt.step_jitter(rnd), jt.step_jitter(rnd))
    assert tt.available(6, client_id=42) == bool(tt.available_for(6, [42])[0])


def test_population_trace_guards():
    pop = T.Population.synthetic(100, seed=0)
    with pytest.raises(ValueError):
        T.AvailabilityTrace.from_profiles(pop, late_join=3)
    with pytest.raises(AssertionError):
        T.AvailabilityTrace(n_clients=100, dropout=(0.1,) * 100, population=pop)
    with pytest.raises(AssertionError):
        T.AvailabilityTrace(n_clients=100, class_dropout=(0.1,), population=pop)


# ---------------- cohort sampling ----------------
@pytest.mark.parametrize("kind", ["blind", "cost-aware"])
@pytest.mark.parametrize("churn", [0.15, 0.995], ids=["churn", "heavy-churn"])
def test_sample_cohort_matches_jax(kind, churn):
    """Over 6 rounds with the last cohort excluded (in flight) and a churn
    trace: the same ids, round by round; heavy churn leaves short cohorts."""
    jp, tp = J.Population.synthetic(5000, mix=MIX, seed=4), T.Population.synthetic(5000, mix=MIX, seed=4)
    jt = J.AvailabilityTrace.from_profiles(jp, seed=5, mobile_dropout=churn, plugged_dropout=churn)
    tt = T.AvailabilityTrace.from_profiles(tp, seed=5, mobile_dropout=churn, plugged_dropout=churn)
    jcm = J.CostModel(profiles=[], update_bytes=4_000_000, population=jp)
    tcm = T.CostModel(profiles=[], update_bytes=4_000_000, population=tp)
    make = {"blind": lambda pkg: pkg.FedAvg(seed=3),
            "cost-aware": lambda pkg: pkg.CostAwareFedAvg(seed=3, expected_steps=20)}[kind]
    js, ts = make(J), make(T)
    busy, sizes = [], []
    for rnd in range(1, 7):
        kw = dict(exclude=set(busy), deadline_s=6.0)
        got = ts.sample_cohort(rnd, tp, 16, availability=tt, cost_model=tcm, **kw)
        assert got == js.sample_cohort(rnd, jp, 16, availability=jt, cost_model=jcm, **kw)
        assert not set(got) & set(busy) and got == sorted(got)
        busy, sizes = got[:3], sizes + [len(got)]
    assert (min(sizes) < 16) == (churn > 0.5)


def test_sample_clients_population_overload_matches_jax():
    jp, tp = J.Population.synthetic(10_000, seed=0), T.Population.synthetic(10_000, seed=0)
    js, ts = J.FedAvg(min_fit_clients=8, fraction_fit=0.0), T.FedAvg(min_fit_clients=8, fraction_fit=0.0)
    for rnd in (1, 3, 8):
        chosen = ts.sample_clients(rnd, tp)
        assert len(chosen) == 8 and chosen == sorted(chosen)
        assert chosen == js.sample_clients(rnd, jp) == ts.sample_clients(rnd, tp)


def test_cost_aware_sampling_prefers_feasible():
    mix = {"jetson-tx2-gpu": 0.5, "pixel-2": 0.5}
    pop = T.Population.synthetic(4_000, mix=mix, seed=4)
    cm = T.CostModel(profiles=[], update_bytes=4_000_000, population=pop)
    tau = 6.0  # pixel-2: 20 x 0.37 s + its links ~ 10.1 s; a Jetson ~ 3.7 s
    cohort = T.CostAwareFedAvg(expected_steps=20).sample_cohort(2, pop, 16, cost_model=cm,
                                                                deadline_s=tau)
    t = pop.expected_round_s(cohort, steps=20, up_bytes=4e6, down_bytes=4e6)
    assert len(cohort) == 16 and (t <= tau).all() and T.deadline_feasible(t, tau).all()
    assert all(pop.profile(c).name == "jetson-tx2-gpu" for c in cohort)
    blind = T.FedAvg().sample_cohort(2, pop, 16)
    assert (pop.expected_round_s(blind, steps=20, up_bytes=4e6, down_bytes=4e6) > tau).any()
    jpop = J.Population.synthetic(4_000, mix=mix, seed=4)
    assert cohort == J.CostAwareFedAvg(expected_steps=20).sample_cohort(
        2, jpop, 16, cost_model=J.CostModel(profiles=[], update_bytes=4_000_000, population=jpop),
        deadline_s=tau)
    assert T.deadline_feasible([1.0, 7.0], None).all() and T.deadline_feasible([7.0], np.inf).all()


def test_cost_aware_fills_from_infeasible_fastest_first():
    pop = T.Population.synthetic(50, mix=("pixel-2", "pixel-3"), seed=1)
    cm = T.CostModel(profiles=[], update_bytes=4_000_000, population=pop)
    aware = T.CostAwareFedAvg(expected_steps=20)
    # impossible deadline: nobody is feasible, so ranking is fastest-first
    cohort = aware.sample_cohort(1, pop, 10, cost_model=cm, deadline_s=1e-6)
    assert len(cohort) == 10 and {pop.profile(c).name for c in cohort} == {"pixel-3"}
    jpop = J.Population.synthetic(50, mix=("pixel-2", "pixel-3"), seed=1)
    assert cohort == J.CostAwareFedAvg(expected_steps=20).sample_cohort(
        1, jpop, 10, cost_model=J.CostModel(profiles=[], update_bytes=4_000_000, population=jpop),
        deadline_s=1e-6)


def test_cost_model_profile_for_population():
    pop = T.Population.from_profiles([T.PROFILES["pixel-4"], T.PROFILES["pixel-2"]])
    cm = T.CostModel(profiles=[], update_bytes=1, population=pop)
    assert cm.profile_for(0) is T.PROFILES["pixel-4"] and cm.profile_for(1) is T.PROFILES["pixel-2"]
    legacy = T.CostModel(profiles=[T.PROFILES["pixel-4"], T.PROFILES["pixel-2"]], update_bytes=1)
    assert legacy.profile_for(2) is T.PROFILES["pixel-4"]


# ---------------- CohortState ----------------
def _row(v, n=8):
    return np.full(n, float(v), np.float32)


def test_cohort_state_lru_matches_jax():
    """A scripted sequence of row puts, touches, gathers and scatters on a
    capacity-3 store: after every operation the same LRU order and
    eviction count as the reference's, and gathers bitwise equal (an
    evicted or unseen client gathers zeros)."""
    js = J.CohortState(J.TopKCodec(frac=0.25), 8, capacity=3)
    ts = T.CohortState(T.TopKCodec(frac=0.25), 8, capacity=3, device="cpu")
    block = np.arange(16, dtype=np.float32).reshape(2, 8)
    script = [("put", 1, 1), ("put", 2, 2), ("get", 1), ("put", 3, 3), ("put", 4, 4),
              ("gather", [2, 4, 1, 9]), ("get", 3), ("scatter", [5, 1]), ("put", 6, 6),
              ("gather", [3, 5, 6, 1]), ("get", 42), ("scatter", [7, 3])]
    for op in script:
        if op[0] == "put":
            js.put_row(op[1], _row(op[2]))
            ts.put_row(op[1], _row(op[2]))
        elif op[0] == "get":
            jr, tr = js.get_row(op[1]), ts.get_row(op[1])
            assert (jr is None) == (tr is None)
            if tr is not None:
                np.testing.assert_array_equal(tr.numpy(), jr)
        elif op[0] == "gather":
            got = ts.gather(op[1])
            assert got.dtype == torch.float32 and got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), np.asarray(js.gather(op[1])))
        else:
            js.scatter(op[1], jnp.asarray(block))
            ts.scatter(op[1], torch.from_numpy(block))
        assert list(ts._rows) == list(js._rows) and ts.evictions == js.evictions
        assert (len(ts), ts.nbytes) == (len(js), js.nbytes)
    assert ts.evictions == 5
    ts.reset()
    assert len(ts) == 0 and ts.evictions == 0


def test_cohort_state_rows_are_host_tensors_with_own_storage():
    ts = T.CohortState(T.Int8Codec(), 8, capacity=4, device="cpu")
    block = torch.arange(24, dtype=torch.float32).reshape(3, 8)
    ts.scatter([10, 11, 12], block)
    ts.put_row(13, block[1])
    block.zero_()  # the engine's buffer is reused: the store keeps its copies
    for cid, want in ((10, 0), (11, 8), (12, 16), (13, 8)):
        row = ts.get_row(cid)
        assert row.device.type == "cpu" and row.dtype == torch.float32 and row.shape == (8,)
        assert row.untyped_storage().nbytes() == 8 * 4 and row.storage_offset() == 0
        assert torch.equal(row, torch.arange(want, want + 8, dtype=torch.float32))
    np.testing.assert_array_equal(ts.gather([11, 99]).numpy()[1], np.zeros(8))


def test_cohort_state_stateless_and_unported():
    for codec in (T.NullCodec(), None):
        cs = T.CohortState(codec, 8, device="cpu")
        assert cs.stateless and cs.gather([1, 2, 3]) == ()
        cs.scatter([1, 2], ())  # a no-op, not a crash
        assert len(cs) == 0 and cs.nbytes == 0
    assert not T.CohortState(T.Int8Codec(), 8, device="cpu").stateless

    class Foreign(T.UpdateCodec):
        pass

    # a foreign codec is stateful through the base flat state, as in JAX's
    # CohortState; a MixedCodec is refused
    assert not T.CohortState(Foreign(), 8, device="cpu").stateless
    with pytest.raises(TypeError, match="MixedCodec"):
        T.CohortState(T.MixedCodec(codecs=(T.Int8Codec(),), assignment=(0,)), 8, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        T.CohortState(T.Int8Codec(), 8, device="cpu", shardings=("fsdp",))


def test_no_card_no_default_device(monkeypatch):
    """``CohortState`` and the quickstart default to the card and raise
    without one."""
    from repro_torch.examples import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.CohortState(T.Int8Codec(), 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.run()


# ---------------- LazyClientPool ----------------
class _StubClient:
    def __init__(self, cid):
        self.cid = cid
        self.row = None

    def export_state(self):
        return self.row

    def import_state(self, state):
        self.row = state


def test_lazy_pool_spills_and_rehydrates():
    pop = T.Population.synthetic(100, seed=0)
    store = T.CohortState(T.TopKCodec(frac=0.5), 4, capacity=64, device="cpu")
    pool = T.LazyClientPool(pop, _StubClient, capacity=1, state_store=store)
    c0 = pool[0]
    c0.row = torch.tensor([1.0, 2.0, 3.0, 4.0])
    pool[1]                       # capacity 1: evicts client 0, spilling its row
    assert pool.live == 1 and store.get_row(0) is not None
    c0_again = pool[0]            # a fresh object, its carry rehydrated
    assert c0_again is not c0
    np.testing.assert_array_equal(c0_again.row.numpy(), [1.0, 2.0, 3.0, 4.0])
    assert pool.materializations == 3 and len(pool) == 100
    pool.reset_state()
    assert pool.live == 0 and len(store) == 0 and pool.materializations == 0


def test_torch_client_rehydration_then_discard_is_a_noop():
    """An Int8 client's residual survives eviction and rehydration bitwise;
    the rehydrated row is the rollback point, so a ``discard_update`` right
    after is a no-op (not a reset to None), and the client's row does not
    alias the store's."""
    _, _, tm = _models()
    params = _torch_params()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 64)).astype(np.float32)
    y = rng.integers(0, 31, 64).astype(np.int32)
    pop = T.Population.synthetic(10, seed=0)

    def factory(cid):
        return T.TorchClient(client_id=cid, loss_fn=tm.loss_fn, batch_size=32, device="cpu",
                             dataset=ClientDataset(client_id=cid, x=x, y=y),
                             trainable_mask=tm.trainable_mask(params))

    n = sum(t.numel() for t in tree_leaves(params))
    store = T.CohortState(T.Int8Codec(), n, capacity=4, device="cpu")
    pool = T.LazyClientPool(pop, factory, capacity=1, state_store=store)
    c3 = pool[3]
    c3.fit(T.FitIns(parameters=params, config={"epochs": 1, "codec": T.Int8Codec()}))
    residual = c3.export_state().clone()
    assert residual.abs().max() > 0
    pool[4]                                   # evicts client 3 into the store
    back = pool[3]
    assert back is not c3 and torch.equal(back._residual, residual)
    back.discard_update()
    assert back._residual is not None and torch.equal(back._residual, residual)
    back._residual.add_(1.0)
    assert torch.equal(store.get_row(3), residual)
    assert T.Client().export_state() is None


# ---------------- the round engine over CohortState ----------------
def _engine_batches(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.normal(size=(C, STEPS, B, 64)).astype(np.float32)),
            "y": torch.from_numpy(rng.integers(0, 31, (C, STEPS, B)).astype(np.int32))}


def _torch_step(codec):
    _, _, tm = _models()
    spec = T.RoundSpec(max_steps=STEPS, execution_mode="parallel", codec=codec)
    return T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(), spec)


def _equal_metrics(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


@pytest.mark.parametrize("codec_name", ["Int8Codec", "TopKCodec"])
def test_engine_gather_scatter_bitwise_threaded(codec_name):
    """3 rounds with the residual rows resident only while sampled
    (``gather`` / ``scatter``) against the same rounds with the (C, n)
    state threaded: globals, metrics and the final rows bitwise."""
    codec = getattr(T, codec_name)()
    step, batches = _torch_step(codec), _engine_batches()
    params = _torch_params()
    n = sum(t.numel() for t in tree_leaves(params))
    w, bud = torch.ones(C), torch.full((C,), STEPS, dtype=torch.int32)
    cohort = [3, 17, 5, 40]
    g, state, threaded = params, codec.init_client_state(C, n, device="cpu"), []
    for rnd in range(3):
        g, _, state, met = step(g, (), state, batches, w, bud, rnd)
        threaded.append((g, met))
    store = T.CohortState(codec, n, capacity=16, device="cpu")
    gp = params
    for rnd in range(3):
        dense = store.gather(cohort)
        gp, _, dense, met = step(gp, (), dense, batches, w, bud, rnd)
        store.scatter(cohort, dense)
        _equal_metrics(met, threaded[rnd][1])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gp), tree_leaves(threaded[rnd][0])))
    assert torch.equal(store.gather(cohort), state)


@pytest.mark.parametrize("codec_name", ["Int8Codec", "TopKCodec"])
def test_eviction_round_bitwise_matches_fresh_residual(codec_name):
    """A store of capacity 1 loses C - 1 rows at every scatter: each of its
    rounds is bitwise the round in which those rows were zeroed by hand."""
    codec = getattr(T, codec_name)()
    step, batches = _torch_step(codec), _engine_batches()
    params = _torch_params()
    n = sum(t.numel() for t in tree_leaves(params))
    w, bud = torch.ones(C), torch.full((C,), STEPS, dtype=torch.int32)
    cohort = list(range(C))

    tight = T.CohortState(codec, n, capacity=1, device="cpu")
    g, outs = params, []
    for rnd in range(3):
        dense = tight.gather(cohort)
        g, _, dense, met = step(g, (), dense, batches, w, bud, rnd)
        tight.scatter(cohort, dense)
        outs.append((g, met))
    assert tight.evictions == (C - 1) + 2 * C and len(tight) == 1

    store = T.CohortState(codec, n, capacity=16, device="cpu")
    g = params
    for rnd in range(3):
        dense = store.gather(cohort)
        dense[: C - 1] = 0.0  # what eviction reset (only row C - 1 survived)
        g, _, new, met = step(g, (), dense, batches, w, bud, rnd)
        store.scatter(cohort, new)
        _equal_metrics(met, outs[rnd][1])
        assert torch.isfinite(met["residual_norm_mean"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g), tree_leaves(outs[-1][0])))


def test_population_engine_round_matches_jax():
    """One TopK round from each package's ``CohortState`` over the same
    cohort (rows pre-seeded identically): globals and the scattered rows
    within ``test_torch_rounds.py``'s ``atol=1e-6``."""
    jm, jparams, _ = _models()
    n = sum(x.size for x in jax.tree.leaves(jparams))
    cohort = [2, 9, 4, 7]
    seeded = (np.random.default_rng(3).normal(size=(2, n)) * 1e-3).astype(np.float32)
    js = J.CohortState(J.TopKCodec(), n, capacity=8)
    ts = T.CohortState(T.TopKCodec(), n, capacity=8, device="cpu")
    for store in (js, ts):
        store.put_row(9, seeded[0])
        store.put_row(7, seeded[1])
    batches = _engine_batches(1)
    jrs = jax.jit(J.make_round_step(jm.loss_fn, jsgd(0.1), J.FedAvg(), J.RoundSpec(
        max_steps=STEPS, execution_mode="parallel", codec=J.TopKCodec())))
    w = np.asarray([1.0, 2.0, 0.5, 3.0], np.float32)
    bud = np.asarray([2, 1, 2, 2], np.int32)
    jg, _, jst, jmet = jrs(jparams, (), js.gather(cohort),
                           {k: jnp.asarray(v.numpy()) for k, v in batches.items()},
                           jnp.asarray(w), jnp.asarray(bud), 0, jnp.ones(C))
    js.scatter(cohort, jst)
    tg, _, tst, tmet = _torch_step(T.TopKCodec())(_torch_params(), (), ts.gather(cohort), batches,
                                                  torch.from_numpy(w), torch.from_numpy(bud), 0)
    ts.scatter(cohort, tst)
    np.testing.assert_allclose(_flat(tg, False), _flat(jg, True), rtol=0, atol=1e-6)
    for cid in cohort:
        np.testing.assert_allclose(ts.get_row(cid).numpy(), js.get_row(cid), rtol=0, atol=1e-6)
    assert list(ts._rows) == list(js._rows)
    for key in jmet:
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5, atol=1e-7)


# ---------------- Server population mode ----------------
FIXED_FLEET = ("pixel-4", "jetson-tx2-gpu", "tpu-v5e-chip", "pixel-2", "jetson-tx2-cpu",
               "pixel-3") * 2


def _fixed_delta_client(pkg, cid, delta, profile):
    """A deterministic client: global + its fixed delta, shipped through
    the codec the strategy chose; integer example counts."""

    class _Fixed(pkg.Client):
        def properties(self):
            prof = pkg.PROFILES[profile]
            return pkg.ClientProperties(client_id=cid, device_profile=profile,
                                        uplink_mbps=prof.uplink_mbps,
                                        downlink_mbps=prof.downlink_mbps)

        def fit(self, ins):
            tm = jax.tree.map if pkg is J else tree_map
            add = jnp.add if pkg is J else torch.add
            newp = tm(add, ins.parameters, delta)
            codec = ins.config["codec"]
            enc, _ = pkg.compress_update(codec, newp, ins.parameters)
            n = sum(int(np.prod(x.shape)) for x in (
                jax.tree.leaves(newp) if pkg is J else tree_leaves(newp)))
            return pkg.FitRes(parameters=pkg.compress_to_wire(codec, enc, n),
                              num_examples=3 + cid % 5,
                              metrics={"loss": 1.0 + cid / 8, "steps_done": 1 + cid % 4})

        def evaluate(self, ins):
            return pkg.EvaluateRes(loss=0.5 + cid / 16, num_examples=1 + cid % 2,
                                   metrics={"acc": cid / 12})

    return _Fixed()


@functools.cache
def _fixed_deltas():
    rng = np.random.default_rng(0)
    return [jax.tree.map(lambda x: (rng.normal(size=x.shape) * 1e-2).astype(np.float32),
                         _models()[1]) for _ in FIXED_FLEET]


def _fixed_population_run(pkg, case):
    jparams = _models()[1]
    pop = pkg.Population.from_profiles([pkg.PROFILES[p] for p in FIXED_FLEET])
    deltas = _fixed_deltas()

    def factory(cid):
        d = (jax.tree.map(jnp.asarray, deltas[cid]) if pkg is J
             else params_from_numpy(deltas[cid], "cpu"))
        return _fixed_delta_client(pkg, cid, d, FIXED_FLEET[cid])

    params = jparams if pkg is J else _torch_params()
    n = sum(x.size for x in jax.tree.leaves(jparams))
    cm = pkg.CostModel(profiles=[], update_bytes=4 * n, population=pop)
    trace = {
        "no-churn": None,
        "all-down": lambda: pkg.AvailabilityTrace.from_profiles(
            pop, seed=0, mobile_dropout=1.0, plugged_dropout=1.0),
        "flaky": lambda: pkg.AvailabilityTrace.from_profiles(
            pop, seed=3, mobile_dropout=0.7, plugged_dropout=0.7),
        "deadline": lambda: pkg.AvailabilityTrace.from_profiles(pop, seed=2),
    }[case]
    strategy = (pkg.CostAwareFedAvg(codec_policy=pkg.BandwidthCodecPolicy(), expected_steps=2)
                if case == "deadline" else pkg.FedAvg(codec_policy=pkg.BandwidthCodecPolicy()))
    kw = {} if pkg is J else {"device": "cpu"}
    server = pkg.Server(
        strategy=strategy, clients=pkg.LazyClientPool(pop, factory, capacity=8),
        cost_model=cm, population=pop, cohort_size=C,
        availability=None if trace is None else trace(),
        policy=pkg.Deadline(tau=0.5) if case == "deadline" else None, **kw,
    )
    server.logger.quiet = True
    return server.run(params, num_rounds=8 if case == "flaky" else 3)


@pytest.mark.parametrize("case", ["no-churn", "all-down", "flaky", "deadline"])
def test_server_population_mode_matches_jax(case):
    """12 fixed-delta clients (phones TopK, Jetsons Int8, datacenter Null
    under ``BandwidthCodecPolicy``), cohort 4: History equal field for
    field and the final params bitwise.  All-down churn gives only empty
    rounds, flaky churn short and empty ones; under ``Deadline`` the
    cost-aware sampler ranks with the cutoff and stragglers drop."""
    (jg, jh), (tg, th) = _fixed_population_run(J, case), _fixed_population_run(T, case)
    for a, b in zip(jh.rounds, th.rounds, strict=True):
        ja, tb = vars(a), vars(b)
        assert ja.keys() == tb.keys()
        for k in ja:
            assert (ja[k] == tb[k]) or (np.isnan(ja[k]) and np.isnan(tb[k])), (k, ja[k], tb[k])
    np.testing.assert_array_equal(_flat(tg, False), _flat(jg, True))
    parts = [r.participants for r in th.rounds]
    init = _flat(_models()[1], True)
    if case == "all-down":
        assert parts == [0] * 3 and all(np.isnan(r.train_loss) for r in th.rounds)
        assert all(r.comm_bytes == 0 and r.energy_j == 0.0 for r in th.rounds)
        np.testing.assert_array_equal(_flat(tg, False), init)
    elif case == "flaky":
        assert any(0 < p < C for p in parts) and 0 in parts
    elif case == "deadline":
        assert sum(r.dropped for r in th.rounds) > 0
    else:
        assert parts == [C] * 3


def _training_run(population_mode: bool):
    """4 training clients (a phone on TopK, a Jetson on Int8, a datacenter
    client on Null, a phone) through the list path or population mode at
    N == cohort size."""
    _, _, tm = _models()
    params = _torch_params()
    mask = tm.trainable_mask(params)
    fleet = ("pixel-4", "jetson-tx2-gpu", "tpu-v5e-chip", "pixel-2")
    data = make_features(n=len(fleet) * 64, num_classes=31, feature_dim=64, seed=5)

    def factory(cid):
        lo = cid * 64
        return T.TorchClient(client_id=cid, loss_fn=tm.loss_fn, batch_size=16, device="cpu",
                             dataset=ClientDataset(client_id=cid, x=data.x[lo:lo + 64],
                                                   y=data.y[lo:lo + 64]),
                             trainable_mask=mask, device_profile=fleet[cid])

    profiles = [T.PROFILES[p] for p in fleet]
    strategy = T.FedAvg(local_epochs=1, local_lr=0.1, codec_policy=T.BandwidthCodecPolicy())
    if population_mode:
        pop = T.Population.from_profiles(profiles)
        n = sum(t.numel() for t in tree_leaves(params))
        store = T.CohortState(T.Int8Codec(), n, device="cpu")
        server = T.Server(strategy=strategy, device="cpu",
                          clients=T.LazyClientPool(pop, factory, capacity=8, state_store=store),
                          cost_model=T.CostModel(profiles=[], update_bytes=4 * n, population=pop),
                          population=pop, cohort_size=len(fleet))
    else:
        server = T.Server(strategy=strategy, clients=[factory(c) for c in range(len(fleet))],
                          cost_model=T.make_cost_model_for(params, profiles), device="cpu")
    server.logger.quiet = True
    return server.run(params, num_rounds=3), server


def test_population_at_cohort_size_bitwise_legacy():
    (g_leg, h_leg), _ = _training_run(False)
    (g_pop, h_pop), server = _training_run(True)
    for a, b in zip(h_leg.rounds, h_pop.rounds, strict=True):
        assert vars(a) == vars(b)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_leg), tree_leaves(g_pop)))
    assert server.clients.live <= server.clients.capacity and h_pop.rounds[-1].participants == 4


def test_population_mode_needs_cohort_size():
    pop = T.Population.synthetic(64, seed=0)
    srv = T.Server(strategy=T.FedAvg(), clients=T.LazyClientPool(pop, lambda c: None),
                   population=pop, device="cpu")
    with pytest.raises(ValueError, match="cohort_size"):
        srv.run({"w": torch.zeros(2)}, num_rounds=1)


def test_quickstart_runs_on_the_cpu():
    """The quickstart's both halves, one round each: 5 pixel-4 clients,
    then a 16-client cohort of a 100,000-device fleet."""
    from repro_torch.examples import quickstart

    out = quickstart.run(device="cpu", rounds=(1, 1))
    assert out["history"].rounds[0].participants == 5
    fleet = out["fleet_history"].rounds[0]
    assert fleet.participants == 16 and np.isfinite(fleet.train_loss)
    assert out["pool"].live <= 16 and len(out["pool"]) == 100_000
