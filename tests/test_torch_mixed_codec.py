"""Port parity for ``MixedCodec``: per-device mixed-codec batches in one
round of the port's engine (the twins of ``tests/test_mixed_codec.py``,
plus the ``"mixed"`` cases of ``tests/test_scheduler.py``'s masked-client
test), against the JAX package on the same numpy inputs and the same
JAX-initialized params, on the reduced head model.

Tolerances: the reference's own.  One mixed round against JAX's, or
against the groups combined by hand: ``atol=rtol=1e-4`` (local SGD's last
bits, and an Int8 code or TopK selection on its edge); the sequential mode
(bf16 accumulator) against the parallel one: ``2e-3`` on the globals,
``2e-2`` on the residual rows.  A masked client's garbled data leaves the
global and every residual row bitwise unchanged.
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
from repro.data.federated import ClientDataset as JClientDataset
from repro.models import build_model as jbuild_model
from repro.optim import sgd as jsgd
import repro_torch.core as T
from repro_torch.configs.base import get_config
from repro_torch.core.cost_model import CostModel
from repro_torch.core.rounds import make_client_update
from repro_torch.data.federated import ClientDataset
from repro_torch.launch import ClientMesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_flatten_to_vector, tree_leaves, tree_size

FLEET = ("pixel-4", "jetson-tx2-gpu", "tpu-v5e-chip")  # TopK / Int8 / Null
C, STEPS, B = 3, 2, 16
ROUND_TOL = dict(atol=1e-4, rtol=1e-4)


def _fleet_codec(pkg=T, profile_names=FLEET):
    return pkg.MixedCodec.from_policy(pkg.BandwidthCodecPolicy(),
                                      [pkg.PROFILES[p] for p in profile_names])


# ---------------- construction ----------------
def test_from_policy_assignment_and_bank():
    codec = _fleet_codec(profile_names=("pixel-4", "jetson-tx2-gpu", "tpu-v5e-chip", "pixel-3"))
    kinds = [type(codec.codecs[g]) for g in codec.assignment]
    assert kinds == [T.TopKCodec, T.Int8Codec, T.NullCodec, T.TopKCodec]
    assert len(codec.codecs) == 3 and codec.n_clients == 4
    groups = {type(c).__name__: list(idx) for _, c, idx in codec.groups()}
    assert groups == {"TopKCodec": [0, 3], "Int8Codec": [1], "NullCodec": [2]}
    jcodec = _fleet_codec(J, ("pixel-4", "jetson-tx2-gpu", "tpu-v5e-chip", "pixel-3"))
    assert jcodec.assignment == codec.assignment
    assert [type(c).__name__ for c in jcodec.codecs] == [type(c).__name__ for c in codec.codecs]


def test_assignment_out_of_range_rejected():
    with pytest.raises(AssertionError):
        T.MixedCodec(codecs=(T.NullCodec(),), assignment=(0, 1))


def test_init_client_state_per_group_rows():
    codec = _fleet_codec(profile_names=("pixel-4", "pixel-3", "jetson-tx2-gpu", "tpu-v5e-chip"))
    state = codec.init_client_state(4, 100, device="cpu")
    assert isinstance(state, tuple) and len(state) == 3
    assert state[0].shape == (2, 100) and state[1].shape == (1, 100) and state[2] == ()
    with pytest.raises(AssertionError):
        codec.init_client_state(3, 100, device="cpu")


def test_wire_bytes_is_per_client():
    codec, n = _fleet_codec(), 4096
    assert codec.wire_bytes(n) == [T.TopKCodec().wire_bytes(n), T.Int8Codec().wire_bytes(n),
                                   T.NullCodec().wire_bytes(n)]
    assert codec.wire_bytes([100, 200, 300]) == [
        T.TopKCodec().wire_bytes(100), T.Int8Codec().wire_bytes(200),
        T.NullCodec().wire_bytes(300)]
    assert codec.wire_bytes(n) == _fleet_codec(J).wire_bytes(n)
    with pytest.raises(TypeError):
        codec._wire_bytes_scalar(n)


def test_per_client_surfaces_are_group_owned():
    codec = _fleet_codec()
    for call in (
        lambda: codec.encode(torch.zeros(8)),
        lambda: codec.decode({}),
        lambda: codec.transmit_tree({"w": torch.zeros(8)}, ()),
        lambda: codec.reduce({}, torch.ones(3)),
    ):
        with pytest.raises(TypeError, match="group"):
            call()


# ---------------- flat-batch aggregation semantics ----------------
def test_aggregate_batch_matches_per_group_decode_reference():
    """Group partial sums under ONE denominator == the weighted mean of the
    per-client decoded deltas, each client decoded by its own codec; and
    JAX's aggregate_batch on the same input."""
    rng = np.random.default_rng(3)
    names = ("pixel-4", "jetson-tx2-gpu", "tpu-v5e-chip", "pixel-3")
    codec = _fleet_codec(profile_names=names)
    c, n = 4, 700
    deltas_np = (rng.normal(size=(c, n)) * 0.01).astype(np.float32)
    w_np = np.asarray([1.0, 3.0, 2.0, 5.0], np.float32)
    deltas, w = torch.from_numpy(deltas_np), torch.from_numpy(w_np)
    avg, new_state = codec.aggregate_batch(deltas, w, codec.init_client_state(c, n, device="cpu"))
    dec_rows = []
    for i in range(c):
        cc = codec.codecs[codec.assignment[i]]
        dec_rows.append(cc.decode(cc.encode(deltas[i])))
    exp = torch.einsum("c,cn->n", w, torch.stack(dec_rows)) / w.sum()
    torch.testing.assert_close(avg, exp, atol=1e-5, rtol=1e-5)
    assert new_state[0].shape == (2, n) and new_state[1].shape == (1, n)
    torch.testing.assert_close(new_state[1][0], deltas[1] - dec_rows[1], atol=1e-6, rtol=0)
    jcodec = _fleet_codec(J, names)
    javg, jstate = jcodec.aggregate_batch(jnp.asarray(deltas_np), jnp.asarray(w_np),
                                          jcodec.init_client_state(c, n))
    np.testing.assert_allclose(avg.numpy(), np.asarray(javg), rtol=1e-6, atol=1e-9)
    for a, b in zip(tree_leaves(new_state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_aggregate_batch_size_must_match_assignment():
    codec = _fleet_codec()
    with pytest.raises(AssertionError, match="clients"):
        codec.aggregate_batch(torch.ones(2, 64), torch.ones(2),
                              codec.init_client_state(3, 64, device="cpu"))


def test_aggregate_batch_zero_weights_yield_zeros():
    codec = _fleet_codec()
    avg, _ = codec.aggregate_batch(torch.full((3, 512), 0.01), torch.zeros(3),
                                   codec.init_client_state(3, 512, device="cpu"))
    assert torch.equal(avg, torch.zeros(512))


# ---------------- the round engine ----------------
@functools.cache
def _models():
    jm = jbuild_model(jget_config("mobilenet-head-office31").reduced())
    jparams = jm.init(jax.random.key(0))
    tm = build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")
    return jm, jparams, tm


def _torch_params():
    return params_from_numpy(jax.tree.map(np.asarray, _models()[1]), "cpu")


@functools.cache
def _train_np(c=C, seed=0):
    jm = _models()[0]
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 1.0, size=(jm.cfg.num_classes, jm.cfg.feature_dim))
    xs, ys = [], []
    for i in range(c):
        r = np.random.default_rng(100 + i)
        y = r.integers(0, jm.cfg.num_classes, STEPS * B)
        xs.append(centers[y] + 0.4 * r.normal(size=(STEPS * B, jm.cfg.feature_dim)))
        ys.append(y)
    return {"x": np.stack(xs).reshape(c, STEPS, B, -1).astype(np.float32),
            "y": np.stack(ys).reshape(c, STEPS, B).astype(np.int32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _run_engine(codec, mode, rounds=2, weights=None):
    tm = _models()[2]
    params = _torch_params()
    spec = T.RoundSpec(max_steps=STEPS, execution_mode=mode, codec=codec)
    rs = T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(), spec)
    c = codec.n_clients
    w = torch.ones(c) if weights is None else weights
    bud = torch.full((c,), STEPS, dtype=torch.int32)
    p, cstate, mets = params, codec.init_client_state(c, tree_size(params), device="cpu"), []
    for rnd in range(rounds):
        p, _, cstate, met = rs(p, (), cstate, _t(_train_np()), w, bud, rnd)
        mets.append(met)
    return p, cstate, mets


def _run_jax_engine(codec, mode, rounds=2, weights=None):
    jm, jparams, _ = _models()
    spec = J.RoundSpec(max_steps=STEPS, execution_mode=mode, codec=codec)
    rs = jax.jit(J.make_round_step(jm.loss_fn, jsgd(0.1), J.FedAvg(), spec))
    c = codec.n_clients
    w = jnp.ones(c) if weights is None else jnp.asarray(weights.numpy())
    bud = jnp.full((c,), STEPS, jnp.int32)
    n = sum(x.size for x in jax.tree.leaves(jparams))
    p, cstate = jparams, codec.init_client_state(c, n)
    for rnd in range(rounds):
        p, _, cstate, _ = rs(p, (), cstate, jax.tree.map(jnp.asarray, _train_np()), w, bud, rnd)
    return p, cstate


def _vec(tree, jax_side=False):
    if jax_side:
        return np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree.leaves(tree)])
    return tree_flatten_to_vector(tree).numpy()


def test_mixed_round_uniform_signature_and_state():
    codec = _fleet_codec()
    p, cstate, mets = _run_engine(codec, "parallel")
    met = mets[-1]
    assert set(p) == set(_torch_params())
    n = tree_size(p)
    assert isinstance(cstate, tuple) and len(cstate) == 3
    assert cstate[0].shape == (1, n) and cstate[1].shape == (1, n) and cstate[2] == ()
    assert {"client_loss_mean", "client_loss_max", "steps_total",
            "residual_norm_mean"} <= set(met)
    assert float(met["residual_norm_mean"]) > 0.0


def test_mixed_round_no_dense_topk_materialization(monkeypatch):
    """The TopK group's payload is never densified inside a mixed round:
    decode_batch raises if anything calls it."""
    def boom(self, enc):
        raise AssertionError("TopKCodec.decode_batch called on the aggregation path")

    monkeypatch.setattr(T.TopKCodec, "decode_batch", boom)
    p, _, _ = _run_engine(_fleet_codec(), "parallel")
    assert all(torch.isfinite(x).all() for x in tree_leaves(p))


def test_mixed_round_matches_manual_group_combination():
    """One mixed round == every group aggregated by its own codec, the
    partial weighted sums combined under the fleet denominator."""
    codec = _fleet_codec()
    w = torch.tensor([1.0, 2.0, 0.5])
    p_mixed, _, _ = _run_engine(codec, "parallel", rounds=1, weights=w)
    tm = _models()[2]
    params = _torch_params()
    cu = make_client_update(tm.loss_fn, sgd(0.1),
                            T.RoundSpec(max_steps=STEPS, execution_mode="parallel", codec=codec))
    new_params, _, _ = torch.func.vmap(cu, in_dims=(None, 0, 0))(
        params, _t(_train_np()), torch.full((C,), STEPS, dtype=torch.int32))
    flat_global = tree_flatten_to_vector(params)
    deltas = torch.cat([x.reshape(C, -1) for x in tree_leaves(new_params)], dim=1) - flat_global
    total = torch.zeros_like(flat_global)
    for _, cc, idx in codec.groups():
        mean_g, _ = cc.aggregate_batch(deltas[idx], w[idx],
                                       cc.init_client_state(len(idx), flat_global.numel(),
                                                            device="cpu"))
        total = total + mean_g * w[idx].sum()
    torch.testing.assert_close(tree_flatten_to_vector(p_mixed), flat_global + total / w.sum(),
                               **ROUND_TOL)


@pytest.mark.parametrize("segmented", [False, True], ids=["flat", "segmented"])
@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_mixed_round_matches_jax(mode, segmented):
    """Two mixed rounds of the port's engine against JAX's jitted round
    step from the same params and batches, the bank flat or carrying the
    head model's segment map: globals within ROUND_TOL (2e-3 for the bf16
    sequential accumulator)."""
    codec, jcodec = _fleet_codec(), _fleet_codec(J)
    if segmented:
        codec = codec.with_segments(T.SegmentMap.from_tree(_torch_params()))
        jcodec = jcodec.with_segments(J.SegmentMap.from_tree(_models()[1]))
    w = torch.tensor([1.0, 2.0, 0.5])
    p_t, cs_t, _ = _run_engine(codec, mode, weights=w)
    p_j, cs_j = _run_jax_engine(jcodec, mode, weights=w)
    tol = ROUND_TOL if mode == "parallel" else dict(atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_vec(p_t), _vec(p_j, True), **tol)
    assert len(tree_leaves(cs_t)) == len(jax.tree.leaves(cs_j))
    for a, b in zip(tree_leaves(cs_t), jax.tree.leaves(cs_j)):
        assert tuple(a.shape) == b.shape


def test_mixed_sequential_matches_parallel():
    """The per-group loops land the global and the per-group rows of the
    parallel mode (bf16 sequential accumulator tolerance), and round 1's
    weighted loss agrees to fp noise."""
    codec = _fleet_codec()
    w = torch.tensor([1.0, 2.0, 0.5])
    p_p, cs_p, mets_p = _run_engine(codec, "parallel", weights=w)
    p_s, cs_s, mets_s = _run_engine(codec, "sequential", weights=w)
    for a, b in zip(tree_leaves(p_p), tree_leaves(p_s)):
        torch.testing.assert_close(a, b, atol=2e-3, rtol=2e-3)
    for a, b in zip(tree_leaves(cs_p), tree_leaves(cs_s)):
        torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)
    assert float(mets_s[0]["client_loss_mean"]) == pytest.approx(
        float(mets_p[0]["client_loss_mean"]), rel=1e-4)


def test_mixed_mesh_path_rejected_at_build_time():
    tm = _models()[2]
    mesh = ClientMesh(axes=(("pod", 2), ("data", 2)), rank=0, groups={"pod": None, "data": None})
    spec = T.RoundSpec(max_steps=STEPS, execution_mode="parallel", codec=_fleet_codec())
    with pytest.raises(NotImplementedError, match="MixedCodec"):
        T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(), spec, mesh=mesh,
                          client_axes=("pod", "data"))


# ---------------- the engine against Server.run ----------------
def _server_run(pkg, rounds=2):
    jm, jparams, tm = _models()
    train = _train_np()
    clients, extra = [], ({} if pkg is J else {"device": "cpu"})
    for c, profile in enumerate(FLEET):
        x, y = train["x"][c].reshape(STEPS * B, -1), train["y"][c].reshape(STEPS * B)
        if pkg is J:
            clients.append(J.JaxClient(client_id=c, loss_fn=jm.loss_fn,
                                       dataset=JClientDataset(client_id=c, x=x, y=y),
                                       batch_size=STEPS * B, device_profile=profile))
        else:
            clients.append(T.TorchClient(client_id=c, loss_fn=tm.loss_fn,
                                         dataset=ClientDataset(client_id=c, x=x, y=y),
                                         batch_size=STEPS * B, device_profile=profile,
                                         device="cpu"))
    params = jparams if pkg is J else _torch_params()
    strat = pkg.FedAvg(local_epochs=1, local_lr=0.1, codec_policy=pkg.BandwidthCodecPolicy())
    cm = pkg.make_cost_model_for(params, [pkg.PROFILES[p] for p in FLEET])
    server = pkg.Server(strategy=strat, clients=clients, cost_model=cm, **extra)
    server.logger.quiet = True
    final, hist = server.run(params, num_rounds=rounds)
    return final, hist, strat, clients, cm


def test_mixed_fleet_engine_matches_python_server():
    """Pixel->TopK, Jetson->Int8, TPU->Null: the port's MixedCodec round ==
    its sequential round == its Server.run == JAX's Server.run, within
    tolerance, and every client ships its group codec's wire size."""
    params = _torch_params()
    n = tree_size(params)
    codec = _fleet_codec()
    p_server, hist, strat, clients, cm = _server_run(T)
    j_server, j_hist, _, _, _ = _server_run(J)
    # one full-batch step a round: permutation-invariant, the server's rows
    flat_train = {k: v.reshape((C, 1, STEPS * B) + v.shape[3:]) for k, v in _train_np().items()}
    p_par, _, _ = _run_engine_one_step(codec, "parallel", flat_train)
    p_seq, _, _ = _run_engine_one_step(codec, "sequential", flat_train)
    np.testing.assert_allclose(_vec(p_par), _vec(p_server), **ROUND_TOL)
    np.testing.assert_allclose(_vec(p_seq), _vec(p_par), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_vec(p_server), _vec(j_server, True), **ROUND_TOL)
    mixed_wb = codec.wire_bytes(n)
    props = {c.client_id: c.properties() for c in clients}
    for cid, ins in strat.configure_fit(1, params, [0, 1, 2], client_properties=props):
        res = clients[cid].fit(ins)
        assert isinstance(res.parameters, T.CompressedParameters)
        assert res.parameters.num_bytes == ins.config["codec"].wire_bytes(n) == mixed_wb[cid]
    assert hist.rounds[0].comm_bytes == sum(mixed_wb) + C * cm.update_bytes
    assert hist.rounds[0].comm_bytes == j_hist.rounds[0].comm_bytes


def _run_engine_one_step(codec, mode, train):
    tm = _models()[2]
    spec = T.RoundSpec(max_steps=1, execution_mode=mode, codec=codec)
    rs = T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(), spec)
    p = _torch_params()
    cs = codec.init_client_state(C, tree_size(p), device="cpu")
    w = torch.full((C,), float(STEPS * B))
    bud = torch.ones(C, dtype=torch.int32)
    for rnd in range(2):
        p, _, cs, met = rs(p, (), cs, _t(train), w, bud, rnd)
    return p, cs, met


# ---------------- per-group cost accounting ----------------
def test_cost_model_fleet_uplink_bytes():
    cm = CostModel(profiles=[T.PROFILES[p] for p in FLEET], update_bytes=4_000_000)
    codec, n = _fleet_codec(), 10_000
    assert cm.fleet_uplink_bytes(codec, n, 3) == codec.wire_bytes(n)
    assert cm.fleet_uplink_bytes(T.Int8Codec(), n, 3) == [T.Int8Codec().wire_bytes(n)] * 3
    assert cm.fleet_uplink_bytes(None, n, 3) is None
    with pytest.raises(AssertionError):
        cm.fleet_uplink_bytes(codec, n, 5)


# ---------------- the participation mask (tests/test_scheduler.py's mixed cases) ----------------
SCHED_FLEET = ("pixel-4", "pixel-3", "jetson-tx2-gpu", "tpu-v5e-chip")  # TopK x2, Int8, Null


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_masked_client_leaves_residual_and_aggregate_untouched(mode):
    """Garble a dropped client's data with NaNs: the global and every other
    client's residual rows are bitwise the unmasked-data run's, and the
    dropped client's own row carries unchanged (client 2, the Int8 group's
    one row; client 0, the TopK group's first)."""
    codec = _fleet_codec(profile_names=SCHED_FLEET)
    tm = _models()[2]
    params = _torch_params()
    rs = T.make_round_step(tm.loss_fn, sgd(0.1), T.FedAvg(),
                           T.RoundSpec(max_steps=STEPS, execution_mode=mode, codec=codec))
    batch = _t(_train_np(c=4))
    w = torch.tensor([1.0, 2.0, 1.5, 1.0])
    bud = torch.full((4,), STEPS, dtype=torch.int32)
    cs = codec.init_client_state(4, tree_size(params), device="cpu")
    _, _, cs, _ = rs(params, (), cs, batch, w, bud, 0)  # a carried state first

    for dropped, (g, row) in ((2, (1, 0)), (0, (0, 0))):
        mask = torch.ones(4)
        mask[dropped] = 0.0
        g_a, _, cs_a, _ = rs(params, (), cs, batch, w, bud, 1, mask)
        garbled = {"x": batch["x"].clone(), "y": batch["y"]}
        garbled["x"][dropped] = float("nan")
        g_b, _, cs_b, _ = rs(params, (), cs, garbled, w, bud, 1, mask)
        for a, b in zip(tree_leaves(g_a), tree_leaves(g_b)):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(cs_a), tree_leaves(cs_b)):
            assert torch.equal(a, b)
        assert torch.equal(cs_a[g][row], cs[g][row])
    assert not torch.equal(cs_a[0][1], cs[0][1])  # a live TopK client's row moved


def test_server_population_mode_guards():
    """Population mode needs a cohort size and refuses a MixedCodec: its
    static slots cannot follow a resampled cohort (the twin of
    tests/test_population.py's guards)."""
    pop = T.Population.synthetic(64, seed=0)
    srv = T.Server(strategy=T.FedAvg(), clients=T.LazyClientPool(pop, lambda c: None),
                   population=pop, device="cpu")
    with pytest.raises(ValueError):
        srv.run({}, num_rounds=1)
    srv = T.Server(strategy=T.FedAvg(), clients=T.LazyClientPool(pop, lambda c: None),
                   population=pop, cohort_size=4, device="cpu",
                   codec=T.MixedCodec(codecs=(T.Int8Codec(),), assignment=(0,) * 4))
    with pytest.raises(TypeError, match="MixedCodec"):
        srv.run({}, num_rounds=1)
