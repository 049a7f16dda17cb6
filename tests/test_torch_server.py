"""Port parity for the whole slice: ``Server.run`` + ``FedAvg`` + the
Int8/Null uplink with its grouped wire reduce, the cost model and the
scheduler, against the JAX package on the same seeds.

Both packages start from the JAX init (``params_from_numpy``) and build
their datasets separately from the same seed.  The virtual clock's time,
energy and bytes are deterministic arithmetic on identical inputs, so
``History`` must agree exactly; parameters agree to the stated tolerance.
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
from repro.data.federated import dirichlet_partition as jdirichlet
from repro.data.synthetic import make_features as jmake_features
from repro.models import build_model as jbuild_model
import repro_torch.core as T
from repro_torch.configs.base import get_config
from repro_torch.data.federated import dirichlet_partition
from repro_torch.data.synthetic import make_features
from repro_torch.models import build_model, params_from_numpy
from repro_torch.utils.pytree import tree_leaves, tree_map

FLEET = ["jetson-tx2-gpu", "jetson-tx2-cpu", "jetson-tx2-gpu", "tpu-v5e-chip"]


@functools.cache
def _jax_side():
    """One JAX model, loss function and trainable mask for every run here:
    the JAX client keys its jitted local SGD on their ids, so reusing them
    compiles each step count once instead of once per run."""
    jm = jbuild_model(jget_config("mobilenet-head-office31").reduced())
    jparams = jm.init(jax.random.key(0))
    return jm, jparams, jm.loss_fn, jm.trainable_mask(jparams)


def _jax_init():
    jm, jparams, _, _ = _jax_side()
    return jm, jparams


def _flat(tree, jax_side):
    leaves = jax.tree.leaves(tree) if jax_side else [t.numpy() for t in tree_leaves(tree)]
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


def _history_equal(jh, th):
    for a, b in zip(jh.rounds, th.rounds, strict=True):
        assert (a.comm_bytes, a.wall_time_s, a.energy_j, a.steps) == (
            b.comm_bytes, b.wall_time_s, b.energy_j, b.steps
        )
        assert (a.participants, a.dropped) == (b.participants, b.dropped)


# ---------------- 1: fixed-delta clients, Int8 + Null fleet ----------------
def _fixed_delta_client(pkg, cid, delta, profile):
    """A deterministic client: global + its fixed delta, shipped through
    the codec the strategy chose (no training, no residual)."""

    class _Fixed(pkg.Client):
        def properties(self):
            prof = pkg.PROFILES[profile]
            return pkg.ClientProperties(
                client_id=cid, device_profile=profile,
                uplink_mbps=prof.uplink_mbps, downlink_mbps=prof.downlink_mbps,
            )

        def fit(self, ins):
            add = jnp.add if pkg is J else torch.add
            tm = jax.tree.map if pkg is J else tree_map
            newp = tm(add, ins.parameters, delta)
            codec = ins.config["codec"]
            enc, _ = pkg.compress_update(codec, newp, ins.parameters)
            n = sum(int(np.prod(x.shape)) for x in (
                jax.tree.leaves(newp) if pkg is J else tree_leaves(newp)))
            return pkg.FitRes(
                parameters=pkg.compress_to_wire(codec, enc, n),
                num_examples=10 * (cid + 1), metrics={"loss": 1.0, "steps_done": 1},
            )

        def evaluate(self, ins):
            return pkg.EvaluateRes(loss=1.0, num_examples=1, metrics={"acc": 0.0})

    return _Fixed()


def test_fixed_delta_int8_null_fleet_matches_jax():
    jm, jparams = _jax_init()
    rng = np.random.default_rng(0)
    deltas = [
        jax.tree.map(lambda x: (rng.normal(size=x.shape) * 1e-2).astype(np.float32), jparams)
        for _ in FLEET
    ]
    runs = {}
    for pkg in (J, T):
        clients = [
            _fixed_delta_client(
                pkg, cid,
                jax.tree.map(jnp.asarray, d) if pkg is J else params_from_numpy(d, "cpu"),
                prof,
            )
            for cid, (d, prof) in enumerate(zip(deltas, FLEET))
        ]
        params = (jparams if pkg is J
                  else params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))
        cm = pkg.make_cost_model_for(params, [pkg.PROFILES[p] for p in FLEET])
        kw = {} if pkg is J else {"device": "cpu"}
        server = pkg.Server(
            strategy=pkg.FedAvg(codec_policy=pkg.BandwidthCodecPolicy()),
            clients=clients, cost_model=cm, **kw,
        )
        server.logger.quiet = True
        runs[pkg] = server.run(params, num_rounds=3)
    (jfinal, jh), (tfinal, th) = runs[J], runs[T]
    np.testing.assert_allclose(_flat(tfinal, False), _flat(jfinal, True), rtol=0, atol=1e-6)
    _history_equal(jh, th)
    n = sum(x.size for x in jax.tree.leaves(jparams))
    codecs = T.BandwidthCodecPolicy()
    assert th.rounds[0].comm_bytes == (
        3 * codecs.int8.wire_bytes(n) + codecs.null.wire_bytes(n) + 4 * 4 * n
    )


# ---------------- 2-3: training clients ----------------
def _run(pkg, jparams, *, policy_codecs, rounds, policy=None, trace_seed=None):
    if pkg is J:
        jm, _, loss_fn, mask = _jax_side()
        data = jmake_features(n=600, num_classes=31, feature_dim=jm.cfg.feature_dim, seed=0)
        shards = jdirichlet(data, n_clients=len(FLEET), alpha=1.0, seed=0)
        params = jparams
    else:
        m = build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")
        data = make_features(n=600, num_classes=31, feature_dim=m.cfg.feature_dim, seed=0)
        shards = dirichlet_partition(data, n_clients=len(FLEET), alpha=1.0, seed=0)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        loss_fn, mask = m.loss_fn, m.trainable_mask(params)
    Client = J.JaxClient if pkg is J else T.TorchClient
    extra = {} if pkg is J else {"device": "cpu"}
    clients = [
        Client(client_id=s.client_id, loss_fn=loss_fn, dataset=s, batch_size=32,
               trainable_mask=mask, device_profile=prof, **extra)
        for s, prof in zip(shards, FLEET)
    ]
    profiles = [pkg.PROFILES[p] for p in FLEET]
    cm = pkg.make_cost_model_for(params, profiles)
    strategy = pkg.FedAvg(
        local_epochs=2, local_lr=0.1,
        codec_policy=pkg.BandwidthCodecPolicy() if policy_codecs else None,
    )
    trace = (None if trace_seed is None
             else pkg.AvailabilityTrace.from_profiles(profiles, seed=trace_seed, plugged_dropout=0.3))
    server = pkg.Server(strategy=strategy, clients=clients, cost_model=cm,
                        policy=policy, availability=trace, **extra)
    server.logger.quiet = True
    return server.run(params, num_rounds=rounds)


def test_training_int8_null_fleet_matches_jax():
    """3 Jetson clients on Int8 + 1 TPU-class client on Null, 3 rounds of
    local SGD.  Int8 codes are bitwise for bitwise inputs, but local SGD
    differs in the last bits (matmul order), so a delta on a rounding edge
    can flip one code: ``atol`` is one Int8 block scale per round."""
    _, jparams = _jax_init()
    jfinal, jh = _run(J, jparams, policy_codecs=True, rounds=3)
    tfinal, th = _run(T, jparams, policy_codecs=True, rounds=3)
    _history_equal(jh, th)
    init = _flat(jparams, True)
    jf, tf = _flat(jfinal, True), _flat(tfinal, False)
    block_scale = np.abs(jf - init).max() / 127
    np.testing.assert_allclose(tf, jf, rtol=0, atol=3 * block_scale)
    for a, b in zip(jh.rounds, th.rounds):
        np.testing.assert_allclose(b.train_loss, a.train_loss, rtol=1e-4)
        np.testing.assert_allclose(b.eval_acc, a.eval_acc, atol=0.02)
    assert th.rounds[-1].eval_acc > th.rounds[0].eval_acc
    assert th.final_accuracy() == th.rounds[-1].eval_acc
    assert [r for r, _ in th.accuracy_series()] == [1, 2, 3]
    assert th.time_to_accuracy(0.0) == th.rounds[0].wall_time_s == jh.time_to_accuracy(0.0)
    assert (th.total_time_s, th.total_energy_j) == (jh.total_time_s, jh.total_energy_j)
    n = init.size
    policy = T.BandwidthCodecPolicy()
    assert th.rounds[0].comm_bytes == (
        3 * policy.int8.wire_bytes(n) + policy.null.wire_bytes(n) + 4 * 4 * n
    )


@pytest.mark.parametrize(
    "policy,trace_seed",
    [(None, None), ("deadline", 1), ("buffered", None)],
    ids=["syncall", "deadline-churn", "buffered-async"],
)
def test_raw_pytree_fleet_matches_jax(policy, trace_seed):
    """No codec: raw params up, the leafwise weighted mean.  Under a
    Deadline with availability churn the clients truncate to the cutoff
    and stragglers are dropped; BufferedAsync carries stale arrivals."""
    _, jparams = _jax_init()
    pol = {
        None: lambda pkg: None,
        "deadline": lambda pkg: pkg.Deadline(tau=0.153 * 2 * 4 + 0.05),
        "buffered": lambda pkg: pkg.BufferedAsync(buffer_size=2, max_staleness=1),
    }[policy]
    rounds = 3 if policy is None else 2
    jfinal, jh = _run(J, jparams, policy_codecs=False, rounds=rounds, policy=pol(J), trace_seed=trace_seed)
    tfinal, th = _run(T, jparams, policy_codecs=False, rounds=rounds, policy=pol(T), trace_seed=trace_seed)
    _history_equal(jh, th)
    if policy is not None:  # the scheduler really dropped or carried someone
        assert any(r.dropped or r.staleness_mean for r in th.rounds)
    np.testing.assert_allclose(_flat(tfinal, False), _flat(jfinal, True), rtol=1e-4, atol=1e-5)


def test_cost_model_matches_jax():
    """The port's cost model is the JAX package's list-of-clients surface:
    the same charges, wasted-work windows, churn draws and uplink fallback,
    exactly."""
    profiles = [J.PROFILES[p] for p in FLEET]
    jcm = J.CostModel(profiles=profiles, update_bytes=4 * 7_007)
    tcm = T.CostModel(profiles=[T.PROFILES[p] for p in FLEET], update_bytes=4 * 7_007)
    for cid, steps, up, jit in ((0, 10, None, 1.0), (3, 4, 1_234, 1.3), (5, 0, 99, 0.7)):
        jc = jcm.client_round_cost(cid, steps, uplink_bytes=up, jitter=jit)
        tc = tcm.client_round_cost(cid, steps, uplink_bytes=up, jitter=jit)
        assert (tc.profile, tc.t_total_s, tc.e_total_j) == (jc.profile, jc.t_total_s, jc.e_total_j)
        for frac in (0.0, 0.01, 0.5, 1.0, 2.0):
            w = frac * jc.t_total_s
            assert tcm.wasted_energy(tc, w) == jcm.wasted_energy(jc, w)
    for kw in ({}, {"late_join": 2, "jitter_std": 0.2, "plugged_dropout": 0.3}):
        jt = J.AvailabilityTrace.from_profiles(profiles, seed=5, **kw)
        tt = T.AvailabilityTrace.from_profiles(profiles, seed=5, **kw)
        for rnd in range(1, 5):
            np.testing.assert_array_equal(tt.available(rnd), jt.available(rnd))
            np.testing.assert_array_equal(tt.step_jitter(rnd), jt.step_jitter(rnd))
    codec = T.Int8Codec()
    assert T.CostModel.fleet_uplink_bytes(codec, 7_007, 3) == J.CostModel.fleet_uplink_bytes(
        J.Int8Codec(), 7_007, 3)
    assert T.CostModel.fleet_uplink_bytes(None, 7_007, 3) is None


def test_client_sampling_bitwise():
    for frac in (0.5, 0.3, 1.0):
        js, ts = J.FedAvg(fraction_fit=frac, seed=7), T.FedAvg(fraction_fit=frac, seed=7)
        for rnd in range(1, 6):
            assert ts.sample_clients(rnd, list(range(11))) == js.sample_clients(rnd, list(range(11)))


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Server(strategy=T.FedAvg(), clients=[]).run({"w": torch.zeros(2)}, 1)
