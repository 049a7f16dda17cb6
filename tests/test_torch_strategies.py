"""Port parity for the strategy family behind ``Server.run``: FedTau (the
paper's cutoff), FedProx, FedOpt (FedAdam, FedYogi, FedAvgM with Adam and
Yogi) and FedBuff, against the JAX package on the CPU at reduced width.

Both packages start from the JAX init (``params_from_numpy``) and build
their datasets from the same seed.  The virtual clock's time, energy, bytes
and step counts are deterministic arithmetic on identical inputs, so
``History`` must agree exactly; parameters agree within the tolerances of
``test_torch_server.py``: local SGD differs in the last bits (matmul
order), so raw payloads agree to rtol 1e-4 / atol 1e-5 and an Int8 code
on a rounding edge may flip (one block scale a round).
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
from repro.core.cost_model import CostModel as JCostModel
from repro.data.federated import dirichlet_partition as jdirichlet
from repro.data.synthetic import make_features as jmake_features
from repro.models import build_model as jbuild_model
from repro.optim import adam as jadam, adamw as jadamw, sgd as jsgd, yogi as jyogi
import repro_torch.core as T
from repro_torch.configs.base import get_config
from repro_torch.core.cost_model import CostModel as TCostModel
from repro_torch.core.protocol import wire_to_enc
from repro_torch.data.federated import dirichlet_partition
from repro_torch.data.synthetic import make_features
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import adam, adamw, sgd, yogi
from repro_torch.utils.pytree import tree_leaves, tree_map

FLEET = ["jetson-tx2-gpu", "jetson-tx2-cpu", "jetson-tx2-gpu", "tpu-v5e-chip"]


@functools.cache
def _jax_side():
    """One JAX model, loss function and mask for every run here: the JAX
    client keys its jitted local SGD on their ids, so each step count and
    mu compiles once."""
    jm = jbuild_model(jget_config("mobilenet-head-office31").reduced())
    jparams = jm.init(jax.random.key(0))
    return jm, jparams, jm.loss_fn, jm.trainable_mask(jparams)


@functools.cache
def _torch_model():
    return build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")


def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _flat(tree, jax_side):
    leaves = jax.tree.leaves(tree) if jax_side else [t.numpy() for t in tree_leaves(tree)]
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


def _history_equal(jh, th):
    for a, b in zip(jh.rounds, th.rounds, strict=True):
        assert (a.comm_bytes, a.wall_time_s, a.energy_j, a.steps) == (
            b.comm_bytes, b.wall_time_s, b.energy_j, b.steps)
        assert (a.participants, a.dropped, a.staleness_mean) == (
            b.participants, b.dropped, b.staleness_mean)


# ---------------- optimizers ----------------
OPTS = {
    "adam": (lambda: jadam(0.1, b1=0.9, b2=0.99), lambda: adam(0.1, b1=0.9, b2=0.99)),
    "adamw": (lambda: jadamw(0.05), lambda: adamw(0.05)),
    "yogi": (lambda: jyogi(0.1), lambda: yogi(0.1)),
}


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_jax(name):
    """Five steps on one input, the state carried: params and moments
    within rtol 1e-6 (the bias corrections are fp32 in both)."""
    rng = np.random.default_rng(3)
    p = {"a": rng.normal(size=(7, 5)).astype(np.float32),
         "b": rng.normal(size=(11,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 10.0 ** -i for k, v in p.items()}
             for i in range(5)]
    grads[2]["b"][:4] = 0.0  # sign(0) = 0 in Yogi, no movement in Adam's first moment
    jmake, tmake = OPTS[name]
    jopt, topt = jmake(), tmake()
    jp, tp = jax.tree.map(jnp.asarray, p), _t(p)
    js, ts = jopt.init(jp), topt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), jp, js, step)
        with torch.no_grad():
            tp, ts = topt.update(_t(g), tp, ts, step)
    np.testing.assert_allclose(_flat(tp, False), _flat(jp, True), rtol=1e-6, atol=0)
    np.testing.assert_allclose(_flat(ts, False), _flat(js, True), rtol=1e-6, atol=0)


@pytest.mark.parametrize("make_opt", [lambda: sgd(0.1, momentum=0.9), lambda: adam(0.1),
                                      lambda: yogi(0.1)], ids=["sgdm", "adam", "yogi"])
def test_optimizers_minimize_quadratic(make_opt):
    opt = make_opt()
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    with torch.no_grad():
        for i in range(200):
            params, state = opt.update(tree_map(lambda w: 2 * w, params), params, state, i)
    assert float(params["w"].abs().max()) < 0.1


# ---------------- cost model, FedProx, FedBuff, dispatch ----------------
def test_tau_steps_under_budget_match_jax():
    jp, tp = J.PROFILES, T.PROFILES
    jcm = JCostModel(profiles=[jp["jetson-tx2-gpu"], jp["jetson-tx2-cpu"], jp["pixel-2"]],
                     update_bytes=1_000_000)
    tcm = TCostModel(profiles=[tp["jetson-tx2-gpu"], tp["jetson-tx2-cpu"], tp["pixel-2"]],
                     update_bytes=1_000_000)
    for ref, e, spe in (("jetson-tx2-gpu", 10, 78), ("jetson-tx2-gpu", 3, 9),
                        ("jetson-tx2-cpu", 1, 7), ("pixel-4", 5, 4)):
        tau = tcm.tau_for_profile(ref, epochs=e, steps_per_epoch=spe)
        assert tau == jcm.tau_for_profile(ref, epochs=e, steps_per_epoch=spe)
        jtau = T.tau_from_reference_processor(tcm, ref, epochs=e, steps_per_epoch=spe)
        assert jtau == J.tau_from_reference_processor(jcm, ref, epochs=e, steps_per_epoch=spe)
        for mult in (0.0, 0.5, 1.0, 1.12, 3.0):
            for cid in range(4):
                full = e * spe
                assert tcm.steps_under_tau(cid, tau * mult, full) == jcm.steps_under_tau(
                    cid, tau * mult, full)
    tau = tcm.tau_for_profile("jetson-tx2-gpu", epochs=10, steps_per_epoch=78)
    assert tcm.steps_under_tau(0, tau, 780) == 780       # GPU completes
    assert tcm.steps_under_tau(1, tau, 780) < 780        # CPU truncated
    assert tcm.steps_under_tau(1, 0.0, 780) == 780       # tau = 0: no cutoff


def test_fedprox_loss_extra_matches_jax():
    rng = np.random.default_rng(1)
    p = {"w": rng.normal(size=(9, 4)).astype(np.float32), "b": rng.normal(size=3).astype(np.float32)}
    g = {"w": rng.normal(size=(9, 4)).astype(np.float32), "b": rng.normal(size=3).astype(np.float32)}
    for mu in (0.01, 2.0):
        want = float(J.FedProx(mu=mu).client_loss_extra(jax.tree.map(jnp.asarray, p),
                                                        jax.tree.map(jnp.asarray, g)))
        got = float(T.FedProx(mu=mu).client_loss_extra(_t(p), _t(g)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(T.FedProx(mu=2.0).client_loss_extra(
        {"w": torch.ones(2)}, {"w": torch.zeros(2)})) == pytest.approx(2.0)
    assert float(T.FedAvg().client_loss_extra(_t(p), _t(g))) == 0.0


def test_fedbuff_fit_weights_bitwise():
    """The Python float n * (1 / (1 + s) ** alpha), then fp32: the same bits
    as the JAX package's for every staleness the policy admits."""
    ns, ss = [100, 37, 250, 11, 64, 1000, 3], [0, 1, 2, 3, 4, 2, 1]
    for alpha in (0.0, 0.5, 1.0, 0.3):
        jres = [(i, J.FitRes(parameters=None, num_examples=n, staleness=s))
                for i, (n, s) in enumerate(zip(ns, ss))]
        tres = [(i, T.FitRes(parameters=None, num_examples=n, staleness=s))
                for i, (n, s) in enumerate(zip(ns, ss))]
        jw = np.asarray(J.FedBuffStrategy(alpha=alpha)._fit_weights(jres))
        tw = T.FedBuffStrategy(alpha=alpha)._fit_weights(tres, "cpu").numpy()
        assert tw.dtype == np.float32 and tw.tobytes() == jw.tobytes()
    w = T.FedBuffStrategy(alpha=0.5)._fit_weights(tres[:4], "cpu")
    assert float(w[3]) == pytest.approx(11 / 2.0)  # (1 + 3) ** 0.5 = 2
    pol = T.FedBuffStrategy(buffer_size=3, max_staleness=2).make_policy()
    assert (type(pol), pol.buffer_size, pol.max_staleness) == (T.BufferedAsync, 3, 2)


def test_grouped_fit_compatible_matches_jax():
    """Every stock strategy takes the grouped wire reduce; a subclass that
    overrides ``aggregate``, or pairs a stock one with its own
    ``server_update``, densifies."""
    def median(pkg):
        class Median(pkg.FedAvg):
            def aggregate(self, client_params, weights, global_params, server_state, rnd):
                return client_params, server_state
        return Median()

    def custom_update(pkg):
        class Shrink(pkg.FedProx):
            def server_update(self, avg_params, global_params, server_state, rnd):
                return avg_params, server_state
        return Shrink()

    def custom_fedopt(pkg):
        class Opt(pkg.FedOpt):
            def aggregate(self, client_params, weights, global_params, server_state, rnd):
                return global_params, server_state
        return Opt()

    makers = [lambda pkg, k=k: pkg.STRATEGIES[k]() for k in sorted(T.STRATEGIES)]
    makers += [median, custom_update, custom_fedopt]
    got = [m(T)._grouped_fit_compatible() for m in makers]
    assert got == [m(J)._grouped_fit_compatible() for m in makers]
    assert got == [True] * len(T.STRATEGIES) + [False, False, False]


def test_strategies_keys():
    """Every key of the JAX package's STRATEGIES, the population sampler's
    ``costaware-fedavg`` included, each building the same class of
    strategy by name."""
    assert set(T.STRATEGIES) == set(J.STRATEGIES)
    for key, make in T.STRATEGIES.items():
        assert make().name == J.STRATEGIES[key]().name


# ---------------- FedOpt's server state ----------------
def test_fedadam_server_update_three_rounds_matches_jax():
    """``server_update`` over 3 rounds with its state threaded, as the round
    engine calls it: params and moments against JAX (rtol 1e-6); the state
    lives on the params' device and is nonzero after round 2."""
    rng = np.random.default_rng(0)
    gp = {"w": rng.normal(size=(40,)).astype(np.float32),
          "v": rng.normal(size=(3, 5)).astype(np.float32)}
    deltas = [{k: 0.05 * rng.normal(size=v.shape).astype(np.float32) for k, v in gp.items()}
              for _ in range(3)]
    for name in ("fedadam", "fedyogi", "fedavgm"):
        js, ts = J.STRATEGIES[name](server_lr=0.1), T.STRATEGIES[name](server_lr=0.1)
        jp, tp = jax.tree.map(jnp.asarray, gp), _t(gp)
        jstate, tstate = js.init_state(jp), ts.init_state(tp)
        for rnd, d in enumerate(deltas, 1):
            javg = jax.tree.map(lambda p, x: p + jnp.asarray(x), jp, d)
            tavg = tree_map(lambda p, x: p + torch.from_numpy(x), tp, d)
            jp, jstate = js.server_update(javg, jp, jstate, rnd)
            tp, tstate = ts.server_update(tavg, tp, tstate, rnd)
        np.testing.assert_allclose(_flat(tp, False), _flat(jp, True), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_flat(tstate, False), _flat(jstate, True), rtol=1e-6, atol=1e-7)
        assert all(t.device.type == "cpu" and t.dtype == torch.float32
                   for t in tree_leaves(tstate))
        assert any(float(t.abs().sum()) > 0 for t in tree_leaves(tstate))


def _topk_results(pkg, gp, n_clients, seed=0):
    """Clients that each moved the global by seeded noise, shipped as TopK
    10% wires (the same numpy draws for both packages)."""
    rng = np.random.default_rng(seed)
    codec = pkg.TopKCodec(frac=0.1)
    flat_n = sum(int(np.prod(x.shape)) for x in gp.values())
    out = []
    for c in range(n_clients):
        noise = {k: 0.02 * rng.normal(size=v.shape).astype(np.float32) for k, v in gp.items()}
        if pkg is J:
            g = jax.tree.map(jnp.asarray, gp)
            newp = jax.tree.map(lambda x, n: x + jnp.asarray(n), g, noise)
        else:
            g = _t(gp)
            newp = tree_map(lambda x, n: x + torch.from_numpy(n), g, noise)
        enc, _ = pkg.compress_update(codec, newp, g)
        out.append((c, pkg.FitRes(parameters=pkg.compress_to_wire(codec, enc, flat_n),
                                  num_examples=10 + 3 * c)))
    return out


def test_fedadam_topk_sparse_keeps_exact_zeros():
    """FedAdam over the grouped TopK reduce: the pseudo-gradient is EXACTLY
    zero where no client sent a value, so Adam leaves those coordinates
    bitwise unchanged (the densify path's fp noise would move them by an
    lr-scale sign step); the sent coordinates match JAX."""
    rng = np.random.default_rng(5)
    gp = {"w": rng.normal(size=(300,)).astype(np.float32)}
    tres, jres = _topk_results(T, gp, 4), _topk_results(J, gp, 4)
    ts, js = T.FedAdam(), J.FedAdam()
    tw = ts._fit_weights(tres, "cpu")
    grouped = ts._aggregate_fit_wire(0, tres, tw, _t(gp), ts.init_state(_t(gp)))
    assert grouped is not None, "a TopK-only fleet must take the grouped wire path"
    out = grouped[0]["w"].numpy()
    touched = np.zeros(300, bool)
    for _, res in tres:
        touched[wire_to_enc(res.parameters, "cpu")["idx"].numpy()] = True
    assert 0 < touched.sum() < 300
    assert out[~touched].tobytes() == gp["w"][~touched].tobytes()
    jout = np.asarray(js.aggregate_fit(0, jres, jax.tree.map(jnp.asarray, gp))["w"])
    np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-7)
    # aggregate_fit takes the same path and returns the same bits
    assert T.FedAdam().aggregate_fit(0, tres, _t(gp))["w"].numpy().tobytes() == out.tobytes()


# ---------------- Server.run, the whole slice ----------------
def _strategy(pkg, name, cm, spe):
    """The strategy under test, the same config in both packages."""
    if name == "fedtau":
        tau = cm.tau_for_profile("jetson-tx2-gpu", epochs=2, steps_per_epoch=spe)
        return pkg.FedTau(local_epochs=2, local_lr=0.1, tau_s=tau, cost_model=cm,
                          steps_per_epoch=spe)
    if name == "fedprox":
        return pkg.FedProx(local_epochs=2, local_lr=0.1, mu=0.5)
    if name == "fedbuff":
        return pkg.FedBuffStrategy(local_epochs=2, local_lr=0.1, buffer_size=2, max_staleness=2)
    return pkg.STRATEGIES[name](local_epochs=2, local_lr=0.1)


def _run(pkg, name, *, codecs, rounds, deadline=False):
    jm, jparams, loss_fn, mask = _jax_side()
    if pkg is J:
        data = jmake_features(n=600, num_classes=31, feature_dim=jm.cfg.feature_dim, seed=0)
        shards = jdirichlet(data, n_clients=len(FLEET), alpha=1.0, seed=0)
        params, Client, extra = jparams, J.JaxClient, {}
    else:
        m = _torch_model()
        data = make_features(n=600, num_classes=31, feature_dim=m.cfg.feature_dim, seed=0)
        shards = dirichlet_partition(data, n_clients=len(FLEET), alpha=1.0, seed=0)
        params, Client, extra = _t(jparams), T.TorchClient, {"device": "cpu"}
        loss_fn, mask = m.loss_fn, m.trainable_mask(params)
    clients = [
        Client(client_id=s.client_id, loss_fn=loss_fn, dataset=s, batch_size=32,
               trainable_mask=mask, device_profile=prof, **extra)
        for s, prof in zip(shards, FLEET)
    ]
    cm = pkg.make_cost_model_for(params, [pkg.PROFILES[p] for p in FLEET])
    strategy = _strategy(pkg, name, cm, clients[0].steps_per_epoch())
    if codecs:
        strategy.codec_policy = pkg.BandwidthCodecPolicy()
    policy = (strategy.make_policy() if name == "fedbuff"
              else pkg.Deadline() if deadline else None)
    server = pkg.Server(strategy=strategy, clients=clients, cost_model=cm, policy=policy,
                        **extra)
    server.logger.quiet = True
    final, hist = server.run(params, num_rounds=rounds)
    return final, hist, strategy


RUNS = [("fedtau", False), ("fedtau", True), ("fedtau-deadline", False), ("fedprox", False),
        ("fedprox", True), ("fedadam", False), ("fedadam", True), ("fedyogi", False),
        ("fedyogi", True), ("fedavgm", False), ("fedavgm", True), ("fedbuff", False),
        ("fedbuff", True)]


@pytest.mark.parametrize("name,codecs", RUNS,
                         ids=[f"{n}-{'int8-null' if c else 'raw'}" for n, c in RUNS])
def test_server_run_matches_jax(name, codecs):
    """Three rounds of the Jetson/TPU fleet, raw pytrees or under
    ``BandwidthCodecPolicy`` (Jetsons Int8, the TPU-class client Null)."""
    deadline = name.endswith("-deadline")
    name = name.removesuffix("-deadline")
    jfinal, jh, js = _run(J, name, codecs=codecs, rounds=3, deadline=deadline)
    tfinal, th, ts = _run(T, name, codecs=codecs, rounds=3, deadline=deadline)
    _history_equal(jh, th)
    jf, tf = _flat(jfinal, True), _flat(tfinal, False)
    if codecs:
        init = _flat(_jax_side()[1], True)
        block_scale = np.abs(jf - init).max() / 127
        np.testing.assert_allclose(tf, jf, rtol=0, atol=3 * block_scale)
    else:
        np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-5)
    for a, b in zip(jh.rounds, th.rounds):
        np.testing.assert_allclose(b.train_loss, a.train_loss, rtol=1e-4)
        np.testing.assert_allclose(b.eval_acc, a.eval_acc, atol=0.02)
    if name == "fedtau":  # the jetson-tx2-cpu client's budget is below the GPUs'
        budgets = ts.client_step_budgets(range(len(FLEET)))
        assert budgets[1] < budgets[0] == 2 * ts.steps_per_epoch
    if name == "fedbuff":
        assert any(r.staleness_mean > 0 for r in th.rounds)
    if isinstance(ts, T.FedOpt):  # the moments, carried across rounds, as the params
        assert any(float(t.abs().sum()) > 0 for t in tree_leaves(ts._server_state))
        np.testing.assert_allclose(_flat(ts._server_state, False),
                                   _flat(js._server_state, True), rtol=1e-4, atol=1e-5)


# ---------------- the round engine ----------------
def test_fedadam_round_step_matches_jax():
    """FedAdam through ``make_round_step`` (parallel, Int8), 3 rounds with
    the server state and residuals threaded, against JAX's jitted step.
    Local SGD differs in the last bits, so an Int8 code on a rounding edge
    may flip and move the pseudo-gradient by one block scale; Adam turns
    that into a bounded move of its coordinate.  The params are held as
    the Server.run tests hold them (three block scales of the run's own
    movement), each moment at three of its own block scales."""
    jm, jparams, _, _ = _jax_side()
    tm = _torch_model()
    C, STEPS, B = 3, 2, 8
    jrs = jax.jit(J.make_round_step(jm.loss_fn, jsgd(0.1), J.FedAdam(), J.RoundSpec(
        max_steps=STEPS, execution_mode="parallel", codec=J.Int8Codec())))
    tstrat = T.FedAdam()
    trs = T.make_round_step(tm.loss_fn, sgd(0.1), tstrat, T.RoundSpec(
        max_steps=STEPS, execution_mode="parallel", codec=T.Int8Codec()))
    n = sum(x.size for x in jax.tree.leaves(jparams))
    weights, budgets = np.asarray([1.0, 2.0, 0.5], np.float32), np.asarray([2, 1, 2], np.int32)
    jp, tp = jparams, _t(jparams)
    js, ts = J.FedAdam().init_state(jp), tstrat.init_state(tp)
    jc = J.Int8Codec().init_client_state(C, n)
    tc = T.Int8Codec().init_client_state(C, n, device="cpu")
    rng = np.random.default_rng(0)
    for rnd in range(3):
        b = {"x": rng.normal(size=(C, STEPS, B, 64)).astype(np.float32),
             "y": rng.integers(0, 31, (C, STEPS, B)).astype(np.int32)}
        jp, js, jc, _ = jrs(jp, js, jc, jax.tree.map(jnp.asarray, b), jnp.asarray(weights),
                            jnp.asarray(budgets), rnd)
        tp, ts, tc, _ = trs(tp, ts, tc, {k: torch.from_numpy(v) for k, v in b.items()},
                            torch.from_numpy(weights), torch.from_numpy(budgets), rnd)
    jf = _flat(jp, True)
    block_scale = np.abs(jf - _flat(jparams, True)).max() / 127
    np.testing.assert_allclose(_flat(tp, False), jf, rtol=0, atol=3 * block_scale)
    for key in ("m", "v"):
        jmom = _flat(js[key], True)
        np.testing.assert_allclose(_flat(ts[key], False), jmom, rtol=0,
                                   atol=3 * np.abs(jmom).max() / 127)
    assert all(t.device.type == "cpu" for t in tree_leaves(ts))
    assert float(ts["m"]["head"]["w2"].abs().sum()) > 0
