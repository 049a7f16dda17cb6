"""Port parity for the mesh round step (``core/rounds.py`` with a
``launch.mesh.ClientMesh``): the port's 4-rank gloo mesh against the JAX
package's shard_map round step on ``jax.make_mesh((2, 2), ("pod", "data"))``
(conftest forces 8 host devices), for the fp32 and int8 collectives with
the Null, Int8 and TopK uplink codecs, 3 rounds with client 0 masked in
round 2, from the same JAX-initialized params and numpy batches.

One module-scoped 4-rank job (``torch_mesh_ranks.mesh_rounds``) runs every
case, then the reduced ResNet's int8 collective with the Int8 uplink (its
20 leaves; ``RESNET_CASE``, held by its own tolerances below); its ranks
import no JAX.  JAX outputs go through ``np.asarray``
before any indexing: indexing a mesh-sharded array directly raises
``ShardingTypeError`` under jax 0.9.

Each round is compared from the same inputs: JAX's round step starts from
the state the port's round started from (params, codec and collective
residual rows), so a difference cannot carry into later rounds, and the
ranks log what they fed ``ops.collective_pack_leaves`` (per leaf their
padded ``eff`` and its shared scales) and ``ops.quantize_int8`` (the Int8
uplink's value and scales).

Tolerances:
- params and residual rows ``rtol=atol=1e-6``, metrics ``rtol=1e-5``,
  except where a code differs.  A code differs only where the value sits
  on a half-way point of its grid: Int8-decoded values are integer ratios
  of one another, so value / shared scale can sit exactly on .5, and
  JAX's jitted ``/ 127`` scales, one ulp off their eager values, tip
  round-half-even there.
- So the residual rows are read in units of their block scale s, with
  ``CODE_EPS = 2e-3``: an equal code moves a residual entry by at most
  ``CODE_EPS`` (SGD's last bits; under 6e-4 seen), a differing uplink code
  by one s (within ``CODE_EPS``), and a differing collective code moves
  what the rank sent by exactly one s.  A code may differ only on its own
  half-way point (within ``CODE_EPS``), or in the collective where a
  differing uplink code moved the value, by at most that move / s + 1.
  A TopK selection on its edge moves its value between wire and residual.
  At most ``MAX_FLIPS`` codes differ a round (5 in all were seen: 4
  collective, 1 uplink).
- Params may then differ by 1e-6 plus, per entry, each differing code's
  scale (times its weight share for the uplink), over the weight sum; the
  residual-norm metrics by the mean norm of the rows' per-entry bounds.
- ``test_mesh_int8_collective_is_the_reference_psum`` rebuilds every int8
  round from the logged ``eff`` with the JAX package's reference kernels:
  scales, residual rows and the new global bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import repro.core as J
from repro.configs.base import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.optim import sgd as jsgd
import repro_torch.core as T
import torch_mesh_ranks
from repro_torch.configs.base import get_config
from repro_torch.launch import ClientMesh, run_local_mesh
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import sgd

C, STEPS, B = 4, 2, 8
AXES = ("pod", "data")
HEAD, RESNET = "mobilenet-head-office31", "resnet18-cifar10"
# the reduced ResNet's case (its 20 leaves through the int8 collective),
# keyed apart from the head model's (collective, codec) cases
RESNET_CASE = ("resnet", "int8", "Int8Codec")
WEIGHTS = np.asarray([1.0, 2.0, 3.0, 1.0], np.float32)   # example counts: exact sums
BUDGETS = np.asarray([2, 1, 2, 2], np.int32)             # client 1 stops after one step
MASKS = [np.ones(C, np.float32), np.asarray([0.0, 1.0, 1.0, 1.0], np.float32),
         np.ones(C, np.float32)]
CODECS = ["NullCodec", "Int8Codec", "TopKCodec"]
CASES = [(coll, codec) for coll in ("fp32", "int8") for codec in CODECS]
BLOCK = 256
CODE_EPS = 2e-3  # in block scales (module docstring)
MAX_FLIPS = 16   # differing codes a round, of C x 7,199 entries


def _arch(case) -> str:
    return RESNET if case[0] == "resnet" else HEAD


@functools.cache
def _jax_model(arch=HEAD):
    jm = jbuild_model(jget_config(arch).reduced())
    return jm, jm.init(jax.random.key(0))


def _batches(arch=HEAD):
    rng = np.random.default_rng(0)
    if arch == RESNET:  # NHWC images, 4 a batch
        return {"x": rng.normal(size=(C, STEPS, 4, 32, 32, 3)).astype(np.float32),
                "y": rng.integers(0, 10, (C, STEPS, 4)).astype(np.int32)}
    return {
        "x": rng.normal(size=(C, STEPS, B, 64)).astype(np.float32),
        "y": rng.integers(0, 31, (C, STEPS, B)).astype(np.int32),
    }


def _jmesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs >=4 host devices (see conftest.py)")
    return jax.make_mesh((2, 2), AXES)


@pytest.fixture(scope="module")
def port_run():
    """Every case on the port's 4-rank gloo mesh, in one spawn: the head
    model's, then the reduced ResNet's."""
    runs = [(prefix, arch, cases, jax.tree.map(np.asarray, _jax_model(arch)[1]),
             _batches(arch), WEIGHTS, BUDGETS, MASKS, STEPS)
            for prefix, arch, cases in (((), HEAD, CASES),
                                        (RESNET_CASE[:1], RESNET, [RESNET_CASE[1:]]))]
    return run_local_mesh(
        torch_mesh_ranks.mesh_rounds, pod=2, data=2, backend="gloo", device="cpu",
        args=(runs,), timeout_s=240,
    )


@functools.cache
def _jax_step(collective, codec_name, arch=HEAD):
    jm, _ = _jax_model(arch)
    spec = J.RoundSpec(max_steps=STEPS, execution_mode="parallel",
                       codec=getattr(J, codec_name)(), collective=collective)
    return jax.jit(J.make_round_step(jm.loss_fn, jsgd(0.1), J.FedAvg(), spec, mesh=_jmesh(),
                                     client_axes=AXES))


def _port_rows(port_run, case, rnd, key):
    """(C, ...) rows per state leaf, assembled from the ranks (rank = client)."""
    per_rank = [port_run[r][case]["rounds"][rnd][key] for r in range(C)]
    return [np.stack([rows[i] for rows in per_rank]) for i in range(len(per_rank[0]))]


def _port_start(port_run, case, rnd):
    """What the port's round ``rnd`` started from, as numpy: flat params,
    and the codec and collective residual rows (C, ...) per state leaf."""
    collective, codec_name = case[-2:]
    _, jparams = _jax_model(_arch(case))
    n = sum(x.size for x in jax.tree.leaves(jparams))
    if rnd == 0:
        codec_rows = [np.asarray(x).reshape(C, -1) for x in
                      jax.tree.leaves(getattr(J, codec_name)().init_client_state(C, n))]
        coll_rows = ([np.zeros((C, x.size), np.float32) for x in jax.tree.leaves(jparams)]
                     if collective == "int8" else [])
        flat = np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree.leaves(jparams)])
        return flat, codec_rows, coll_rows
    prev = port_run[0][case]["rounds"][rnd - 1]
    return (prev["params"], _port_rows(port_run, case, rnd - 1, "codec_row"),
            _port_rows(port_run, case, rnd - 1, "coll_row"))


def _unflatten_like(tree, flats):
    leaves, treedef = jax.tree.flatten(tree)
    return jax.tree.unflatten(treedef, [jnp.asarray(f).reshape(x.shape)
                                        for f, x in zip(flats, leaves, strict=True)])


def _jax_round(port_run, case, rnd):
    """JAX's mesh round step ``rnd`` from the state the port's round
    ``rnd`` started from: flat params, metrics, and the codec and
    collective residual rows (C, ...) as numpy.  Each round is compared
    from the same inputs, so a difference cannot carry into later rounds."""
    collective, codec_name = case[-2:]
    _, jparams = _jax_model(_arch(case))
    n = sum(x.size for x in jax.tree.leaves(jparams))
    flat, codec_rows, coll_rows = _port_start(port_run, case, rnd)
    sizes = np.cumsum([x.size for x in jax.tree.leaves(jparams)])[:-1]
    g = _unflatten_like(jparams, np.split(flat, sizes))
    state = _unflatten_like(getattr(J, codec_name)().init_client_state(C, n), codec_rows)
    if collective == "int8":
        state = (state, _unflatten_like(J.init_collective_residual(jparams, C), coll_rows))
    batch = jax.tree.map(jnp.asarray, _batches(_arch(case)))
    g, _, state, met = _jax_step(collective, codec_name, _arch(case))(
        g, (), state, batch, jnp.asarray(WEIGHTS), jnp.asarray(BUDGETS), rnd,
        jnp.asarray(MASKS[rnd]))
    codec_state, coll = state if collective == "int8" else (state, ())
    return {
        "params": np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree.leaves(g)]),
        "metrics": {k: float(np.asarray(v)) for k, v in met.items()},
        "codec_rows": [np.asarray(x).reshape(C, -1) for x in jax.tree.leaves(codec_state)],
        "coll_rows": [np.asarray(x).reshape(C, -1) for x in jax.tree.leaves(coll)],
    }


def _log_rows(port_run, case, rnd, key, item, sizes):
    """One logged array of every rank, split per model leaf: ``item`` 0 is
    the value the op got (``collective_pack_leaves``' padded, the uplink's
    ``quantize_int8``'s not), 1 its block scales repeated onto the value's
    entries.  ``key`` "coll_log" holds one entry per leaf,
    "uplink_log" one for the whole flat delta."""
    per_rank = []
    for r in range(C):
        log = port_run[r][case]["rounds"][rnd][key]
        if key == "uplink_log":
            x, s = log[0]
            vals = (x if item == 0 else np.repeat(s, BLOCK))[:sum(sizes)]
            per_rank.append([vals])
        else:
            per_rank.append([(x if item == 0 else np.repeat(s, BLOCK))[:n]
                             for (x, s), n in zip(log, sizes, strict=True)])
    return [np.stack([rows[i] for rows in per_rank]) for i in range(len(per_rank[0]))]


def _on_half_way(x):
    """How far each value sits from a half-way point of the integer grid."""
    return np.abs(x - np.floor(x) - 0.5)


def _uplink_gap(port_run, case, rnd, got_rows, want_rows):
    """The uplink codes or selections that differ between the packages.

    Both packages quantize the same client value up to SGD's last bits, so
    a decoded delta differs only where a code differs, by the opposite of
    the residual's change (decoded = value - residual).  Returns, per
    entry (C, N): that decoded-delta gap, and an a-priori bound on the
    residual gap (for the residual-norm metric); asserts each differing
    Int8 code moved its residual by one block scale, sits on a half-way
    point, and that few differ."""
    if not got_rows:  # NullCodec: no state, decoded = delta
        return 0.0, None
    (a,), (b,) = got_rows, want_rows
    if case[1] == "TopKCodec":
        # a selection on its edge: the value moves between wire and residual
        differs = (a == 0) != (b == 0)
        assert int(differs.sum()) <= MAX_FLIPS, f"{int(differs.sum())} selections differ"
        np.testing.assert_allclose(np.where(differs, 0, a), np.where(differs, 0, b),
                                   rtol=1e-6, atol=1e-6)
        return -(a - b) * differs, np.where(differs, np.abs(a - b), 1e-6 + 1e-6 * np.abs(b))
    sizes = [a.shape[1]]
    (s,) = _log_rows(port_run, case, rnd, "uplink_log", 1, sizes)
    (x,) = _log_rows(port_run, case, rnd, "uplink_log", 0, sizes)
    d = (a - b) / s
    flips = np.abs(d) > 0.5
    assert np.all(np.where(flips, np.abs(np.abs(d) - 1.0), np.abs(d)) <= CODE_EPS), (
        f"round {rnd}: an uplink residual entry moved by {np.abs(d).max()} scales")
    assert int(flips.sum()) <= MAX_FLIPS, f"round {rnd}: {int(flips.sum())} uplink codes differ"
    assert np.all(_on_half_way(x / s)[flips] <= CODE_EPS)
    return -(a - b) * flips, np.where(flips, 1 + CODE_EPS, CODE_EPS) * s


@pytest.mark.parametrize("collective,codec_name", CASES)
def test_mesh_round_step_matches_jax(port_run, collective, codec_name):
    """Each round, from the state the port's round started from, against
    JAX's (module docstring): params, metrics and every client's codec and
    collective residual rows."""
    case = (collective, codec_name)
    _, jparams = _jax_model()
    sizes = [x.size for x in jax.tree.leaves(jparams)]
    splits = np.cumsum(sizes)[:-1]
    differing = 0
    for rnd in range(len(MASKS)):
        w_eff = WEIGHTS * MASKS[rnd]
        want = _jax_round(port_run, case, rnd)
        got = port_run[0][case]["rounds"][rnd]
        for r in range(1, C):  # the new global is replicated bitwise on every rank
            np.testing.assert_array_equal(port_run[r][case]["rounds"][rnd]["params"],
                                          got["params"])
        assert set(got["metrics"]) == set(want["metrics"])
        codec_rows = _port_rows(port_run, case, rnd, "codec_row")
        assert len(codec_rows) == len(want["codec_rows"])
        dec_gap, up_bound = _uplink_gap(port_run, case, rnd, codec_rows, want["codec_rows"])
        wsum = float(w_eff.sum())
        atol = {}
        if up_bound is not None:
            atol["residual_norm_mean"] = float(np.mean(np.linalg.norm(up_bound, axis=1)))
        if collective == "fp32":
            # a decoded delta that differs moves the sum by its weight share
            allowed = np.abs(w_eff @ np.broadcast_to(dec_gap, (C, len(got["params"]))))
        else:
            # the collective codes: sent = eff - residual = code * s, and
            # eff moves by w * the decoded-delta gap, so
            # k = (w * gap - residual gap) / s counts the codes that differ
            scales = _log_rows(port_run, case, rnd, "coll_log", 1, sizes)
            effs = _log_rows(port_run, case, rnd, "coll_log", 0, sizes)
            gaps = np.split(np.broadcast_to(dec_gap, (C, sum(sizes))) * w_eff[:, None],
                            splits, axis=1)
            coll_rows = _port_rows(port_run, case, rnd, "coll_row")
            allowed, bounds = [], []
            for a, b, s, eff, gap in zip(coll_rows, want["coll_rows"], scales, effs, gaps,
                                         strict=True):
                k = (gap - (a - b)) / s
                codes = np.rint(k)
                assert np.all(np.abs(k - codes) <= CODE_EPS), (
                    f"round {rnd}: a collective residual entry is off the code grid by "
                    f"{np.abs(k - codes).max()} scales")
                moved = gap != 0
                # a code differs on its own only on a half-way point, by one
                lone = (codes != 0) & ~moved
                assert np.all(np.abs(codes[lone]) == 1)
                assert np.all(_on_half_way(eff / s)[lone] <= CODE_EPS)
                assert np.all(np.abs(codes) <= np.abs(gap) / s + 1)
                differing += int((codes != 0).sum())
                allowed.append((np.abs(codes) * s * (1 + CODE_EPS)).sum(axis=0))
                bounds.append(np.abs(gap) + (np.abs(codes) + CODE_EPS) * s)
            allowed = np.concatenate(allowed)
            # |d mean of row norms| <= mean of the rows' difference norms
            atol["collective_residual_norm_mean"] = float(np.mean(np.concatenate(
                [np.linalg.norm(bd, axis=1) for bd in bounds])))
        err = np.abs(got["params"] - want["params"])
        assert np.all(err <= 1e-6 + 1e-6 * np.abs(want["params"]) + allowed / wsum), (
            f"round {rnd}: max err {err.max()} over the allowance")
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, atol=atol.get(k, 0.0),
                                       err_msg=k)
    assert differing <= MAX_FLIPS * len(MASKS)
    print(f"{case}: {differing} collective codes differ over {len(MASKS)} rounds")


@pytest.mark.parametrize("codec_name", CODECS)
def test_mesh_int8_collective_is_the_reference_psum(port_run, codec_name):
    """Every int8 round rebuilt from the ranks' logged ``eff`` (this rank's
    ``wx + residual``, padded) with the JAX package's reference kernels: the
    shared scales, every rank's new collective residual row and the new
    global, bitwise.  The padded tail and a masked rank's ``eff`` are zero."""
    _check_reference_psum(port_run, ("int8", codec_name))


def _check_reference_psum(port_run, case):
    _, jparams = _jax_model(_arch(case))
    shapes = [x.size for x in jax.tree.leaves(jparams)]
    for rnd, m in enumerate(MASKS):
        flat, _, prev_rows = _port_start(port_run, case, rnd)
        new_rows = _port_rows(port_run, case, rnd, "coll_row")
        logs = [port_run[r][case]["rounds"][rnd]["coll_log"] for r in range(C)]
        wsum = np.float32((WEIGHTS * m).sum())  # integer weights: exact
        want, off = [], 0
        for i, n in enumerate(shapes):
            effs = np.stack([log[i][0] for log in logs])
            assert effs.shape[1] % BLOCK == 0 and not effs[:, n:].any()
            assert not effs[m == 0].any()
            am = np.abs(effs).reshape(C, -1, BLOCK).max(axis=(0, 2))
            s = np.where(am == 0.0, np.float32(1.0), am / np.float32(127.0)).astype(np.float32)
            for log in logs:
                np.testing.assert_array_equal(log[i][1], s)
            qs = [np.asarray(jref.collective_pack(jnp.asarray(e), jnp.asarray(s))) for e in effs]
            total = np.asarray(jref.collective_unpack(jnp.asarray(sum(qs)), jnp.asarray(s)))[:n]
            for c in range(C):
                sent = np.asarray(jref.collective_unpack(jnp.asarray(qs[c]), jnp.asarray(s)))[:n]
                row = effs[c, :n] - sent if m[c] else prev_rows[i][c]
                np.testing.assert_array_equal(new_rows[i][c], row)
            want.append(flat[off:off + n] + total / wsum)
            off += n
        np.testing.assert_array_equal(port_run[0][case]["rounds"][rnd]["params"],
                                      np.concatenate(want))


@pytest.mark.parametrize("collective,codec_name", CASES)
def test_mesh_masked_rank_carries_its_rows(port_run, collective, codec_name):
    """Round 2 masks client 0: its codec and collective residual rows leave
    the round bitwise as they entered it, and the live rows changed; a
    mask of None is bitwise the all-ones mask."""
    case = (collective, codec_name)
    rank0 = port_run[0][case]["rounds"]
    live = port_run[1][case]["rounds"]
    for key in ("codec_row", "coll_row"):
        for before, after in zip(rank0[0][key], rank0[1][key], strict=True):
            np.testing.assert_array_equal(before, after)
        if live[0][key]:  # stateful: some leaf of a live row moved
            assert any(not np.array_equal(a, b) for a, b in
                       zip(live[0][key], live[1][key], strict=True))
    assert all(port_run[r][case]["mask_none_same"] for r in range(C))


@pytest.mark.parametrize("collective,codec_name", CASES)
def test_mesh_collective_all_reduces_once_a_tier(port_run, collective, codec_name):
    """The int8 collective reduces every leaf at once: per rank and round
    one MAX all-reduce of the block absmax and one SUM of the int32 codes a
    tier (2 tiers), where a call a leaf made 10 of each; the fp32
    collective makes neither (its SUMs are fp32, one a leaf and tier)."""
    case = (collective, codec_name)
    n_leaves = len(jax.tree.leaves(_jax_model()[1]))
    for r in range(C):
        for rnd in port_run[r][case]["rounds"]:
            n_max, n_int32, n_all = rnd["all_reduces"]
            assert (n_max, n_int32) == ((2, 2) if collective == "int8" else (0, 0))
            if collective == "fp32":
                assert n_all >= 2 * n_leaves


@pytest.mark.parametrize("collective,codec_name", CASES)
def test_mesh_round_launches_and_state(port_run, collective, codec_name):
    """On the CPU the plain versions run, so no kernel is launched; the
    state pytree has JAX's leaves (codec rows, and per model leaf a
    collective residual row for int8)."""
    case = (collective, codec_name)
    rounds = port_run[0][case]["rounds"]
    assert all(sum(r["launches"].values()) == 0 for r in rounds)
    n_leaves = len(jax.tree.leaves(_jax_model()[1]))
    assert len(rounds[0]["coll_row"]) == (n_leaves if collective == "int8" else 0)
    assert len(rounds[0]["codec_row"]) == (0 if codec_name == "NullCodec" else 1)


def test_mesh_resnet_int8_collective_is_the_reference_psum(port_run):
    """The reduced ResNet's 20 leaves (``fc_b``'s 10 floats sort first, so
    19 start away from a 16-byte boundary) through the int8 collective
    with the Int8 uplink: every round rebuilt bitwise from the ranks'
    logged ``eff``, as for the head model."""
    _check_reference_psum(port_run, RESNET_CASE)


def test_mesh_resnet_rows_launches_and_all_reduces(port_run):
    """The ResNet case's state: one uplink residual row and a collective
    row per leaf (20); no kernel launch on the CPU; one MAX and one int32
    SUM all-reduce a tier a round over all 20 leaves; rank 0's rows carried
    bitwise through its masked round 2; ``mask=None`` bitwise all ones."""
    assert len(jax.tree.leaves(_jax_model(RESNET)[1])) == 20
    for r in range(C):
        rec = port_run[r][RESNET_CASE]
        assert len(rec["rounds"][0]["coll_row"]) == 20
        assert len(rec["rounds"][0]["codec_row"]) == 1
        assert all(sum(x["launches"].values()) == 0 for x in rec["rounds"])
        assert all(x["all_reduces"][:2] == (2, 2) for x in rec["rounds"])
        assert rec["mask_none_same"]
    rank0 = port_run[0][RESNET_CASE]["rounds"]
    for key in ("codec_row", "coll_row"):
        for before, after in zip(rank0[0][key], rank0[1][key], strict=True):
            np.testing.assert_array_equal(before, after)


RESNET_TOL = 1e-4    # a client's update, two local steps (test_torch_rounds.py)
RESNET_FLIPS = 1e-2  # the share of uplink or collective codes that may differ


def test_mesh_resnet_round_matches_jax(port_run):
    """Each ResNet round, from the state the port's round started from,
    against JAX's shard_map round step.  A client's update differs by at
    most ``RESNET_TOL`` between the frameworks (convs summed in another
    order), so an uplink or collective code near a half-way point may
    differ, and its residual moves instead.  With the inputs equal,
    sent_c = w_c dec_c + r_in - r_coll_c and dec_c = delta_c + r_up_in -
    r_up_c, so a priori
    |d global| <= sum_c (w_c (RESNET_TOL + |d r_up_c|) + |d r_coll_c|) / W;
    a residual gap past its code-equal bound counts as a differing code,
    and at most ``RESNET_FLIPS`` of either kind may.  The loss metrics
    within rtol 1e-4, the steps equal."""
    for rnd in range(len(MASKS)):
        w_eff = (WEIGHTS * MASKS[rnd])[:, None]
        want = _jax_round(port_run, RESNET_CASE, rnd)
        got = port_run[0][RESNET_CASE]["rounds"][rnd]
        (up,), (up_j,) = _port_rows(port_run, RESNET_CASE, rnd, "codec_row"), want["codec_rows"]
        coll = np.concatenate(_port_rows(port_run, RESNET_CASE, rnd, "coll_row"), axis=1)
        up_gap, coll_gap = np.abs(up - up_j), np.abs(coll - np.concatenate(want["coll_rows"], 1))
        assert (up_gap > RESNET_TOL).mean() <= RESNET_FLIPS
        assert (coll_gap > w_eff * (RESNET_TOL + up_gap) + 1e-6).mean() <= RESNET_FLIPS
        allowed = (w_eff * (RESNET_TOL + up_gap) + coll_gap).sum(axis=0) / w_eff.sum()
        err = np.abs(got["params"] - want["params"])
        assert np.all(err <= 1e-6 + allowed), f"round {rnd}: max err {err.max()}"
        for key in ("client_loss_mean", "client_loss_max", "steps_total"):
            np.testing.assert_allclose(got["metrics"][key], want["metrics"][key], rtol=1e-4,
                                       err_msg=key)


def test_client_mesh_layout_matches_jax_make_mesh(port_run):
    """Rank r holds client r: the client that shard_map gives mesh position
    (pod, data) under P(("pod", "data")) is the rank with those coordinates,
    and each rank's tier groups are the ranks along that axis."""
    mesh = _jmesh()
    pos = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
    arr = jax.device_put(jnp.arange(C), NamedSharding(mesh, P(AXES)))
    for shard in arr.addressable_shards:
        client = int(np.asarray(shard.data)[0])
        p, d = pos[shard.device.id]
        lay = port_run[client]["layout"]
        assert lay["coords"] == {"pod": p, "data": d}
        assert lay["groups"]["data"] == [2 * p, 2 * p + 1]
        assert lay["groups"]["pod"] == [d, 2 + d]


def test_init_collective_residual_matches_jax():
    jm, jparams = _jax_model()
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    want = jax.tree.leaves(J.init_collective_residual(jparams, 3))
    got = jax.tree.leaves(jax.tree.map(np.asarray, {
        k: {n: t.numpy() for n, t in v.items()}
        for k, v in T.init_collective_residual(tparams, 3).items()
    }))
    assert [x.shape for x in got] == [x.shape for x in want]
    assert all(x.dtype == np.float32 and not x.any() for x in got)


def test_collective_validation_errors_match_jax():
    tm = build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")
    jm, _ = _jax_model()
    for pkg, m in ((J, jm), (T, tm)):
        with pytest.raises(ValueError, match="fp32 | int8"):
            pkg.make_round_step(m.loss_fn, (jsgd if pkg is J else sgd)(0.1), pkg.FedAvg(),
                                pkg.RoundSpec(max_steps=1, execution_mode="parallel",
                                              collective="int4"))
        with pytest.raises(NotImplementedError, match="mesh"):
            pkg.make_round_step(m.loss_fn, (jsgd if pkg is J else sgd)(0.1), pkg.FedAvg(),
                                pkg.RoundSpec(max_steps=1, execution_mode="parallel",
                                              collective="int8"))
    mesh = ClientMesh(axes=(("pod", 2), ("data", 2), ("model", 2)), rank=0,
                      groups={"pod": None, "data": None, "model": None})
    step = functools.partial(T.make_round_step, tm.loss_fn, sgd(0.1), T.FedAvg())
    with pytest.raises(NotImplementedError, match="item 13"):
        step(T.RoundSpec(max_steps=1, execution_mode="parallel"), mesh=mesh,
             client_axes=AXES)  # a model axis inside a client
    for mode in ("sequential", "fsdp"):
        with pytest.raises(NotImplementedError, match="item 13"):
            step(T.RoundSpec(max_steps=1, execution_mode=mode), mesh=mesh, client_axes=AXES)
    flat = ClientMesh(axes=(("pod", 2), ("data", 2)), rank=0, groups={"pod": None, "data": None})
    rs = step(T.RoundSpec(max_steps=1, execution_mode="parallel"), mesh=flat,
              client_axes=AXES)
    with pytest.raises(ValueError, match="one client"):
        rs({}, (), (), {}, torch.ones(2), torch.ones(2, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="not on mesh"):  # collective_tiers' check
        step(T.RoundSpec(max_steps=1, execution_mode="parallel"), mesh=flat,
             client_axes=("pod", "rack"))


# a rank that raises reports its own error however slowly the ranks spawn
# and import torch (the deadline covers the spawn: 120 s); a hang times out
# after 10 s
@pytest.mark.parametrize("fn,error,match,timeout_s", [
    (torch_mesh_ranks.fail_on_rank_one, RuntimeError, "rank one fails on purpose", 120),
    (torch_mesh_ranks.hang_on_rank_one, TimeoutError, "gave no result within", 10),
], ids=["fails", "hangs"])
def test_run_local_mesh_reports_a_failing_rank(fn, error, match, timeout_s):
    """A rank that raises or hangs raises here, and no rank outlives the call."""
    import multiprocessing

    with pytest.raises(error, match=match):
        run_local_mesh(fn, pod=1, data=2, backend="gloo", device="cpu", timeout_s=timeout_s)
    assert not multiprocessing.active_children()


def test_run_local_mesh_defaults_to_the_card(monkeypatch):
    """``device=None`` means the card: without one it raises before any
    rank starts, as every entry point of the package does."""
    import multiprocessing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_local_mesh(torch_mesh_ranks.fail_on_rank_one, pod=1, data=2, backend="gloo")
    assert not multiprocessing.active_children()
