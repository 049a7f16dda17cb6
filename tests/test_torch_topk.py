"""Port parity for the TopK uplink: the plain ``topk_scatter_reduce`` (via
``ops`` on CPU tensors), ``TopKCodec`` and the mixed Pixel/Jetson/TPU
fleet through ``Server.run``, against the JAX package on the same numpy
inputs.  The JAX side runs as its own tests run it: the Pallas scatter
body in interpret mode and the jnp oracle.  The hand-written kernel is
held against the plain version on the card by
``test_torch_cuda_kernels.py``.

Tolerances: the reduce's terms are the same fp32 products ``w_c * val``
on both sides, so where the rows share no index every coordinate holds one
term and the results are bitwise; where they overlap only the summation
order can differ (the Pallas body adds normalized terms), so
``rtol=atol=1e-6``.  The weights are example counts, integers as on the
real path, so their sum is exact in any order (fp32 weights summed in
another order would move the denominator by an ulp).  The encoder's selection is a stable sort on both
sides: bitwise, ties, NaN and all-zero rows included.
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
from repro.core import protocol as jp
from repro.data.federated import dirichlet_partition as jdirichlet
from repro.data.synthetic import make_features as jmake_features
from repro.kernels import ref as jref
from repro.kernels.scatter_reduce import topk_scatter_reduce as pallas_topk
from repro.models import build_model as jbuild_model
import repro_torch.core as T
from repro_torch.configs.base import get_config
from repro_torch.core import protocol as tp
from repro_torch.data.federated import dirichlet_partition
from repro_torch.data.synthetic import make_features
from repro_torch.kernels import ops
from repro_torch.kernels import scatter_reduce as scatter_kernel
from repro_torch.models import build_model, params_from_numpy
from repro_torch.utils.pytree import tree_leaves

TOL = dict(rtol=1e-6, atol=1e-6)
# jitted: one XLA compile per shape instead of one per eager op
_jref_topk = jax.jit(jref.topk_scatter_reduce, static_argnums=3)


def _payload(c, k, n, seed, dup=False, disjoint=False):
    """(idx int32, val fp32, w fp32) as numpy: distinct indices per row,
    repeated ones (``dup``), or rows that share no index (``disjoint``)."""
    rng = np.random.default_rng(seed)
    if disjoint:
        idx = rng.permutation(n)[: c * k].reshape(c, k)
    elif dup:
        pool = rng.integers(0, n, (c, max(1, k // 2)))
        idx = pool[:, rng.integers(0, pool.shape[1], k)]
    else:
        idx = np.stack([rng.choice(n, size=k, replace=False) for _ in range(c)])
    val = rng.normal(size=(c, k)).astype(np.float32)
    w = rng.integers(10, 500, c).astype(np.float32)  # example counts
    return idx.astype(np.int32), val, w


def _ours(idx, val, w, n, **kw):
    return ops.topk_scatter_reduce(
        torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(w), n, **kw
    ).numpy()


def _theirs(idx, val, w, n):
    args = (jnp.asarray(idx), jnp.asarray(val), jnp.asarray(w), n)
    return np.asarray(_jref_topk(*args)), np.asarray(pallas_topk(*args, interpret=True))


def _dense_mean(idx, val, w, n):
    dense = np.zeros((idx.shape[0], n), np.float64)
    for c in range(idx.shape[0]):
        np.add.at(dense[c], idx[c], val[c])
    return (w.astype(np.float64) @ dense / w.sum()).astype(np.float32)


@pytest.mark.parametrize("c,k,n,kind", [
    (4, 64, 8192, "distinct"), (8, 10, 1000, "distinct"), (2, 512, 4096, "distinct"),
    (4, 32, 2048, "dup"), (3, 7, 100, "dup"), (5, 40, 1000, "disjoint"),
])
def test_scatter_reduce_matches_jax(c, k, n, kind):
    idx, val, w = _payload(c, k, n, seed=c * 1000 + k, dup=kind == "dup",
                           disjoint=kind == "disjoint")
    out = _ours(idx, val, w, n)
    exp_ref, exp_pallas = _theirs(idx, val, w, n)
    assert out.shape == (n,) and out.dtype == np.float32
    np.testing.assert_allclose(out, exp_ref, **TOL)
    np.testing.assert_allclose(out, exp_pallas, **TOL)
    np.testing.assert_allclose(out, _dense_mean(idx, val, w, n), rtol=1e-5, atol=1e-6)
    if kind == "disjoint":  # one term a coordinate: the same bits
        np.testing.assert_array_equal(out, exp_ref)


def test_scatter_reduce_normalize_false_is_the_weighted_sum():
    idx, val, w = _payload(4, 32, 2048, seed=5)
    out = _ours(idx, val, w, 2048, normalize=False)
    exp_ref, exp_pallas = _theirs(idx, val, w, 2048)
    tol = dict(rtol=TOL["rtol"], atol=TOL["atol"] * float(w.sum()))
    np.testing.assert_allclose(out, exp_ref * w.sum(), **tol)
    np.testing.assert_allclose(out, exp_pallas * w.sum(), **tol)
    # exactly the mean times safe_weight_sum, as the JAX _denormalize
    mean = _ours(idx, val, w, 2048)
    np.testing.assert_array_equal(out, mean * np.float32(w.sum(dtype=np.float32)))


def test_scatter_reduce_empty_payloads_and_zero_value_padding():
    n = 500
    for c, k in ((3, 0), (0, 4)):
        idx, val = np.zeros((c, k), np.int32), np.zeros((c, k), np.float32)
        out = _ours(idx, val, np.ones(c, np.float32), n)
        assert out.shape == (n,) and not out.any()
    # a client padded with value-0 entries (heterogeneous k) adds nothing
    idx, val, w = _payload(4, 16, n, seed=7)
    val[2] = 0.0
    exp_ref, exp_pallas = _theirs(idx, val, w, n)
    np.testing.assert_allclose(_ours(idx, val, w, n), exp_ref, **TOL)
    np.testing.assert_allclose(_ours(idx, val, w, n), exp_pallas, **TOL)


def test_scatter_reduce_out_of_range_indices_dropped():
    n = 256
    idx = np.asarray([[0, -1, n, 5, 2**30, 255, -(2**31)]], np.int32)
    val = np.ones((1, 7), np.float32)
    w = np.ones(1, np.float32)
    exp = np.zeros(n, np.float32)
    exp[[0, 5, 255]] = 1.0  # only the in-range entries land; -1 never wraps
    out = _ours(idx, val, w, n)
    np.testing.assert_array_equal(out, exp)
    for theirs in _theirs(idx, val, w, n):
        np.testing.assert_array_equal(out, theirs)


def test_scatter_reduce_zero_weights_give_zeros():
    idx, val, _ = _payload(4, 32, 1024, seed=3)
    for normalize in (True, False):
        out = _ours(idx, val, np.zeros(4, np.float32), 1024, normalize=normalize)
        assert not np.isnan(out).any() and not out.any()


@pytest.mark.parametrize("n", [100, 8193])
def test_scatter_reduce_tail_indices(n):
    """Indices in the last, ragged stretch of the output land."""
    c, k = 3, 8
    rng = np.random.default_rng(n)
    idx = np.stack([np.sort(rng.choice(n, size=k, replace=False)) for _ in range(c)])
    idx[:, -1], idx[:, 0] = n - 1, 0
    val = rng.normal(size=(c, k)).astype(np.float32)
    w = rng.integers(10, 500, c).astype(np.float32)
    out = _ours(idx.astype(np.int32), val, w, n)
    exp_ref, exp_pallas = _theirs(idx.astype(np.int32), val, w, n)
    np.testing.assert_allclose(out, exp_ref, **TOL)
    np.testing.assert_allclose(out, exp_pallas, **TOL)
    assert out[-1] == pytest.approx(float(exp_ref[-1]), abs=1e-6)


def _one_launch_model(idx, val, w, n, *, tile, unit, normalize=True):
    """The card kernel's two phases in numpy, fp32, with its tile and unit
    sizes as arguments.  Phase 1: per unit of ``unit`` entries of a row, a
    flag (an entry out of [0, n) or not above its predecessor) and, for a
    row's entries, start[c][t] = j for every tile boundary t * tile in
    (idx[c][j-1], idx[c][j]], the tail after its last entry = k; each write
    counted.  Phase 2: per tile, each row's terms in client order, a
    canonical row's from its start range, a foreign row's (any unit flagged)
    from a whole scan with out-of-range entries as index 0 value 0; divided
    by the weight sum (0 -> 1), and with ``normalize=False`` multiplied
    back.  Returns (out, flags, start, writes)."""
    c_rows, k = idx.shape
    tiles, units = -(-n // tile), -(-k // unit)
    flags = np.zeros((c_rows, units), np.int32)
    start = np.full((c_rows, tiles + 1), -7, np.int64)   # never read if not written
    writes = np.zeros((c_rows, tiles + 1), np.int64)
    for c in range(c_rows):
        for j in range(k):
            cur, prev = int(idx[c, j]), int(idx[c, j - 1]) if j else -1
            if cur < 0 or cur >= n or prev >= cur:
                flags[c, j // unit] = 1
            elif prev >= -1:
                ts = list(range(0 if prev < 0 else prev // tile + 1, cur // tile + 1))
                if j == k - 1:
                    ts += list(range(cur // tile + 1, tiles + 1))
                for t in ts:
                    start[c, t] = k if t > cur // tile else j
                    writes[c, t] += 1
    wsum = np.float32(w.astype(np.float32).sum())
    wsum = np.float32(1.0) if wsum == 0 else wsum
    out = np.zeros(n, np.float32)
    for t in range(tiles):
        lo, hi = t * tile, min(t * tile + tile, n)
        acc = np.zeros(hi - lo, np.float32)
        for c in range(c_rows):
            if flags[c].any():
                for j in range(k):
                    i, v = int(idx[c, j]), val[c, j]
                    if not 0 <= i < n:
                        i, v = 0, np.float32(0)
                    if lo <= i < hi:
                        acc[i - lo] += np.float32(w[c]) * v
            else:
                js = np.arange(start[c, t], start[c, t + 1])
                acc[idx[c, js] - lo] += np.float32(w[c]) * val[c, js]
        mean = acc / wsum
        out[lo:hi] = mean if normalize else mean * wsum
    return out, flags, start, writes


@pytest.mark.parametrize("kind", ["distinct", "sparse tiles", "dup", "out of range"])
def test_one_launch_scatter_arithmetic(kind):
    """The kernel's phase-1 index on a canonical wire writes every tile
    start of every row exactly once (nothing is read that the launch did
    not write); a foreign row is
    flagged; phase 2 then gives the plain version's result, bitwise where
    the rows share no index, in both forms."""
    n, tile, unit = 1000, 64, 16
    if kind == "sparse tiles":  # whole tiles between a row's entries, none in the first or last
        idx, val, w = _payload(3, 6, n, seed=8)
        idx = np.sort(idx % 700 + 100, axis=1).astype(np.int32)
        idx = np.stack([np.unique(r)[:4] for r in idx]).astype(np.int32)
        val, w = val[:, :4], w
    else:
        idx, val, w = _payload(4, 40, n, seed=9, dup=kind == "dup", disjoint=kind != "dup")
        idx = np.sort(idx, axis=1).astype(np.int32)
        if kind == "out of range":
            idx[2, 5], idx[3, -1] = -3, n
    out, flags, start, writes = _one_launch_model(idx, val, w, n, tile=tile, unit=unit)
    canonical = ~flags.any(axis=1)
    assert (writes[canonical] == 1).all()
    if kind in ("distinct", "sparse tiles"):
        assert canonical.all()
    else:
        assert not canonical.all()
    exp = ops.topk_scatter_reduce(*(torch.from_numpy(a) for a in (idx, val, w)), n).numpy()
    np.testing.assert_allclose(out, exp, **TOL)
    if kind != "dup":
        np.testing.assert_array_equal(out, exp)
    summed, *_ = _one_launch_model(idx, val, w, n, tile=tile, unit=unit, normalize=False)
    np.testing.assert_array_equal(summed, out * np.float32(w.sum(dtype=np.float32)))


def test_scatter_workspace_covers_flags_and_starts():
    """One flag per UNIT entries of each row and tiles + 1 starts of each."""
    assert scatter_kernel.workspace_ints(4, 19_743, 1_974_303) == 4 * (20 + 242 + 1)
    assert scatter_kernel.workspace_ints(1, 1, 1) == 3


@pytest.mark.parametrize("normalize", [True, False])
def test_scatter_kernel_wrapper_raises_off_the_card(normalize):
    idx, val, w = (torch.from_numpy(a) for a in _payload(2, 8, 100, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        scatter_kernel.topk_scatter_reduce(idx, val, w, 100, normalize=normalize)


@pytest.mark.parametrize("normalize", [1, 0, None, "False"])
def test_scatter_kernel_wrapper_takes_only_a_bool_normalize(normalize):
    idx, val, w = (torch.from_numpy(a) for a in _payload(2, 8, 100, seed=1))
    with pytest.raises(TypeError, match="normalize"):
        scatter_kernel.topk_scatter_reduce(idx, val, w, 100, normalize=normalize)


# ---------------- TopKCodec ----------------
def _edge_rows(n=300):
    """Rows that stress the selection: ties across the cut, NaN, an
    all-zero row, -0.0 beside 0.0."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(4, n)) * 1e-3).astype(np.float32)
    x[0, ::7] = 0.5          # many equal magnitudes, more than k of them
    x[0, 3::7] = -0.5
    x[1, 10], x[1, 50] = np.nan, -np.inf
    x[2] = 0.0
    x[3, ::2] = -0.0
    return x


@pytest.mark.parametrize("frac", [0.01, 0.1])
def test_encode_matches_jax_bitwise(frac):
    x = _edge_rows()
    jc, tc = J.TopKCodec(frac=frac), T.TopKCodec(frac=frac)
    for row in x:
        je, te = jc.encode(jnp.asarray(row)), tc.encode(torch.from_numpy(row))
        assert te["idx"].dtype == torch.int32 and te["n"] == je["n"]
        np.testing.assert_array_equal(te["idx"].numpy(), np.asarray(je["idx"]))
        np.testing.assert_array_equal(te["val"].numpy(), np.asarray(je["val"]))
        np.testing.assert_array_equal(tc.decode(te).numpy(), np.asarray(jc.decode(je)))
    jb, tb = jc.encode_batch(jnp.asarray(x)), tc.encode_batch(torch.from_numpy(x))
    np.testing.assert_array_equal(tb["idx"].numpy(), np.asarray(jb["idx"]))
    np.testing.assert_array_equal(tb["val"].numpy(), np.asarray(jb["val"]))
    np.testing.assert_array_equal(tc.decode_batch(tb).numpy(), np.asarray(jc.decode_batch(jb)))
    assert tc.wire_bytes(300) == jc.wire_bytes(300) == 8 * tc.k_of(300)
    assert tc.wire_bytes([300, 1_974_303]) == jc.wire_bytes([300, 1_974_303])
    assert T.TopKCodec().k_of(1_974_303) == 19_743


def test_codec_reduce_equals_dense_decode_and_reduce():
    """The codec's reduce on a real encoded payload equals the dense
    decode + weighted mean, and the JAX codec's reduce."""
    rng = np.random.default_rng(0)
    deltas = (rng.normal(size=(6, 3000)) * 0.01).astype(np.float32)
    w = (rng.random(6) + 0.1).astype(np.float32)
    tc, jc = T.TopKCodec(frac=0.05), J.TopKCodec(frac=0.05)
    enc = tc.encode_batch(torch.from_numpy(deltas))
    out = tc.reduce(enc, torch.from_numpy(w)).numpy()
    dense = tc.decode_batch(enc).numpy()
    np.testing.assert_allclose(out, (w @ dense) / w.sum(), **TOL)
    jenc = jc.encode_batch(jnp.asarray(deltas))
    np.testing.assert_allclose(out, np.asarray(jc.reduce(jenc, jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        out, np.asarray(jc.reduce(jenc, jnp.asarray(w), interpret=True)), **TOL
    )


# ---------------- the mixed fleet through Server.run ----------------
FLEET = ["pixel-4", "jetson-tx2-gpu", "tpu-v5e-chip", "pixel-2", "galaxy-tab-s6"]


@functools.cache
def _jax_side():
    jm = jbuild_model(jget_config("mobilenet-head-office31").reduced())
    jparams = jm.init(jax.random.key(0))
    return jm, jparams, jm.loss_fn, jm.trainable_mask(jparams)


def _run_fleet(pkg, rounds):
    jm, jparams, jloss, jmask = _jax_side()
    if pkg is J:
        data = jmake_features(n=600, num_classes=31, feature_dim=jm.cfg.feature_dim, seed=0)
        shards = jdirichlet(data, n_clients=len(FLEET), alpha=1.0, seed=0)
        params, loss_fn, mask, extra = jparams, jloss, jmask, {}
    else:
        m = build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")
        data = make_features(n=600, num_classes=31, feature_dim=m.cfg.feature_dim, seed=0)
        shards = dirichlet_partition(data, n_clients=len(FLEET), alpha=1.0, seed=0)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        loss_fn, mask, extra = m.loss_fn, m.trainable_mask(params), {"device": "cpu"}
    Client = J.JaxClient if pkg is J else T.TorchClient
    clients = [
        Client(client_id=s.client_id, loss_fn=loss_fn, dataset=s, batch_size=32,
               trainable_mask=mask, device_profile=p, **extra)
        for s, p in zip(shards, FLEET)
    ]
    strategy = pkg.FedAvg(local_epochs=2, local_lr=0.1, codec_policy=pkg.BandwidthCodecPolicy())
    uploads = []
    agg = strategy.aggregate_fit

    def recorded(rnd, results, global_params):
        uploads.append(results)
        return agg(rnd, results, global_params)

    strategy.aggregate_fit = recorded
    cm = pkg.make_cost_model_for(params, [pkg.PROFILES[p] for p in FLEET])
    server = pkg.Server(strategy=strategy, clients=clients, cost_model=cm, **extra)
    server.logger.quiet = True
    final, history = server.run(params, num_rounds=rounds)
    return final, history, uploads


def _wire_allowance(j_uploads, t_uploads) -> tuple[float, int]:
    """The limit chip_smoke.py's replay holds the card to, here between the
    packages: local SGD differs in the last bits, so an Int8 code on a
    rounding edge or a TopK entry on the selection edge may differ.  Each
    differing Int8 code may move the global by its code change x block
    scale x its client's weight share, each differing TopK index by its
    |value| x weight share."""
    allow, differing = 0.0, 0
    for jres, tres in zip(j_uploads, t_uploads, strict=True):
        wsum = sum(r.num_examples for _, r in tres)
        for (_, a), (_, b) in zip(jres, tres, strict=True):
            share = b.num_examples / wsum
            ea, eb = jp.wire_to_enc(a.parameters), tp.wire_to_enc(b.parameters, "cpu")
            if "q" in eb:
                dq = np.abs(np.asarray(ea["q"], np.int32) - eb["q"].numpy().astype(np.int32))
                scale = np.maximum(np.asarray(ea["scale"]), eb["scale"].numpy())
                differing += int((dq > 0).sum())
                allow += float((dq.reshape(-1, 256) * scale[:, None]).sum()) * share
            elif "idx" in eb:
                ja = dict(zip(np.asarray(ea["idx"]).tolist(), np.asarray(ea["val"]).tolist()))
                tb = dict(zip(eb["idx"].numpy().tolist(), eb["val"].numpy().tolist()))
                for i in set(ja) ^ set(tb):
                    differing += 1
                    allow += abs(ja.get(i, tb.get(i))) * share
    return allow, differing


def test_mixed_fleet_server_run_matches_jax():
    """3 TopK phones + 1 Jetson (Int8) + 1 TPU-class client (Null), 3
    rounds of local SGD: History equal, the port's global within 1e-5 plus
    the differing wire entries' share of the JAX package's."""
    jfinal, jh, jup = _run_fleet(J, 3)
    tfinal, th, tup = _run_fleet(T, 3)
    for a, b in zip(jh.rounds, th.rounds, strict=True):
        assert (a.comm_bytes, a.wall_time_s, a.energy_j, a.steps) == (
            b.comm_bytes, b.wall_time_s, b.energy_j, b.steps)
        assert (a.participants, a.dropped) == (b.participants, b.dropped)
        np.testing.assert_allclose(b.train_loss, a.train_loss, rtol=1e-4)
    codecs = sorted(type(r.parameters.codec).__name__ for _, r in tup[0])
    assert codecs == ["Int8Codec", "NullCodec", "TopKCodec", "TopKCodec", "TopKCodec"]
    allow, _ = _wire_allowance(jup, tup)
    jf = np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree.leaves(jfinal)])
    tf = np.concatenate([x.numpy().reshape(-1) for x in tree_leaves(tfinal)])
    assert np.abs(tf - jf).max() <= 1e-5 + allow
    n = jf.size
    pol = T.BandwidthCodecPolicy()
    assert th.rounds[0].comm_bytes == (
        3 * pol.topk.wire_bytes(n) + pol.int8.wire_bytes(n) + pol.null.wire_bytes(n)
        + len(FLEET) * 4 * n
    )
    assert th.rounds[-1].eval_acc > th.rounds[0].eval_acc
