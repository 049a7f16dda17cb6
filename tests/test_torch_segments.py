"""Port parity for the segmented wire (``SegmentMap``, ``StructuredUpdate``,
the per-segment codec surface and ``LoRACodec``): the twins of
``tests/test_structured_update.py``, held against the JAX package on the
same numpy inputs, plus the protocol's segmented round trips.

Tolerances: Null, Int8 and TopK on one input give bitwise codes, indices
and decodes in both packages (a stable sort, IEEE divisions and products
on both sides), so those comparisons are exact.  Whole rounds differ in
local SGD's last bits, so a port round is held bitwise against the port's
own flat run (``SegmentMap.flat`` is the flat path) rather than against
JAX.  LoRA's basis is carried across (``segment_basis`` patched to JAX's
draw), and the QR factorizations of the two packages differ in rounding:
reconstructions within ``LORA_TOL`` (fp32 inputs of magnitude ~1e-2).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)
from hypothesis_compat import given, settings, st

import repro.core as J
from repro.core import compression as jcomp
from repro.core import protocol as jp
from repro.configs.base import get_config as jget_config
from repro.models import build_model as jbuild_model
import repro_torch.core as T
from repro_torch.configs.base import get_config
from repro_torch.core import compression as tcomp
from repro_torch.core import protocol as tp
from repro_torch.core.rounds import make_multi_round_step
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.utils.pytree import (
    tree_flatten_to_vector, tree_leaves, tree_size, tree_unflatten_from_vector,
)

CODECS = {"null": "NullCodec", "int8": "Int8Codec", "topk": "TopKCodec"}
KW = {"null": {}, "int8": {}, "topk": {"frac": 0.25}}
LORA_TOL = dict(rtol=0, atol=2e-6)


def _codec(pkg, name):
    return getattr(pkg, CODECS[name])(**KW[name])


def _np_tree(seed, scale=0.01):
    """A param-like tree with a 1-D bias, 2-D matrices and a 3-D
    stacked-expert leaf; every leaf after the first starts unaligned."""
    rng = np.random.default_rng(seed)
    return {
        "bias": (rng.normal(size=(9,)) * scale).astype(np.float32),
        "emb": (rng.normal(size=(12, 8)) * scale).astype(np.float32),
        "experts": (rng.normal(size=(2, 5, 4)) * scale).astype(np.float32),
        "w": (rng.normal(size=(16, 6)) * scale).astype(np.float32),
    }


def _llm_tree(seed, scale=0.01):
    """Matrices big enough for rank-4 factors to undercut the dense wire."""
    rng = np.random.default_rng(seed)
    return {
        "bias": (rng.normal(size=(48,)) * scale).astype(np.float32),
        "experts": (rng.normal(size=(2, 40, 48)) * scale).astype(np.float32),
        "w": (rng.normal(size=(64, 48)) * scale).astype(np.float32),
    }


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.fixture
def jax_basis(monkeypatch):
    """LoRA's basis carried across: the port draws JAX's q."""
    def basis(seed, seg, n, r):
        key = jax.random.fold_in(jax.random.key(seed), seg.offset)
        return torch.from_numpy(np.asarray(jax.random.normal(key, (n, r), jnp.float32)).copy())

    monkeypatch.setattr(tcomp, "segment_basis", basis)


def _same_map(tmap, jmap):
    assert [(s.name, s.shape, s.offset) for s in tmap] == [
        (s.name, s.shape, s.offset) for s in jmap]
    assert tmap.n_params == jmap.n_params


# ---------------- the segment map ----------------
def test_from_tree_tiles_the_flat_vector():
    t = _t(_np_tree(0))
    segs = T.SegmentMap.from_tree(t)
    assert segs.n_params == tree_size(t) == 9 + 96 + 40 + 96
    off = 0
    for seg, leaf in zip(segs, tree_leaves(t)):
        assert seg.offset == off and seg.shape == tuple(leaf.shape)
        off += seg.size
    assert segs.matches_leaves(tree_leaves(t))
    _same_map(segs, J.SegmentMap.from_tree(_j(_np_tree(0))))
    # the head model at full width: JAX's map, field for field, from its shapes
    tm = build_model(get_config("mobilenet-head-office31"), device="cpu")
    jm = jbuild_model(jget_config("mobilenet-head-office31"))
    hmap = T.SegmentMap.from_tree(tm.init(0))
    _same_map(hmap, J.SegmentMap.from_tree(jax.eval_shape(jm.init, jax.random.key(0))))
    assert [(s.name, s.offset) for s in hmap] == [
        ("['base']['w']", 0), ("['head']['b1']", 1_638_400), ("['head']['b2']", 1_638_656),
        ("['head']['w1']", 1_638_687), ("['head']['w2']", 1_966_367)]


def test_noncontiguous_segments_rejected():
    with pytest.raises(AssertionError, match="contiguous"):
        T.SegmentMap((T.Segment("a", (4,), 0), T.Segment("b", (4,), 5)))


def test_matrix_shape_folds_leading_axes():
    assert T.Segment("e", (2, 5, 4), 0).matrix_shape == (10, 4)
    assert T.Segment("w", (16, 6), 0).matrix_shape == (16, 6)
    with pytest.raises(AssertionError, match="no matrix view"):
        T.Segment("b", (9,), 0).matrix_shape


def _assert_split_roundtrip(np_tree):
    t = _t(np_tree)
    segs = T.SegmentMap.from_tree(t)
    vec = tree_flatten_to_vector(t)
    parts = segs.split(vec)
    for part, leaf, seg in zip(parts, tree_leaves(t), segs):
        assert torch.equal(part, leaf.reshape(-1)), seg.name
    assert torch.equal(torch.cat(parts), vec)
    back = tree_unflatten_from_vector(vec, t)
    for a, b in zip(tree_leaves(back), tree_leaves(t)):
        assert torch.equal(a, b)
    _same_map(segs, J.SegmentMap.from_tree(_j(np_tree)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_roundtrip_pinned(seed):
    _assert_split_roundtrip(_np_tree(seed, scale=10.0 ** (seed - 1)))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=40), min_size=1, max_size=6),
       st.integers(min_value=0, max_value=2**31 - 1))
def test_split_roundtrip_property(sizes, seed):
    rng = np.random.default_rng(seed)
    _assert_split_roundtrip(
        {f"l{i}": rng.normal(size=(n,)).astype(np.float32) for i, n in enumerate(sizes)})


# ---------------- one flat segment == the flat path, surface level ----------------
@pytest.mark.parametrize("name", list(CODECS))
def test_single_segment_aggregate_batch_bitwise(name):
    """SegmentMap.flat is bitwise the flat aggregate_batch, and both are
    bitwise the JAX package's on one input."""
    codec, n = _codec(T, name), 700
    seg = codec.with_segments(T.SegmentMap.flat(n))
    rng = np.random.default_rng(5)
    deltas = (rng.normal(size=(3, n)) * 0.01).astype(np.float32)
    w = np.asarray([1.0, 3.0, 2.0], np.float32)
    out_f, new_f = codec.aggregate_batch(torch.from_numpy(deltas), torch.from_numpy(w),
                                         codec.init_client_state(3, n, device="cpu"))
    out_s, new_s = seg.aggregate_batch(torch.from_numpy(deltas), torch.from_numpy(w),
                                       seg.init_client_state(3, n, device="cpu"))
    assert torch.equal(out_s, out_f)
    assert isinstance(new_s, tuple) and len(new_s) == 1
    if name == "null":
        assert new_s == ((),) and new_f == ()
    else:
        assert torch.equal(new_s[0], new_f)
    assert seg.wire_bytes(n) == codec.wire_bytes(n)
    jseg = _codec(J, name).with_segments(J.SegmentMap.flat(n))
    jout, jnew = jseg.aggregate_batch(jnp.asarray(deltas), jnp.asarray(w),
                                      jseg.init_client_state(3, n))
    np.testing.assert_allclose(out_s.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-9)
    for a, b in zip(tree_leaves(new_s), jax.tree.leaves(jnew)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", list(CODECS) + ["lora"])
def test_structured_wire_serialization_exact(name, jax_basis):
    """encode_structured -> CompressedParameters -> wire_to_enc round-trips
    in the port, its bytes are the per-segment wire sizes and JAX's, and
    its decode is JAX's (bitwise for Null/Int8/TopK)."""
    np_tree = _np_tree(3) if name != "lora" else _llm_tree(3)
    t = _t(np_tree)
    segs = T.SegmentMap.from_tree(t)
    if name == "lora":
        codec = T.LoRACodec(rank=4, factor_codec=T.Int8Codec()).with_segments(segs)
        jcodec = J.LoRACodec(rank=4, factor_codec=J.Int8Codec()).with_segments(
            J.SegmentMap.from_tree(_j(np_tree)))
    else:
        codec = _codec(T, name).with_segments(segs)
        jcodec = _codec(J, name).with_segments(J.SegmentMap.from_tree(_j(np_tree)))
    n = segs.n_params
    vec = tree_flatten_to_vector(t)
    su = codec.encode_structured(vec)
    assert isinstance(su, T.StructuredUpdate) and len(su.payloads) == len(segs)
    dec = codec.decode_structured(su)
    cp = tp.compress_to_wire(codec, su, n)
    assert cp.num_bytes == codec.wire_bytes(n) == jcodec.wire_bytes(n)
    back = tp.wire_to_enc(cp, "cpu")
    assert torch.equal(codec.decode_structured(back), dec)
    out = tp.wire_to_pytree(cp, {k: torch.zeros_like(v) for k, v in t.items()})
    torch.testing.assert_close(tree_flatten_to_vector(out), dec, rtol=1e-6, atol=1e-6)
    jcp = jp.compress_to_wire(jcodec, jcodec.encode_structured(jnp.asarray(vec.numpy())), n)
    assert jcp.fields == cp.fields and jcp.num_bytes == cp.num_bytes
    jdec = np.asarray(jcodec.decode_structured(jp.wire_to_enc(jcp)))
    if name == "lora":
        np.testing.assert_allclose(dec.numpy(), jdec, **LORA_TOL)
    else:
        np.testing.assert_array_equal(dec.numpy(), jdec)


@pytest.mark.parametrize("name", ["null", "int8"])
def test_compress_update_leafwise_matches_flat(name):
    """The client-side surface: segmented compress_update decodes to the
    flat path's update (bitwise for Null, within half a block scale for
    Int8: per-segment blocks start at other offsets), and to JAX's
    segmented update bitwise."""
    g, p = _np_tree(7), _np_tree(8)
    flat_codec = _codec(T, name)
    seg_codec = flat_codec.with_segments(T.SegmentMap.from_tree(_t(g)))
    enc_f, _ = tcomp.compress_update(flat_codec, _t(p), _t(g))
    enc_s, res_s = tcomp.compress_update(seg_codec, _t(p), _t(g))
    out_f = tree_flatten_to_vector(tcomp.decompress_update(flat_codec, enc_f, _t(g)))
    out_s = tree_flatten_to_vector(tcomp.decompress_update(seg_codec, enc_s, _t(g)))
    tol = dict(atol=0, rtol=0) if name == "null" else dict(atol=5e-4, rtol=0)
    torch.testing.assert_close(out_s, out_f, **tol)
    assert isinstance(res_s, tuple)
    for row, seg in zip(res_s, seg_codec.segments):
        if seg_codec.segment_stateful(seg):
            assert row.shape == (seg.size,)
        else:
            assert row == ()
    jcodec = _codec(J, name).with_segments(J.SegmentMap.from_tree(_j(g)))
    jenc, jres = jcomp.compress_update(jcodec, _j(p), _j(g))
    jout = jcomp.decompress_update(jcodec, jenc, _j(g))
    np.testing.assert_array_equal(
        out_s.numpy(), np.concatenate([np.asarray(x).reshape(-1) for x in jax.tree.leaves(jout)]))
    for a, b in zip(tree_leaves(res_s), jax.tree.leaves(jres)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_topk_leafwise_selects_per_segment():
    """Leafwise TopK keeps k_of(seg.size) entries of EACH segment, the
    same indices as JAX's: a small loud layer is not starved by a big one."""
    rng = np.random.default_rng(0)
    g = {"big": np.zeros((512,), np.float32), "small": np.zeros((8,), np.float32)}
    p = {"big": (rng.normal(size=(512,)) * 100.0).astype(np.float32),
         "small": (rng.normal(size=(8,)) * 0.01).astype(np.float32)}
    codec = T.TopKCodec(frac=0.25).with_segments(T.SegmentMap.from_tree(_t(g)))
    su, _ = tcomp.compress_update(codec, _t(p), _t(g))
    jcodec = J.TopKCodec(frac=0.25).with_segments(J.SegmentMap.from_tree(_j(g)))
    jsu, _ = jcomp.compress_update(jcodec, _j(p), _j(g))
    for payload, jpayload, seg in zip(su.payloads, jsu.payloads, su.segments):
        assert payload["idx"].shape == (math.ceil(0.25 * seg.size),), seg.name
        np.testing.assert_array_equal(payload["idx"].numpy(), np.asarray(jpayload["idx"]))
    out = tcomp.decompress_update(codec, su, _t(g))
    assert float(out["small"].abs().max()) > 0.0


# ---------------- one flat segment == the flat path, whole rounds ----------------
C, STEPS, B = 4, 2, 8


def _setup():
    m = build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")
    rng = np.random.default_rng(0)
    batches = {
        "x": torch.from_numpy(rng.normal(size=(C, STEPS, B, 64)).astype(np.float32)),
        "y": torch.from_numpy(rng.integers(0, 31, (C, STEPS, B)).astype(np.int32)),
    }
    return m, m.init(0), batches


def _run_rounds(m, params, train, codec, mode, rounds=3):
    spec = T.RoundSpec(max_steps=STEPS, execution_mode=mode, codec=codec)
    rs = T.make_round_step(m.loss_fn, sgd(0.1), T.FedAvg(), spec, m.trainable_mask(params))
    w = torch.tensor([1.0, 2.0, 0.5, 1.0])
    bud = torch.tensor([2, 1, 2, 2], dtype=torch.int32)
    p, cstate = params, codec.init_client_state(C, tree_size(params), device="cpu")
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    for rnd in range(rounds):
        p, _, cstate, met = rs(p, (), cstate, train, w, bud, rnd, mask if rnd == 1 else None)
    return p, cstate, met


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
@pytest.mark.parametrize("name", list(CODECS))
def test_single_segment_round_bitwise_matches_flat(name, mode):
    """Whole rounds (a masked one among them) under SegmentMap.flat are
    bitwise the flat codec's: globals, residual rows and metrics."""
    m, params, train = _setup()
    flat_codec = _codec(T, name)
    seg_codec = flat_codec.with_segments(T.SegmentMap.flat(tree_size(params)))
    p_f, cs_f, met_f = _run_rounds(m, params, train, flat_codec, mode)
    p_s, cs_s, met_s = _run_rounds(m, params, train, seg_codec, mode)
    _assert_bitwise(p_s, p_f)
    _assert_bitwise(cs_s, cs_f)
    assert set(met_s) == set(met_f)
    for k in met_f:
        assert torch.equal(met_s[k], met_f[k]), k


@pytest.mark.parametrize("name", list(CODECS))
def test_single_segment_scan_bitwise_matches_flat(name):
    """The same on the scanned trainer (the R rounds eagerly on the CPU)."""
    m, params, train = _setup()
    R = 3
    outs = {}
    for label, codec in (("flat", _codec(T, name)),
                         ("seg", _codec(T, name).with_segments(
                             T.SegmentMap.flat(tree_size(params))))):
        spec = T.RoundSpec(max_steps=STEPS, execution_mode="parallel", codec=codec)
        multi = make_multi_round_step(m.loss_fn, sgd(0.1), T.FedAvg(), spec, R,
                                      stacked_batches=False)
        avail = torch.ones(R, C)
        avail[1, 2] = 0.0
        outs[label] = multi(params, (), codec.init_client_state(C, tree_size(params), device="cpu"),
                            train, torch.ones(C), torch.full((C,), STEPS, dtype=torch.int32),
                            avail, torch.zeros(R, C), torch.zeros(R, C))
    _assert_bitwise(outs["seg"][0], outs["flat"][0])
    _assert_bitwise(outs["seg"][2], outs["flat"][2])
    for k in outs["flat"][3]:
        assert torch.equal(outs["seg"][3][k], outs["flat"][3][k]), k


# ---------------- CohortState: leafwise spill ----------------
def test_cohort_state_leafwise_spill_rehydrates_bitwise():
    segs = T.SegmentMap.from_tree(_t(_np_tree(11)))
    cs = T.CohortState(T.Int8Codec().with_segments(segs), segs.n_params, capacity=8,
                       device="cpu")
    rng = np.random.default_rng(0)
    rows = {cid: tuple(torch.from_numpy(rng.normal(size=(seg.size,)).astype(np.float32))
                       for seg in segs) for cid in (3, 7)}
    for cid, row in rows.items():
        cs.put_row(cid, row)
    g = cs.gather([3, 5, 7])
    assert isinstance(g, tuple) and len(g) == len(segs)
    for i, seg in enumerate(segs):
        assert g[i].shape == (3, seg.size)
        assert torch.equal(g[i][0], rows[3][i])
        assert torch.equal(g[i][1], torch.zeros(seg.size))
        assert torch.equal(g[i][2], rows[7][i])
    cs.scatter([3, 5, 7], g)
    _assert_bitwise(cs.gather([3, 5, 7]), g)
    # a stored row has storage of its own, never a view of the block
    assert all(r.untyped_storage().nbytes() == r.numel() * 4 for r in cs.get_row(5))


def test_cohort_state_leafwise_eviction_resets_residual():
    segs = T.SegmentMap.from_tree({"a": torch.zeros(4), "b": torch.zeros(2, 2)})
    cs = T.CohortState(T.TopKCodec(frac=0.5).with_segments(segs), 8, capacity=2,
                       device="cpu")
    for cid in (1, 2, 3):  # capacity 2: inserting 3 evicts 1
        cs.put_row(cid, (torch.full((4,), float(cid)), torch.full((4,), float(cid))))
    assert cs.evictions == 1
    g = cs.gather([1, 2, 3])
    for i in range(2):
        assert torch.equal(g[i][0], torch.zeros(4))
        assert torch.equal(g[i][1], torch.full((4,), 2.0))
        assert torch.equal(g[i][2], torch.full((4,), 3.0))


def test_cohort_state_single_segment_matches_flat_across_eviction():
    """gather, aggregate, scatter under SegmentMap.flat are bitwise the
    flat store, the reset row an eviction leaves included."""
    n = 96
    flat_codec = T.Int8Codec()
    seg_codec = flat_codec.with_segments(T.SegmentMap.flat(n))
    rng = np.random.default_rng(2)
    deltas = torch.from_numpy((rng.normal(size=(3, n)) * 0.01).astype(np.float32))
    w = torch.ones(3)

    def run(codec):
        cs = T.CohortState(codec, n, capacity=2, device="cpu")
        outs = []
        for cohort in ([1, 2, 3], [2, 3, 4], [1, 2, 4]):
            out, new_state = codec.aggregate_batch(deltas, w, cs.gather(cohort))
            cs.scatter(cohort, new_state)
            outs.append(out)
        return cs, outs

    cs_f, outs_f = run(flat_codec)
    cs_s, outs_s = run(seg_codec)
    assert cs_f.evictions == cs_s.evictions > 0
    for a, b in zip(outs_s, outs_f):
        assert torch.equal(a, b)
    for cid in (1, 2, 4):
        assert torch.equal(torch.cat(cs_s.gather([cid]), dim=1)[0], cs_f.gather([cid])[0])


# ---------------- per-segment kernel calls ----------------
def test_topk_group_calls_the_reduce_once_per_segment(monkeypatch):
    """A segmented TopK aggregate_batch calls ops.topk_scatter_reduce once
    a segment, each at that segment's size (the kernel sees per-segment
    shapes), and its result is the per-segment composition."""
    segs = T.SegmentMap((T.Segment("a", (256,), 0), T.Segment("b", (16, 16), 256),
                         T.Segment("c", (7,), 512)))
    n = segs.n_params
    rng = np.random.default_rng(4)
    deltas = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
    w = torch.tensor([1.0, 3.0])
    calls = []
    real = ops.topk_scatter_reduce

    def counted(idx, val, weights, n_params, **kw):
        calls.append(n_params)
        return real(idx, val, weights, n_params, **kw)

    monkeypatch.setattr(ops, "topk_scatter_reduce", counted)
    flat = T.TopKCodec(frac=0.1)
    seg = flat.with_segments(segs)
    out, new = seg.aggregate_batch(deltas, w, seg.init_client_state(2, n, device="cpu"))
    assert calls == [s.size for s in segs]
    parts = [flat.aggregate_batch(deltas[:, s.offset:s.offset + s.size].contiguous(), w,
                                  flat.init_client_state(2, s.size, device="cpu"))
             for s in segs]
    assert torch.equal(out, torch.cat([p for p, _ in parts]))
    _assert_bitwise(new, tuple(r for _, r in parts))


# ---------------- LoRA + mixed fleets ----------------
def test_lora_wire_beats_int8_and_reconstructs_low_rank(jax_basis):
    np_tree = _llm_tree(13)
    segs = T.SegmentMap.from_tree(_t(np_tree))
    lora = T.LoRACodec(rank=4, factor_codec=T.NullCodec()).with_segments(segs)
    int8 = T.Int8Codec().with_segments(segs)
    n = segs.n_params
    assert lora.wire_bytes(n) < int8.wire_bytes(n)
    jlora = J.LoRACodec(rank=4, factor_codec=J.NullCodec()).with_segments(
        J.SegmentMap.from_tree(_j(np_tree)))
    assert lora.wire_bytes(n) == jlora.wire_bytes(n)
    rng = np.random.default_rng(1)
    low = (rng.normal(size=(64, 2)) @ rng.normal(size=(2, 48))).astype(np.float32)
    seg = next(s for s in segs if s.name.endswith("['w']"))
    dec = lora.decode_segment(lora.encode_segment(torch.from_numpy(low).reshape(-1), seg), seg)
    np.testing.assert_allclose(dec.reshape(64, 48).numpy(), low, atol=1e-3, rtol=1e-3)
    jseg = next(s for s in jlora.segments if s.name == seg.name)
    jdec = jlora.decode_segment(jlora.encode_segment(jnp.asarray(low).reshape(-1), jseg), jseg)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=0, atol=2e-5)


def test_lora_requires_segments():
    with pytest.raises(TypeError, match="SegmentMap"):
        T.LoRACodec(rank=2).encode(torch.zeros(8))
    with pytest.raises(TypeError, match="SegmentMap"):
        T.LoRACodec(rank=2).wire_bytes(8)
    with pytest.raises(TypeError, match="SegmentMap"):
        T.LoRACodec(rank=2).init_client_state(2, 8, device="cpu")


def test_lora_residual_telescopes(jax_basis):
    """What rank r cannot carry lands in the residual (JAX's within 1e-6),
    and a second round with no new delta transmits it: the residual
    contracts in both packages.  The second round's factors are not
    compared: the residual is orthogonal to X q by construction, so its
    projection on the same basis is rounding noise in either package."""
    np_tree = _llm_tree(17, scale=1.0)
    t = _t(np_tree)
    segs = T.SegmentMap.from_tree(t)
    lora = T.LoRACodec(rank=2, factor_codec=T.NullCodec()).with_segments(segs)
    g = {k: torch.zeros_like(v) for k, v in t.items()}
    _, res1 = tcomp.compress_update(lora, t, g)
    _, res2 = tcomp.compress_update(lora, g, g, residual=res1)
    n1 = sum(float((r * r).sum()) for r in res1 if not isinstance(r, tuple))
    n2 = sum(float((r * r).sum()) for r in res2 if not isinstance(r, tuple))
    assert n2 < n1
    jlora = J.LoRACodec(rank=2, factor_codec=J.NullCodec()).with_segments(
        J.SegmentMap.from_tree(_j(np_tree)))
    jg = jax.tree.map(jnp.zeros_like, _j(np_tree))
    _, jres1 = jcomp.compress_update(jlora, _j(np_tree), jg)
    _, jres2 = jcomp.compress_update(jlora, jg, jg, residual=jres1)
    for a, b in zip(tree_leaves(res1), jax.tree.leaves(jres1)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    jn = [sum(float(jnp.sum(r * r)) for r in res if not isinstance(r, tuple))
          for res in (jres1, jres2)]
    assert jn[1] < jn[0]


def test_mixed_lora_int8_fleet_aggregates(jax_basis):
    """One fleet, a LoRA group and an Int8 group, one round: finite, JAX's
    global within LORA_TOL, one wire size a client."""
    np_tree = _llm_tree(19)
    t = _t(np_tree)
    segs = T.SegmentMap.from_tree(t)
    mixed = T.MixedCodec(codecs=(T.LoRACodec(rank=2, fallback=T.Int8Codec()), T.Int8Codec()),
                         assignment=(0, 0, 1, 1)).with_segments(segs)
    n = segs.n_params
    client = {k: torch.stack([v * (1 + 0.1 * c) for c in range(4)]) for k, v in t.items()}
    new_global, _ = mixed.aggregate_updates(client, t, torch.ones(4),
                                            mixed.init_client_state(4, n, device="cpu"))
    assert set(new_global) == set(t)
    assert all(torch.isfinite(x).all() for x in new_global.values())
    per_client = mixed.wire_bytes([n] * 4)
    lora_wire = T.LoRACodec(rank=2, fallback=T.Int8Codec()).with_segments(segs).wire_bytes(n)
    int8_wire = T.Int8Codec().with_segments(segs).wire_bytes(n)
    assert per_client == [lora_wire, lora_wire, int8_wire, int8_wire]
    assert lora_wire < int8_wire
    jmixed = J.MixedCodec(codecs=(J.LoRACodec(rank=2, fallback=J.Int8Codec()), J.Int8Codec()),
                          assignment=(0, 0, 1, 1)).with_segments(J.SegmentMap.from_tree(_j(np_tree)))
    jclient = jax.tree.map(lambda v: jnp.stack([v * (1 + 0.1 * c) for c in range(4)]),
                           _j(np_tree))
    jglobal, _ = jmixed.aggregate_updates(jclient, _j(np_tree), jnp.ones(4),
                                          jmixed.init_client_state(4, n))
    assert jmixed.wire_bytes([n] * 4) == per_client
    for k in t:
        np.testing.assert_allclose(new_global[k].numpy(), np.asarray(jglobal[k]), **LORA_TOL)


def test_mixed_codec_rejects_conflicting_segment_maps():
    segs_a = T.SegmentMap.from_tree({"a": torch.zeros(8)})
    segs_b = T.SegmentMap.from_tree({"a": torch.zeros(4), "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="segment map"):
        T.MixedCodec(codecs=(T.Int8Codec().with_segments(segs_a),
                             T.TopKCodec(frac=0.5).with_segments(segs_b)),
                     assignment=(0, 1))


# ---------------- the head model: a frozen base, unaligned leaves ----------------
def test_head_model_lora_frozen_base_decodes_to_exact_zeros(jax_basis):
    """LoRA on the head model's map: the frozen base's delta is exactly
    zero, its factors decode to exact zeros (no residual either), and the
    whole decode is JAX's within LORA_TOL; Int8 factors on the unaligned
    head.w1 and head.w2 slices, the biases on the fallback."""
    tm = build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")
    g = tm.init(0)
    rng = np.random.default_rng(3)
    p = {"base": {"w": g["base"]["w"].clone()},
         "head": {k: v + torch.from_numpy((rng.normal(size=v.shape) * 0.01).astype(np.float32))
                  for k, v in g["head"].items()}}
    segs = T.SegmentMap.from_tree(g)
    codec = T.LoRACodec(rank=4, factor_codec=T.Int8Codec()).with_segments(segs)
    assert [codec._use_lora(s) for s in segs] == [True, False, False, True, True]
    su, res = tcomp.compress_update(codec, p, g)
    base = codec.decode_segment(su.payloads[0], segs[0])
    assert torch.equal(base, torch.zeros(segs[0].size)) and torch.equal(res[0], base)
    cp = tp.compress_to_wire(codec, su, segs.n_params)
    assert cp.num_bytes == codec.wire_bytes(segs.n_params)
    dec = tree_flatten_to_vector(tp.wire_to_pytree(cp, g)) - tree_flatten_to_vector(g)
    jg = jax.tree.map(lambda x: jnp.asarray(x.numpy()), g)
    jp_ = jax.tree.map(lambda x: jnp.asarray(x.numpy()), p)
    jcodec = J.LoRACodec(rank=4, factor_codec=J.Int8Codec()).with_segments(J.SegmentMap.from_tree(jg))
    jsu, _ = jcomp.compress_update(jcodec, jp_, jg)
    jdec = np.asarray(jcodec.decode_structured(jsu))
    np.testing.assert_allclose(dec.numpy(), jdec, rtol=0, atol=1e-5)
    assert np.all(jdec[: segs[0].size] == 0)
