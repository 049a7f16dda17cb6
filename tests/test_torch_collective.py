"""Port parity for the int8 compressed collective's pieces: the plain
``collective_pack`` / ``collective_unpack`` against ``repro.kernels.ref`` and
against the Pallas bodies in interpret mode (bitwise: the scale is an input,
so the one-ulp scale quirk of the uplink quantizer cannot arise here),
``CompressedPsum`` on one rank, the collective byte formulas (exactly
equal to the JAX package's), and ``collective_tiers``.  The ops routing: a CPU tensor takes the plain
version and launches nothing; a tensor on another device raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

from repro.core import CompressedPsum as JCompressedPsum
from repro.core.compression import fp32_collective_bytes as jfp32_collective_bytes
from repro.kernels import collective_quant as jcq
from repro.kernels import ref as jref
from repro_torch.core import CompressedPsum, fp32_collective_bytes
from repro_torch.kernels import collective_quant, ops, ref
from repro_torch.launch import ClientMesh, collective_tiers, mesh_info

BLOCK = 256


def _scales(x):
    am = np.abs(x).reshape(-1, BLOCK).max(axis=1)
    return np.where(am == 0.0, 1.0, am / np.float32(127.0)).astype(np.float32)


def _edge_values(rng, n_blocks):
    """Values on the pack's edges, with power-of-two scales so that
    (k + 1/2) * s is exact: half-way points (ties go to even), zeros,
    +-127 s, values past +-127 s (clipped), and -0.0."""
    s = (2.0 ** rng.integers(-12, 2, n_blocks)).astype(np.float32)
    k = rng.integers(-140, 140, (n_blocks, BLOCK)).astype(np.float32)
    half = rng.random((n_blocks, BLOCK)) < 0.5
    x = (k + np.where(half, 0.5, 0.0)) * s[:, None]
    x[:, :4] = np.asarray([0.0, -0.0, 127.0, -127.0]) * s[:, None]
    x[:, 4:6] = np.asarray([127.5, -128.5]) * s[:, None]
    return x.astype(np.float32).reshape(-1), s


def _inputs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "edges":
        return _edge_values(rng, 9)
    x = (rng.normal(size=(7713 * BLOCK,)) * 10.0 ** rng.uniform(-5, 0)).astype(np.float32)
    x[:BLOCK] = 0.0  # a zero block: scale 0 -> 1
    return x, _scales(x)


@pytest.mark.parametrize("kind", ["edges", "deltas"])
def test_collective_pack_unpack_match_jax_bitwise(kind):
    x, s = _inputs(kind, 0)
    q = ref.collective_pack(torch.from_numpy(x), torch.from_numpy(s))
    assert q.dtype == torch.int32 and int(q.abs().max()) <= 127
    q_jref = np.asarray(jref.collective_pack(jnp.asarray(x), jnp.asarray(s)))
    # bn=BLOCK: with the default bn=8192 the Pallas grid is N // 8192, so
    # at Np = 1,974,528 the last 256 values are never written (a reference
    # quirk the port does not copy; its kernels take any N % 256 == 0)
    q_pal = np.asarray(jcq.collective_pack(jnp.asarray(x), jnp.asarray(s), bn=BLOCK,
                                           interpret=True))
    np.testing.assert_array_equal(q.numpy(), q_jref)
    np.testing.assert_array_equal(q.numpy(), q_pal)
    back = ref.collective_unpack(q, torch.from_numpy(s))
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jref.collective_unpack(jnp.asarray(q_jref), jnp.asarray(s))))
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jcq.collective_unpack(jnp.asarray(q_jref), jnp.asarray(s), bn=BLOCK, interpret=True)))


def test_collective_pack_ties_round_to_even_and_clip():
    s = torch.full((1,), 0.25)
    x = torch.zeros(BLOCK)
    x[:6] = torch.tensor([0.5, 1.5, -0.5, -2.5, 127.5, -200.0]) * 0.25
    q = ref.collective_pack(x, s)
    assert q[:6].tolist() == [0, 2, 0, -2, 127, -127]


def test_collective_quant_exactly_summable():
    """Shared scales: the int32 sum of 8 ranks' codes is exact, and
    unpack(sum) equals sum(unpack) to one fp32 rounding per element."""
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(8, 4096)).astype(np.float32)
    s = torch.from_numpy(_scales(np.abs(xs).max(axis=0)))  # the MAX all-reduce
    qs = [ref.collective_pack(torch.from_numpy(x), s) for x in xs]
    q_sum = sum(q.to(torch.int64) for q in qs)
    assert int(q_sum.abs().max()) <= 8 * 127
    assert torch.equal(sum(qs), q_sum.to(torch.int32))
    summed = ref.collective_unpack(q_sum.to(torch.int32), s)
    unpacked = sum(ref.collective_unpack(q, s) for q in qs)
    torch.testing.assert_close(summed, unpacked, rtol=0, atol=float(s.max()) * 1e-4)


@pytest.mark.parametrize("n", [7050, 1, 256, 4113])  # ragged ones are padded to the block
def test_compressed_psum_on_one_rank_matches_jax_pieces(n):
    """With no tier to reduce over, psum is pack -> unpack of wx + residual
    against its own block scale, and the residual is what was not sent."""
    rng = np.random.default_rng(2)
    wx = (rng.normal(size=n) * 1e-3).astype(np.float32)
    r = (rng.normal(size=n) * 1e-5).astype(np.float32)
    total, new_r = CompressedPsum().psum(torch.from_numpy(wx), torch.from_numpy(r), ())
    eff = jnp.pad(jnp.asarray(wx) + jnp.asarray(r), (0, (-n) % BLOCK))
    am = jnp.max(jnp.abs(eff).reshape(-1, BLOCK), axis=1)
    sj = jnp.where(am == 0.0, 1.0, am / 127.0)
    want = np.asarray(jref.collective_unpack(jref.collective_pack(eff, sj), sj))[:n]
    np.testing.assert_array_equal(total.numpy(), want)
    np.testing.assert_array_equal(new_r.numpy(), np.asarray(eff)[:n] - want)
    # the scales the pack derives from the (here unreduced) block absmax
    leaves, resid = [torch.from_numpy(wx)], [torch.from_numpy(r)]
    absmax = ops.collective_absmax(leaves, None, resid)
    np.testing.assert_array_equal(absmax.numpy(), np.asarray(am))
    _, scales, _ = ops.collective_pack_leaves(leaves, None, resid, absmax)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(sj))


# mobilenet-head-office31.reduced()'s leaves in JAX's order (base.w, head.b1,
# head.b2, head.w1, head.w2): two end mid-block, one is 31 values
REDUCED_LEAVES = (4096, 32, 31, 2048, 992)
WEIGHT = 3.0  # an example count


def _bits_or_nan(got, want):
    """Bitwise, a NaN matching any NaN."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(np.where(nan, 0, got).view(np.int32),
                                  np.where(nan, 0, want).view(np.int32))


def _leaf_case(case, seed, sizes=REDUCED_LEAVES):
    """Per leaf (d, r) in numpy, the weight and the live flag.  "edges":
    weight 1/2 and d = 2 eff, each block of eff holding 127 s (its absmax,
    so the scale is the power of two s), +-0, -127 s and half-way points
    (k + 1/2) s; base.w's block 1 holds a NaN, block 2 zeros (scale 1).
    "deltas": update-like d and residuals; "live" the same with the flag
    True; "masked" with it False and the weight 0 (the round step folds
    the mask into the weight)."""
    rng = np.random.default_rng(seed)
    live = {"live": True, "masked": False}.get(case)
    wf = 0.0 if case == "masked" else WEIGHT
    leaves = []
    for i, n in enumerate(sizes):
        if case == "edges":
            nb = -(-n // BLOCK)
            s = 2.0 ** rng.integers(-12, 2, (nb, 1))
            k = rng.integers(-126, 127, (nb, BLOCK)) + np.where(rng.random((nb, BLOCK)) < 0.5,
                                                                 0.5, 0.0)
            k[:, :4] = [127.0, 0.0, -0.0, -127.0]
            eff = (k * s).astype(np.float32).reshape(-1)[:n]
            if i == 0:
                eff[BLOCK + 5], eff[2 * BLOCK:3 * BLOCK] = np.nan, 0.0
            leaves.append((2 * eff, np.zeros(n, np.float32)))
            wf = 0.5
        else:
            d = (rng.normal(size=n) * 10.0 ** rng.uniform(-4, -1)).astype(np.float32)
            r = (rng.normal(size=n) * 1e-5).astype(np.float32)
            leaves.append((d, r))
    return leaves, wf, live


def _jax_leaf_psum(d, r, wf, live):
    """The JAX round step's int8 collective on one leaf (``leaf_psum`` in
    ``repro.core.rounds``, a masked rank's leaf zeroed before it), eager and
    with no axis to reduce over."""
    d, r = jnp.asarray(d), jnp.asarray(r)
    if live is not None:
        d = jnp.where(live, d, jnp.zeros_like(d))
    wx = d.astype(jnp.float32) * jnp.float32(wf)
    r_in = r if live is None else jnp.where(live, r, 0.0)
    total, new_r = JCompressedPsum().psum(wx, r_in, ())
    if live is not None:
        new_r = jnp.where(live, new_r, r)
    return np.asarray(total), np.asarray(new_r)


@pytest.mark.parametrize("case", ["edges", "deltas", "live", "masked"])
def test_psum_leaves_on_one_rank_matches_jax_per_leaf_psum(case):
    """``psum_leaves`` over the reduced head model's five leaves (no tier:
    one rank) against JAX's ``CompressedPsum.psum`` leaf by leaf, as its
    round step calls it: totals and new residuals bitwise, NaN as NaN.  A
    masked rank's totals are zeros and its rows carry bitwise.  (An inf
    makes x / scale NaN, whose conversion to int32 PyTorch leaves to the
    CPU and XLA maps to 0; the card maps it to 0 too, so inf blocks are
    held there, ``test_torch_cuda_kernels.py``.)"""
    leaves, wf, live = _leaf_case(case, 22)
    ds = [torch.from_numpy(d) for d, _ in leaves]
    rs = [torch.from_numpy(r) for _, r in leaves]
    totals, new_rs = CompressedPsum().psum_leaves(
        ds, torch.full((1,), wf), rs, (), None if live is None else torch.tensor(live))
    for (d, r), total, new_r in zip(leaves, totals, new_rs, strict=True):
        want_total, want_r = _jax_leaf_psum(d, r, wf, live)
        _bits_or_nan(total.numpy(), want_total)
        _bits_or_nan(new_r.numpy(), want_r)
        if live is False:
            assert not total.any()
            np.testing.assert_array_equal(new_r.numpy(), r)


@pytest.mark.parametrize("case", ["edges", "deltas", "live", "masked", "inf"])
def test_collective_leaf_plain_versions_are_the_per_leaf_composition(case):
    """``ref.collective_absmax`` and ``ref.collective_pack_leaves`` (what
    the CPU runs, and what the card's kernels are held to) against the
    per-leaf composition they replaced, built from the single-vector
    ``ref.collective_pack`` / ``collective_unpack`` and ``torch.amax``:
    bitwise, NaN as NaN; leaf i at its first block of the flat buffers, its
    pad codes zero.  "inf" is "deltas" with an inf in base.w."""
    from torch_kernel_models import collective_per_leaf

    leaves, wf, live = _leaf_case("deltas" if case == "inf" else case, 23)
    if case == "inf":
        leaves[0][0][300] = np.inf
    ds = [torch.from_numpy(d) for d, _ in leaves]
    rs = [torch.from_numpy(r) for _, r in leaves]
    wf_t = torch.full((1,), wf)
    lv = None if live is None else torch.tensor(live)
    absmax = ref.collective_absmax(ds, wf_t, rs, lv)
    q, s, new = ref.collective_pack_leaves(ds, wf_t, rs, absmax, lv)
    total = ref.collective_unpack(q, s)
    starts = ops.first_blocks(REDUCED_LEAVES)
    assert starts == [0, 16, 17, 18, 26, 30] and q.shape[0] == new.shape[0] == 30 * BLOCK
    per_leaf = collective_per_leaf(ds, wf_t, rs, lv, ref.collective_pack, ref.collective_unpack)
    for (am, sc, code, tot, row), a, b, n in zip(per_leaf, starts, starts[1:], REDUCED_LEAVES):
        _bits_or_nan(absmax[a:b].numpy(), am.numpy())
        _bits_or_nan(s[a:b].numpy(), sc.numpy())
        np.testing.assert_array_equal(q[BLOCK * a:BLOCK * b].numpy(), code.numpy())
        assert not q[BLOCK * a + n:BLOCK * b].any()  # the pad
        _bits_or_nan(total[BLOCK * a:BLOCK * a + n].numpy(), tot.numpy())
        _bits_or_nan(new[BLOCK * a:BLOCK * a + n].numpy(), row.numpy())
    if case == "edges":  # NaN kept by the absmax; the zero block's scale 1
        assert np.isnan(float(absmax[1])) and float(s[2]) == 1.0
    if case == "inf":
        assert np.isinf(float(absmax[1])) and np.isinf(float(s[1]))


@pytest.mark.parametrize("resident", [1, 3, 200])
def test_collective_leaf_walk_covers_every_block_once(resident):
    """The kernels' grid-stride walk over the leaf table (``tests/
    torch_kernel_models.py``): every block of every leaf visited once and
    found in its own leaf, every value read once, none at or past a
    leaf's end, at the reduced and the full head model's leaves and with
    a leaf of no values."""
    from torch_kernel_models import collective_leaf_walk

    for sizes in (REDUCED_LEAVES, (1_638_400, 256, 31, 327_680, 7_936), (300, 0, 5, 256)):
        found, visits, reads = collective_leaf_walk(list(sizes), resident)
        starts = ops.first_blocks(sizes)
        owner = np.concatenate([np.full(b - a, i) for i, (a, b) in
                                enumerate(zip(starts, starts[1:]))])
        np.testing.assert_array_equal(found, owner)
        assert (visits == 1).all()
        assert all((r == 1).all() for r in reads)


def test_ops_route_by_device():
    x, s = _inputs("edges", 3)
    before = ops.launch_counts()
    q = ops.collective_pack(torch.from_numpy(x), torch.from_numpy(s))
    ops.collective_unpack(q, torch.from_numpy(s))
    leaves, wf, _ = _leaf_case("deltas", 4)
    ds, rs = [torch.from_numpy(d) for d, _ in leaves], [torch.from_numpy(r) for _, r in leaves]
    absmax = ops.collective_absmax(ds, torch.full((1,), wf), rs)
    ops.collective_pack_leaves(ds, torch.full((1,), wf), rs, absmax)
    assert ops.launch_counts() == before  # the CPU took the plain versions
    with pytest.raises(ValueError, match="no kernel"):
        ops.collective_pack(torch.zeros(BLOCK, device="meta"), torch.ones(1, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):  # the wrapper takes CUDA tensors only
        collective_quant.collective_pack(torch.from_numpy(x), torch.from_numpy(s))
    with pytest.raises(ValueError, match="no kernel"):
        ops.collective_absmax([torch.zeros(3, device="meta")], None,
                              [torch.zeros(3, device="meta")])
    with pytest.raises(ValueError, match="CUDA"):
        collective_quant.collective_absmax(ds, None, rs)
    with pytest.raises(ValueError, match="leaves"):  # the table's limit, checked first
        collective_quant.collective_absmax(ds * 20, None, rs * 20)


# ---------------- collective bytes ----------------
@pytest.mark.parametrize("n", [1, 255, 256, 7050, 1_974_303])
def test_collective_byte_formulas_match_jax(n):
    assert CompressedPsum().collective_bytes(n) == JCompressedPsum().collective_bytes(n)
    assert fp32_collective_bytes(n) == jfp32_collective_bytes(n)
    assert CompressedPsum().collective_bytes(n) == n + 4 * ((n + 255) // 256) + 4
    if n >= 7050:  # tests/test_collective.py's ratio: int8 moves under a quarter of fp32
        assert fp32_collective_bytes(n) / CompressedPsum().collective_bytes(n) >= 3.9
    assert CompressedPsum.block == JCompressedPsum().block == ops.BLOCK


@pytest.mark.parametrize("client_axes", [("pod", "data"), ("data",), ("pod",),
                                         ("data", "model")])
def test_collective_tiers_and_mesh_info(client_axes):
    mesh = ClientMesh(axes=(("pod", 2), ("data", 2), ("model", 2)), rank=5)
    sizes = dict(mesh.axes)
    assert collective_tiers(mesh, client_axes) == tuple((a, sizes[a]) for a in client_axes)
    with pytest.raises(ValueError, match="not on mesh"):
        collective_tiers(mesh, client_axes + ("rack",))
    assert mesh_info(mesh) == {"axes": {"pod": 2, "data": 2, "model": 2}, "n_devices": 8}
    assert mesh.coords == {"pod": 1, "data": 0, "model": 1}
    if len(jax.devices()) >= 8:  # the JAX mesh of tests/test_collective.py gives the same tiers
        from repro.launch.mesh import collective_tiers as jcollective_tiers

        jmesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
        assert jcollective_tiers(jmesh, client_axes) == collective_tiers(mesh, client_axes)
        with pytest.raises(ValueError, match="not on mesh"):
            jcollective_tiers(jmesh, client_axes + ("rack",))
