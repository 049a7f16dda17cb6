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
    scales = CompressedPsum().shared_scales(torch.from_numpy(np.array(eff)), ())
    np.testing.assert_array_equal(scales.numpy(), np.asarray(sj))


def test_ops_route_by_device():
    x, s = _inputs("edges", 3)
    before = ops.launch_counts()
    q = ops.collective_pack(torch.from_numpy(x), torch.from_numpy(s))
    ops.collective_unpack(q, torch.from_numpy(s))
    assert ops.launch_counts() == before  # the CPU took the plain versions
    with pytest.raises(ValueError, match="no kernel"):
        ops.collective_pack(torch.zeros(BLOCK, device="meta"), torch.ones(1, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):  # the wrapper takes CUDA tensors only
        collective_quant.collective_pack(torch.from_numpy(x), torch.from_numpy(s))


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
