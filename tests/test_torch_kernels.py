"""Port parity: the four reduce/codec kernels' plain PyTorch versions
(``repro_torch.kernels.ref`` via ``ops`` on CPU tensors) against the JAX
package's Pallas bodies in interpret mode and its jnp oracles, on the same
numpy inputs.  The hand-written kernels themselves are held against these
plain versions on the card by ``test_torch_cuda_kernels.py``.

Tolerances: quantize/dequantize are bitwise against the jnp oracle (same
IEEE division, same half-to-even rounding).  The Pallas quantize body's
scales are the oracle's to within one ulp (tests/test_kernels.py holds
them to rtol=1e-6) and its codes bitwise.  The reduces differ only in summation order
(the Pallas reduces normalize the weights first, the oracles divide after):
``rtol=atol=1e-6``.

The CUDA FedAvg reduce's own arithmetic (the weight sum and, for
``normalize=False``, the product inside the launch) is modelled in plain
torch in ``tests/torch_kernel_models.py`` and held bitwise against JAX's
``ops.fedavg_reduce`` in interpret mode for integer weights, where XLA's
CPU dot is the same fmaf chain (C <= 17), and within ``rtol=atol=1e-6``
where the bits may part (non-integer weights, C = 64).  The Int8 codec
kernels' persistent grids are modelled there in numpy (which warp takes
which block, what each reads) and held bitwise against JAX's oracle on
the input padded with zeros, the codec's pad that ``quantize_int8`` now
does inside its launch.  The CUDA Int8 reduce's one launch (client-order
weight sum, the fmaf chain of fl(code * scale), fl(mean * ws) for
``normalize=False``) is modelled there too: bitwise JAX's interpret-mode
reduce for C <= 17, within ``rtol=atol=1e-6`` (times sum(w) for the sum
form) at C = 64 and past the kernel's 1024 shared weights, and bitwise the
composition it replaced for integer weights.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

from repro.kernels import ref as jref
from repro.kernels.dequant_reduce import dequant_reduce as pallas_dequant_reduce
from repro.kernels.fedavg_reduce import fedavg_reduce as pallas_fedavg_reduce
from repro.kernels.quantize import dequantize_int8 as pallas_dequantize
from repro.kernels.quantize import quantize_int8 as pallas_quantize
from repro.kernels import ops as jops
from repro_torch.kernels import ops
from torch_kernel_models import (dequant_reduce_composition, dequant_reduce_one_launch,
                                 dequantize_launch, fedavg_one_launch, quantize_launch)

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(t):
    return t.detach().cpu().numpy()


def _delta(rng, shape, zero_blocks=0):
    """Update-delta-like values spanning several magnitudes, with whole
    zero blocks (scale 0 -> 1)."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-5, 0, size=shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1)[: 256 * zero_blocks] = 0.0
    return x


@pytest.mark.parametrize("n_blocks", [16, 37])
def test_quantize_int8_bitwise(n_blocks):
    rng = np.random.default_rng(n_blocks)
    x = _delta(rng, (n_blocks * 256,), zero_blocks=2)
    # exact-tie values: x / scale lands on k + 0.5, where half-to-even matters
    x[256 * 3 : 256 * 4] = 0.0
    x[256 * 3 : 256 * 3 + 4] = [127.0, 0.5, 1.5, -2.5]  # scale 1.0
    q, s = ops.quantize_int8(_t(x))
    qj, sj = jref.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(_np(q), np.asarray(qj))
    np.testing.assert_array_equal(_np(s), np.asarray(sj))
    qp, sp = pallas_quantize(jnp.asarray(x), interpret=True, bn=4096 if n_blocks % 16 == 0 else 256)
    np.testing.assert_array_equal(_np(q), np.asarray(qp))
    np.testing.assert_array_max_ulp(_np(s), np.asarray(sp), maxulp=1)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert _np(q)[256 * 3 + 1 : 256 * 3 + 4].tolist() == [0, 2, -2]


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4099])
def test_quantize_int8_ragged_n_matches_jax_pad(n):
    """Any N: the codes and scales of x padded with zeros to a block
    multiple, bitwise JAX's oracle on ``jnp.pad(x)``; the pad's codes 0."""
    rng = np.random.default_rng(n)
    x = _delta(rng, (n,))
    q, s = ops.quantize_int8(_t(x))
    qj, sj = jref.quantize_int8(jnp.pad(jnp.asarray(x), (0, (-n) % 256)))
    assert q.shape == (-(-n // 256) * 256,) and s.shape == (-(-n // 256),)
    np.testing.assert_array_equal(_np(q), np.asarray(qj))
    np.testing.assert_array_equal(_np(s), np.asarray(sj))
    assert not _np(q)[n:].any()


# a 3-CTA grid (24 warps): block counts below, at and above it and past
# three strides, whole and ragged; dequantize's warp-steps take two blocks
# each, so 48 blocks fill its grid
@pytest.mark.parametrize("n", [1, 255, 257, 5 * 256, 24 * 256, 24 * 256 + 1, 48 * 256 - 100,
                               48 * 256, 48 * 256 + 3, 79 * 256 - 9])
def test_codec_kernels_work_split_model(n):
    """``csrc/quantize.cu``'s persistent grids in numpy
    (``torch_kernel_models``): every block is quantized once, every value
    below n read once and nothing at or past n, every code, scale and
    output written or read once; the results are JAX's oracle on the
    padded input, bit for bit."""
    rng = np.random.default_rng(n)
    x = _delta(rng, (n,), zero_blocks=1)
    q, s, visits, reads = quantize_launch(x, resident_ctas=3)
    assert (visits == 1).all()
    assert (reads[:n] == 1).all() and not reads[n:].any()
    qj, sj = jref.quantize_int8(jnp.pad(jnp.asarray(x), (0, (-n) % 256)))
    np.testing.assert_array_equal(q, np.asarray(qj))
    np.testing.assert_array_equal(s, np.asarray(sj))
    xd, code_reads, scale_reads, writes = dequantize_launch(q, s, resident_ctas=3)
    assert (code_reads == 1).all() and (scale_reads == 1).all() and (writes == 1).all()
    np.testing.assert_array_equal(xd, np.asarray(jref.dequantize_int8(qj, sj)))


def test_dequantize_int8_bitwise():
    rng = np.random.default_rng(3)
    x = _delta(rng, (16 * 256,), zero_blocks=1)
    qj, sj = jref.quantize_int8(jnp.asarray(x))
    q, s = _t(np.asarray(qj)), _t(np.asarray(sj))
    out = ops.dequantize_int8(q, s)
    np.testing.assert_array_equal(_np(out), np.asarray(jref.dequantize_int8(qj, sj)))
    np.testing.assert_array_equal(
        _np(out), np.asarray(pallas_dequantize(qj, sj, interpret=True, bn=4096))
    )


@pytest.mark.parametrize("c,n,bn", [(4, 8192, 4096), (3, 5000, 4096), (2, 1031, 512)])
@pytest.mark.parametrize("normalize", [True, False])
def test_fedavg_reduce_matches_jax(c, n, bn, normalize):
    rng = np.random.default_rng(c * n)
    u = _delta(rng, (c, n))
    w = (rng.random(c) + 0.1).astype(np.float32) * 40
    out = ops.fedavg_reduce(_t(u), _t(w), normalize=normalize)
    assert out.shape == (n,) and out.dtype == torch.float32
    exp_ref = np.asarray(jref.fedavg_reduce(jnp.asarray(u), jnp.asarray(w)))
    exp_pallas = np.asarray(pallas_fedavg_reduce(jnp.asarray(u), jnp.asarray(w), interpret=True, bn=bn))
    tol = TOL
    if not normalize:  # the weighted sum: the mean's tolerance times sum(w)
        exp_ref, exp_pallas = exp_ref * w.sum(), exp_pallas * w.sum()
        tol = dict(rtol=TOL["rtol"], atol=TOL["atol"] * float(w.sum()))
    np.testing.assert_allclose(_np(out), exp_ref, **tol)
    np.testing.assert_allclose(_np(out), exp_pallas, **tol)


def test_fedavg_reduce_bf16_keeps_dtype():
    rng = np.random.default_rng(5)
    u = _delta(rng, (3, 777))
    w = (rng.random(3) + 0.1).astype(np.float32)
    ut = _t(u).to(torch.bfloat16)
    out = ops.fedavg_reduce(ut, _t(w))
    assert out.dtype == torch.bfloat16 and out.shape == (777,)
    exp = jref.fedavg_reduce(jnp.asarray(u, jnp.bfloat16), jnp.asarray(w))
    np.testing.assert_allclose(
        _np(out.float()), np.asarray(exp.astype(jnp.float32)), rtol=2**-7, atol=1e-8
    )


def _fedavg_pair(seed, c, n, dtype, weights):
    """Updates rounded to ``dtype`` once, for JAX and the port, and
    ``weights`` ("integer" example counts, "real" values, or "zero")."""
    rng = np.random.default_rng(seed)
    u = jnp.asarray(_delta(rng, (c, n)), jnp.dtype(dtype))
    w = {"integer": rng.integers(10, 500, c).astype(np.float32),
         "real": ((rng.random(c) + 0.1) * 40).astype(np.float32),
         "zero": np.zeros(c, np.float32)}[weights]
    ut = _t(np.asarray(u.astype(jnp.float32))).to(getattr(torch, dtype))
    return u, jnp.asarray(w), ut, _t(w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [2, 3, 6, 17])
@pytest.mark.parametrize("normalize", [True, False])
def test_fedavg_one_launch_model_bitwise_vs_jax(c, dtype, normalize):
    """The CUDA kernel's arithmetic (``tests/torch_kernel_models.py``: the
    client-order weight sum, wn = w / ws, one fmaf chain, and for
    ``normalize=False`` the mean and ws each rounded to the dtype before
    their product) is bitwise JAX's Pallas reduce in interpret mode plus
    its ``_denormalize``, for integer weights: their sum is exact in any
    order, and XLA's CPU dot of C <= 17 terms is the same fmaf chain."""
    u, w, ut, wt = _fedavg_pair(c, c, 5001, dtype, "integer")
    exp = jops.fedavg_reduce(u, w, normalize=normalize, interpret=True)
    out = fedavg_one_launch(ut, wt, normalize=normalize)
    assert out.dtype == getattr(torch, dtype) and out.shape == (5001,)
    np.testing.assert_array_equal(_np(out.float()), np.asarray(exp.astype(jnp.float32)))


@pytest.mark.parametrize("c,weights", [(3, "real"), (64, "integer")])
@pytest.mark.parametrize("normalize", [True, False])
def test_fedavg_one_launch_model_close_to_jax(c, weights, normalize):
    """Where the bits may part: weights that are not integers (the two
    weight sums round in other orders) and C = 64 (XLA's CPU dot blocks
    the sum): within the reduces' 1e-6, times sum(w) for the sum form."""
    u, w, ut, wt = _fedavg_pair(c + 1, c, 4099, "float32", weights)
    exp = np.asarray(jops.fedavg_reduce(u, w, normalize=normalize, interpret=True))
    out = _np(fedavg_one_launch(ut, wt, normalize=normalize))
    scale = 1.0 if normalize else float(np.asarray(w).sum())
    np.testing.assert_allclose(out, exp, rtol=TOL["rtol"], atol=TOL["atol"] * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_one_launch_model_zero_weights(dtype):
    """All-zero weights: the zero guard makes ws 1, so both forms give
    zeros, as JAX's do."""
    u, w, ut, wt = _fedavg_pair(7, 3, 1000, dtype, "zero")
    for normalize in (True, False):
        out = fedavg_one_launch(ut, wt, normalize=normalize)
        exp = jops.fedavg_reduce(u, w, normalize=normalize, interpret=True)
        assert not out.any() and not out.isnan().any()
        np.testing.assert_array_equal(_np(out.float()), np.asarray(exp.astype(jnp.float32)))


@pytest.mark.parametrize("c,n,bn", [(4, 8192, 4096), (6, 768, 512)])
@pytest.mark.parametrize("normalize", [True, False])
def test_dequant_reduce_matches_jax(c, n, bn, normalize):
    rng = np.random.default_rng(c + n)
    x = _delta(rng, (c * n,), zero_blocks=1)
    qj, sj = jref.quantize_int8(jnp.asarray(x))
    q, s = np.asarray(qj).reshape(c, n), np.asarray(sj).reshape(c, n // 256)
    w = (rng.random(c) + 0.1).astype(np.float32) * 100
    out = ops.dequant_reduce(_t(q), _t(s), _t(w), normalize=normalize)
    assert out.shape == (n,) and out.dtype == torch.float32
    exp_ref = np.asarray(jref.dequant_reduce(jnp.asarray(q), jnp.asarray(s), jnp.asarray(w)))
    exp_pallas = np.asarray(pallas_dequant_reduce(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(w), interpret=True, bn=bn
    ))
    tol = TOL
    if not normalize:  # the weighted sum: the mean's tolerance times sum(w)
        exp_ref, exp_pallas = exp_ref * w.sum(), exp_pallas * w.sum()
        tol = dict(rtol=TOL["rtol"], atol=TOL["atol"] * float(w.sum()))
    np.testing.assert_allclose(_np(out), exp_ref, **tol)
    np.testing.assert_allclose(_np(out), exp_pallas, **tol)


def _int8_wires(seed, c, n, weights):
    """C clients' Int8 wires of Np = n (JAX's quantize, one zero block) and
    ``weights`` ("integer" example counts, "real" values, or "zero"), as
    numpy arrays for both sides."""
    rng = np.random.default_rng(seed)
    x = _delta(rng, (c * n,), zero_blocks=1)
    qj, sj = jref.quantize_int8(jnp.asarray(x))
    w = {"integer": rng.integers(10, 500, c).astype(np.float32),
         "real": ((rng.random(c) + 0.1) * 40).astype(np.float32),
         "zero": np.zeros(c, np.float32)}[weights]
    return np.asarray(qj).reshape(c, n), np.asarray(sj).reshape(c, n // 256), w


def _jax_dequant_reduce(q, s, w, normalize):
    """JAX's side: the Pallas reduce in interpret mode for the mean, and
    ``ops.dequant_reduce(..., normalize=False)`` (the Pallas reduce, then
    its ``_denormalize``) for the sum."""
    args = (jnp.asarray(q), jnp.asarray(s), jnp.asarray(w))
    if normalize:
        return np.asarray(pallas_dequant_reduce(*args, interpret=True))
    return np.asarray(jops.dequant_reduce(*args, interpret=True, normalize=False))


@pytest.mark.parametrize("c,n", [(1, 512), (3, 768), (6, 4096), (17, 2048)])
@pytest.mark.parametrize("normalize", [True, False])
def test_dequant_reduce_one_launch_model_bitwise_vs_jax(c, n, normalize):
    """The CUDA Int8 reduce's arithmetic (``dequant_reduce_one_launch``)
    is bitwise JAX's Pallas reduce in interpret mode (plus its
    ``_denormalize``) for integer weights at C <= 17: the weight sums are
    exact in any order, each value is the same fp32 product code * scale,
    and XLA's CPU dot of so few terms is the same fmaf chain.  C = 1, and
    a ragged Np of 3 x 256 at C = 3."""
    q, s, w = _int8_wires(c + n, c, n, "integer")
    out = dequant_reduce_one_launch(_t(q), _t(s), _t(w), normalize=normalize)
    assert out.dtype == torch.float32 and out.shape == (n,)
    np.testing.assert_array_equal(_np(out), _jax_dequant_reduce(q, s, w, normalize))


@pytest.mark.parametrize("c,n,weights", [
    (1, 512, "real"), (3, 768, "real"), (6, 4096, "real"), (64, 2048, "integer"),
    (64, 1024, "real"), (1030, 256, "integer"), (4, 1024, "zero"),
])
@pytest.mark.parametrize("normalize", [True, False])
def test_dequant_reduce_one_launch_model_and_cpu_route_close_to_jax(c, n, weights, normalize):
    """The kernel's model and ``ops.dequant_reduce`` on the CPU against
    JAX's interpret-mode reduce in both forms, within the reduces' 1e-6
    (times sum(w) for the sum form): weights that are not integers, C = 64
    (XLA's CPU dot blocks the sum), C = 1030 (past the kernel's 1024
    normalized weights in shared memory), all-zero weights."""
    q, s, w = _int8_wires(2 * c + n, c, n, weights)
    exp = _jax_dequant_reduce(q, s, w, normalize)
    tol = dict(rtol=TOL["rtol"], atol=TOL["atol"] * (1.0 if normalize else max(float(w.sum()), 1.0)))
    model = _np(dequant_reduce_one_launch(_t(q), _t(s), _t(w), normalize=normalize))
    cpu = _np(ops.dequant_reduce(_t(q), _t(s), _t(w), normalize=normalize))
    np.testing.assert_allclose(model, exp, **tol)
    np.testing.assert_allclose(cpu, exp, **tol)
    if weights == "zero":
        assert not model.any() and not np.isnan(model).any()
        assert not cpu.any() and not np.isnan(cpu).any()


@pytest.mark.parametrize("c,n", [(1, 512), (3, 768), (6, 4096), (64, 2048), (1030, 256)])
@pytest.mark.parametrize("normalize", [True, False])
def test_dequant_reduce_one_launch_model_is_the_composition_it_replaced(c, n, normalize):
    """Integer weights: the client-order weight sum inside the launch has
    the bits of PyTorch's ``safe_weight_sum``, so the model is bitwise the
    composition it replaced -- the weights normalized around the old
    kernel's chain, then ``ops._denormalize`` -- in both forms."""
    q, s, w = _int8_wires(3 * c + n, c, n, "integer")
    args = (_t(q), _t(s), _t(w))
    out = dequant_reduce_one_launch(*args, normalize=normalize)
    assert torch.equal(out, dequant_reduce_composition(*args, normalize=normalize))
    if not normalize:
        assert torch.equal(out, ops._denormalize(dequant_reduce_one_launch(*args), args[2]))


@pytest.mark.parametrize("normalize", [True, False])
def test_reduces_all_zero_weights_give_zeros(normalize):
    rng = np.random.default_rng(9)
    u = _delta(rng, (3, 1000))
    w = torch.zeros(3)
    out = ops.fedavg_reduce(_t(u), w, normalize=normalize)
    assert not torch.isnan(out).any() and not out.any()
    x = _delta(rng, (3 * 512,))
    q, s = ops.quantize_int8(_t(x))
    out = ops.dequant_reduce(q.reshape(3, 512), s.reshape(3, 2), w, normalize=normalize)
    assert not torch.isnan(out).any() and not out.any()


def test_ops_routes_by_device_and_never_falls_back():
    """CPU tensors take the plain version and launch nothing; a tensor on
    a device with no kernel raises instead of falling back; mixed devices
    raise."""
    ops.reset_launch_counts()
    x = torch.zeros(512)
    q, s = ops.quantize_int8(x)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    with pytest.raises(ValueError):
        ops.quantize_int8(torch.zeros(512, device="meta"))
    with pytest.raises(ValueError):
        ops.dequantize_int8(q, s.to("meta"))
