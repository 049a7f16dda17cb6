"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Imports no JAX, so it runs where the port runs:

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Elsewhere every test skips.  Quantize/dequantize must match bitwise; the
reduces differ from the plain versions only in summation order (cuBLAS's
against one fp32 accumulator per column): ``rtol=atol=1e-6`` for fp32;
for bf16 outputs the two fp32 sums may straddle a rounding edge, so one
bf16 ulp (``rtol=2**-7``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _delta(rng, shape, zero_blocks=0):
    """Update-delta-like values spanning several magnitudes, with whole
    zero blocks (scale 0 -> 1)."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-5, 0, size=shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1)[: 256 * zero_blocks] = 0.0
    return x


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [1, 9, 7713])
def test_cuda_codec_kernels_bitwise(cuda, n_blocks):
    rng = np.random.default_rng(n_blocks)
    x = _t(_delta(rng, (n_blocks * 256,), zero_blocks=1)).to(cuda)
    before = ops.launch_counts()
    q, s = ops.quantize_int8(x)
    xd = ops.dequantize_int8(q, s)
    after = ops.launch_counts()
    assert after["quantize_int8"] == before["quantize_int8"] + 1
    assert after["dequantize_int8"] == before["dequantize_int8"] + 1
    qr, sr = ref.quantize_int8(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(xd, ref.dequantize_int8(qr, sr))


@pytest.mark.cuda
@pytest.mark.parametrize("c,n", [(2, 1_974_303), (6, 1000), (64, 4099)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fedavg_reduce(cuda, c, n, dtype):
    rng = np.random.default_rng(c)
    u = _t(_delta(rng, (c, n))).to(cuda, dtype)
    w = _t((rng.random(c) + 0.1).astype(np.float32)).to(cuda)
    out = ops.fedavg_reduce(u, w)
    exp = ref.fedavg_reduce(u, w)
    assert out.dtype == dtype
    tol = TOL if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-8)
    torch.testing.assert_close(out.float(), exp.float(), **tol)
    assert not ops.fedavg_reduce(u, torch.zeros_like(w)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("c,n_blocks", [(6, 7713), (64, 7713), (3, 3)])
def test_cuda_dequant_reduce(cuda, c, n_blocks):
    rng = np.random.default_rng(c)
    x = _t(_delta(rng, (c * n_blocks * 256,), zero_blocks=1)).to(cuda)
    q, s = ref.quantize_int8(x)
    q, s = q.reshape(c, -1), s.reshape(c, -1)
    w = _t((rng.random(c) + 0.1).astype(np.float32)).to(cuda)
    torch.testing.assert_close(
        ops.dequant_reduce(q, s, w), ref.dequant_reduce(q, s, w), **TOL
    )
    assert not ops.dequant_reduce(q, s, torch.zeros_like(w)).any()


@pytest.mark.cuda
def test_cuda_quantize_nan_block_poisons_its_scale(cuda):
    """A NaN in a block gives that block a NaN scale, as the plain version
    (torch.amax) does, so the dequantized block is NaN; other blocks stay
    bitwise."""
    rng = np.random.default_rng(11)
    x = _t(_delta(rng, (4 * 256,))).to(cuda)
    x[256 + 7] = float("nan")
    q, s = ops.quantize_int8(x)
    qr, sr = ref.quantize_int8(x)
    assert torch.isnan(s[1]) and torch.isnan(sr[1])
    keep = torch.tensor([0, 2, 3], device=cuda)
    assert torch.equal(s[keep], sr[keep])
    assert torch.equal(q.reshape(4, 256)[keep], qr.reshape(4, 256)[keep])
    assert torch.isnan(ops.dequantize_int8(q, s).reshape(4, 256)[1]).all()
