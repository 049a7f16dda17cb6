"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Imports no JAX, so it runs where the port runs:

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Elsewhere every test skips.  Quantize/dequantize must match bitwise; the
reduces differ from the plain versions only in summation order (cuBLAS's
against one fp32 accumulator per column): ``rtol=atol=1e-6`` for fp32;
for bf16 outputs the two fp32 sums may straddle a rounding edge, so one
bf16 ulp (``rtol=2**-7``).  The FedAvg reduce forms its weight sum in
client order inside the launch: with integer weights it is bitwise the
composition it replaced in both forms (``tests/torch_kernel_models.py``'s
fmaf chain, then ``ops._denormalize``); so is the Int8 reduce
(``dequant_reduce``, the chain of fl(code * scale)).  With FedBuff's
staleness weights, which are not integers, both stay within 4C units of
2**-24 * sum_c |w_c x_c| (``reduce_error_units``).  The TopK scatter reduce adds the
same fp32 products ``w_c * val`` as its plain version and divides by a
weight sum it
forms itself in a fixed order: with integer weights that sum is exact, so
the result is bitwise the client-order composition it replaced and, where
the rows share no index, the plain version; with other weights the two
sums may round apart, within 2C - 1 ulps of the mean.  On TopKCodec's wire
two launches give the same bits.  The attention kernels are held at
``tests/test_kernels.py``'s tolerances, 2e-5 (fp32) and 2e-2 (bf16): their
sums run in another order than the plain versions', the plain decode
rounds q * scale and the probabilities to the cache dtype where the
kernel, like the Pallas body, keeps fp32, and bf16 flash runs its products
on the tensor cores with P rounded to bf16 (``tests/test_torch_attention.py``
holds that rounding against JAX's oracle on the CPU).  The selective scan rounds each
product and sum of its state update as the plain version's PyTorch ops do
and calls the same ``expf``; only the output's sum over N runs in another
order: ``rtol=atol=1e-5`` for fp32 y and the state, and one bf16 ulp
(``rtol=atol=2**-7``) for bf16 y, whose fp32 sums may straddle a rounding
edge.  Its backward recomputes those states bitwise from the forward's
checkpoints: it is bitwise ``tests/torch_kernel_models.py``'s
``scan_bwd_kernel_order``, and within relative L2 1e-5 of the plain
backward, whose sums run in other orders (a bf16 dx 2**-8).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as decode_kernel
from repro_torch.kernels import ops, ref
from repro_torch.utils.pytree import safe_weight_sum, tree_leaves
from torch_kernel_models import (dequant_reduce_composition, dequant_reduce_one_launch,
                                 fedavg_one_launch, fedbuff_weights, reduce_error_units)
from torch_kernel_models import FLASH_BWD_CASES as MODEL_FLASH_BWD_CASES

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
@pytest.mark.parametrize("c,n", [(2, 1_974_303), (64, 1_974_303), (3, 1001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_fedavg_reduce_is_the_composition_it_replaced(cuda, c, n, dtype):
    """Integer weights: bitwise the kernel-plus-composition it replaced in
    both forms -- the weights normalized by safe_weight_sum around the
    kernel, one fmaf chain (``tests/torch_kernel_models.py``), and for
    normalize=False that mean then ``ops._denormalize`` -- and all-zero
    weights give zeros in both forms."""
    rng = np.random.default_rng(c + 2)
    u = _t(_delta(rng, (c, n))).to(cuda, dtype)
    w = _t(rng.integers(10, 500, c).astype(np.float32)).to(cuda)
    mean = ops.fedavg_reduce(u, w)
    summed = ops.fedavg_reduce(u, w, normalize=False)
    old_mean = fedavg_one_launch(u, w)
    assert torch.equal(mean, old_mean)
    assert torch.equal(summed, ops._denormalize(old_mean, w))
    assert torch.equal(summed, ops._denormalize(mean, w))
    for normalize in (True, False):
        zero = ops.fedavg_reduce(u, torch.zeros_like(w), normalize=normalize)
        assert not zero.any() and not zero.isnan().any()


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
@pytest.mark.parametrize("c,n_blocks", [(6, 7713), (64, 7713), (3, 3), (1030, 9), (3, 20_001),
                                        (70, 20_001), (4, 43_649)])
def test_cuda_dequant_reduce_is_the_composition_it_replaced(cuda, c, n_blocks):
    """Integer weights: bitwise the one-launch model and the composition
    it replaced (the weights normalized around the old kernel's chain,
    then ``ops._denormalize``) with normalize True and False: the fleet's
    C = 6 and C = 64 at Np, a ragged 3 blocks, C past the 1024 weights and
    the 64 scale rows a warp stages, 20,001 blocks (1,251 CTAs, more
    than the card holds at once), and the Jetson fleet's C = 4 at the
    ResNet's Np = 11,174,144 (43,649 blocks).  Weights that are not
    integers stay within 1e-6 of the plain version (times sum(w) for the
    sum); all-zero weights give zeros, no NaN, in both forms."""
    rng = np.random.default_rng(c + n_blocks)
    x = _t(_delta(rng, (c * n_blocks * 256,), zero_blocks=1)).to(cuda)
    q, s = ref.quantize_int8(x)
    q, s = q.reshape(c, -1), s.reshape(c, -1)
    w = _t(rng.integers(10, 500, c).astype(np.float32)).to(cuda)
    for normalize in (True, False):
        out = ops.dequant_reduce(q, s, w, normalize=normalize)
        assert torch.equal(out, dequant_reduce_one_launch(q, s, w, normalize=normalize))
        assert torch.equal(out, dequant_reduce_composition(q, s, w, normalize=normalize))
        zero = ops.dequant_reduce(q, s, torch.zeros_like(w), normalize=normalize)
        assert not zero.any() and not zero.isnan().any()
    fw = _t(((rng.random(c) + 0.1) * 40).astype(np.float32)).to(cuda)
    torch.testing.assert_close(ops.dequant_reduce(q, s, fw), ref.dequant_reduce(q, s, fw), **TOL)
    torch.testing.assert_close(ops.dequant_reduce(q, s, fw, normalize=False),
                               ref.dequant_reduce(q, s, fw) * fw.sum(),
                               rtol=TOL["rtol"], atol=TOL["atol"] * float(fw.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,c", [("fedavg_reduce", 2), ("fedavg_reduce", 64),
                                      ("dequant_reduce", 6), ("dequant_reduce", 64)])
def test_cuda_reduces_with_fedbuff_weights_within_bound(cuda, kernel, c):
    """FedBuff's staleness weights n / (1 + s) ** 0.5, s = 0-4, are not
    integers, so the weight sum the launch forms and PyTorch's may round
    apart: both forms stay within 4C units of 2**-24 * sum_c |w_c x_c|
    (over sum w for the mean) of the plain version, the first-order
    rounding budget of two such reduces (``reduce_error_units``)."""
    rng = np.random.default_rng(23 + c)
    w = fedbuff_weights(rng.integers(10, 500, c)).to(cuda)
    if kernel == "fedavg_reduce":
        x = _t(_delta(rng, (c, 1_974_303))).to(cuda)
        run = lambda normalize: ops.fedavg_reduce(x, w, normalize=normalize)
        plain = ref.fedavg_reduce(x, w)
    else:
        qr, sr = ref.quantize_int8(_t(_delta(rng, (c * 7713 * 256,), zero_blocks=1)).to(cuda))
        q, s = qr.reshape(c, -1), sr.reshape(c, -1)
        x = ref.dequantize_int8(qr, sr).reshape(c, -1)
        run = lambda normalize: ops.dequant_reduce(q, s, w, normalize=normalize)
        plain = ref.dequant_reduce(q, s, w)
    for normalize in (True, False):
        want = plain if normalize else ops._denormalize(plain, w)
        assert reduce_error_units(run(normalize), want, x, w, normalize=normalize) <= 4 * c


@pytest.mark.cuda
def test_cuda_dequant_reduce_no_clients_no_launch(cuda):
    """C = 0: zeros of Np, in both forms, and no launch."""
    q = torch.zeros(0, 512, dtype=torch.int8, device=cuda)
    s = torch.zeros(0, 2, device=cuda)
    before = ops.launch_counts()["dequant_reduce"]
    for normalize in (True, False):
        out = ops.dequant_reduce(q, s, torch.zeros(0, device=cuda), normalize=normalize)
        assert out.shape == (512,) and out.dtype == torch.float32 and not out.any()
    assert ops.launch_counts()["dequant_reduce"] == before


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


def _pad(x):
    return torch.nn.functional.pad(x, (0, (-x.numel()) % 256))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 1000, 1_974_303, 8 * 1_974_528 + 5, 11_173_962])
def test_cuda_quantize_any_n_is_the_padded_plain_version(cuda, n):
    """Any N: one launch quantizes x as if padded with zeros to a block
    multiple, bitwise the plain version of the padded x; the pad's codes
    are 0."""
    rng = np.random.default_rng(n)
    x = _t(_delta(rng, (n,))).to(cuda)
    before = ops.launch_counts()["quantize_int8"]
    q, s = ops.quantize_int8(x)
    assert ops.launch_counts()["quantize_int8"] == before + 1
    qr, sr = ref.quantize_int8(_pad(x))
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert not q[n:].any()


@pytest.mark.cuda
def test_cuda_quantize_nan_in_the_tail_block_poisons_only_its_scale(cuda):
    """A NaN and an inf in the partial last block: its scale is NaN, as the
    plain version's of the padded x; every other block stays bitwise."""
    rng = np.random.default_rng(13)
    n = 4 * 256 + 77
    x = _t(_delta(rng, (n,))).to(cuda)
    x[4 * 256 + 5], x[4 * 256 + 60] = float("nan"), float("inf")
    q, s = ops.quantize_int8(x)
    qr, sr = ref.quantize_int8(_pad(x))
    assert torch.isnan(s[4]) and torch.isnan(sr[4])
    assert torch.equal(s[:4], sr[:4]) and torch.equal(q[: 4 * 256], qr[: 4 * 256])


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", [1, 2, 9, 7713, 16_897, 61_705, 135_169])
def test_cuda_dequantize_at_grid_edges(cuda, n_blocks):
    """Odd block counts (the last warp-step holds one block), fewer than
    the grid's warps and many strides of it: bitwise the plain version."""
    rng = np.random.default_rng(n_blocks)
    qr, sr = ref.quantize_int8(_t(_delta(rng, (n_blocks * 256,), zero_blocks=1)).to(cuda))
    assert torch.equal(ops.dequantize_int8(qr, sr), ref.dequantize_int8(qr, sr))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 257, 1_974_303, 11_173_962])
def test_cuda_int8_encode_matches_its_cpu_route(cuda, n):
    """Int8Codec's encode and decode on the card (one quantize launch on
    the unpadded delta) bitwise the same codec on the CPU (F.pad, then the
    plain version)."""
    from repro_torch.core.compression import Int8Codec

    rng = np.random.default_rng(n + 1)
    delta = _t(_delta(rng, (n,)))
    card, cpu = Int8Codec().encode(delta.to(cuda)), Int8Codec().encode(delta)
    assert card["n"] == cpu["n"] == n
    assert torch.equal(card["q"].cpu(), cpu["q"]) and torch.equal(card["scale"].cpu(), cpu["scale"])
    assert torch.equal(Int8Codec().decode(card).cpu(), Int8Codec().decode(cpu))


def _topk_payload(rng, c, k, n, *, disjoint=False):
    """Canonical TopK wires: distinct indices, ascending in every row."""
    if disjoint:
        idx = rng.permutation(n)[: c * k].reshape(c, k)
    else:
        idx = np.stack([rng.choice(n, size=k, replace=False) for _ in range(c)])
    idx = np.sort(idx, axis=1).astype(np.int32)
    val = (rng.normal(size=(c, k)) * 1e-2).astype(np.float32)
    w = rng.integers(10, 500, c).astype(np.float32)
    return _t(idx), _t(val), _t(w)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,n", [(4, 19_743, 1_974_303), (64, 19_743, 1_974_303), (3, 50, 8193)])
def test_cuda_topk_scatter_reduce(cuda, c, k, n):
    rng = np.random.default_rng(c + k)
    idx, val, w = (t.to(cuda) for t in _topk_payload(rng, c, k, n))
    before = ops.launch_counts()["topk_scatter_reduce"]
    out = ops.topk_scatter_reduce(idx, val, w, n)
    assert ops.launch_counts()["topk_scatter_reduce"] == before + 1
    torch.testing.assert_close(out, ref.topk_scatter_reduce(idx, val, w, n), **TOL)
    # canonical wire: the same bits on every launch
    assert torch.equal(out, ops.topk_scatter_reduce(idx, val, w, n))
    # disjoint rows: one term a coordinate, the plain version's bits
    idx, val, w = (t.to(cuda) for t in _topk_payload(rng, c, min(k, n // c), n, disjoint=True))
    assert torch.equal(ops.topk_scatter_reduce(idx, val, w, n), ref.topk_scatter_reduce(idx, val, w, n))


@pytest.mark.cuda
def test_cuda_topk_scatter_reduce_foreign_wires(cuda):
    """Unsorted rows, repeated and out-of-range indices: every in-range
    term lands, nothing wraps; zero weights and empty payloads give zeros."""
    rng = np.random.default_rng(5)
    n = 20_000
    idx = rng.integers(0, n, (5, 300)).astype(np.int32)  # unsorted, with repeats
    idx[1, :10] = [-1, n, 2**31 - 1, -(2**31), 0, 0, n - 1, n - 1, 5, 5]
    val = (rng.normal(size=(5, 300)) * 1e-2).astype(np.float32)
    w = rng.integers(10, 500, 5).astype(np.float32)
    idx, val, w = (_t(a).to(cuda) for a in (idx, val, w))
    torch.testing.assert_close(ops.topk_scatter_reduce(idx, val, w, n),
                               ref.topk_scatter_reduce(idx, val, w, n), **TOL)
    out = ops.topk_scatter_reduce(torch.tensor([[0, -1, 256, 5, 2**30, 255]], dtype=torch.int32,
                                               device=cuda), torch.ones(1, 6, device=cuda),
                                  torch.ones(1, device=cuda), 256)
    exp = torch.zeros(256, device=cuda)
    exp[[0, 5, 255]] = 1.0
    assert torch.equal(out, exp)
    zero = ops.topk_scatter_reduce(idx, val, torch.zeros_like(w), n)
    assert not zero.any() and not zero.isnan().any()
    for c, k in ((3, 0), (0, 7)):
        empty = ops.topk_scatter_reduce(torch.zeros(c, k, dtype=torch.int32, device=cuda),
                                        torch.zeros(c, k, device=cuda), torch.ones(c, device=cuda), n)
        assert empty.shape == (n,) and not empty.any()


@pytest.mark.cuda
def test_cuda_topk_scatter_reduce_dense_tiles_and_many_rows(cuda):
    """The kernel's long paths on canonical wires: a row with more entries
    in one 8192-float tile than a CTA has threads, and more client rows
    than one group of 256."""
    rng = np.random.default_rng(9)
    n = 20_000
    idx = np.stack([np.sort(rng.choice(8192 + 100, size=3000, replace=False)) for _ in range(3)])
    cases = [(idx.astype(np.int32), 3, 3000)]
    idx = np.stack([np.sort(rng.choice(n, size=40, replace=False)) for _ in range(300)])
    cases.append((idx.astype(np.int32), 300, 40))
    for idx, c, k in cases:
        val = (rng.normal(size=(c, k)) * 1e-2).astype(np.float32)
        w = rng.integers(10, 500, c).astype(np.float32)
        idx, val, w = (_t(a).to(cuda) for a in (idx, val, w))
        out = ops.topk_scatter_reduce(idx, val, w, n)
        torch.testing.assert_close(out, ref.topk_scatter_reduce(idx, val, w, n), **TOL)
        assert torch.equal(out, ops.topk_scatter_reduce(idx, val, w, n))


def _client_order_mean(idx, val, w, n, normalize=True):
    """A canonical wire's mean as the kernel orders it, in plain torch:
    each client's products added in client order into a zero (N,), divided
    by safe_weight_sum(w) (and multiplied back): the composition the
    wrapper ran before the weight sum and the product moved inside."""
    acc = torch.zeros(n, dtype=torch.float32, device=idx.device)
    for c in range(idx.shape[0]):
        i = idx[c].long()
        acc[i] = acc[i] + w[c] * val[c]
    wsum = safe_weight_sum(w)
    return acc / wsum if normalize else acc / wsum * wsum


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,n", [(4, 19_743, 1_974_303), (64, 19_743, 1_974_303), (3, 50, 8193)])
def test_cuda_topk_scatter_reduce_is_the_composition_it_replaced(cuda, c, k, n):
    """Integer weights on a canonical wire: bitwise the kernel-plus-
    composition it replaced, with normalize True and False, and the sum
    form is the mean times safe_weight_sum(w)."""
    rng = np.random.default_rng(c + k + 1)
    idx, val, w = (t.to(cuda) for t in _topk_payload(rng, c, k, n))
    mean = ops.topk_scatter_reduce(idx, val, w, n)
    summed = ops.topk_scatter_reduce(idx, val, w, n, normalize=False)
    assert torch.equal(mean, _client_order_mean(idx, val, w, n))
    assert torch.equal(summed, _client_order_mean(idx, val, w, n, normalize=False))
    assert torch.equal(summed, mean * safe_weight_sum(w))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 64])
def test_cuda_topk_scatter_reduce_non_integer_weights_within_ulps(cuda, c):
    """Weights that are not integers: the kernel's fixed-order weight sum
    and PyTorch's may round apart, so the mean is within 2C - 1 ulps of the
    plain version on disjoint rows (where the scatter itself is exact)."""
    rng = np.random.default_rng(c)
    n = 1_974_303
    idx, val, _ = (t.to(cuda) for t in _topk_payload(rng, c, 19_743, n, disjoint=True))
    w = _t((rng.random(c) * 300 + 0.1).astype(np.float32)).to(cuda)
    out, exp = ops.topk_scatter_reduce(idx, val, w, n), ref.topk_scatter_reduce(idx, val, w, n)
    ulp = torch.nextafter(exp.abs(), torch.full_like(exp, float("inf"))) - exp.abs()
    assert float(((out - exp).abs() / ulp).max()) <= 2 * c - 1


@pytest.mark.cuda
def test_cuda_reduces_are_one_device_kernel_a_call(cuda):
    """One ops call, one device activity, for the one-launch reduces
    (fedavg, TopK, and the Int8 reduce at C = 6 and 64) in both forms: no
    memset, index pass, weight-sum, division or denormalization kernels
    around them.  The calls share ONE profiler
    session, the only one of this file: short sessions after the first few
    of a process can stop recording device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(17)
    calls = []  # (kernel name, call)
    for dtype in (torch.float32, torch.bfloat16):
        u = _t(_delta(rng, (2, 1_974_303))).to(cuda, dtype)
        w = _t(rng.integers(10, 500, 2).astype(np.float32)).to(cuda)
        calls += [("fedavg_reduce_kernel", lambda u=u, w=w, nz=nz: ops.fedavg_reduce(
            u, w, normalize=nz)) for nz in (True, False)]
    idx, val, w = (t.to(cuda) for t in _topk_payload(rng, 4, 19_743, 1_974_303))
    calls += [("topk_scatter_reduce_kernel", lambda nz=nz: ops.topk_scatter_reduce(
        idx, val, w, 1_974_303, normalize=nz)) for nz in (True, False)]
    for c in (6, 64):
        q, s = ref.quantize_int8(_t(_delta(rng, (c * 1_974_528,))).to(cuda))
        q, s = q.reshape(c, -1), s.reshape(c, -1)
        wq = _t(rng.integers(10, 500, c).astype(np.float32)).to(cuda)
        calls += [("dequant_reduce_kernel", lambda q=q, s=s, wq=wq, nz=nz: ops.dequant_reduce(
            q, s, wq, normalize=nz)) for nz in (True, False)]
    for _, call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _, call in calls:
            call()
            torch.cuda.synchronize()
    seen = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    names = [e.name for e in seen]
    assert len(seen) == len(calls), names
    assert all(kernel in name for (kernel, _), name in zip(calls, names)), names


# ---------------- collective_pack / collective_unpack ----------------
def _shared_scales(xs):
    """Scales as the MAX all-reduce agrees them: the block absmax over
    every rank's values, / 127 by a tensor, zero -> 1."""
    am = xs.abs().reshape(xs.shape[0], -1, 256).amax(dim=(0, 2))
    s = am / torch.full_like(am, 127.0)
    return torch.where(am == 0, torch.ones_like(s), s)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 8192, 327_680, 1_638_400, 1_974_528])
def test_cuda_collective_pack_unpack_bitwise(cuda, n):
    """The head model's leaf sizes padded to 256, and its padded total."""
    rng = np.random.default_rng(n)
    xs = _t(_delta(rng, (4, n))).to(cuda)
    xs[:, :256] = 0.0  # a block zero on every rank: shared scale 0 -> 1
    s = _shared_scales(xs)
    before = ops.launch_counts()
    qs = [ops.collective_pack(x, s) for x in xs]
    after = ops.launch_counts()
    assert after["collective_pack"] == before["collective_pack"] + 4
    for x, q in zip(xs, qs):
        assert q.dtype == torch.int32 and torch.equal(q, ref.collective_pack(x, s))
        assert torch.equal(ops.collective_unpack(q, s), ref.collective_unpack(q, s))
    total = sum(qs)
    got = ops.collective_unpack(total, s)
    assert torch.equal(got, ref.collective_unpack(total, s))
    # exactly summable: one fp32 rounding per element apart
    each = sum(ref.collective_unpack(q, s) for q in qs)
    torch.testing.assert_close(got, each, rtol=0, atol=float(s.max()) * 1e-4)


@pytest.mark.cuda
def test_cuda_collective_pack_edges(cuda):
    """Half-way points (power-of-two scales make (k + 1/2) s exact), zeros,
    +-127 s, values past it, NaN and inf: bitwise the plain version."""
    rng = np.random.default_rng(7)
    s = (2.0 ** rng.integers(-12, 2, 16)).astype(np.float32)
    k = rng.integers(-140, 140, (16, 256)) + np.where(rng.random((16, 256)) < 0.5, 0.5, 0.0)
    x = (k * s[:, None]).astype(np.float32)
    x[:, :8] = np.asarray([0.0, -0.0, 127.0, -127.0, 127.5, -128.5, np.nan, np.inf],
                          np.float32) * s[:, None]
    x, s = _t(x.reshape(-1)).to(cuda), _t(s).to(cuda)
    q = ops.collective_pack(x, s)
    assert torch.equal(q, ref.collective_pack(x, s))
    assert torch.equal(ops.collective_unpack(q, s), ref.collective_unpack(q, s))
    with pytest.raises(ValueError):
        ops.collective_pack(x[:200], s[:1])  # N % 256 != 0


# the head model's leaves in JAX's order: base.w, head.b1, head.b2, head.w1, head.w2
HEAD_LEAVES = (1_638_400, 256, 31, 327_680, 7_936)


def _same_bits(a, b):
    """Bitwise, a NaN matching any NaN (the card makes its own NaN bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32), torch.where(nan, 0.0, b).view(torch.int32))


def _leaf_inputs(cuda, seed, live):
    """The head model's leaves as views of one flat vector at JAX's leaf
    offsets (head.w1 and head.w2 start 12 bytes past a 16-byte boundary),
    residual rows apart, an example-count weight (zero for a masked rank,
    as the round step folds the mask in) and the live flag.  base.w holds
    a NaN block, an inf block and an all-zero block (scale 1)."""
    rng = np.random.default_rng(seed)
    flat = _t(_delta(rng, (sum(HEAD_LEAVES),))).to(cuda)
    rs = [(_t(_delta(rng, (n,))) * 1e-3).to(cuda) for n in HEAD_LEAVES]
    flat[3 * 256 + 10], flat[5 * 256 + 3] = float("nan"), float("inf")
    flat[7 * 256:8 * 256] = 0.0
    rs[0][7 * 256:8 * 256] = 0.0
    ds = list(torch.split(flat, HEAD_LEAVES))
    assert [d.data_ptr() % 16 for d in ds] == [0, 0, 0, 12, 12]
    lv = None if live is None else torch.tensor(live, device=cuda)
    wf = torch.full((1,), 0.0 if live is False else 123.0, device=cuda)
    return ds, wf, rs, lv


@pytest.mark.cuda
@pytest.mark.parametrize("live", [None, True, False])
def test_cuda_collective_leaf_table_bitwise(cuda, live):
    """The three leaf-table launches against their plain versions and
    against the per-leaf composition they replaced (each leaf's ``psum``,
    the plain single-vector kernels), bitwise, NaN as NaN: a NaN block
    keeps its NaN absmax and scale, an inf block gives inf, a zero block
    scale 1, a masked rank zero codes and its residual carried."""
    from repro_torch.kernels.collective_quant import first_blocks
    from torch_kernel_models import collective_per_leaf

    ds, wf, rs, lv = _leaf_inputs(cuda, 22, live)
    absmax = ops.collective_absmax(ds, wf, rs, lv)
    assert _same_bits(absmax, ref.collective_absmax(ds, wf, rs, lv))
    q, s, new = ops.collective_pack_leaves(ds, wf, rs, absmax, lv)
    want = ref.collective_pack_leaves(ds, wf, rs, absmax, lv)
    assert torch.equal(q, want[0]) and _same_bits(s, want[1]) and _same_bits(new, want[2])
    total = ops.collective_unpack(q, s)
    assert _same_bits(total, ref.collective_unpack(q, s))
    per_leaf = collective_per_leaf(ds, wf, rs, lv, ref.collective_pack, ref.collective_unpack)
    starts = first_blocks(HEAD_LEAVES)
    for (am, sc, code, tot, row), a, b, n in zip(per_leaf, starts, starts[1:], HEAD_LEAVES):
        assert _same_bits(absmax[a:b], am) and _same_bits(s[a:b], sc)
        assert torch.equal(q[a * 256:b * 256], code)
        assert _same_bits(total[a * 256:a * 256 + n], tot)
        assert _same_bits(new[a * 256:a * 256 + n], row)
    assert float(s[7]) == 1.0
    if live is not False:
        assert bool(torch.isnan(s[3])) and bool(torch.isinf(s[5]))
    else:
        assert not q.any() and all(torch.equal(new[a * 256:a * 256 + n], r)
                                   for a, n, r in zip(starts, HEAD_LEAVES, rs))


def _resnet_leaf_sizes():
    """ResNet-18's 62 leaf sizes in JAX's order (``fc_b``'s 10 floats first)."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.resnet18_cifar10 import CNN_CONFIG
    from repro_torch.models import resnet

    assert get_config("resnet18-cifar10").family == "cnn"
    return tuple(t.numel() for t in tree_leaves(resnet.init_params(CNN_CONFIG, 0, device="cpu")))


@pytest.mark.cuda
@pytest.mark.parametrize("live", [None, True, False])
def test_cuda_collective_leaf_table_resnet_bitwise(cuda, live):
    """The leaf-table trio over ResNet-18's 62 leaves at their real starts
    in one flat decode (61 of them start away from a 16-byte boundary),
    bitwise its plain versions and the per-leaf composition it replaced."""
    from repro_torch.kernels.collective_quant import first_blocks
    from torch_kernel_models import collective_per_leaf

    sizes = _resnet_leaf_sizes()
    assert len(sizes) == 62 and sum(sizes) == 11_173_962
    rng = np.random.default_rng(62)
    ds = list(torch.split(_t(_delta(rng, (sum(sizes),))).to(cuda), sizes))
    assert sum(d.data_ptr() % 16 != 0 for d in ds) == 61
    rs = [(_t(_delta(rng, (n,))) * 1e-3).to(cuda) for n in sizes]
    lv = None if live is None else torch.tensor(live, device=cuda)
    wf = torch.full((1,), 0.0 if live is False else 123.0, device=cuda)
    absmax = ops.collective_absmax(ds, wf, rs, lv)
    assert _same_bits(absmax, ref.collective_absmax(ds, wf, rs, lv))
    q, s, new = ops.collective_pack_leaves(ds, wf, rs, absmax, lv)
    want = ref.collective_pack_leaves(ds, wf, rs, absmax, lv)
    assert torch.equal(q, want[0]) and _same_bits(s, want[1]) and _same_bits(new, want[2])
    total = ops.collective_unpack(q, s)
    assert _same_bits(total, ref.collective_unpack(q, s))
    per_leaf = collective_per_leaf(ds, wf, rs, lv, ref.collective_pack, ref.collective_unpack)
    starts = first_blocks(sizes)
    for (am, sc, code, tot, row), a, b, n in zip(per_leaf, starts, starts[1:], sizes):
        assert _same_bits(absmax[a:b], am) and _same_bits(s[a:b], sc)
        assert torch.equal(q[a * 256:b * 256], code)
        assert _same_bits(total[a * 256:a * 256 + n], tot)
        assert _same_bits(new[a * 256:a * 256 + n], row)
    if live is False:
        assert not q.any()


@pytest.mark.cuda
def test_cuda_psum_leaves_one_launch_each(cuda):
    """``CompressedPsum.psum_leaves`` launches each of the three kernels once
    over all five leaves, and its totals and residuals are views of one flat
    buffer each, a leaf's slice at its first block."""
    from repro_torch.core import CompressedPsum

    ds, wf, rs, lv = _leaf_inputs(cuda, 23, True)
    before = ops.launch_counts()
    totals, new_rs = CompressedPsum().psum_leaves(ds, wf, rs, (), lv)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "collective_absmax": 1, "collective_pack": 1, "collective_unpack": 1}
    assert [t.shape[0] for t in totals] == [r.shape[0] for r in new_rs] == list(HEAD_LEAVES)
    assert len({t.untyped_storage().data_ptr() for t in totals}) == 1
    assert all(r.data_ptr() % 16 == 0 for r in new_rs)


# ---------------- attention (the transformer's prefill and decode) ----------------
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _attn_inputs(cuda, seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    return [_t(rng.normal(size=s).astype(np.float32)).to(cuda, dtype) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kv,d,dtype,window,q_offset,causal", [
    (8, 1024, 1024, 16, 8, 128, torch.bfloat16, None, 0, True),   # qwen3-0.6b's prefill
    (8, 1024, 1024, 32, 32, 80, torch.bfloat16, None, 0, True),   # stablelm-3b's: D 80 -> 128
    (8, 1024, 1024, 16, 16, 128, torch.bfloat16, None, 0, True),  # deepseek-moe-16b's (MHA)
    (8, 1024, 1024, 32, 8, 128, torch.bfloat16, None, 0, True),   # granite-8b's, mixtral's
    (2, 256, 256, 4, 2, 32, torch.float32, None, 0, True),
    (2, 256, 256, 4, 2, 64, torch.float32, None, 0, True),
    (2, 256, 256, 4, 2, 128, torch.float32, None, 0, True),
    (2, 256, 256, 4, 2, 256, torch.float32, None, 0, True),
    (2, 512, 512, 8, 2, 64, torch.bfloat16, 128, 0, True),        # window
    (2, 128, 384, 8, 4, 128, torch.float32, None, 256, True),     # q_offset
    (2, 1000, 1000, 16, 8, 128, torch.bfloat16, None, 0, True),   # ragged
    (2, 17, 145, 16, 8, 128, torch.float32, 64, 128, True),       # ragged chunk, window
    (1, 8, 8, 2, 1, 40, torch.float32, 3, 20, True),              # rows with no valid key
    # the bf16 (wgmma) route: D_pad 64, 128, 256; key tiles of 128 (32 at D_pad 256)
    (2, 256, 256, 4, 2, 32, torch.bfloat16, None, 0, True),
    (2, 256, 256, 4, 2, 64, torch.bfloat16, None, 0, True),
    (2, 256, 256, 4, 2, 256, torch.bfloat16, None, 0, True),
    (1, 65, 130, 4, 4, 64, torch.bfloat16, None, 0, False),       # not causal
    (2, 128, 384, 8, 4, 128, torch.bfloat16, None, 256, True),    # q_offset
    (1, 8, 8, 2, 1, 40, torch.bfloat16, 3, 20, True),             # rows with no valid key
    (2, 200, 333, 8, 2, 128, torch.bfloat16, None, 133, True),    # Skv % 128 != 0
    (1, 100, 77, 4, 1, 256, torch.bfloat16, None, 0, False),      # Skv % 32 != 0, D 256
    # the first 128-row item walks every key tile (3 at D 128, 10 at D 256): its
    # rows from 115 on have no valid key, the rows before it do
    (2, 256, 300, 4, 2, 128, torch.bfloat16, 16, 200, True),
    (2, 256, 300, 4, 2, 256, torch.bfloat16, 16, 200, True),
])
def test_cuda_flash_attention(cuda, b, sq, skv, h, kv, d, dtype, window, q_offset, causal):
    q, k, v = _attn_inputs(cuda, sq + d, [(b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)],
                           dtype)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert ops.launch_counts()["flash_attention"] == before + 1
    exp = ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


# the training shapes of chip_smoke.py phase 17 (a) and the other heads and
# masks the backward takes (``torch_kernel_models.FLASH_BWD_CASES``, labels
# dropped): b, sq, skv, h, kv, d, dtype, window, q_offset, causal
FLASH_BWD_CASES = [case[1:] for case in MODEL_FLASH_BWD_CASES]


def _max_rel(got, want):
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,kv,d,dtype,window,q_offset,causal", FLASH_BWD_CASES)
def test_cuda_flash_attention_backward(cuda, b, sq, skv, h, kv, d, dtype, window, q_offset,
                                       causal):
    """The forward's lse and the backward kernel's dq, dk, dv against
    ``ref.attention_with_lse`` / ``ref.attention_bwd`` on the same inputs
    (the kernel's own out and lse) and against autograd of
    ``ref.attention``, each within 2e-5 (fp32) / 2e-2 (bf16) of the
    tensor's max-abs; one counted launch each."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, dout = _attn_inputs(cuda, sq + d + 1, [(b, sq, h, d), (b, skv, kv, d),
                                                    (b, skv, kv, d), (b, sq, h, d)], dtype)
    from repro_torch.kernels import flash_attention as fk

    before = ops.launch_counts()
    out, lse = fk.flash_attention_fwd(q, k, v, **kw)
    grads = fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    exp_out, exp_lse = ref.attention_with_lse(q, k, v, **kw)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    assert _max_rel(lse, exp_lse) <= tol and _max_rel(out, exp_out) <= tol
    plain = ref.attention_bwd(q, k, v, out, lse, dout, **kw)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref.attention(qr, kr, vr, **kw).backward(dout)
    for got, want, auto in zip(grads, plain, (qr.grad, kr.grad, vr.grad), strict=True):
        assert got.dtype == dtype and got.shape == want.shape
        assert bool(torch.isfinite(got.float()).all())
        assert _max_rel(got, want) <= tol and _max_rel(got, auto) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("d,h,kv", [(128, 16, 8), (256, 8, 1), (64, 24, 24)])
def test_cuda_flash_attention_backward_is_bitwise_repeatable(cuda, d, h, kv):
    """bf16's two wgmma kernels own their rows of dQ, dK and dV (no
    atomics): two calls on the same inputs give the same bits, at each
    head-dim bucket, under a window with rows that have no valid key."""
    from repro_torch.kernels import flash_attention as fk

    kw = dict(causal=True, window=48, q_offset=300)
    q, k, v, dout = _attn_inputs(cuda, d + h, [(2, 200, h, d), (2, 380, kv, d),
                                               (2, 380, kv, d), (2, 200, h, d)], torch.bfloat16)
    out, lse = fk.flash_attention_fwd(q, k, v, **kw)
    first = fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    second = fk.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second, strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flash_pair_folds_a_vmapped_cohort_into_one_launch(cuda, monkeypatch):
    """vmap over 3 clients of grad_and_value through ops.flash_attention:
    one forward and one backward launch for the cohort, nothing reaches
    ``ref``, and the gradients match the plain attention's autograd."""
    q, k, v, w = _attn_inputs(cuda, 5, [(3, 2, 64, 4, 32), (3, 2, 64, 2, 32),
                                        (3, 2, 64, 2, 32), (2, 64, 4, 32)], torch.float32)

    def loss(attend):
        return lambda kv_pair, qq: (attend(qq, *kv_pair) * w).sum()

    plain = torch.func.vmap(torch.func.grad_and_value(loss(ref.attention), argnums=(0, 1)))(
        (k, v), q)

    def trap(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("attention", "attention_with_lse", "attention_bwd"):
        monkeypatch.setattr(ref, name, trap)
    ops.reset_launch_counts()
    (gkv, gq), val = torch.func.vmap(
        torch.func.grad_and_value(loss(ops.flash_attention), argnums=(0, 1)))((k, v), q)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    torch.cuda.synchronize()
    (pkv, pq), pval = plain
    torch.testing.assert_close(val, pval, rtol=2e-5, atol=2e-5)
    for got, want in zip((*gkv, gq), (*pkv, pq), strict=True):
        assert _max_rel(got, want) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_pair_at_mlas_padded_width_under_vmap_grad(cuda, dtype, monkeypatch):
    """MLA's attention as ``mla_forward`` runs it: qk width 96, V 64
    zero-padded to 96 and the output's first 64 columns kept, under vmap
    over 2 clients of grad_and_value: one forward and one backward launch,
    nothing reaches ``ref``, and the loss and gradients within 2e-5 (fp32)
    / 2e-2 (bf16) of the plain attention's autograd on the unpadded V."""
    import torch.nn.functional as F

    q, k, v, w = _attn_inputs(cuda, 96, [(2, 2, 256, 8, 96), (2, 2, 256, 8, 96),
                                         (2, 2, 256, 8, 64), (2, 2, 256, 8, 64)], dtype)
    w = w.float()

    def padded(qq, kk, vv, ww):
        return (ops.flash_attention(qq, kk, F.pad(vv, (0, 32)))[..., :64].float() * ww).sum()

    def unpadded(qq, kk, vv, ww):
        return (ref.attention(qq, kk, vv).float() * ww).sum()

    plain, pval = torch.func.vmap(torch.func.grad_and_value(unpadded, argnums=(0, 1, 2)))(
        q, k, v, w)

    def trap(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("attention", "attention_with_lse", "attention_bwd"):
        monkeypatch.setattr(ref, name, trap)
    ops.reset_launch_counts()
    got, val = torch.func.vmap(torch.func.grad_and_value(padded, argnums=(0, 1, 2)))(q, k, v, w)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    assert _max_rel(val, pval) <= tol
    for g, want, x in zip(got, plain, (q, k, v), strict=True):
        assert g.dtype == dtype and g.shape == x.shape
        assert bool(torch.isfinite(g.float()).all()) and _max_rel(g, want) <= tol


@pytest.mark.cuda
def test_cuda_serving_kernels_refuse_a_gradient(cuda):
    """decode_attention has no backward kernel: on the card, an input that
    needs a gradient, or a ``torch.func`` transform's, raises naming item
    15."""
    q, kc, vc = _attn_inputs(cuda, 3, [(2, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32)],
                             torch.float32)
    valid = torch.ones(2, 16, dtype=torch.bool, device=cuda)
    with pytest.raises(NotImplementedError, match="decode_attention.*item 15"):
        ops.decode_attention(q.detach().clone().requires_grad_(), kc, vc, kv_valid=valid)
    with pytest.raises(NotImplementedError, match="decode_attention.*item 15"):
        torch.func.grad(lambda qq: ops.decode_attention(qq, kc, vc, kv_valid=valid).sum())(
            q.detach())


def _scan_bwd_inputs(cuda, seed, b, s, di, n, dtype, groups, init, dh, long_memory=False):
    """``_scan_inputs`` with A (G, Di, N) and D (G, Di), each group its own,
    dy ~ N in x's dtype and an optional final-state cotangent."""
    (x, dt, a, bm, cm, d), h0 = _scan_inputs(cuda, seed, b, s, di, n, dtype, init, long_memory)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    a = torch.stack([a * (1 + 0.05 * k) for k in range(groups)])
    d = torch.stack([d * (1 - 0.1 * k) for k in range(groups)])
    dy = torch.randn((b, s, di), generator=gen, device=cuda).to(dtype)
    dhf = torch.randn((b, di, n), generator=gen, device=cuda) if dh else None
    return x, dt, a, bm, cm, d, dy, h0, dhf


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,n,dtype,groups,init,dh,long_memory", [
    (2, 37, 300, 16, torch.float32, 1, True, True, False),     # ragged S and Di
    (4, 20, 130, 5, torch.bfloat16, 2, False, True, False),    # N below its bucket, G = 2
    (4, 17, 70, 32, torch.float32, 4, True, True, False),      # 8 threads a channel, G = 4
    (2, 33, 300, 64, torch.float32, 1, True, False, False),    # 16 threads a channel
    (2, 1, 300, 8, torch.float32, 1, True, True, False),       # S = 1
    (2, 1024, 128, 16, torch.bfloat16, 2, False, True, True),  # long memory: the model's dt, A
    (4, 64, 16384, 16, torch.bfloat16, 2, False, True, False),  # whole blocks at the real width
])
def test_cuda_selective_scan_backward(cuda, b, s, di, n, dtype, groups, init, dh, long_memory):
    """The training forward and the backward kernel: one launch each; the
    checkpoints and every gradient bitwise ``tests/torch_kernel_models.py``'s
    ``scan_bwd_kernel_order`` (on the card torch's exp is the kernel's
    expf, and the model rounds where the kernel rounds); within relative L2
    1e-5 of ``ref.selective_scan_bwd`` (sums in other orders over bitwise
    equal states; a bf16 dx 2**-8, one rounding); the forward's y and state
    bitwise the serving forward's; two calls bitwise equal."""
    from repro_torch.kernels import selective_scan as sk
    from torch_kernel_models import scan_bwd_kernel_order

    x, dt, a, bm, cm, d, dy, h0, dhf = _scan_bwd_inputs(cuda, s + di + n, b, s, di, n, dtype,
                                                        groups, init, dh, long_memory)
    kw = dict(init_state=h0, groups=groups)
    ops.reset_launch_counts()
    y, h, ck = sk.selective_scan_fwd(x, dt, a, bm, cm, d, **kw)
    grads = sk.selective_scan_bwd(x, dt, a, bm, cm, d, ck, dy, dh_final=dhf, **kw)
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "selective_scan": 1, "selective_scan_bwd": 1}
    again = sk.selective_scan_bwd(x, dt, a, bm, cm, d, ck, dy, dh_final=dhf, **kw)
    ys, hs = sk.selective_scan(x, dt, a, bm, cm, d, **kw)
    model, model_ck, same_states = scan_bwd_kernel_order(x, dt, a, bm, cm, d, dy, dh_final=dhf,
                                                         **kw)
    plain = ref.selective_scan_bwd(x, dt, a, bm, cm, d, dy, dh_final=dhf, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y, ys) and torch.equal(h, hs)
    assert same_states and torch.equal(ck, model_ck)
    assert (grads[6] is None) == (not init)
    for g, g2, m, p in zip(grads, again, model, plain, strict=True):
        if g is None:
            continue
        assert torch.equal(g, g2) and torch.equal(g, m)
        assert _rel_l2(g, p) <= (2 ** -8 if g.dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared A, D", "per-client A, D"])
def test_cuda_scan_pair_folds_a_vmapped_cohort_into_one_launch(cuda, shared, monkeypatch):
    """``vmap(grad)`` over 3 clients through ``ops.selective_scan`` on the
    card: one forward and one backward launch for the cohort (the clients
    folded into B and the groups), never ``ref``; every gradient within
    relative L2 1e-5 of the CPU route's on the same inputs."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    c, b, s, di, n = 3, 2, 40, 200, 16
    xs = torch.randn(c, b, s, di, generator=gen, device=cuda) * 0.5
    dts = torch.nn.functional.softplus(torch.randn(c, b, s, di, generator=gen, device=cuda))
    a = -torch.exp(0.3 * torch.randn(di, n, generator=gen, device=cuda))
    d = torch.randn(di, generator=gen, device=cuda)
    bm, cm = (torch.randn(c, b, s, n, generator=gen, device=cuda) for _ in range(2))
    w = torch.randn(c, b, s, di, generator=gen, device=cuda)
    if not shared:
        a, d = torch.stack([a, 1.01 * a, 0.99 * a]), torch.stack([d, 1.1 * d, 0.9 * d])

    def loss(a, d, x, dt, bm, cm, w):
        y, h = ops.selective_scan(x, dt, a, bm, cm, d)
        return (y * w).sum() + h.sum()

    dim = None if shared else 0
    step = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4, 5)),
                           in_dims=(dim, dim, 0, 0, 0, 0, 0))
    want = step(*(t.cpu() for t in (a, d, xs, dts, bm, cm, w)))

    def trap(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("selective_scan", "selective_scan_bwd"):
        monkeypatch.setattr(ref, name, trap)
    ops.reset_launch_counts()
    got = step(a, d, xs, dts, bm, cm, w)
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "selective_scan": 1, "selective_scan_bwd": 1}
    torch.cuda.synchronize()
    for g, h in zip(got, want, strict=True):
        assert g.shape == h.shape and _rel_l2(g.cpu(), h) <= 1e-5


@pytest.mark.cuda
def test_cuda_hybrid_training_matches_the_cpu(cuda):
    """jamba-1.5-large-398b.reduced() without its experts (a routing that
    flips between the card and the CPU would move whole tokens' gradients)
    in fp32, plan [mamba, attn], from one set of params: loss_fn's value
    and every leaf's gradient on the card within 1e-4 of the CPU route's
    (relative to each leaf's max-abs), one scan and one flash forward and
    backward launch."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(), dtype="float32",
                              moe=None)
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu.init(0)
    rng = np.random.default_rng(0)
    batch = {k: _t(rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32))
             for k in ("tokens", "labels")}
    want, (want_loss, _) = torch.func.grad_and_value(cpu.loss_fn, has_aux=True)(params, batch)
    ops.reset_launch_counts()
    got, (got_loss, _) = torch.func.grad_and_value(card.loss_fn, has_aux=True)(
        tree_map(lambda t: t.to(cuda), params), {k: t.to(cuda) for k, t in batch.items()})
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "selective_scan": 1, "selective_scan_bwd": 1, "flash_attention": 1,
        "flash_attention_bwd": 1}
    torch.cuda.synchronize()
    torch.testing.assert_close(got_loss.cpu(), want_loss, rtol=1e-5, atol=0)
    for g, w_ in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert _max_rel(g.cpu(), w_) <= 1e-4


@pytest.mark.cuda
def test_cuda_dense_training_matches_the_cpu(cuda):
    """qwen3-0.6b.reduced() in fp32 from one set of params: loss_fn's value
    and every leaf's gradient on the card within 1e-4 of the CPU route's
    (relative to each leaf's max-abs: the kernels' and cuBLAS's sums run
    in other orders), one flash forward and one backward launch a layer."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), dtype="float32")
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu.init(0)
    rng = np.random.default_rng(0)
    batch = {k: _t(rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32))
             for k in ("tokens", "labels")}
    want, (want_loss, _) = torch.func.grad_and_value(cpu.loss_fn, has_aux=True)(params, batch)
    ops.reset_launch_counts()
    got, (got_loss, _) = torch.func.grad_and_value(card.loss_fn, has_aux=True)(
        tree_map(lambda t: t.to(cuda), params), {k: t.to(cuda) for k, t in batch.items()})
    counts = ops.launch_counts()
    assert counts["flash_attention"] == counts["flash_attention_bwd"] == cfg.n_layers
    torch.cuda.synchronize()
    torch.testing.assert_close(got_loss.cpu(), want_loss, rtol=1e-5, atol=0)
    for g, w_ in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert _max_rel(g.cpu(), w_) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,dtype,mask", [
    (8, 2048, 16, 8, 128, torch.bfloat16, "linear"),         # qwen3-0.6b's decode
    (8, 2048, 32, 32, 80, torch.bfloat16, "linear"),         # stablelm-3b's (D = 80)
    (8, 2048, 16, 16, 128, torch.bfloat16, "linear"),        # deepseek-moe-16b's (MHA)
    (8, 2048, 32, 8, 128, torch.bfloat16, "linear"),         # granite-8b's, mixtral's
    (8, 2048, 64, 8, 128, torch.bfloat16, "linear"),         # the Jamba slice's (G = 8)
    (8, 2048, 16, 8, 128, torch.bfloat16, "first"),          # position 0: most splits empty
    (8, 1, 16, 8, 128, torch.bfloat16, "linear"),            # S = 1
    (8, 16384, 16, 8, 128, torch.bfloat16, "linear"),
    (8, 2048, 16, 8, 128, torch.bfloat16, "random"),
    (8, 2048, 16, 8, 128, torch.bfloat16, "arcs"),           # whole tiles invalid
    (8, 2048, 16, 8, 128, torch.float32, "random"),
    (2, 300, 8, 4, 256, torch.float32, "random"),
    (2, 1000, 8, 2, 64, torch.float32, "linear"),             # G = 4, ragged S
    (3, 1000, 8, 2, 64, torch.float32, "arcs"),
    (2, 256, 4, 2, 128, torch.float32, "none"),               # an all-invalid row
])
def test_cuda_decode_attention(cuda, b, s, h, kv, d, dtype, mask):
    q, kc, vc = _attn_inputs(cuda, s + d, [(b, h, d), (b, s, kv, d), (b, s, kv, d)], dtype)
    rng = np.random.default_rng(s)
    valid = rng.random((b, s)) > 0.25
    valid[:, 0] = True
    if mask == "linear":
        valid[:] = np.arange(s) <= s // 2
    elif mask == "first":
        valid[:] = np.arange(s) == 0
    elif mask == "arcs":  # row i: a ring's window of s // 3 slots ending at slot i * s // b
        valid[:] = (np.arange(b)[:, None] * (s // b) - np.arange(s)[None]) % s < s // 3
    elif mask == "none":
        valid[0] = False
    valid = _t(valid).to(cuda)
    before = ops.launch_counts()["decode_attention"]
    out = ops.decode_attention(q, kc, vc, kv_valid=valid)
    assert ops.launch_counts()["decode_attention"] == before + 1
    exp = ref.decode_attention(q, kc, vc, kv_valid=valid)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)
    # the splits are combined in index order: the same bits on every launch
    assert torch.equal(out, ops.decode_attention(q, kc, vc, kv_valid=valid))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,dtype,mask,splits", [
    (8, 16384, 16, 8, 128, torch.bfloat16, "linear", 1),  # 129 valid tiles: rounds of 64
    (2, 1000, 8, 2, 64, torch.float32, "linear", 3),
    (2, 256, 4, 2, 128, torch.float32, "none", 16),       # more splits than tiles
    (3, 1000, 8, 2, 64, torch.float32, "arcs", 40),
])
def test_cuda_decode_attention_any_split_count(cuda, b, s, h, kv, d, dtype, mask, splits):
    """Any split count gives the plain version's result within tolerance,
    the same bits twice: one split walking more tiles than its list holds,
    splits with no tile at all (in a row with a valid slot and in one
    without)."""
    q, kc, vc = _attn_inputs(cuda, s + splits, [(b, h, d), (b, s, kv, d), (b, s, kv, d)], dtype)
    rng = np.random.default_rng(s + 1)
    valid = rng.random((b, s)) > 0.25
    if mask == "linear":
        valid[:] = np.arange(s) <= s // 2 + 100
    elif mask == "arcs":
        valid[:] = (np.arange(b)[:, None] * (s // b) - np.arange(s)[None]) % s < s // 3
    else:
        valid[0] = False
    valid = _t(valid).to(cuda)
    out = decode_kernel.decode_attention(q, kc, vc, kv_valid=valid, splits=splits)
    exp = ref.decode_attention(q, kc, vc, kv_valid=valid)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)
    assert torch.equal(out, decode_kernel.decode_attention(q, kc, vc, kv_valid=valid,
                                                           splits=splits))


SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _scan_inputs(cuda, seed, b, s, di, n, dtype, init, long_memory=False):
    """The reference test's distributions, drawn on the card: x ~ 0.5 N,
    dt = softplus(N), A = -exp(0.3 N), B, C, D ~ N, a N state; with
    ``long_memory`` dt and A as the model makes them
    (``models/layers/mamba.py:39-49``): dt log-uniform in [1e-3, 1e-1], A =
    -(1..N) in every channel, so the state carries hundreds of steps."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    x = randn(b, s, di, scale=0.5).to(dtype)
    if long_memory:
        u = torch.rand((b, s, di), generator=gen, device=cuda)
        dt = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
        a = -torch.exp(torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=cuda)))
        a = a.expand(di, n).contiguous()
    else:
        dt = torch.nn.functional.softplus(randn(b, s, di))
        a = -torch.exp(randn(di, n, scale=0.3))
    h0 = randn(b, di, n) if init else None
    return (x, dt, a, randn(b, s, n), randn(b, s, n), randn(di)), h0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,n,dtype,init,long_memory", [
    (8, 1024, 16384, 16, torch.bfloat16, False, False),  # the Jamba slice's prefill
    (2, 1, 300, 16, torch.float32, True, False),          # one step, Di not a block multiple
    (2, 1000, 300, 8, torch.bfloat16, True, False),       # ragged S and Di
    (2, 1000, 300, 16, torch.float32, False, False),
    (1, 1000, 256, 64, torch.float32, True, False),       # the largest N
    (3, 77, 512, 16, torch.float32, True, False),
    (2, 33, 128, 5, torch.bfloat16, False, False),        # N below its register bucket
    (2, 1024, 300, 16, torch.bfloat16, False, True),      # long memory: the model's dt and A
    (2, 1024, 300, 16, torch.float32, False, True),
])
def test_cuda_selective_scan(cuda, b, s, di, n, dtype, init, long_memory):
    args, h0 = _scan_inputs(cuda, s + di + n, b, s, di, n, dtype, init, long_memory)
    before = ops.launch_counts()["selective_scan"]
    y, h = ops.selective_scan(*args, init_state=h0)
    assert ops.launch_counts()["selective_scan"] == before + 1
    y_exp, h_exp = ref.selective_scan(*args, init_state=h0)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (b, s, di)
    assert h.dtype == torch.float32 and h.shape == (b, di, n)
    tol = SCAN_TOL[dtype]
    torch.testing.assert_close(y.float(), y_exp.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_exp, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_selective_scan_never_reaches_ref(cuda, monkeypatch):
    """A CUDA tensor launches the kernel or raises: with the plain version
    replaced by a trap, the scan still runs, and a shape the kernel does
    not take raises instead of falling back."""
    def trap(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "selective_scan", trap)
    args, h0 = _scan_inputs(cuda, 1, 2, 64, 128, 16, torch.bfloat16, True)
    y, h = ops.selective_scan(*args, init_state=h0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all())
    args, _ = _scan_inputs(cuda, 2, 1, 8, 32, 65, torch.float32, False)
    with pytest.raises(ValueError, match="N <= 64"):
        ops.selective_scan(*args)


@pytest.mark.cuda
def test_cuda_hybrid_stack_matches_the_cpu(cuda):
    """The reduced hybrid (jamba without experts, 4 layers, fp32) from one
    set of params on the card and on the CPU: prefill and 4 decode steps'
    logits within 1e-4 of their scale (the kernels' sums run in other
    orders), one selective_scan launch per mamba layer per prefill and none
    in a decode step."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(), moe=None,
                              n_layers=4, dtype="float32")
    cpu, card = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu.init(0)
    card_params = tree_map(lambda t: t.to(cuda), params)
    toks = _t(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 100)).astype(np.int32))
    n_mamba = sum(spec.kind == "mamba" for spec in cfg.layer_plan())
    with torch.inference_mode():
        want, cache = cpu.prefill(params, {"tokens": toks}, 128)
        ops.reset_launch_counts()
        got, card_cache = card.prefill(card_params, {"tokens": toks.to(cuda)}, 128)
        assert ops.launch_counts()["selective_scan"] == n_mamba
        assert ops.launch_counts()["flash_attention"] == cfg.n_layers - n_mamba
        for _ in range(4):
            torch.testing.assert_close(got.cpu(), want, rtol=0,
                                       atol=1e-4 * float(want.abs().max()))
            tok = torch.argmax(want[:, -1], -1)[:, None].to(torch.int32)
            ops.reset_launch_counts()
            got, card_cache = card.decode_step(card_params, {"tokens": tok.to(cuda)},
                                               card_cache, 128)
            assert ops.launch_counts()["selective_scan"] == 0
            assert ops.launch_counts()["decode_attention"] == cfg.n_layers - n_mamba
            want, cache = cpu.decode_step(params, {"tokens": tok}, cache, 128)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b"])
def test_cuda_moe_forward_matches_the_cpu_without_a_host_sync(cuda, arch):
    """The MoE layer at width 256 with the config's experts (64 top-6 + 2
    shared; 8 top-2), bf16, on the card under
    ``set_sync_debug_mode("error")`` (a host sync raises) against the
    plain path on the CPU on identical inputs, at a prefill (S = 64, cf
    1.25) and a decode step (S = 1, cf 2.0): the chosen experts equal
    wherever the router-logit gap exceeds 1e-3 (the fp32 logits differ
    only in summation order), the output within chip_smoke.py's a-priori
    bound 2**-8 * sqrt(roundings) relative L2 over the tokens routed alike
    (the gated FFN 8, the scale's cast and product 2, k fold steps, the
    shared MLP and its add 9)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import moe
    from repro_torch.utils.pytree import tree_map

    full = get_config(arch)
    cfg = dataclasses.replace(full.reduced(d_model=256), d_ff=512, dtype="bfloat16",
                              moe=dataclasses.replace(full.moe, d_expert=512 if
                                                      full.moe.d_expert else 0))
    mc, d = cfg.moe, cfg.d_model
    bound = 2 ** -8 * (8 + 2 + mc.top_k + (9 if mc.n_shared_experts else 0)) ** 0.5
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(gen, cfg, torch.bfloat16)
    card_params = tree_map(lambda t: t.to(cuda), params)
    for s, cf in ((64, 1.25), (1, 2.0)):
        x = torch.randn((4, s, d), generator=gen).to(torch.bfloat16)
        xc = x.to(cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, aux = moe.moe_forward(cfg, card_params, xc, capacity_factor=cf)
            _, got_i, _ = moe.router_topk(cfg, card_params, xc.reshape(-1, d))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want, want_aux = moe.moe_forward(cfg, params, x, capacity_factor=cf)
        _, want_i, _ = moe.router_topk(cfg, params, x.reshape(-1, d))
        top = torch.sort(x.reshape(-1, d).float() @ params["router"], -1, descending=True).values
        gap = top[:, mc.top_k - 1] - top[:, mc.top_k]
        differ = (torch.sort(got_i.cpu(), -1).values != torch.sort(want_i, -1).values).any(-1)
        assert not bool((differ & (gap > 1e-3)).any()), f"cf {cf}"
        alike = ~differ.view(4, s)
        a, b = got.cpu().float()[alike], want.float()[alike]
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert float((a - b).norm() / b.norm()) <= bound, f"cf {cf}"
        if not bool(differ.any()):
            assert float(aux["moe_drop_frac"]) == float(want_aux["moe_drop_frac"])


@pytest.mark.cuda
def test_cuda_moe_layer_vmap_grad_is_repeatable_and_matches_the_cpu(cuda):
    """The MoE layer's training step as the round engine runs it:
    ``vmap`` over 2 clients of ``grad_and_value`` of ``moe_forward`` +
    ``moe_loss``, at deepseek's router (64 experts top-6, 2 shared), width
    256, fp32, S = 64 at cf 1.25 (pairs dropped), on the card under
    ``set_sync_debug_mode("error")``: two calls bitwise equal; each
    client's chosen experts against the CPU's on the same inputs (equal
    wherever the router-logit gap exceeds 1e-3), and where a client's
    routes agree its loss within 1e-5 and every gradient within 1e-4 of
    its max-abs (the sums run in other orders)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import moe
    from repro_torch.utils.pytree import tree_map

    full = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(full.reduced(d_model=256), dtype="float32",
                              moe=dataclasses.replace(full.moe, d_expert=256))
    router = moe.router_topk

    def loss(p, x, w):
        routes = []

        def recorded(cfg_, params, xf):
            topv, topi, aux = router(cfg_, params, xf)
            routes.append(torch.sort(topi, -1).values)
            return topv, topi, aux

        moe.router_topk = recorded
        try:
            out, aux = moe.moe_forward(cfg, p, x)
        finally:
            moe.router_topk = router
        return (out * w).mean() + moe.moe_loss(aux, cfg), (routes[0], aux["moe_drop_frac"])

    step = torch.func.vmap(torch.func.grad_and_value(loss, has_aux=True), in_dims=(None, 0, 0))
    gen = torch.Generator().manual_seed(3)
    params = moe.init_moe(gen, cfg, torch.float32)
    x, w = (torch.randn((2, 2, 64, cfg.d_model), generator=gen) for _ in range(2))
    card_params = tree_map(lambda t: t.to(cuda), params)
    xc, wc = x.to(cuda), w.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, (got_loss, (got_routes, drop)) = step(card_params, xc, wc)
        again, (again_loss, _) = step(card_params, xc, wc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got_loss, again_loss) and float(drop.min()) > 0
    for g, a in zip(tree_leaves(got), tree_leaves(again), strict=True):
        assert torch.equal(g, a)
    want, (want_loss, (want_routes, _)) = step(params, x, w)
    logits = x.reshape(2, -1, cfg.d_model) @ params["router"]
    top = torch.sort(logits, -1, descending=True).values
    gap = top[..., 5] - top[..., 6]
    differ = (got_routes.cpu() != want_routes).any(-1)
    assert not bool((differ & (gap > 1e-3)).any())
    alike = [c for c in range(2) if not bool(differ[c].any())]
    assert alike, "both clients' routes flipped"
    for c in alike:
        torch.testing.assert_close(got_loss[c].cpu(), want_loss[c], rtol=1e-5, atol=0)
        for g, w_ in zip(tree_leaves(got), tree_leaves(want), strict=True):
            assert _max_rel(g[c].cpu(), w_[c]) <= 1e-4


# ---------------- the ResNet's convs (the TF32 guard) ----------------
@pytest.mark.cuda
def test_cuda_resnet_conv_and_forward_are_fp32(cuda):
    """The package turns TF32 off for cuDNN and cuBLAS at import; a
    ``repro_torch`` conv on the card then agrees with the CPU's within
    fp32 summation order (atol 2e-5 on outputs of magnitude ~5; TF32's
    10-bit mantissa would be off by ~1e-2), and so does the full-width
    ResNet's forward (logits within 1e-4)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model, resnet

    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(3)
    for stride, (h, k, cin, cout) in ((1, (32, 3, 64, 64)), (2, (32, 3, 64, 128)),
                                      (2, (16, 1, 128, 256))):
        x = _t(rng.normal(size=(8, h, h, cin)).astype(np.float32))
        w = _t((rng.normal(size=(k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32))
        card = resnet.conv2d(x.to(cuda), w.to(cuda), stride).cpu()
        torch.testing.assert_close(card, resnet.conv2d(x, w, stride), rtol=0, atol=2e-5)
    cpu_model = build_model(get_config("resnet18-cifar10"), device="cpu")
    params = cpu_model.init(0)
    x = _t(rng.normal(size=(4, 32, 32, 3)).astype(np.float32))
    want = resnet.forward(cpu_model.cfg, params, x)
    got = resnet.forward(cpu_model.cfg, _to(params, cuda), x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def _to(tree, device):
    from repro_torch.utils.pytree import tree_map

    return tree_map(lambda t: t.to(device), tree)


# ---------------- population mode: the cohort store on the card ----------------
@pytest.mark.cuda
@pytest.mark.parametrize("codec_name", ["Int8Codec", "TopKCodec"])
def test_cuda_cohort_state_gather_scatter_round_trip(cuda, codec_name):
    """``gather`` lands one contiguous (C, N) fp32 block on the card at the
    head model's N; ``scatter`` brings the rows back bitwise, as fp32 host
    tensors with storage of their own, and a second gather returns the
    same bits (never-seen ids gather zeros)."""
    from repro_torch.core import CohortState, Int8Codec, TopKCodec

    n = 1_974_303
    codec = {"Int8Codec": Int8Codec(), "TopKCodec": TopKCodec()}[codec_name]
    store = CohortState(codec, n, capacity=16)
    assert store.device.type == "cuda"
    cohort = [7, 3, 10**6 - 1, 42]
    dense = store.gather(cohort)
    assert dense.is_cuda and dense.dtype == torch.float32 and dense.is_contiguous()
    assert dense.shape == (4, n) and not dense.any()
    rows = torch.randn(4, n, device=cuda)
    store.scatter(cohort, rows)
    for cid, want in zip(cohort, rows):
        row = store.get_row(cid)
        assert row.device.type == "cpu" and row.dtype == torch.float32
        assert row.untyped_storage().nbytes() == 4 * n and row.storage_offset() == 0
        assert torch.equal(row, want.cpu())
    again = store.gather([42, 5, 7])
    assert torch.equal(again[0], rows[3]) and torch.equal(again[2], rows[0])
    assert not again[1].any()


@pytest.mark.cuda
def test_cuda_int8_client_residual_survives_eviction(cuda):
    """An Int8 ``TorchClient`` on the card: its residual, spilled to the
    host by ``LazyClientPool`` and rehydrated, comes back to the card
    bitwise; a ``discard_update`` right after is a no-op."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import (CohortState, FitIns, Int8Codec, LazyClientPool, Population,
                                  TorchClient)
    from repro_torch.data.federated import ClientDataset
    from repro_torch.models import build_model

    model = build_model(get_config("mobilenet-head-office31"), device=cuda)
    params = model.init(0)
    n = sum(t.numel() for t in tree_leaves(params))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, model.cfg.feature_dim)).astype(np.float32)
    y = rng.integers(0, 31, 64).astype(np.int32)

    def factory(cid):
        return TorchClient(client_id=cid, loss_fn=model.loss_fn, batch_size=32, device=cuda,
                           dataset=ClientDataset(client_id=cid, x=x, y=y),
                           trainable_mask=model.trainable_mask(params))

    store = CohortState(Int8Codec(), n, capacity=4)
    pool = LazyClientPool(Population.synthetic(10, seed=0), factory, capacity=1,
                          state_store=store)
    first = pool[3]
    first.fit(FitIns(parameters=params, config={"epochs": 1, "codec": Int8Codec()}))
    residual = first.export_state().clone()
    assert residual.is_cuda and residual.abs().max() > 0
    pool[4]
    assert store.get_row(3).device.type == "cpu"
    back = pool[3]
    assert back is not first and back._residual.is_cuda
    assert torch.equal(back._residual, residual)
    back.discard_update()
    assert torch.equal(back._residual, residual)


# ---------------- the scanned trainer: one CUDA graph of the whole run ----------------
SCAN_FLEET = ["tpu-v5e-chip", "jetson-tx2-gpu", "jetson-tx2-gpu", "pixel-2", "pixel-2", "pixel-3"]


def _scan_setup(cuda, rounds):
    """The reduced head model over tests/test_scan.py's fleet, Deadline and
    churn: (model, params, server factory, batches (R, C, 2, 4, ...))."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import AvailabilityTrace, CostModel, Deadline, FedAvg, PROFILES, Server
    from repro_torch.models import build_model

    model = build_model(get_config("mobilenet-head-office31").reduced(), device=cuda)
    params = model.init(0)
    c = len(SCAN_FLEET)
    profiles = [PROFILES[p] for p in SCAN_FLEET]
    cm = CostModel(profiles=profiles, update_bytes=4 * sum(t.numel() for t in tree_leaves(params)))
    tau = 1.25 * cm.client_round_cost(1, 2).t_total_s
    trace = AvailabilityTrace.from_profiles(profiles, seed=0, mobile_dropout=0.3, jitter_std=0.1)

    def server(cohort=None):
        srv = Server(strategy=FedAvg(), clients=[], cost_model=cm, policy=Deadline(tau=tau),
                     availability=trace, cohort_size=cohort, device=cuda)
        srv.logger.quiet = True
        return srv

    rng = np.random.default_rng(0)
    batches = {
        "x": _t(rng.normal(size=(rounds, c, 2, 4, model.cfg.feature_dim)).astype(np.float32)).to(cuda),
        "y": _t(rng.integers(0, 31, (rounds, c, 2, 4)).astype(np.int32)).to(cuda),
    }
    return model, params, server, batches


@pytest.mark.cuda
@pytest.mark.parametrize("codec_name,cohort", [("Int8Codec", None), ("TopKCodec", 4)],
                         ids=["int8", "topk-cohort"])
def test_cuda_scanned_graph_is_the_per_round_driver(cuda, codec_name, cohort):
    """run_scanned on the card captures the 6 rounds as one CUDA graph:
    its final globals, stacked outputs and History are bitwise the
    per-round driver's; the capture launched R times the warm-up round's
    kernels; a second call replays the same graph (no second capture),
    launches nothing from the host and gives the same bits."""
    from repro_torch.core import RoundSpec, TopKCodec, Int8Codec
    from repro_torch.optim import sgd

    model, params, server, batches = _scan_setup(cuda, 6)
    codec = Int8Codec() if codec_name == "Int8Codec" else TopKCodec(frac=0.05)
    kw = dict(loss_fn=model.loss_fn, opt=sgd(0.1), batches=batches,
              spec=RoundSpec(max_steps=2, execution_mode="parallel", codec=codec))
    srv = server(cohort)
    g, hist, st = srv.run_scanned(params, 6, **kw)
    (multi, _), = srv._scan_fns.values()
    cap = multi.last_capture
    assert multi.captures == 1
    warm = {k: v for k, v in cap["warmup_launches"].items() if v}
    assert warm and cap["capture_launches"] == {k: 6 * cap["warmup_launches"][k]
                                                for k in cap["warmup_launches"]}
    g_ref, hist_ref, st_ref = server(cohort).run_scanned(params, 6, reference=True, **kw)
    for a, b in zip(tree_leaves(g), tree_leaves(g_ref)):
        assert a.is_cuda and torch.equal(a, b)
    assert set(st) == set(st_ref)
    for k in st:
        np.testing.assert_array_equal(st[k], st_ref[k], err_msg=k)
    assert repr(hist.rounds) == repr(hist_ref.rounds)  # NaN-equal, every float exact
    assert sum(r.dropped for r in hist.rounds) > 0
    ops.reset_launch_counts()
    g2, hist2, _ = srv.run_scanned(params, 6, **kw)
    assert multi.captures == 1 and not any(ops.launch_counts().values())
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g), tree_leaves(g2)))
    assert repr(hist2.rounds) == repr(hist.rounds)


@pytest.mark.cuda
def test_cuda_scanned_graph_pool_is_flat_in_rounds(cuda):
    """With one batch reused every round, the graph's private memory pool
    at R = 32 is within 5% of R = 8's (apart from the per-round outputs):
    each round's intermediates are freed inside the capture and reused."""
    from repro_torch.core import Int8Codec, RoundSpec
    from repro_torch.optim import sgd

    model, params, server, batches = _scan_setup(cuda, 1)
    one = {k: v[0].clone() for k, v in batches.items()}
    pool = {}
    for rounds in (8, 32):
        srv = server()
        srv.run_scanned(params, rounds, loss_fn=model.loss_fn, opt=sgd(0.1), batches=one,
                        stacked_batches=False,
                        spec=RoundSpec(max_steps=2, execution_mode="parallel", codec=Int8Codec()))
        (multi, _), = srv._scan_fns.values()
        pool[rounds] = multi.last_capture["pool_bytes"]
    assert pool[8] > 0
    assert pool[32] <= 1.05 * pool[8] + (32 - 8) * 10 * 512, pool


# ---------------- the segmented wire: kernels at per-segment shapes ----------------
HEAD_SEGMENTS = ((1_638_687, 327_680), (1_966_367, 7_936))  # head.w1, head.w2 (offset, size)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,size", HEAD_SEGMENTS, ids=["head.w1", "head.w2"])
def test_cuda_quantize_at_an_unaligned_segment_start(cuda, offset, size):
    """A head-model leaf's slice of the flat delta starts 12 bytes past a
    16-byte boundary: the card's quantize takes it in one launch, bitwise
    its plain version on the padded slice and the kernel on an aligned
    copy of the slice."""
    rng = np.random.default_rng(offset)
    flat = _t(_delta(rng, (1_974_303,))).to(cuda)
    x = flat[offset:offset + size]
    assert x.data_ptr() % 16 == 12
    before = ops.launch_counts()["quantize_int8"]
    q, s = ops.quantize_int8(x)
    assert ops.launch_counts()["quantize_int8"] == before + 1
    pad = (-size) % 256
    q_ref, s_ref = ref.quantize_int8(torch.nn.functional.pad(x.cpu(), (0, pad)))
    assert torch.equal(q.cpu(), q_ref) and torch.equal(s.cpu(), s_ref)
    q_al, s_al = ops.quantize_int8(x.clone())
    assert torch.equal(q, q_al) and torch.equal(s, s_al)


def _head_map_and_deltas(cuda, c=4, seed=0):
    from repro_torch.configs.base import get_config
    from repro_torch.core import SegmentMap
    from repro_torch.models import build_model

    segs = SegmentMap.from_tree(build_model(get_config("mobilenet-head-office31"),
                                            device="cpu").init(0))
    rng = np.random.default_rng(seed)
    return segs, _t(_delta(rng, (c, segs.n_params))).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("codec_name", ["Int8Codec", "TopKCodec"])
def test_cuda_segmented_aggregate_batch_is_the_per_segment_composition(cuda, codec_name):
    """The head model's 5-segment map: a segmented aggregate_batch on the
    card is bitwise the flat codec run on each segment's column block
    alone, and launches each reduce once a segment."""
    from repro_torch.core import Int8Codec, TopKCodec

    segs, deltas = _head_map_and_deltas(cuda)
    flat = Int8Codec() if codec_name == "Int8Codec" else TopKCodec(frac=0.01)
    seg = flat.with_segments(segs)
    w = torch.tensor([1.0, 3.0, 2.0, 5.0], device=cuda)
    reduce = "dequant_reduce" if codec_name == "Int8Codec" else "topk_scatter_reduce"
    before = ops.launch_counts()[reduce]
    out, new = seg.aggregate_batch(deltas, w, seg.init_client_state(4, segs.n_params, device=cuda))
    assert ops.launch_counts()[reduce] == before + len(segs)
    for s, part, row in zip(segs, out.split([s.size for s in segs]), new):
        block = deltas[:, s.offset:s.offset + s.size].contiguous()
        p_ref, r_ref = flat.aggregate_batch(block, w, flat.init_client_state(4, s.size, device=cuda))
        assert torch.equal(part, p_ref) and torch.equal(row, r_ref), s.name


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [False, True], ids=["mixed", "mixed-segmented"])
def test_cuda_scanned_graph_with_a_mixed_codec_is_the_per_round_driver(cuda, segmented):
    """run_scanned with MixedCodec.from_policy on the scan fleet (Null,
    Int8, TopK groups), flat or carrying the model's segment map: the one
    CUDA graph is bitwise the per-round driver, and the capture launched
    R times the warm-up round's kernels."""
    from repro_torch.core import BandwidthCodecPolicy, MixedCodec, PROFILES, RoundSpec, SegmentMap
    from repro_torch.optim import sgd

    model, params, server, batches = _scan_setup(cuda, 6)
    codec = MixedCodec.from_policy(BandwidthCodecPolicy(), [PROFILES[p] for p in SCAN_FLEET])
    if segmented:
        codec = codec.with_segments(SegmentMap.from_tree(params))
    kw = dict(loss_fn=model.loss_fn, opt=sgd(0.1), batches=batches,
              spec=RoundSpec(max_steps=2, execution_mode="parallel", codec=codec))
    srv = server()
    g, hist, st = srv.run_scanned(params, 6, **kw)
    (multi, _), = srv._scan_fns.values()
    cap = multi.last_capture
    assert multi.captures == 1
    assert cap["capture_launches"] == {k: 6 * v for k, v in cap["warmup_launches"].items()}
    g_ref, hist_ref, st_ref = server().run_scanned(params, 6, reference=True, **kw)
    for a, b in zip(tree_leaves(g), tree_leaves(g_ref)):
        assert a.is_cuda and torch.equal(a, b)
    for k in st:
        np.testing.assert_array_equal(st[k], st_ref[k], err_msg=k)
    assert repr(hist.rounds) == repr(hist_ref.rounds)


@pytest.mark.cuda
def test_cuda_mla_matches_the_cpu_without_a_host_sync(cuda):
    """MLA at width 256 (4 heads, qk width 32 + 16 = 48, v width 32), bf16: ``mla_forward`` on the card (one flash
    launch, V zero-padded to 48) and 3 absorbed ``mla_decode`` steps from
    its latents under ``set_sync_debug_mode("error")`` (a host sync
    raises), against the plain path on the CPU on identical inputs: each
    output and the latent caches within chip_smoke.py's a-priori bound
    2**-8 * sqrt(MLA_ROUNDINGS = 12) relative L2."""
    import dataclasses

    from repro_torch.configs.base import MLAConfig, get_config
    from repro_torch.models.layers import attention, mla
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(
        get_config("minicpm3-4b").reduced(d_model=256), dtype="bfloat16",
        mla=MLAConfig(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32))
    bound = 2 ** -8 * 12 ** 0.5
    gen = torch.Generator().manual_seed(0)
    params = mla.init_mla(gen, cfg, torch.bfloat16)
    params["q_norm"] = torch.randn(64, generator=gen) * 0.1
    card_params = tree_map(lambda t: t.to(cuda), params)
    x = torch.randn((2, 64, 256), generator=gen).to(torch.bfloat16)

    def rel(a, b):
        a, b = a.cpu().double(), b.double()
        return float((a - b).norm() / b.norm())

    before = ops.launch_counts()["flash_attention"]
    got = mla.mla_forward(cfg, card_params, x.to(cuda))
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = mla.mla_forward(cfg, params, x)
    for a, b in zip(got, want, strict=True):
        assert a.is_cuda and a.dtype == torch.bfloat16 and rel(a, b) <= bound
    caches = [mla.init_mla_cache(cfg, 2, 80, torch.bfloat16, device=d) for d in (cuda, "cpu")]
    for c in caches:
        c["c_kv"][:, :64] = got[1].to(c["c_kv"].device)
        c["k_rope"][:, :64] = got[2].to(c["k_rope"].device)
    for pos in (64, 65, 66):
        xt = torch.randn((2, 1, 256), generator=gen).to(torch.bfloat16)
        valid = attention.kv_valid(2, 80, pos, ring=False, device=cuda)
        xc = xt.to(cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _ = mla.mla_decode(cfg, card_params, xc, caches[0], pos, ring=False,
                                    valid=valid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref_out, _ = mla.mla_decode(cfg, params, xt, caches[1], pos, ring=False,
                                    valid=valid.cpu())
        assert rel(out, ref_out) <= bound, pos
    for key in ("c_kv", "k_rope"):
        assert rel(caches[0][key], caches[1][key]) <= bound, key


@pytest.mark.cuda
def test_cuda_xlstm_matches_the_cpu_without_a_host_sync(cuda):
    """xlstm-1.3b reduced (sLSTM, mLSTM, sLSTM, mLSTM, stacked; each with
    the reduced config's MLP), bf16, on the card against the plain path on
    the CPU from the same weights: the prefill's logits and caches and 3
    decode steps fed the CPU's tokens, each step under
    ``set_sync_debug_mode("error")`` (a host sync raises), within
    chip_smoke.py's a-priori bound 2**-8 * sqrt(roundings a layer x
    layers) relative L2 (sLSTM 11 and mLSTM 14, ``XLSTM_ROUNDINGS``, and
    the MLP's 8); no hand-written kernel launches."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.pytree import tree_map

    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(), n_layers=4,
                              xlstm_slstm_every=2, scan_layers=True)
    bound = 2 ** -8 * (2 * (11 + 8) + 2 * (14 + 8)) ** 0.5
    cpu_model, card_model = build_model(cfg, device="cpu"), build_model(cfg, device=cuda)
    params = cpu_model.init(0)
    card_params = tree_map(lambda t: t.to(cuda), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 512))
                            .astype(np.int32))

    def rel(a, b):
        a, b = a.cpu().double(), b.double()
        return float((a - b).norm() / b.norm())

    before = ops.launch_counts()
    with torch.inference_mode():
        want, cpu_cache = cpu_model.prefill(params, {"tokens": toks}, 1024)
        got, cache = card_model.prefill(card_params, {"tokens": toks.to(cuda)}, 1024)
        assert rel(got, want) <= bound
        for a, b in zip(tree_leaves(cache["layers"]), tree_leaves(cpu_cache["layers"])):
            assert a.is_cuda and a.dtype == torch.float32 and rel(a, b) <= bound
        for _ in range(3):
            tok = torch.argmax(want[:, -1], -1)[:, None].to(torch.int32)
            want, cpu_cache = cpu_model.decode_step(params, {"tokens": tok}, cpu_cache, 1024)
            tok = tok.to(cuda)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got, cache = card_model.decode_step(card_params, {"tokens": tok}, cache, 1024)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert rel(got, want) <= bound
    assert ops.launch_counts() == before
