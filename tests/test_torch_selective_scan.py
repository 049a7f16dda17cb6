"""The port's plain selective scan (``repro_torch.kernels.ref``: the CPU
route of ``ops.selective_scan``, and what the CUDA kernel is held against
on the card) against the JAX package: its Pallas kernel run with
``interpret=True`` and its jnp oracle, on the same numpy inputs.

Tolerances, stated with their reasons:
- y and the final state in fp32 within 2e-4, as ``tests/test_kernels.py``
  holds the Pallas kernel against the oracle: the port steps through the
  recurrence in the Pallas kernel's order, the oracle sums by a chunked
  associative scan, and the CPU exponentials of XLA and of PyTorch may
  differ by an ulp;
- y in bf16 within 2e-2 (that file's bf16 tolerance): the fp32 sums above
  round to bf16 once and may land on either side of a tie, one bf16 ulp
  (at most 2**-7 relative) apart; the state stays fp32 and keeps 2e-4;
- one recurrent step against JAX's ``selective_scan_step`` within 1e-6:
  the same products in the same order, but XLA's CPU ``exp`` and
  PyTorch's are not the same function (one ulp apart on some inputs) and
  the output's sum over N may run in another order;
- the scan against its own stepwise recurrence and its ``init_state``
  continuation within 2e-5 (``tests/test_kernels.py:83-112``): the step
  forms (dt B) x where the scan forms (dt x) B, and sums y by an einsum.

The Pallas kernel leaves tails unwritten when S % chunk or Di % bd is
nonzero, so it is called only where both divide; ragged S is held
against the oracle.  The kernel wrapper's own checks run here as well:
they raise before any launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

from repro.kernels import ref as jref
from repro.kernels.selective_scan import selective_scan as jscan_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as scan_kernel
from torch_kernel_models import scan_kernel_order

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Y_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
STATE_TOL = 2e-4


def _inputs(seed, b, s, di, n, dtype="float32", init=False):
    """x (in ``dtype``), dt = softplus(normal), A = -exp(0.3 normal), B, C,
    D and (``init``) a state, as numpy arrays fed to both packages; the
    shapes and scales of ``tests/test_kernels.py``."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, di)) * 0.5).astype(np.float32)
    x = np.array(jnp.asarray(x, JDT[dtype]).astype(jnp.float32))  # rounded once
    arrs = {
        "x": x,
        "dt": np.logaddexp(rng.normal(size=(b, s, di)), 0).astype(np.float32),
        "A": -np.exp(rng.normal(size=(di, n)) * 0.3).astype(np.float32),
        "Bm": rng.normal(size=(b, s, n)).astype(np.float32),
        "Cm": rng.normal(size=(b, s, n)).astype(np.float32),
        "D": rng.normal(size=(di,)).astype(np.float32),
    }
    if init:
        arrs["init_state"] = rng.normal(size=(b, di, n)).astype(np.float32)
    j = {k: jnp.asarray(v, JDT[dtype] if k == "x" else jnp.float32) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).to(TDT[dtype] if k == "x" else torch.float32)
         for k, v in arrs.items()}
    return j, t


def _args(d):
    return (d["x"], d["dt"], d["A"], d["Bm"], d["Cm"], d["D"])


def _close(port, jax_out, tol):
    np.testing.assert_allclose(port.to(torch.float32).numpy(), np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


def _port_scan(t, **kw):
    y, h = ops.selective_scan(*_args(t), init_state=t.get("init_state"), **kw)
    assert y.dtype == t["x"].dtype and y.shape == t["x"].shape
    assert h.dtype == torch.float32 and h.shape == (t["x"].shape[0], *t["A"].shape)
    return y, h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,n,bd,chunk", [
    (1, 128, 64, 16, 32, 64),
    (2, 256, 128, 8, 128, 128),
])
def test_plain_scan_matches_jax_pallas(b, s, di, n, bd, chunk, dtype):
    """The reference test's shapes (``tests/test_kernels.py:66-80``), Pallas
    in interpret mode, where bd and chunk divide Di and S."""
    j, t = _inputs(s + di, b, s, di, n, dtype)
    jy, jh = jscan_pallas(*_args(j), interpret=True, bd=bd, chunk=chunk)
    y, h = _port_scan(t)
    _close(y, jy, Y_TOL[dtype])
    _close(h, jh, STATE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,n,init", [
    (2, 17, 48, 8, False),
    (1, 100, 96, 16, True),
    (2, 1, 40, 4, True),
])
def test_plain_scan_matches_jax_oracle_at_ragged_s(b, s, di, n, init, dtype):
    """Lengths the TPU dispatch sends to the oracle (S % 128 != 0), with and
    without an initial state."""
    j, t = _inputs(s * di + n, b, s, di, n, dtype, init=init)
    jy, jh = jref.selective_scan(*_args(j), init_state=j.get("init_state"))
    y, h = _port_scan(t)
    _close(y, jy, Y_TOL[dtype])
    _close(h, jh, STATE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_matches_jax_step(dtype):
    j, t = _inputs(3, 2, 1, 64, 16, dtype, init=True)
    jy, jh = jref.selective_scan_step(j["x"][:, 0], j["dt"][:, 0], j["A"], j["Bm"][:, 0],
                                      j["Cm"][:, 0], j["D"], j["init_state"])
    y, h = ops.selective_scan_step(t["x"][:, 0], t["dt"][:, 0], t["A"], t["Bm"][:, 0],
                                   t["Cm"][:, 0], t["D"], t["init_state"])
    assert y.dtype == TDT[dtype] and h.dtype == torch.float32
    _close(h, jh, 1e-6)
    _close(y, jy, 1e-6 if dtype == "float32" else Y_TOL[dtype])


def test_scan_matches_its_stepwise_recurrence():
    """``tests/test_kernels.py:83-97`` on the port: the scan equals the
    literal per-token recurrence of ``selective_scan_step``."""
    _, t = _inputs(4, 1, 64, 32, 8)
    y_scan, h_scan = _port_scan(t)
    h = torch.zeros((1, 32, 8))
    ys = []
    for i in range(64):
        y, h = ref.selective_scan_step(t["x"][:, i], t["dt"][:, i], t["A"], t["Bm"][:, i],
                                       t["Cm"][:, i], t["D"], h)
        ys.append(y)
    torch.testing.assert_close(y_scan, torch.stack(ys, 1), atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(h_scan, h, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_state_continuation(dtype):
    """``tests/test_kernels.py:100-112`` on the port: scan(x[:s]) equals
    scan(x[:m]) then scan(x[m:], init_state) -- bitwise, since both walk
    the same steps in the same order."""
    _, t = _inputs(5, 1, 128, 32, 8, dtype)
    y_full, h_full = _port_scan(t)
    m = 64
    first = {k: v[:, :m] if k in ("x", "dt", "Bm", "Cm") else v for k, v in t.items()}
    rest = {k: v[:, m:] if k in ("x", "dt", "Bm", "Cm") else v for k, v in t.items()}
    _, h1 = _port_scan(first)
    y2, h2 = _port_scan({**rest, "init_state": h1})
    assert torch.equal(y_full[:, m:], y2) and torch.equal(h_full, h2)


def _long_memory(seed, b, s, di, n, dtype):
    """dt and A as the model makes them (``models/layers/mamba.py:39-49``):
    dt log-uniform in [1e-3, 1e-1], A = -(1..N) in every channel."""
    j, t = _inputs(seed, b, s, di, n, dtype)
    rng = np.random.default_rng(seed + 1)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(b, s, di))).astype(np.float32)
    a = -np.exp(np.log(np.arange(1, n + 1, dtype=np.float32)))[None].repeat(di, 0)
    for k, v in (("dt", dt), ("A", a)):
        j[k], t[k] = jnp.asarray(v), torch.from_numpy(np.ascontiguousarray(v))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,n,init,long_memory", [
    (2, 40, 24, 16, False, False),
    (1, 33, 16, 5, True, False),    # N padded to the kernel's bucket of 8
    (1, 20, 8, 64, True, False),
    (1, 256, 12, 16, False, True),  # the model's dt and A: the state carries far
])
def test_kernel_order_matches_jax_oracle(b, s, di, n, init, long_memory, dtype):
    """The CUDA kernel's order of y's sum over the states (four partial
    sums, then a tree; ``tests/torch_kernel_models.py``) against JAX's
    oracle at this file's tolerances, and its state, rounded as the plain
    version rounds it, bitwise the plain version's."""
    if long_memory:
        j, t = _long_memory(s + di, b, s, di, n, dtype)
    else:
        j, t = _inputs(s + di + n, b, s, di, n, dtype, init=init)
    jy, jh = jref.selective_scan(*_args(j), init_state=j.get("init_state"))
    y, h = scan_kernel_order(*_args(t), init_state=t.get("init_state"))
    _close(y, jy, Y_TOL[dtype])
    _close(h, jh, STATE_TOL)
    _, h_plain = _port_scan(t)
    assert torch.equal(h, h_plain)


def test_cpu_route_never_counts_a_launch():
    _, t = _inputs(6, 1, 8, 16, 4, init=True)
    before = ops.launch_counts()
    _port_scan(t)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("change,err,match", [
    (dict(x=torch.zeros(1, 4, 8, dtype=torch.float16)), TypeError, "dtype"),
    (dict(A=torch.zeros(8, 65)), ValueError, "N <= 64"),
    (dict(Bm=torch.zeros(1, 4, 3)), ValueError, "Bm has shape"),
    (dict(init_state=torch.zeros(1, 8, 5)), ValueError, "init_state has shape"),
    (dict(x=torch.zeros(1, 0, 8), dt=torch.zeros(1, 0, 8), Bm=torch.zeros(1, 0, 4),
          Cm=torch.zeros(1, 0, 4)), ValueError, "S, Di >= 1"),
    ({}, ValueError, "CUDA tensors"),
])
def test_kernel_wrapper_checks_raise_before_launch(change, err, match):
    """The wrapper's checks on CPU tensors: each raises before the launch
    (on a CPU tensor the last one is all that stops it)."""
    args = dict(x=torch.zeros(1, 4, 8), dt=torch.zeros(1, 4, 8), A=torch.zeros(8, 4),
                Bm=torch.zeros(1, 4, 4), Cm=torch.zeros(1, 4, 4), D=torch.zeros(8))
    args.update(change)
    n = args["A"].shape[1]
    if "Bm" not in change:
        args["Bm"] = args["Cm"] = torch.zeros(1, 4, n)
    init = args.pop("init_state", None)
    before = ops.launch_counts()
    with pytest.raises(err, match=match):
        scan_kernel.selective_scan(args["x"], args["dt"], args["A"], args["Bm"], args["Cm"],
                                   args["D"], init_state=init)
    assert ops.launch_counts() == before

