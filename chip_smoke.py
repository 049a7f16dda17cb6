#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits non-zero):

1. build the hand-written kernels from csrc/ (one nvcc per source, in
   parallel) and print the build seconds;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, at C=64, at a ragged N, with all-zero weights and
   (topk_scatter_reduce) on disjoint, repeated, unsorted, out-of-range and
   empty payloads and twice on one payload, and time kernel (through its
   ops wrapper, and as a bare launch), plain version and the library call
   where there is one;
3. drive the paper's Flower loop at the full width of
   mobilenet-head-office31 -- Server.run + FedAvg + BandwidthCodecPolicy
   over 6 Jetson TX2 clients (Int8) and 2 datacenter-class clients (Null),
   3 rounds -- with the launch counts set to 0 just before and read just
   after, and check counts, device, accuracy and wire bytes;
3b. the same over the paper's mixed fleet: 4 phones (TopK), 4 Jetsons
   (Int8), 2 datacenter-class clients (Null), then its reduced-width
   card-vs-CPU replay as in phase 4;
4. run the phase-3 loop at reduced width on the card and on the CPU (where
   the plain versions run) from the same seed, replay the card's uploads
   through the CPU aggregation, and compare;
5. profile a steady full-width round of each fleet: host seconds by FL
   stage, the card's busy time and its top kernels (torch.profiler);
6. the round engine (make_round_step) at full width, parallel and
   sequential, each with the Null, Int8 and TopK codecs: 8 clients, 8 local
   steps of batch 32, tau budgets 2-8, one client dropped in round 2, with
   launch counts per round, host seconds per round and the card's busy
   time in a profiled fourth round.

Prints the card's nvidia-smi name and power limit and a {"kernels": [...]}
line, and ends with {"ok": true, "device": {...}}.  The full report goes
to DIR/chip_smoke.json and the profiled round's trace to
DIR/round3_trace.json and DIR/mixed_fleet_round3_trace.json (DIR defaults
to smoke_out).
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
BLOCK = 256
N_PARAMS = 1_974_303          # mobilenet-head-office31, frozen base included
REPORT = {"checks": [], "timings": []}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def check(name: str, ok: bool, **info) -> None:
    REPORT["checks"].append({"name": name, "ok": bool(ok), **info})
    print(f"[{'ok' if ok else 'FAIL'}] {name} {json.dumps(info, default=str)}", flush=True)
    if not ok:
        raise SystemExit(f"check failed: {name}")


# ---------------- timing ----------------
_FLUSH = None


def time_ms(fn, iters: int = 30) -> float:
    """Median device time of one call.  Before each call a 512 MB memset
    evicts the 50 MB L2 (the server meets freshly decoded wires mostly
    cold) and keeps the card busy while the host enqueues the call, so the
    events bracket the device work and not the host's launch overhead."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        _FLUSH.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def delta_like(rng, shape, device="cuda"):
    """Update-delta-like fp32 values spanning several magnitudes, with one
    all-zero quantization block (scale 0 -> 1)."""
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-5, -1, size=shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1)[:BLOCK] = 0.0
    return torch.from_numpy(x).to(device)


# ---------------- phase 2: kernels against their plain versions ----------------
def kernel_phase(rng) -> dict:
    from repro_torch.kernels import _cuda, ops, ref
    from repro_torch.utils.pytree import safe_weight_sum

    dev = torch.device("cuda")
    rows = {}
    tol = dict(rtol=1e-6, atol=1e-6)

    def launch(lib, fn, counter, *args):
        """The bare kernel launch (``launch_ms``).  ``ms`` times the ops
        wrapper instead -- checks, allocation and, for the reduces, the
        weight normalization -- which is the work ``plain_ms`` times too."""
        return lambda: _cuda.launch(lib, fn, counter, dev, *args)

    def normalized(w):
        return (w / safe_weight_sum(w)).contiguous()

    # --- quantize_int8 / dequantize_int8: bitwise ---
    for label, n_blocks in (("main", N_PARAMS // BLOCK + 1), ("ragged", 9)):
        x = delta_like(rng, (n_blocks * BLOCK,))
        q, s = ops.quantize_int8(x)
        qr, sr = ref.quantize_int8(x)
        q_err = max(float((q.int() - qr.int()).abs().max()), float((s - sr).abs().max()))
        check(f"quantize_int8 bitwise [{label}, Np={x.numel()}]",
              torch.equal(q, qr) and torch.equal(s, sr),
              codes_differing=int((q != qr).sum()), max_abs_err=q_err)
        xd = ops.dequantize_int8(q, s)
        xr = ref.dequantize_int8(qr, sr)
        dq_err = float((xd - xr).abs().max())
        check(f"dequantize_int8 bitwise [{label}, Np={x.numel()}]", torch.equal(xd, xr),
              max_abs_err=dq_err)
        if label != "main":
            continue
        qo, so, xo = torch.empty_like(q), torch.empty_like(s), torch.empty_like(xd)
        b_ms, b_by = bound(nbytes(x, q, s), 6 * x.numel())
        rows["quantize_int8"] = dict(
            source="src/repro_torch/kernels/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:41",
            max_abs_err=q_err,
            ms=time_ms(lambda: ops.quantize_int8(x)),
            launch_ms=time_ms(launch("quantize", "repro_quantize_int8", "quantize_int8",
                                     x.data_ptr(), qo.data_ptr(), so.data_ptr(), n_blocks)),
            plain_ms=time_ms(lambda: ref.quantize_int8(x)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"x ({x.numel()},) fp32", bytes=nbytes(x, q, s),
        )
        b_ms, b_by = bound(nbytes(q, s, xd), xd.numel())
        rows["dequantize_int8"] = dict(
            source="src/repro_torch/kernels/csrc/quantize.cu",
            replaces="src/repro/kernels/quantize.py:69",
            max_abs_err=dq_err,
            ms=time_ms(lambda: ops.dequantize_int8(q, s)),
            launch_ms=time_ms(launch("quantize", "repro_dequantize_int8", "dequantize_int8",
                                     q.data_ptr(), s.data_ptr(), xo.data_ptr(), n_blocks)),
            plain_ms=time_ms(lambda: ref.dequantize_int8(q, s)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"q ({q.numel()},) int8", bytes=nbytes(q, s, xd),
        )

    # --- dequant_reduce: C=6 (the fleet's Int8 group), C=64, ragged, zero weights ---
    np_main = (N_PARAMS // BLOCK + 1) * BLOCK
    for label, c, npad in (("main", 6, np_main), ("C=64", 64, np_main), ("ragged", 3, 3 * BLOCK)):
        x = delta_like(rng, (c, npad))
        qr, sr = ref.quantize_int8(x.reshape(-1))
        q, s = qr.reshape(c, npad), sr.reshape(c, npad // BLOCK)
        w = torch.from_numpy((rng.random(c) * 500 + 10).astype(np.float32)).to(dev)
        out, exp = ops.dequant_reduce(q, s, w), ref.dequant_reduce(q, s, w)
        err = float((out - exp).abs().max())
        check(f"dequant_reduce within rtol=atol=1e-6 [{label}: C={c}, Np={npad}]",
              torch.allclose(out, exp, **tol), max_abs_err=err)
        zero = ops.dequant_reduce(q, s, torch.zeros_like(w))
        check(f"dequant_reduce zero weights -> zeros [{label}]",
              not zero.any() and not zero.isnan().any())
        if label == "ragged":
            continue
        wn, outo = normalized(w), torch.empty_like(out)
        b_ms, b_by = bound(nbytes(q, s, w, out), 3 * q.numel())
        row = dict(
            source="src/repro_torch/kernels/csrc/dequant_reduce.cu",
            replaces="src/repro/kernels/dequant_reduce.py:77",
            max_abs_err=err,
            ms=time_ms(lambda: ops.dequant_reduce(q, s, w)),
            launch_ms=time_ms(launch("dequant_reduce", "repro_dequant_reduce", "dequant_reduce",
                                     q.data_ptr(), s.data_ptr(), wn.data_ptr(), outo.data_ptr(),
                                     c, npad)),
            plain_ms=time_ms(lambda: ref.dequant_reduce(q, s, w)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"q ({c}, {npad}) int8", bytes=nbytes(q, s, w, out),
        )
        if label == "main":
            rows["dequant_reduce"] = row
        else:
            REPORT["timings"].append({"name": "dequant_reduce", "case": label, **row})

    # --- fedavg_reduce: C=2 fp32 (the fleet's Null group), C=64, bf16, ragged, zero ---
    for label, c, n, dtype in (
        ("main", 2, N_PARAMS, torch.float32), ("C=64", 64, N_PARAMS, torch.float32),
        ("bf16", 2, N_PARAMS, torch.bfloat16), ("ragged", 3, 1001, torch.float32),
    ):
        u = delta_like(rng, (c, n)).to(dtype)
        w = torch.from_numpy((rng.random(c) * 500 + 10).astype(np.float32)).to(dev)
        out, exp = ops.fedavg_reduce(u, w), ref.fedavg_reduce(u, w)
        # bf16: the two fp32 sums may straddle a bf16 rounding edge -> one ulp
        t = tol if dtype == torch.float32 else dict(rtol=2**-7, atol=1e-8)
        err = float((out.float() - exp.float()).abs().max())
        check(f"fedavg_reduce within {t} [{label}: C={c}, N={n}, {dtype}]",
              out.dtype == dtype and torch.allclose(out.float(), exp.float(), **t),
              max_abs_err=err)
        zero = ops.fedavg_reduce(u, torch.zeros_like(w))
        check(f"fedavg_reduce zero weights -> zeros [{label}]",
              not zero.any() and not zero.isnan().any())
        if label == "ragged":
            continue
        wn, outo = normalized(w), torch.empty_like(out)
        wn_lib = wn.to(dtype)
        entry = "repro_fedavg_reduce_f32" if dtype == torch.float32 else "repro_fedavg_reduce_bf16"
        b_ms, b_by = bound(nbytes(u, w, out), 2 * u.numel())
        row = dict(
            source="src/repro_torch/kernels/csrc/fedavg_reduce.cu",
            replaces="src/repro/kernels/fedavg_reduce.py:56",
            max_abs_err=err,
            ms=time_ms(lambda: ops.fedavg_reduce(u, w)),
            launch_ms=time_ms(launch("fedavg_reduce", entry, "fedavg_reduce",
                                     u.data_ptr(), wn.data_ptr(), outo.data_ptr(), c, n)),
            plain_ms=time_ms(lambda: ref.fedavg_reduce(u, w)),
            # the yardstick: one library call (cuBLAS gemv) on the same inputs
            library_ms=time_ms(lambda: wn_lib @ u),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"u ({c}, {n}) {dtype}", bytes=nbytes(u, w, out),
        )
        if label == "main":
            rows["fedavg_reduce"] = row
        else:
            REPORT["timings"].append({"name": "fedavg_reduce", "case": label, **row})
    rows["topk_scatter_reduce"] = topk_kernel_checks(dev, tol, launch)
    return rows


TOPK_K = 19_743               # TopKCodec(frac=0.01).k_of(N_PARAMS)


def topk_payload(gen, c: int, k: int, n: int, dev, *, disjoint=False):
    """A canonical TopK wire (distinct indices, ascending per row), values
    like update deltas, weights like example counts."""
    if disjoint:
        idx = torch.randperm(n, generator=gen, device=dev)[: c * k].reshape(c, k)
    else:
        idx = torch.rand(c, n, generator=gen, device=dev).topk(k, dim=1).indices
    idx = idx.sort(dim=1).values.to(torch.int32)
    val = torch.randn(c, k, generator=gen, device=dev) * 1e-2
    w = torch.randint(10, 500, (c,), generator=gen, device=dev).to(torch.float32)
    return idx, val, w


def topk_kernel_checks(dev, tol, launch) -> dict:
    """topk_scatter_reduce against its plain version: C=4 (the mixed fleet's
    TopK group) and C=64 at full width, then the edge payloads."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.scatter_reduce import TILE
    from repro_torch.utils.pytree import safe_weight_sum

    gen = torch.Generator(device=dev).manual_seed(13)
    row = None
    for label, c in (("main", 4), ("C=64", 64)):
        idx, val, w = topk_payload(gen, c, TOPK_K, N_PARAMS, dev)
        out, exp = ops.topk_scatter_reduce(idx, val, w, N_PARAMS), ref.topk_scatter_reduce(idx, val, w, N_PARAMS)
        err = float((out - exp).abs().max())
        check(f"topk_scatter_reduce within rtol=atol=1e-6 [{label}: C={c}, k={TOPK_K}, N={N_PARAMS}]",
              torch.allclose(out, exp, **tol), max_abs_err=err)
        check(f"topk_scatter_reduce two launches bitwise equal [{label}]",
              torch.equal(out, ops.topk_scatter_reduce(idx, val, w, N_PARAMS)))
        di, dv, dw = topk_payload(gen, c, TOPK_K, N_PARAMS, dev, disjoint=True)
        check(f"topk_scatter_reduce bitwise on disjoint rows [{label}]",
              torch.equal(ops.topk_scatter_reduce(di, dv, dw, N_PARAMS),
                          ref.topk_scatter_reduce(di, dv, dw, N_PARAMS)))
        wf = w.contiguous()
        wsum = safe_weight_sum(wf)
        tiles = -(-N_PARAMS // TILE)
        ws = torch.empty(c * (tiles + 2), dtype=torch.int32, device=dev)
        outo = torch.empty_like(out)
        valid = (idx >= 0) & (idx < N_PARAMS)
        sidx = torch.where(valid, idx, 0).reshape(-1).long()
        contrib = (torch.where(valid, val, 0.0) * wf[:, None]).reshape(-1)
        b_ms, b_by = bound(nbytes(idx, val, w, out), 2 * idx.numel())
        timing = dict(
            source="src/repro_torch/kernels/csrc/topk_scatter_reduce.cu",
            replaces="src/repro/kernels/scatter_reduce.py:108",
            max_abs_err=err,
            ms=time_ms(lambda: ops.topk_scatter_reduce(idx, val, w, N_PARAMS)),
            launch_ms=time_ms(launch("topk_scatter_reduce", "repro_topk_scatter_reduce",
                                     "topk_scatter_reduce", idx.data_ptr(), val.data_ptr(),
                                     wf.data_ptr(), wsum.data_ptr(), outo.data_ptr(), ws.data_ptr(),
                                     c, TOPK_K, N_PARAMS, ws.numel())),
            plain_ms=time_ms(lambda: ref.topk_scatter_reduce(idx, val, w, N_PARAMS)),
            # the yardstick: one index_add_ on the same sanitized, weighted,
            # flattened inputs, plus the normalization
            library_ms=time_ms(lambda: torch.zeros(N_PARAMS, device=dev).index_add_(
                0, sidx, contrib) / wsum),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"idx/val ({c}, {TOPK_K}), N={N_PARAMS}", bytes=nbytes(idx, val, w, out),
        )
        if label == "main":
            row = timing
        else:
            REPORT["timings"].append({"name": "topk_scatter_reduce", "case": label, **timing})

    # canonical wires down the kernel's long paths: more entries of a row in
    # one tile than a CTA has threads, and more rows than one group of 256
    n = 20_000
    for label, c, k, span in (("3000 entries in one tile", 3, 3000, TILE + 100),
                              ("C=300 rows", 300, 40, n)):
        idx = torch.rand(c, span, generator=gen, device=dev).topk(k, dim=1).indices
        idx = idx.sort(dim=1).values.to(torch.int32)
        val = torch.randn(c, k, generator=gen, device=dev) * 1e-2
        w = torch.randint(10, 500, (c,), generator=gen, device=dev).to(torch.float32)
        out, exp = ops.topk_scatter_reduce(idx, val, w, n), ref.topk_scatter_reduce(idx, val, w, n)
        check(f"topk_scatter_reduce within rtol=atol=1e-6 and two launches bitwise [{label}]",
              torch.allclose(out, exp, **tol) and torch.equal(out, ops.topk_scatter_reduce(idx, val, w, n)),
              max_abs_err=float((out - exp).abs().max()))

    # foreign wires: unsorted rows with repeats, out-of-range indices
    idx = torch.randint(0, n, (5, 300), generator=gen, device=dev, dtype=torch.int32)
    idx[1, :10] = torch.tensor([-1, n, 2**31 - 1, -(2**31), 0, 0, n - 1, n - 1, 5, 5],
                               dtype=torch.int32, device=dev)
    val = torch.randn(5, 300, generator=gen, device=dev) * 1e-2
    w = torch.randint(10, 500, (5,), generator=gen, device=dev).to(torch.float32)
    out, exp = ops.topk_scatter_reduce(idx, val, w, n), ref.topk_scatter_reduce(idx, val, w, n)
    check("topk_scatter_reduce within rtol=atol=1e-6 [unsorted rows, repeated and "
          "out-of-range indices]", torch.allclose(out, exp, **tol),
          max_abs_err=float((out - exp).abs().max()))
    drop = ops.topk_scatter_reduce(
        torch.tensor([[0, -1, 256, 5, 2**30, 255]], dtype=torch.int32, device=dev),
        torch.ones(1, 6, device=dev), torch.ones(1, device=dev), 256)
    keep = torch.zeros(256, device=dev)
    keep[[0, 5, 255]] = 1.0
    check("topk_scatter_reduce drops negative and >= N indices", torch.equal(drop, keep))
    zero = ops.topk_scatter_reduce(idx, val, torch.zeros_like(w), n)
    check("topk_scatter_reduce zero weights -> zeros", not zero.any() and not zero.isnan().any())
    for c, k in ((3, 0), (0, 7)):
        empty = ops.topk_scatter_reduce(torch.zeros(c, k, dtype=torch.int32, device=dev),
                                        torch.zeros(c, k, device=dev), torch.ones(c, device=dev), n)
        check(f"topk_scatter_reduce C={c}, k={k} -> zeros", empty.shape == (n,) and not empty.any())
    summed = ops.topk_scatter_reduce(idx, val, w, n, normalize=False)
    check("topk_scatter_reduce normalize=False = mean x safe_weight_sum(w)",
          torch.equal(summed, out * safe_weight_sum(w)))
    return row


# ---------------- phases 3-4: the Flower loop ----------------
PROFILE_FLEET = ["jetson-tx2-gpu"] * 3 + ["jetson-tx2-cpu"] * 3 + ["tpu-v5e-chip"] * 2
# the paper's mixed fleet: Android phones (TopK), Jetsons (Int8), datacenter (Null)
MIXED_FLEET = (["pixel-4", "pixel-3", "pixel-2", "galaxy-tab-s6"]
               + ["jetson-tx2-gpu"] * 2 + ["jetson-tx2-cpu"] * 2 + ["tpu-v5e-chip"] * 2)


def flower_loop(arch, device, n_rounds: int, on_round=None, stage_s: dict | None = None,
                agg_log: list | None = None, fleet=PROFILE_FLEET):
    """The paper's Flower loop on the smoke fleet.  ``on_round()`` runs at
    the end of every round; with ``stage_s`` every client ``fit`` /
    ``evaluate`` and the strategy's ``aggregate_fit`` add their host seconds
    (synchronized) to it; with ``agg_log`` every ``aggregate_fit`` appends
    (rnd, results, global in, global out), the globals copied to the CPU."""
    from repro_torch.core import (
        PROFILES, BandwidthCodecPolicy, FedAvg, Server, TorchClient,
        make_cost_model_for,
    )
    from repro_torch.data.federated import dirichlet_partition
    from repro_torch.data.synthetic import make_features
    from repro_torch.models import build_model
    from repro_torch.utils.logging import MetricsLogger
    from repro_torch.utils.pytree import tree_map

    class RoundHook(MetricsLogger):
        def log(self, event, **kv):
            super().log(event, **kv)
            if on_round is not None:
                on_round()

    def timed(fn, stage):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stage_s[stage] = stage_s.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return call

    model = build_model(arch, device=device)
    data = make_features(n=2000, num_classes=31, feature_dim=model.cfg.feature_dim, seed=0)
    shards = dirichlet_partition(data, n_clients=len(fleet), alpha=1.0, seed=0)
    params = model.init(0)
    mask = model.trainable_mask(params)
    clients = [
        TorchClient(client_id=s.client_id, loss_fn=model.loss_fn, dataset=s,
                    batch_size=32, trainable_mask=mask, device_profile=p, device=device)
        for s, p in zip(shards, fleet)
    ]
    strategy = FedAvg(local_epochs=2, local_lr=0.1, codec_policy=BandwidthCodecPolicy())
    if stage_s is not None:
        for c in clients:
            c.fit, c.evaluate = timed(c.fit, "fit"), timed(c.evaluate, "evaluate")
        strategy.aggregate_fit = timed(strategy.aggregate_fit, "aggregate_fit")
    if agg_log is not None:
        def recorded(fn):
            def call(rnd, results, global_params):
                out = fn(rnd, results, global_params)
                agg_log.append((rnd, results, tree_map(lambda t: t.cpu(), global_params),
                                tree_map(lambda t: t.cpu(), out)))
                return out
            return call
        strategy.aggregate_fit = recorded(strategy.aggregate_fit)
    cost_model = make_cost_model_for(params, [PROFILES[p] for p in fleet])
    server = Server(
        strategy=strategy, clients=clients, cost_model=cost_model, device=device,
        logger=RoundHook("server", stream=sys.stderr),
    )
    return params, cost_model, server.run(params, num_rounds=n_rounds)


def main_path_phase() -> dict:
    from repro_torch.core import BandwidthCodecPolicy
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_leaves, tree_size

    stamps: list[float] = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, cost_model, (final, history) = flower_loop(
        "mobilenet-head-office31", "cuda", 3,
        on_round=lambda: stamps.append(time.perf_counter()),
    )
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0

    n = tree_size(params)
    check("full width: N = 1,974,303 params", n == N_PARAMS, n_params=n)
    per_round = {"quantize_int8": 6, "dequantize_int8": 6, "dequant_reduce": 1, "fedavg_reduce": 1}
    check("main path launched every kernel (6+6+1+1 per round)",
          all(counts[k] == 3 * v for k, v in per_round.items()), launches=counts)
    check("global params on cuda", all(t.is_cuda for t in tree_leaves(final)))
    accs = [r.eval_acc for r in history.rounds]
    check("accuracy finite and rising (round 3 > round 1)",
          all(math.isfinite(a) for a in accs) and accs[-1] > accs[0], eval_acc=accs)
    policy = BandwidthCodecPolicy()
    expect = 6 * policy.int8.wire_bytes(n) + 2 * policy.null.wire_bytes(n) + 8 * cost_model.update_bytes
    check("comm_bytes = codec wires + downlinks",
          all(r.comm_bytes == expect for r in history.rounds),
          comm_bytes=[r.comm_bytes for r in history.rounds], expected=expect)
    round_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    return {"launches": counts, "round_wall_s": round_s, "run_wall_s": wall,
            "eval_acc": accs, "train_loss": [r.train_loss for r in history.rounds]}


def mixed_fleet_phase() -> dict:
    """Phase 3b: the mixed fleet at full width, launch counts from 0."""
    from repro_torch.core import BandwidthCodecPolicy
    from repro_torch.kernels import ops
    from repro_torch.utils.pytree import tree_leaves, tree_size

    stamps: list[float] = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params, cost_model, (final, history) = flower_loop(
        "mobilenet-head-office31", "cuda", 3,
        on_round=lambda: stamps.append(time.perf_counter()), fleet=MIXED_FLEET,
    )
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    n = tree_size(params)
    per_round = {"quantize_int8": 4, "dequantize_int8": 4, "dequant_reduce": 1,
                 "fedavg_reduce": 1, "topk_scatter_reduce": 1}
    check("mixed fleet: launches per round 4/4/1/1/1 (TopK clients launch none)",
          all(counts[k] == 3 * v for k, v in per_round.items()), launches=counts)
    check("mixed fleet: global params on cuda", all(t.is_cuda for t in tree_leaves(final)))
    accs = [r.eval_acc for r in history.rounds]
    check("mixed fleet: accuracy finite and rising (round 3 > round 1)",
          all(math.isfinite(a) for a in accs) and accs[-1] > accs[0], eval_acc=accs)
    policy = BandwidthCodecPolicy()
    expect = (4 * policy.topk.wire_bytes(n) + 4 * policy.int8.wire_bytes(n)
              + 2 * policy.null.wire_bytes(n) + len(MIXED_FLEET) * cost_model.update_bytes)
    check("mixed fleet: comm_bytes = codec wires + downlinks",
          all(r.comm_bytes == expect for r in history.rounds),
          comm_bytes=[r.comm_bytes for r in history.rounds], expected=expect)
    round_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    return {"launches": counts, "round_wall_s": round_s, "eval_acc": accs,
            "train_loss": [r.train_loss for r in history.rounds]}


def reduced_parity_phase(fleet=PROFILE_FLEET) -> None:
    """The card (kernels) against the CPU (plain versions) at reduced width.

    1. Replay: every round's uploads that reached the card's
       ``aggregate_fit`` go through a CPU strategy's ``aggregate_fit`` against
       the same global; the new globals differ only by the reduces' summation
       order (rtol=atol=1e-6), so a wrong weight or a dropped codec group
       shows.
    2. The same 2-round run on both devices from the same seed: History must
       be equal.  Local SGD differs in the last bits between the devices, so
       an Int8 code on a rounding edge may flip and a TopK entry on the
       selection edge may change; the final params may differ by 1e-5 plus,
       for every code that differs between the two runs' wires, that code's
       change times its block scale times its client's weight share, and for
       every TopK index sent by one run only, its |value| times the weight
       share."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import FedAvg, Int8Codec, TopKCodec
    from repro_torch.core.protocol import wire_to_enc
    from repro_torch.utils.pytree import tree_flatten_to_vector

    arch = get_config("mobilenet-head-office31").reduced()
    name = "reduced width" if fleet is PROFILE_FLEET else "mixed fleet, reduced width"
    card_log, cpu_log = [], []
    _, _, (on_card, h_card) = flower_loop(arch, "cuda", 2, agg_log=card_log, fleet=fleet)
    _, _, (on_cpu, h_cpu) = flower_loop(arch, "cpu", 2, agg_log=cpu_log, fleet=fleet)

    replay_err = 0.0
    cpu_strategy = FedAvg(local_epochs=2, local_lr=0.1)
    for rnd, results, g_in, g_out in card_log:
        want = tree_flatten_to_vector(cpu_strategy.aggregate_fit(rnd, results, g_in))
        got = tree_flatten_to_vector(g_out)
        replay_err = max(replay_err, float((got - want).abs().max()))
        check(f"{name}: round {rnd} card aggregate = CPU aggregate of the same "
              f"uploads (rtol=atol=1e-6)", torch.allclose(got, want, rtol=1e-6, atol=1e-6),
              max_abs_err=float((got - want).abs().max()))

    atol, flipped = 1e-5, 0
    for (_, card_res, _, _), (_, cpu_res, _, _) in zip(card_log, cpu_log, strict=True):
        wsum = sum(r.num_examples for _, r in card_res)
        for (_, a), (_, b) in zip(card_res, cpu_res, strict=True):
            kind = type(a.parameters.codec)
            if kind not in (Int8Codec, TopKCodec):
                continue
            ea, eb = wire_to_enc(a.parameters, "cpu"), wire_to_enc(b.parameters, "cpu")
            if kind is TopKCodec:
                va = dict(zip(ea["idx"].tolist(), ea["val"].tolist()))
                vb = dict(zip(eb["idx"].tolist(), eb["val"].tolist()))
                for i in set(va) ^ set(vb):
                    flipped += 1
                    atol += abs(va.get(i, vb.get(i))) * a.num_examples / wsum
                continue
            dq = (ea["q"].int() - eb["q"].int()).abs().reshape(-1, BLOCK)
            scale = torch.maximum(ea["scale"], eb["scale"]).reshape(-1, 1)
            flipped += int((dq > 0).sum())
            atol += float((dq * scale).sum()) * a.num_examples / wsum
    err = float((tree_flatten_to_vector(on_card).cpu() - tree_flatten_to_vector(on_cpu)).abs().max())
    check(f"{name}: card vs CPU run (atol = 1e-5 + the differing wire entries' share)",
          err <= atol and all(
              (x.comm_bytes, x.wall_time_s, x.energy_j) == (y.comm_bytes, y.wall_time_s, y.energy_j)
              for x, y in zip(h_card.rounds, h_cpu.rounds, strict=True)),
          max_abs_err=err, atol=atol, codes_differing=flipped, replay_max_abs_err=replay_err)


PORT_KERNELS = ("quantize_int8_kernel", "dequant_reduce_kernel", "fedavg_reduce_kernel",
                "topk_index_rows", "topk_scatter_tiles")


def device_time(prof) -> tuple[float, dict]:
    """A profiler run's card busy time (the union of its device intervals,
    us) and device time by kernel name."""
    from torch.autograd import DeviceType

    spans, by_kernel = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy_us, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us, by_kernel


def profile_phase(card: str, out_dir: Path, fleet=PROFILE_FLEET) -> dict:
    """Where a steady full-width round's time goes, on a fresh 3-round run
    of the same loop: round 2's host seconds split by FL stage (each stage
    synchronized), round 3 under torch.profiler (device activity only) for
    the card's busy time and its kernels.  The profiler's own cost inflates
    round 3's wall time, so the card's idle share is taken against round 2,
    which does the same device work without it."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    stage_s: dict = {}
    marks: list[float] = []
    split: dict = {}

    def on_round():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if len(marks) == 1:
            stage_s.clear()
        elif len(marks) == 2:
            split.update(stage_s)
            prof.start()
        elif len(marks) == 3:
            prof.stop()

    flower_loop("mobilenet-head-office31", "cuda", 3, on_round=on_round, stage_s=stage_s,
                fleet=fleet)
    round2_s, round3_s = marks[1] - marks[0], marks[2] - marks[1]
    split["other"] = round2_s - sum(split.values())
    busy_us, by_kernel = device_time(prof)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    ours_us = sum(us for name, us in by_kernel.items() if any(k in name for k in PORT_KERNELS))
    label = "" if fleet is PROFILE_FLEET else "mixed fleet "
    prof.export_chrome_trace(str(out_dir / f"{label.replace(' ', '_')}round3_trace.json"))
    out = {
        "round2_host_s": round2_s, "round2_stage_s": split,
        "round3_profiled_s": round3_s, "round3_device_busy_ms": busy_us / 1e3,
        "device_idle_share_vs_round2": 1.0 - busy_us / 1e6 / round2_s,
        "round3_port_kernels_us": ours_us, "round3_top_device_us": top,
    }
    print(f"{label}round 2 host split: {json.dumps({k: round(v, 4) for k, v in split.items()})} "
          f"of {round2_s:.4f} s ({card})", flush=True)
    print(f"{label}round 3 profiled: card busy {busy_us / 1e3:.3f} ms, of which the port's "
          f"kernels {ours_us:.1f} us; idle {out['device_idle_share_vs_round2']:.4f} of "
          f"round 2's {round2_s:.4f} s ({card})", flush=True)
    for name, us in top:
        print(f"  {us:10.1f} us  {name[:100]}", flush=True)
    return out


ENGINE_BUDGETS = [8, 7, 6, 5, 4, 3, 2, 8]   # the tau cutoff, in local steps
ENGINE_DROP = 3                              # the client masked out of round 2


def round_engine_phase(card: str) -> dict:
    """Phase 6: make_round_step at full width, parallel and sequential x
    Null / Int8 / TopK, 3 rounds each (8 clients, 8 local steps of batch
    32).  Every round starts from launch counts of 0 and ends synchronized.
    A fourth round, the same work as round 3, runs under torch.profiler for
    the card's busy time; its idle share is taken against round 3."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (
        FedAvg, Int8Codec, NullCodec, RoundSpec, TopKCodec, make_round_step,
    )
    from repro_torch.data.synthetic import make_features
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import sgd
    from repro_torch.utils.pytree import tree_flatten_to_vector, tree_size

    c, steps, b = 8, 8, 32
    model = build_model("mobilenet-head-office31", device="cuda")
    params = model.init(0)
    n = tree_size(params)
    data = make_features(n=c * steps * b, num_classes=31, feature_dim=model.cfg.feature_dim, seed=1)
    batches = {
        "x": torch.from_numpy(data.x.reshape(c, steps, b, -1)).cuda(),
        "y": torch.from_numpy(data.y.reshape(c, steps, b)).cuda(),
    }
    weights = torch.from_numpy(np.random.default_rng(2).integers(50, 400, c).astype(np.float32)).cuda()
    budgets = torch.tensor(ENGINE_BUDGETS, dtype=torch.int32, device="cuda")
    drop = torch.ones(c, device="cuda")
    drop[ENGINE_DROP] = 0.0
    # launches a round: (quantize, dequantize, dequant_reduce, topk_scatter_reduce)
    expect = {
        ("parallel", "NullCodec"): (0, 0, 0, 0), ("parallel", "Int8Codec"): (1, 1, 1, 0),
        ("parallel", "TopKCodec"): (0, 0, 0, 1), ("sequential", "NullCodec"): (0, 0, 0, 0),
        ("sequential", "Int8Codec"): (c, c, 0, 0), ("sequential", "TopKCodec"): (0, 0, 0, 0),
    }
    out, first_round = {}, {}
    for (mode, name), want in expect.items():
        codec = {"NullCodec": NullCodec(), "Int8Codec": Int8Codec(), "TopKCodec": TopKCodec()}[name]
        step = make_round_step(model.loss_fn, sgd(0.1), FedAvg(),
                               RoundSpec(max_steps=steps, execution_mode=mode, codec=codec),
                               trainable_mask=model.trainable_mask(params))
        g, state = params, codec.init_client_state(c, n)
        losses, host_s, counts = [], [], []
        for rnd in range(3):
            mask = drop if rnd == 1 else None
            state_in = state
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            g, _, state, met = step(g, (), state, batches, weights, budgets, rnd, mask)
            torch.cuda.synchronize()
            host_s.append(time.perf_counter() - t0)
            counts.append(ops.launch_counts())
            losses.append(float(met["client_loss_mean"]))
            if rnd == 0:
                first_round[(mode, name)] = tree_flatten_to_vector(g)
            if rnd == 1 and name != "NullCodec":
                check(f"engine {mode} {name}: the dropped client's residual row is bitwise unchanged",
                      torch.equal(state[ENGINE_DROP], state_in[ENGINE_DROP]))
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        step(g, (), state, batches, weights, budgets, 3, None)
        torch.cuda.synchronize()
        prof.stop()
        busy_us, by_kernel = device_time(prof)
        ours_us = sum(us for k, us in by_kernel.items() if any(p in k for p in PORT_KERNELS))
        idle = 1.0 - busy_us / 1e6 / host_s[2]
        got = [(k["quantize_int8"], k["dequantize_int8"], k["dequant_reduce"],
                k["topk_scatter_reduce"]) for k in counts]
        check(f"engine {mode} {name}: launches per round {want} "
              "(quantize, dequantize, dequant_reduce, topk_scatter_reduce), no fedavg_reduce",
              all(x == want for x in got) and all(k["fedavg_reduce"] == 0 for k in counts),
              launches=got)
        check(f"engine {mode} {name}: client loss falls over 3 rounds",
              all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], loss=losses)
        check(f"engine {mode} {name}: global params finite on cuda",
              bool(torch.isfinite(tree_flatten_to_vector(g)).all()) and tree_flatten_to_vector(g).is_cuda)
        print(f"engine {mode} {name}: host s per round {[round(x, 4) for x in host_s]}; "
              f"profiled round: card busy {busy_us / 1e3:.3f} ms (the port's kernels "
              f"{ours_us:.1f} us), idle {idle:.4f} of round 3 ({card})", flush=True)
        out[f"{mode}/{name}"] = {"host_s": host_s, "loss": losses, "launches": got,
                                 "device_busy_ms": busy_us / 1e3, "port_kernels_us": ours_us,
                                 "device_idle_share_vs_round3": idle}
    par, seq = first_round[("parallel", "NullCodec")], first_round[("sequential", "NullCodec")]
    check("engine: parallel Null = sequential Null after round 1 within the bf16 "
          "accumulator's atol=rtol=2e-3 (tests/test_fl_engine.py:94)",
          torch.allclose(par, seq, rtol=2e-3, atol=2e-3), max_abs_err=float((par - seq).abs().max()))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=Path("smoke_out"),
                        help="directory for the JSON report and the round trace")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _cuda

    card = card_line()
    print(f"card: {card}", flush=True)
    torch.manual_seed(0)
    rng = np.random.default_rng(0)

    t0 = time.perf_counter()
    built = _cuda.build()
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        print(f"built {name}.cu in {info['seconds']:.2f} s", flush=True)
        print(info["log"], file=sys.stderr)
    print(f"kernel build: {build_s:.2f} s wall ({len(built)} sources, parallel nvcc)", flush=True)
    REPORT["build_s"] = build_s

    args.out.mkdir(parents=True, exist_ok=True)
    rows = kernel_phase(rng)
    loop = main_path_phase()
    mixed = mixed_fleet_phase()
    reduced_parity_phase()
    reduced_parity_phase(MIXED_FLEET)
    REPORT["profile"] = profile_phase(card, args.out)
    REPORT["profile_mixed_fleet"] = profile_phase(card, args.out, MIXED_FLEET)
    REPORT["engine"] = round_engine_phase(card)
    for k, s in enumerate(loop["round_wall_s"], 1):
        print(f"round {k}: {s:.4f} s host wall ({card})", flush=True)
    for k, s in enumerate(mixed["round_wall_s"], 1):
        print(f"mixed fleet round {k}: {s:.4f} s host wall, eval acc "
              f"{mixed['eval_acc'][k - 1]:.4f} ({card})", flush=True)

    kernels = []
    for name in ("quantize_int8", "dequantize_int8", "dequant_reduce", "fedavg_reduce",
                 "topk_scatter_reduce"):
        r = rows[name]
        # each kernel's launches on the path that runs it: phase 3's loop,
        # and for the TopK reduce phase 3b's mixed fleet
        launches = (mixed if name == "topk_scatter_reduce" else loop)["launches"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
            "launches": launches, "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
        lib = "" if r["library_ms"] is None else f", library {r['library_ms'] * 1e3:.2f} us"
        print(f"{name}: {r['shape']}: kernel {r['ms'] * 1e3:.2f} us (bare launch "
              f"{r['launch_ms'] * 1e3:.2f} us), plain "
              f"{r['plain_ms'] * 1e3:.2f} us{lib}, bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bytes'] / 1e6:.2f} MB), launches {launches} ({card})",
              flush=True)
    for t in REPORT["timings"]:
        lib = "" if t["library_ms"] is None else f", library {t['library_ms'] * 1e3:.2f} us"
        print(f"{t['name']} [{t['case']}]: {t['shape']}: kernel {t['ms'] * 1e3:.2f} us (bare "
              f"launch {t['launch_ms'] * 1e3:.2f} us), plain "
              f"{t['plain_ms'] * 1e3:.2f} us{lib}, bound {t['bound_ms'] * 1e3:.2f} us ({card})",
              flush=True)

    REPORT.update(card=card, kernels=kernels, main_path=loop, mixed_fleet=mixed, rows=rows)
    (args.out / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1, default=str))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
