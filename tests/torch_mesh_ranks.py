"""Rank functions of the port's mesh tests (``test_torch_mesh.py``).

Each runs inside one rank that ``repro_torch.launch.run_local_mesh``
spawned, so this module imports neither JAX nor the JAX package: a rank
starts by importing only torch and ``repro_torch``.  Not collected by
pytest (no ``test_`` prefix).
"""
from __future__ import annotations

import time
from typing import ClassVar

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.core as T
from repro_torch.configs.base import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_flatten_to_vector, tree_leaves


def _np_rows(state):
    """A client-state pytree (leaves lead with 1) as a list of flat numpy
    leaves, in JAX leaf order."""
    return [x.detach().cpu().numpy().reshape(-1) for x in tree_leaves(state)]


class OpsLog:
    """Keeps what the round fed two ``ops`` entry points, and its
    all-reduces: per ``collective_pack_leaves`` call (one a round, over
    every model leaf), per leaf this rank's padded ``eff = wx + residual``
    (the plain version's ``ref.collective_eff`` of the call's leaf, weight,
    residual and live flag) and the shared scales of its blocks; per
    ``quantize_int8`` call (the Int8 uplink) the value it quantized and the
    block scales it chose; per ``dist.all_reduce`` whether it was a MAX and
    its dtype.  ``install`` wraps them in this rank's process."""

    coll: ClassVar[list] = []
    uplink: ClassVar[list] = []
    calls: ClassVar[list] = []

    @classmethod
    def install(cls):
        pack, quantize = ops.collective_pack_leaves, ops.quantize_int8

        def collective_pack_leaves(ds, wf, rs, absmax, live=None):
            q, scales, new_r = pack(ds, wf, rs, absmax, live)
            starts = ops.first_blocks(d.shape[0] for d in ds)
            for d, r, a, b in zip(ds, rs, starts, starts[1:]):
                eff = ref.collective_eff(d, wf, r, live, block=ops.BLOCK)
                cls.coll.append((eff.numpy().copy(), scales[a:b].numpy().copy()))
            return q, scales, new_r

        def quantize_int8(x, block=256):
            q, scale = quantize(x, block=block)
            cls.uplink.append((x.numpy().copy(), scale.numpy().copy()))
            return q, scale

        all_reduce = dist.all_reduce

        def counted_all_reduce(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
            cls.calls.append((op == dist.ReduceOp.MAX, tensor.dtype))
            return all_reduce(tensor, op=op, group=group, async_op=async_op)

        ops.collective_pack_leaves, ops.quantize_int8 = collective_pack_leaves, quantize_int8
        dist.all_reduce = counted_all_reduce

    @classmethod
    def clear(cls):
        cls.coll.clear()
        cls.uplink.clear()
        cls.calls.clear()

    @classmethod
    def all_reduces(cls):
        """The round's all-reduces: (MAX calls, SUM calls over int32, all)."""
        return (sum(m for m, _ in cls.calls),
                sum(not m and t == torch.int32 for m, t in cls.calls), len(cls.calls))


def layout(mesh):
    """This rank's coordinates and the ranks of its tier groups."""
    return {
        "rank": mesh.rank,
        "coords": mesh.coords,
        "groups": {a: dist.get_process_group_ranks(g) for a, g in mesh.groups.items()},
    }


def mesh_rounds(mesh, runs):
    """For each run ``(prefix, arch, cases, params_np, batches_np, weights,
    budgets, masks, steps)``: build the reduced ``arch`` from the JAX
    params ``params_np``, run every (collective, codec) case of ``cases``
    for ``len(masks)`` rounds on this rank's client and return, per case
    (keyed ``prefix + (collective, codec)``) and round, what the parity
    tests compare: the new global (flat), the metrics, this rank's codec and
    collective residual rows, and the kernel launches of the round.  Each
    case also runs its first round with ``mask=None`` and reports whether
    that equals the all-ones mask bitwise.  For the int8 collective each
    round also returns, per model leaf, the padded ``eff`` and the shared
    scales of this rank's ``CompressedPsum.psum_leaves``, and for the Int8
    uplink the value it quantized and its scales (``OpsLog``)."""
    OpsLog.install()
    torch.set_num_threads(1)  # four ranks share the host's cores
    out = {"layout": layout(mesh)}
    for prefix, arch, *run in runs:
        for case, rec in _arch_rounds(mesh, arch, *run):
            out[prefix + case] = rec
    return out


def _arch_rounds(mesh, arch, cases, params_np, batches_np, weights, budgets, masks, steps):
    """``mesh_rounds``' cases on one model: yields (case, its record)."""
    r = mesh.rank
    model = build_model(get_config(arch).reduced(), device="cpu")
    params0 = params_from_numpy(params_np, "cpu")
    n = sum(x.numel() for x in tree_leaves(params0))
    batches = {k: torch.from_numpy(v[r:r + 1].copy()) for k, v in batches_np.items()}
    w = torch.from_numpy(weights[r:r + 1].copy())
    bud = torch.from_numpy(budgets[r:r + 1].copy())
    for collective, codec_name in cases:
        codec = getattr(T, codec_name)()
        spec = T.RoundSpec(max_steps=steps, execution_mode="parallel", codec=codec,
                           collective=collective)
        step = T.make_round_step(model.loss_fn, sgd(0.1), T.FedAvg(), spec, mesh=mesh,
                                 client_axes=("pod", "data"))
        state = codec.init_client_state(1, n, device="cpu")
        if collective == "int8":
            state = (state, T.init_collective_residual(params0, 1))
        g, rounds = params0, []
        for rnd, m in enumerate(masks):
            mask = torch.from_numpy(m[r:r + 1].copy())
            ops.reset_launch_counts()
            OpsLog.clear()
            g_new, _, state_new, met = step(g, (), state, batches, w, bud, rnd, mask)
            launches, all_reduces = ops.launch_counts(), OpsLog.all_reduces()
            coll_log, uplink_log = list(OpsLog.coll), list(OpsLog.uplink)
            if rnd == 0:
                g_none, _, s_none, _ = step(g, (), state, batches, w, bud, rnd, None)
                none_same = all(
                    torch.equal(a, b) for a, b in zip(
                        tree_leaves((g_new, state_new)), tree_leaves((g_none, s_none)),
                        strict=True)
                )
            codec_state, coll = state_new if collective == "int8" else (state_new, ())
            rounds.append({
                "params": tree_flatten_to_vector(g_new).numpy(),
                "metrics": {k: float(v) for k, v in met.items()},
                "codec_row": _np_rows(codec_state),
                "coll_row": _np_rows(coll),
                "launches": launches,
                "all_reduces": all_reduces,
                "coll_log": coll_log,
                "uplink_log": uplink_log,
            })
            g, state = g_new, state_new
        yield (collective, codec_name), {"rounds": rounds, "mask_none_same": none_same}


def fail_on_rank_one(mesh):
    """A rank that raises, for the launcher's error path."""
    if mesh.rank == 1:
        raise ValueError("rank one fails on purpose")
    return mesh.rank


def hang_on_rank_one(mesh):
    """A rank that outlives the launcher's timeout."""
    if mesh.rank == 1:
        time.sleep(600)
    return mesh.rank
