"""The FL round step without a mesh: the twin of ``repro.core.rounds``.

One ``round_step`` = every sampled client runs (up to) ``max_steps`` local
SGD steps from the current global model, then the Strategy aggregates.
Both execution modes share one contract::

    round_step(global_params, server_state, client_state, batches, weights,
               step_budgets, rnd, mask=None)
        -> (new_global, new_server_state, new_client_state, metrics)

- ``batches``: a pytree whose leaves lead with (C, max_steps, B, ...);
  ``weights`` (C,) aggregation weights; ``step_budgets`` (C,) int, the
  paper's tau cutoff as a per-client step budget (a client steps while
  ``i < budget`` and freezes its params and optimizer state after).
- ``client_state``: codec-owned (``codec.init_client_state``): one
  (C, N) fp32 residual block for Int8/TopK, ``()`` for Null; a tuple with
  one entry a segment for a segmented codec, and one entry a bank codec
  for a ``MixedCodec``.
- ``mask``: the scheduler's (C,) 0/1 participation mask.  A masked client
  still runs its local work but contributes zero weight under the one
  ``safe_weight_sum`` denominator, its delta is pinned to zero before the
  reduce (0 * NaN from a diverged client would poison it), its residual
  row carries unchanged, and its loss and steps leave the metrics.
  ``mask=None`` is bitwise an all-ones mask.

Modes:

- **parallel**: ``torch.func.vmap`` of the client update over the client
  axis, then ``codec.aggregate_updates``: a leafwise weighted mean for
  Null, and for Int8 / TopK the (C, N) deltas encoded once and reduced
  straight off the encoded payload (one ``quantize_int8`` +
  ``dequantize_int8`` + ``dequant_reduce``, or one ``topk_scatter_reduce``).
- **sequential**: one client at a time; each client's delta goes through
  ``codec.transmit_tree`` (encode -> decode) into a bf16 accumulator.  A
  ``MixedCodec`` runs one loop a group, in bank order, through the group's
  codec, with one accumulator across the groups.

Both modes take a ``MixedCodec`` (each group on its codec's own kernels,
one fleet-wide denominator) and segmented codecs (per-segment rows and
kernels, core/compression.py).

- **parallel + mesh** (``mesh=`` a ``launch.mesh.ClientMesh``): one
  client per rank, as shard_map's ``per_client`` sees it.  Every rank calls
  ``round_step`` with its own block: batches, weights, budgets and mask
  with a leading axis of 1, and its own ``client_state`` row.  It trains
  locally, sends its delta through ``codec.transmit_tree`` and
  all-reduces the partial weighted sum ``decoded_delta * w`` over the
  client axes' process groups, inner tier first; the weight denominator is
  all-reduced alongside.  ``RoundSpec.collective`` is that all-reduce's
  wire: ``"fp32"`` as is, ``"int8"`` through ``CompressedPsum`` (codes on
  a block scale shared by every rank, summed exactly in int32, one
  dequant after the last hop), with ``client_state = (codec_state,
  collective_residual)`` (``init_collective_residual``).  A masked rank
  transmits nothing, not even its carried collective residual, and keeps
  both residual rows unchanged.  ``strategy.server_update`` runs on every
  rank, and the metrics, computed from the per-client scalars gathered
  over the world group, are the same on every rank.

**The scanned trainer** (``make_multi_round_step``): R rounds as one
program, each round's dispatch mask (availability, on-device cohort
sampling), the policy's tensor verdict (``RoundPolicy.plan_arrays``) and
``round_step`` with that mask, over precomputed (R, C) schedule matrices.
Where the JAX package compiles one ``lax.scan``, the port captures the
whole run, unrolled, as one ``torch.cuda.CUDAGraph`` on the card and
replays it; on the CPU it runs the same body eagerly.  Unrolled, every
round is captured with its own Python ``rnd``, so what a strategy or an
optimizer computes from it on the host (FedAdam's bias corrections, a
``Schedule``'s learning rate) is baked in per round, bitwise the eager
run's.

Not ported yet (ROADMAP.md): model axes inside a client (auto-sharded
params), ``execution_mode="fsdp"``, the sequential mode on a mesh, the
param-dim sharding of client state and the scanned trainer on a mesh
(queue 1 item 13).  The mesh refuses a ``MixedCodec``, as the JAX
package's does: one SPMD program runs one wire format on every rank.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.kernels import _cuda
from repro_torch.optim import Optimizer
from repro_torch.utils.pytree import (
    safe_weight_sum, tree_leaves, tree_map, tree_sq_norm, tree_sub, tree_unflatten,
    tree_where,
)

from .compression import CompressedPsum, MixedCodec, NullCodec, _rows_on
from .strategy.base import Strategy

PyTree = Any


@dataclass(frozen=True)
class RoundSpec:
    """Static configuration of the round step."""

    max_steps: int               # local steps (tau masks within)
    execution_mode: str          # "parallel" | "sequential" ("fsdp": item 13)
    prox_mu: float = 0.0         # FedProx proximal coefficient (0 = off)
    microbatches: int = 1        # gradient accumulation within one local step
    codec: Any = field(default_factory=NullCodec)  # UpdateCodec (wire format)
    # the mesh all-reduce's wire: "fp32" (default) or "int8" (CompressedPsum)
    collective: str = "fp32"


def make_client_update(
    loss_fn: Callable,           # (params, batch) -> (loss, metrics)
    opt: Optimizer,
    spec: RoundSpec,
    trainable_mask: PyTree | None = None,
):
    """Returns client_update(global_params, batches, step_budget) ->
    (new_params, mean_loss, steps_done) for ONE client; ``batches`` leaves
    lead with (max_steps, ...).  Pure tensor code, so ``torch.func.vmap``
    maps it over clients."""

    def total_loss(params, batch, global_params):
        loss, metrics = loss_fn(params, batch)
        if spec.prox_mu > 0.0:
            loss = loss + 0.5 * spec.prox_mu * tree_sq_norm(tree_sub(params, global_params))
        return loss, metrics

    grad_fn = torch.func.grad_and_value(total_loss, has_aux=True)

    def grad_of(params, batch, global_params):
        if spec.microbatches <= 1:
            grads, (loss, _) = grad_fn(params, batch, global_params)
            return loss, grads
        # gradient accumulation over microbatch slices of the batch dim, in
        # bf16 accumulators (the JAX engine's memory trade)
        mb = spec.microbatches
        micro = tree_map(lambda x: x.reshape(mb, x.shape[0] // mb, *x.shape[1:]), batch)
        loss_sum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device), params)
        for m in range(mb):
            grads, (loss, _) = grad_fn(params, tree_map(lambda x: x[m], micro), global_params)
            gacc = tree_map(lambda a, g: a + g.to(a.dtype), gacc, grads)
            loss_sum = loss_sum + loss
        return loss_sum / mb, tree_map(lambda g: (g / mb).to(torch.bfloat16), gacc)

    def client_update(global_params, batches, step_budget):
        params = global_params
        opt_state = opt.init(global_params)
        losses = []
        for i in range(spec.max_steps):
            batch = tree_map(lambda x: x[i], batches)
            loss, grads = grad_of(params, batch, global_params)
            new_params, new_opt_state = opt.update(grads, params, opt_state, i)
            if trainable_mask is not None:
                new_params = tree_map(
                    lambda n, o, m: n if m else o, new_params, params, trainable_mask
                )
            live = i < step_budget
            params = tree_where(live, new_params, params)
            opt_state = tree_where(live, new_opt_state, opt_state)
            losses.append(torch.where(live, loss, torch.zeros_like(loss)))
        steps_done = torch.clamp(step_budget, max=spec.max_steps)
        mean_loss = torch.stack(losses).sum() / torch.clamp(steps_done, min=1)
        return params, mean_loss, steps_done

    return client_update


def init_collective_residual(global_params: PyTree, n_clients: int) -> PyTree:
    """Zero error-feedback state of the int8 collective: one fp32 buffer
    per model leaf with a leading client axis, on the params' device.  On
    the mesh each rank holds its own row (``n_clients=1``), and
    ``round_step`` takes ``client_state = (codec_state, this)``."""
    return tree_map(
        lambda g: torch.zeros((n_clients,) + tuple(g.shape), dtype=torch.float32,
                              device=g.device),
        global_params,
    )


def _state_metrics(new_client_state) -> dict:
    """Residual-norm telemetry when the codec carries per-client state: the
    mean over every residual row of every leaf, so a segmented or mixed
    codec's tuple state counts all its rows (stateless entries none)."""
    rows = [
        torch.linalg.vector_norm(leaf.reshape(leaf.shape[0], -1), dim=-1)
        for leaf in tree_leaves(new_client_state)
        if leaf.dim() >= 2 and leaf.shape[0] > 0
    ]
    if not rows:
        return {}
    return {"residual_norm_mean": torch.mean(torch.cat(rows))}


def _carry_masked_state(codec, mask, old_state, new_state):
    """Masked (non-participating) clients' codec state rows carry
    unchanged: a dropped client never transmitted, so its residual must not
    absorb this round's untransmitted delta.  A ``MixedCodec``'s per-group
    state takes the fleet mask sliced by each group's rows."""

    def keep_rows(m):
        def leaf(o, n):
            return torch.where(m.reshape((-1,) + (1,) * (n.dim() - 1)) > 0, n, o)

        return leaf

    if isinstance(codec, MixedCodec):
        out = list(new_state)
        for g, _, idx in codec.groups():
            if tree_leaves(new_state[g]):  # a stateless group has nothing to carry
                out[g] = tree_map(keep_rows(mask[_rows_on(idx, mask.device)]),
                                  old_state[g], new_state[g])
        return tuple(out)
    if not tree_leaves(new_state):
        return new_state
    return tree_map(keep_rows(mask), old_state, new_state)


def _masked_metrics(losses, steps, weights, mask):
    """Participation-aware loss/steps metrics.  ``torch.where``, not a
    product, so a masked client's NaN/inf loss cannot poison them."""
    wf = weights.to(torch.float32)
    if mask is None:
        return {
            "client_loss_mean": torch.sum(losses * wf) / safe_weight_sum(wf),
            "client_loss_max": torch.max(losses),
            "steps_total": torch.sum(steps),
        }
    mf = mask.to(torch.float32)
    w_eff = wf * mf
    live = mf > 0
    losses_eff = torch.where(live, losses, torch.zeros_like(losses))
    any_live = torch.any(live)
    nan = torch.full_like(losses[0], float("nan"))
    return {
        # a fully-masked round has no defined loss: NaN, never 0.0 or -inf
        "client_loss_mean": torch.where(
            any_live, torch.sum(losses_eff * w_eff) / safe_weight_sum(w_eff), nan
        ),
        "client_loss_max": torch.where(
            any_live, torch.max(torch.where(live, losses, torch.full_like(losses, -torch.inf))), nan
        ),
        "steps_total": torch.sum(torch.where(live, steps, torch.zeros_like(steps))),
    }


def make_round_step(
    loss_fn: Callable,
    opt: Optimizer,
    strategy: Strategy,
    spec: RoundSpec,
    trainable_mask: PyTree | None = None,
    mesh=None,
    client_axes: tuple[str, ...] = ("data",),
):
    """Builds the uniform round_step (module docstring) for ``spec``;
    ``mesh`` (a ``launch.mesh.ClientMesh``) maps one client to each rank
    along ``client_axes``.

    Aggregation is codec-mediated on both modes: the weighted mean of the
    codec-decoded deltas feeds ``strategy.server_update``."""
    codec = spec.codec if spec.codec is not None else NullCodec()
    if spec.collective not in ("fp32", "int8"):
        raise ValueError(f"RoundSpec.collective={spec.collective!r}: expected fp32 | int8")
    if spec.collective == "int8" and (mesh is None or spec.execution_mode != "parallel"):
        raise NotImplementedError(
            "collective='int8' compresses the mesh all-reduce: it requires "
            "execution_mode='parallel' with a mesh; the vmap and sequential modes "
            "have no cross-rank collective to compress"
        )
    if spec.execution_mode == "fsdp" or (mesh is not None and spec.execution_mode != "parallel"):
        raise NotImplementedError(
            f"execution_mode={spec.execution_mode!r} with mesh={mesh!r} is not ported "
            "yet: ROADMAP.md queue 1 item 13 (fsdp and the sequential mode on a mesh)"
        )
    if spec.execution_mode not in ("parallel", "sequential"):
        raise ValueError(
            f"RoundSpec.execution_mode={spec.execution_mode!r}: expected parallel | sequential"
        )
    client_update = make_client_update(loss_fn, opt, spec, trainable_mask)

    if mesh is not None:
        if isinstance(codec, MixedCodec):
            raise NotImplementedError(
                "MixedCodec is not supported on the mesh shard_map path: an "
                "SPMD program runs ONE wire format per device; use the "
                "vmap-parallel or sequential execution mode for mixed fleets"
            )
        return _make_mesh_round_step(client_update, codec, strategy, spec, mesh, client_axes)

    if spec.execution_mode == "parallel":

        def round_step(global_params, server_state, client_state, batches, weights,
                       step_budgets, rnd, mask=None):
            new_params, losses, steps = torch.func.vmap(
                client_update, in_dims=(None, 0, 0)
            )(global_params, batches, step_budgets)
            if mask is not None:
                # a masked client's params are pinned back to the global
                # BEFORE the reduce: zero weight alone would let a diverged
                # client's 0 * NaN poison it
                new_params = tree_map(
                    lambda p, g: torch.where(mask.reshape((-1,) + (1,) * g.dim()) > 0, p, g[None]),
                    new_params, global_params,
                )
            w_agg = weights if mask is None else weights.to(torch.float32) * mask.to(torch.float32)
            avg_params, new_client_state = codec.aggregate_updates(
                new_params, global_params, w_agg, client_state
            )
            if mask is not None:
                new_client_state = _carry_masked_state(codec, mask, client_state,
                                                       new_client_state)
            new_global, new_state = strategy.server_update(
                avg_params, global_params, server_state, rnd
            )
            metrics = {
                **_masked_metrics(losses, steps, weights, mask),
                **_state_metrics(new_client_state),
            }
            return new_global, new_state, new_client_state, metrics

        return round_step

    def round_step(global_params, server_state, client_state, batches, weights,
                   step_budgets, rnd, mask=None):
        wf = weights.to(torch.float32)
        mf = None if mask is None else mask.to(torch.float32)
        wsum = safe_weight_sum(wf if mf is None else wf * mf)
        dev = wf.device
        # bf16 delta accumulator: halves the largest param-state buffer; the
        # one-round accumulation error is far below local-SGD noise
        delta_acc = tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.bfloat16, device=g.device), global_params
        )
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        loss_max = torch.full((), -torch.inf, dtype=torch.float32, device=dev)
        steps_acc = torch.zeros((), dtype=step_budgets.dtype, device=dev)
        # (codec, this state, its clients): a MixedCodec loops once a group,
        # in bank order, with the accumulators carried across the groups
        if isinstance(codec, MixedCodec):
            passes = [(codec_g, client_state[g], idx) for g, codec_g, idx in codec.groups()]
        else:
            passes = [(codec, client_state, range(wf.shape[0]))]
        new_states = []
        for codec_g, state_g, idx in passes:
            rows = []
            for j, c in enumerate(idx):
                w = wf[c]
                state_row = tree_map(lambda x: x[j], state_g)
                new_params, loss, steps = client_update(
                    global_params, tree_map(lambda x: x[c], batches), step_budgets[c]
                )
                delta = tree_sub(new_params, global_params)
                # codec round-trip: only what survives the wire is accumulated
                dec_delta, new_row = codec_g.transmit_tree(delta, state_row)
                if mf is not None:
                    # masked: zero weight AND a zeroed delta, the residual row
                    # carried unchanged, out of the metrics
                    live = mf[c] > 0
                    w = w * mf[c]
                    dec_delta = tree_map(lambda d: torch.where(live, d, torch.zeros_like(d)),
                                         dec_delta)
                    new_row = tree_map(lambda n, o: torch.where(live, n, o), new_row, state_row)
                    loss = torch.where(live, loss, torch.zeros_like(loss))
                    loss_for_max = torch.where(live, loss, torch.full_like(loss, -torch.inf))
                    steps = torch.where(live, steps, torch.zeros_like(steps))
                else:
                    loss_for_max = loss
                scale = (w / wsum).to(torch.bfloat16)
                delta_acc = tree_map(
                    lambda acc, d: acc + scale * d.to(torch.bfloat16), delta_acc, dec_delta
                )
                loss_acc = loss_acc + loss * w / wsum
                loss_max = torch.maximum(loss_max, loss_for_max)
                steps_acc = steps_acc + steps
                rows.append(new_row)
            if tree_leaves(state_g):
                new_states.append(tree_map(lambda *xs: torch.stack(xs), rows[0], *rows[1:]))
            else:
                new_states.append(state_g)
        if isinstance(codec, MixedCodec):
            new_client_state = list(client_state)
            for (g, _, _), st in zip(codec.groups(), new_states):
                new_client_state[g] = st
            new_client_state = tuple(new_client_state)
        else:
            new_client_state = new_states[0]
        if mf is not None:
            any_live = torch.any(mf > 0)
            nan = torch.full_like(loss_acc, float("nan"))
            loss_acc = torch.where(any_live, loss_acc, nan)
            loss_max = torch.where(any_live, loss_max, nan)
        avg_params = tree_map(
            lambda g, d: (g.to(torch.float32) + d.to(torch.float32)).to(g.dtype),
            global_params, delta_acc,
        )
        new_global, new_state = strategy.server_update(
            avg_params, global_params, server_state, rnd
        )
        metrics = {
            "client_loss_mean": loss_acc,
            "client_loss_max": loss_max,
            "steps_total": steps_acc,
            **_state_metrics(new_client_state),
        }
        return new_global, new_state, new_client_state, metrics

    return round_step


def _gather_rows(row: torch.Tensor) -> torch.Tensor:
    """(k,) fp32 on every rank -> (world, k), row r from rank r (= client
    r).  Built from one SUM all-reduce of a zero block holding this rank's
    row, since gloo's CUDA path has no all_gather; adding zeros is exact."""
    out = torch.zeros((dist.get_world_size(),) + tuple(row.shape), dtype=row.dtype,
                      device=row.device)
    out[dist.get_rank()] = row
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def _row_norms(state_rows) -> torch.Tensor:
    """This rank's residual norm per state leaf (leaves lead with 1)."""
    leaves = [x for x in tree_leaves(state_rows) if x.dim() >= 2]
    if not leaves:
        return torch.zeros(0)
    return torch.stack([torch.linalg.vector_norm(x.reshape(-1)) for x in leaves])


def _make_mesh_round_step(client_update, codec, strategy, spec, mesh, client_axes):
    """The parallel + mesh round step (module docstring): one client per
    rank, the weighted delta all-reduced over the client axes."""
    client_axes = tuple(client_axes)
    groups = mesh.tier_groups(client_axes)
    inside = [name for name, size in mesh.axes if name not in client_axes and size > 1]
    if inside:
        raise NotImplementedError(
            f"mesh axes {inside} inside a client (auto-sharded params) are not ported "
            "yet: ROADMAP.md queue 1 item 13"
        )
    cpsum = CompressedPsum() if spec.collective == "int8" else None

    def all_reduce_tiers(t):
        # hierarchical: inside the pod first, then across pods
        for group in reversed(groups):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def round_step(global_params, server_state, client_state, batches, weights,
                   step_budgets, rnd, mask=None):
        if weights.shape[0] != 1:
            raise ValueError(
                f"a mesh rank holds one client (leading axis 1), got {weights.shape[0]}"
            )
        codec_state, coll_resid = client_state if cpsum is not None else (client_state, None)
        new_p, loss, steps = client_update(
            global_params, tree_map(lambda x: x[0], batches), step_budgets[0]
        )
        # this client's uplink, encoded before anything crosses the mesh
        delta = tree_map(lambda n, g: n.to(torch.float32) - g.to(torch.float32),
                         new_p, global_params)
        state_row = tree_map(lambda x: x[0], codec_state)
        dec_delta, new_row = codec.transmit_tree(delta, state_row)
        live = None if mask is None else mask[0] > 0
        wf = weights[:1].to(torch.float32)
        if live is not None:
            # a dropped client never transmitted: its row carries unchanged,
            # and its delta is zeroed BEFORE the all-reduce (zero weight
            # alone would let a diverged client's 0 * NaN poison the sum;
            # the int8 collective's kernels send zeros for it themselves)
            new_row = tree_map(lambda n, o: torch.where(live, n, o), new_row, state_row)
            if cpsum is None:
                dec_delta = tree_map(lambda d: torch.where(live, d, torch.zeros_like(d)),
                                     dec_delta)
            wf = wf * mask[:1].to(torch.float32)
        wsum = all_reduce_tiers(wf.clone())
        wsum = torch.where(wsum == 0.0, torch.ones_like(wsum), wsum)  # safe_weight_sum
        codec_rows = tree_map(lambda x: x[None], new_row)

        if cpsum is None:
            def leaf_avg(g, d):
                wx = all_reduce_tiers(d.to(torch.float32) * wf)
                return (g.to(torch.float32) + wx / wsum).to(g.dtype)

            avg = tree_map(leaf_avg, global_params, dec_delta)
            coll_rows, new_client_state = (), codec_rows
        else:
            # the int8 collective over every leaf at once; a dropped rank
            # sends nothing, not even its carried residual, and keeps its
            # residual rows
            resid_row = tree_map(lambda x: x[0], coll_resid)
            leaves_d, leaves_r = tree_leaves(dec_delta), tree_leaves(resid_row)
            totals, new_rs = cpsum.psum_leaves(
                [d.to(torch.float32).reshape(-1) for d in leaves_d], wf,
                [r.reshape(-1) for r in leaves_r], groups, live,
            )
            sums = tree_unflatten(dec_delta, [t.view(d.shape) for t, d in zip(totals, leaves_d)])
            avg = tree_map(lambda g, t: (g.to(torch.float32) + t / wsum).to(g.dtype),
                           global_params, sums)
            coll_rows = tree_unflatten(
                resid_row, [r.view(d.shape)[None] for r, d in zip(new_rs, leaves_r)]
            )
            new_client_state = (codec_rows, coll_rows)
        new_global, new_state = strategy.server_update(avg, global_params, server_state, rnd)

        # the per-client scalars of every rank, for metrics that are the
        # same on every rank and equal to the unsharded round step's
        codec_norms, coll_norms = _row_norms(codec_rows), _row_norms(coll_rows)
        dev = wf.device
        scalars = [loss.to(torch.float32).reshape(1), steps.to(torch.float32).reshape(1),
                   weights[:1].to(torch.float32)]
        if mask is not None:
            scalars.append(mask[:1].to(torch.float32))
        rows = _gather_rows(torch.cat(scalars + [codec_norms.to(dev), coll_norms.to(dev)]))
        losses, steps_all, weights_all = rows[:, 0], rows[:, 1], rows[:, 2]
        k = 3 if mask is None else 4
        metrics = _masked_metrics(
            losses, steps_all.to(step_budgets.dtype), weights_all,
            None if mask is None else rows[:, 3],
        )
        n_codec = codec_norms.shape[0]
        if n_codec:
            # leaf-major, as the unsharded step concatenates its rows
            metrics["residual_norm_mean"] = torch.mean(rows[:, k:k + n_codec].T.reshape(-1))
        if coll_norms.shape[0]:
            metrics["collective_residual_norm_mean"] = torch.mean(
                rows[:, k + n_codec:].T.reshape(-1)
            )
        return new_global, new_state, new_client_state, metrics

    return round_step


def cohort_dispatch_mask(priorities, avail_mask, cohort_size: int):
    """On-device cohort sampling: the ``cohort_size`` available clients
    with the LOWEST priorities win (uniform priorities == a uniform draw
    without replacement).

    Tensor code with no host sync, so it runs alike inside the captured
    graph and in the per-round driver.  Unavailable clients rank at +inf,
    so a round with fewer than ``cohort_size`` available clients
    dispatches only whoever is up (including nobody).  The double stable
    argsort turns priorities into dense ranks; exactly equal priorities
    break by client id.
    """
    pri = torch.where(avail_mask > 0, priorities, torch.inf)
    order = torch.argsort(pri, stable=True)
    ranks = torch.argsort(order, stable=True)
    return torch.where((ranks < cohort_size) & (avail_mask > 0), 1.0, 0.0)


def make_scheduled_round(round_step: Callable, policy, tau: float | None,
                         cohort_size: int | None) -> Callable:
    """One round of the scanned trainer, shared by the graph and by
    ``Server.run_scanned(reference=True)`` so both run the same ops::

        scheduled_round(g, ss, cs, batch, weights, step_budgets, rnd,
                        avail_r, t_r, pri_r) -> (g, ss, cs, outputs)

    ``outputs`` holds the round's metrics plus ``participation_mask``,
    ``dispatch_mask``, ``round_wall_s``, ``participants`` and
    ``dispatched``."""

    def scheduled_round(g, ss, cs, batch, weights, step_budgets, rnd, avail_r, t_r, pri_r):
        if cohort_size is None:
            dispatch = avail_r
        else:
            dispatch = cohort_dispatch_mask(pri_r, avail_r, cohort_size)
        mask, round_end = policy.plan_arrays(dispatch, t_r, tau=tau)
        g, ss, cs, met = round_step(g, ss, cs, batch, weights, step_budgets, rnd, mask)
        return g, ss, cs, {
            **met,
            "participation_mask": mask,
            "dispatch_mask": dispatch,
            "round_wall_s": round_end,
            "participants": torch.sum(torch.where(mask > 0, 1.0, 0.0)),
            "dispatched": torch.sum(torch.where(dispatch > 0, 1.0, 0.0)),
        }

    return scheduled_round


@dataclass
class _Captured:
    graph: Any            # torch.cuda.CUDAGraph of the whole run
    inputs: list          # the graph's own input buffers, in tree_leaves order
    outputs: tuple        # (g, ss, cs, stacked), written by every replay


class MultiRoundStep:
    """The multi-round trainer ``make_multi_round_step`` returns (its
    docstring has the contract).

    Routes by the params' device alone: on a CPU it runs the R rounds
    eagerly; on a CUDA card it captures them, unrolled, as one
    ``torch.cuda.CUDAGraph`` at the first call with a given input
    signature (shapes, dtypes, device) and replays it at every call.  A
    capture copies the inputs into the graph's own buffers first, so the
    caller's tensors stay valid; before it, one eager round runs on copies,
    on a side stream, with its results discarded, so the kernels' build
    and first-call queries and cuBLAS' setup stay out of the graph.  A
    failed capture raises: nothing runs the rounds eagerly instead.

    ``captures`` counts the captures; ``last_capture`` describes the
    latest: its ``seconds``, the private memory ``pool_bytes`` it took,
    the kernel launches of its warm-up round and of the capture itself
    (``warmup_launches``, ``capture_launches``: a replay counts none) and
    the ``graph``, whose ``cudaGraph_t`` is kept (``raw_cuda_graph``).
    """

    def __init__(self, scheduled_round: Callable, num_rounds: int, stacked_batches: bool):
        self._round = scheduled_round
        self.num_rounds = num_rounds
        self.stacked_batches = stacked_batches
        self.captures = 0
        self.last_capture: dict | None = None
        self._graphs: dict[tuple, _Captured] = {}

    def __call__(self, global_params, server_state, client_state, batches, weights,
                 step_budgets, avail, t_total, priorities):
        inputs = (global_params, server_state, client_state, batches, weights,
                  step_budgets, avail, t_total, priorities)
        dev = tree_leaves(global_params)[0].device
        if dev.type == "cpu":
            return self._rounds(*inputs)
        if dev.type != "cuda":
            raise ValueError(f"make_multi_round_step runs on a CUDA card or the CPU, not {dev}")
        leaves = tree_leaves(inputs)
        key = tuple((tuple(x.shape), x.dtype, x.device) for x in leaves)
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(inputs, dev)
        else:
            for dst, src in zip(cap.inputs, leaves):
                dst.copy_(src)
        cap.graph.replay()
        # the graph's outputs are rewritten by its next replay
        return tree_map(torch.clone, cap.outputs)

    def _rounds(self, g, ss, cs, batches, weights, step_budgets, avail, t_total, priorities,
                n_rounds: int | None = None):
        outs = []
        for i in range(self.num_rounds if n_rounds is None else n_rounds):
            batch = tree_map(lambda x: x[i], batches) if self.stacked_batches else batches
            g, ss, cs, out = self._round(g, ss, cs, batch, weights, step_budgets, i + 1,
                                         avail[i], t_total[i], priorities[i])
            outs.append(out)
        stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return g, ss, cs, stacked

    def _capture(self, inputs, dev) -> _Captured:
        static = tree_map(torch.clone, inputs)
        before = dict(_cuda.LAUNCHES)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._rounds(*tree_map(torch.clone, static), n_rounds=1)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        warm = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = dict(_cuda.LAUNCHES)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.device(dev), torch.cuda.graph(graph):
            outputs = self._rounds(*static)
        graph.instantiate()
        torch.cuda.synchronize(dev)
        self.captures += 1
        self.last_capture = {
            "seconds": time.perf_counter() - t0,
            "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
            "warmup_launches": warm,
            "capture_launches": {k: v - before[k] for k, v in _cuda.LAUNCHES.items()},
            "graph": graph,
        }
        return _Captured(graph, tree_leaves(static), outputs)


def make_multi_round_step(
    loss_fn: Callable,
    opt: Optimizer,
    strategy: Strategy,
    spec: RoundSpec,
    num_rounds: int,
    *,
    policy=None,
    tau: float | None = None,
    cohort_size: int | None = None,
    trainable_mask: PyTree | None = None,
    mesh=None,
    client_axes: tuple[str, ...] = ("data",),
    param_shardings: PyTree | None = None,
    stacked_batches: bool = True,
) -> MultiRoundStep:
    """``num_rounds`` FL rounds as one program over the uniform
    ``round_step`` (module docstring: "the scanned trainer").

    Returns a ``MultiRoundStep``::

        multi_round_step(global_params, server_state, client_state,
                         batches, weights, step_budgets,
                         avail, t_total, priorities)
            -> (new_global, new_server_state, new_client_state, stacked)

    where ``avail`` / ``t_total`` / ``priorities`` are the precomputed
    (R, C) schedule matrices (``AvailabilityTrace.available_matrix``,
    ``CostModel.fleet_time_matrix`` as float32,
    ``cohort_priority_matrix``) on the params' device, and ``stacked`` is
    a dict of (R,)- and (R, C)-shaped per-round outputs (the round_step
    metrics plus ``participation_mask``, ``dispatch_mask``,
    ``round_wall_s``, ``participants``, ``dispatched``), decoded to a
    ``History`` once, after the run.

    ``batches``: leaves lead with (R, C, max_steps, ...) when
    ``stacked_batches`` (each round gets its own slice) or (C, max_steps,
    ...) when not: the same batch every round, so device memory stays
    flat in R.

    Scheduling is the ``policy``'s tensor verdict (``plan_arrays``): each
    round computes a dispatch mask (availability, and the on-device cohort
    when ``cohort_size`` is set), asks the policy who reports and how long
    the round ran, and feeds the reporter mask to ``round_step``.  ``tau``
    is a host float resolved beforehand (``Deadline.resolve_tau``); only
    ``traceable`` policies are taken (``SyncAll``, ``Deadline``:
    ``BufferedAsync`` carries a cross-round pending set).
    """
    from .scheduler import SyncAll

    if mesh is not None or param_shardings is not None:
        raise NotImplementedError(
            "make_multi_round_step on a mesh is not ported yet: ROADMAP.md queue 1 "
            "item 13 (a captured round needs collectives that stream capture takes, "
            "and gloo's are not)"
        )
    round_step = make_round_step(loss_fn, opt, strategy, spec, trainable_mask)
    policy = SyncAll() if policy is None else policy
    if not getattr(policy, "traceable", False):
        raise NotImplementedError(
            f"{type(policy).__name__} cannot run in the multi-round trainer: its "
            "verdict depends on cross-round pending-arrival state (see "
            "core/scheduler.py); use Server.run, or a traceable policy "
            "(SyncAll, Deadline)"
        )
    return MultiRoundStep(make_scheduled_round(round_step, policy, tau, cohort_size),
                          int(num_rounds), stacked_batches)
