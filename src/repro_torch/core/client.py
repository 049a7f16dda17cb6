"""FL clients — the paper's §4 on-device trainers, in PyTorch.

``Client`` mirrors the Flower client surface the paper describes (§4.1):
``get_weights`` / ``fit`` / ``evaluate`` / ``properties``.  ``TorchClient``
is the twin of ``repro.core.client.JaxClient``: it owns a local dataset
shard and a device profile and runs local SGD with ``torch.autograd``.  It
honors the server's config knobs ``epochs``, the cutoff step budget
``max_steps`` (tau), ``deadline_s``, FedProx's ``mu`` and the uplink
``codec``.  With a codec it ships a ``CompressedParameters`` delta payload
and carries its error-feedback residual across rounds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.data.federated import ClientDataset
from repro_torch.optim import Optimizer, sgd
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (
    tree_bytes, tree_leaves, tree_map, tree_size, tree_sq_norm, tree_sub, tree_unflatten,
)

from .compression import compress_update
from .cost_model import PROFILES
from .protocol import (
    ClientProperties, EvaluateIns, EvaluateRes, FitIns, FitRes,
    compress_to_wire,
)

PyTree = Any


class Client:
    """Protocol-level client interface (paper §4.1)."""

    def get_weights(self, config: dict) -> PyTree:
        raise NotImplementedError

    def fit(self, ins: FitIns) -> FitRes:
        raise NotImplementedError

    def evaluate(self, ins: EvaluateIns) -> EvaluateRes:
        raise NotImplementedError

    def properties(self) -> ClientProperties:
        """Device/network facts the server's codec + tau policies consume."""
        return ClientProperties(client_id=-1)

    def reset_state(self) -> None:
        """Drop per-trajectory carry (e.g. error-feedback residuals).

        The Server calls this at the start of every ``run`` so reused client
        objects do not leak one experiment's compression state into the
        next."""

    def discard_update(self) -> None:
        """The scheduler discarded this client's last ``fit`` (deadline
        drop / staleness expiry): roll back any state that assumed the
        update was delivered, leaving the residual exactly as it entered
        the round."""

    def export_state(self):
        """Round-to-round carry as one flat fp32 row (for a segmented codec,
        a tuple of per-segment rows, ``()`` for a stateless segment), or
        None if there is none — what ``LazyClientPool`` spills into a
        ``CohortState`` when it evicts this client (core/population.py's
        eviction contract)."""
        return None

    def import_state(self, state) -> None:
        """Rehydrate a previously ``export_state``-ed row on a freshly
        materialized client."""


@dataclass
class TorchClient(Client):
    client_id: int
    loss_fn: Callable                    # (params, batch) -> (loss, metrics)
    dataset: ClientDataset
    batch_size: int = 32
    optimizer: Optimizer | None = None
    trainable_mask: PyTree | None = None
    device_profile: str = "generic"
    device: Any = None                   # None -> the CUDA card
    _params: PyTree = None
    _residual: Any = field(default=None, repr=False)  # error-feedback carry
    # pre-fit residual, kept until the scheduler's verdict: discard_update
    # rolls back to it when the arrival is dropped/expired
    _residual_prev: Any = field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.optimizer is None:
            self.optimizer = sgd(0.05)

    def get_weights(self, config: dict) -> PyTree:
        return self._params

    def properties(self) -> ClientProperties:
        prof = PROFILES.get(self.device_profile)
        return ClientProperties(
            client_id=self.client_id,
            device_profile=self.device_profile,
            uplink_mbps=prof.uplink_mbps if prof else 20.0,
            downlink_mbps=prof.downlink_mbps if prof else 50.0,
        )

    def reset_state(self) -> None:
        self._residual = None
        self._residual_prev = None

    def discard_update(self) -> None:
        self._residual = self._residual_prev

    def export_state(self):
        # the residual itself: CohortState.put_row copies it to the host
        return self._residual

    def import_state(self, state) -> None:
        def on_device(r):
            return torch.as_tensor(r).to(self.device, torch.float32, copy=True)

        if isinstance(state, (tuple, list)):  # segmented: leafwise rows
            row = tuple(r if isinstance(r, tuple) else on_device(r) for r in state)
        else:
            row = on_device(state)
        self._residual = row
        # the rollback point is the rehydrated row: a discard_update right
        # after re-materialization must be a no-op, not a reset to None
        self._residual_prev = row

    def steps_per_epoch(self) -> int:
        return self.dataset.steps_per_epoch(self.batch_size)

    @staticmethod
    def _comm_time_s(ins: FitIns, cfg: dict, prof) -> float:
        """This round's transfer time on the device's own links: the full
        global model down, the codec's wire (or the full model) up."""
        codec = cfg.get("codec")
        down_b = tree_bytes(ins.parameters)
        up_b = (
            codec.wire_bytes(tree_size(ins.parameters))
            if codec is not None else down_b
        )
        return prof.comm_time_s(up_b, down_b)

    def _local_sgd(self, global_params, xs, ys, n_live: int, opt: Optimizer, mu: float):
        """``n_live`` SGD steps from ``global_params`` over the stacked
        batches -> (params, loss summed over the steps).  With ``mu`` > 0
        each step's loss gains FedProx's ``0.5 * mu * ||w - w_global||^2``
        against the detached global.  Frozen leaves (trainable_mask False)
        are never updated and get no gradient."""
        anchor = tree_map(torch.Tensor.detach, global_params)
        leaves = tree_leaves(global_params)
        mask = (
            tree_leaves(self.trainable_mask) if self.trainable_mask is not None
            else [True] * len(leaves)
        )
        train = [i for i, m in enumerate(mask) if m]
        opt_state = opt.init([leaves[i] for i in train])
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for step in range(n_live):
            live = [
                leaf.detach().requires_grad_(m) for leaf, m in zip(leaves, mask)
            ]
            params = tree_unflatten(global_params, live)
            loss, _ = self.loss_fn(params, {"x": xs[step], "y": ys[step]})
            if mu > 0:
                loss = loss + 0.5 * mu * tree_sq_norm(tree_sub(params, anchor))
            grads = torch.autograd.grad(loss, [live[i] for i in train])
            with torch.no_grad():
                new, opt_state = opt.update(
                    list(grads), [live[i] for i in train], opt_state, step
                )
                loss_sum = loss_sum + loss.detach()
            leaves = [leaf.detach() for leaf in live]
            for i, p in zip(train, new):
                leaves[i] = p
        return tree_unflatten(global_params, leaves), loss_sum

    def fit(self, ins: FitIns) -> FitRes:
        self._residual_prev = self._residual  # rollback point (discard_update)
        cfg = ins.config
        epochs = int(cfg.get("epochs", 1))
        spe = self.steps_per_epoch()
        full_steps = epochs * spe
        budget = int(cfg.get("max_steps", full_steps))
        # on-device deadline enforcement: a client that knows its own step
        # time AND link speeds truncates local work so compute + comm fit
        # the round cutoff.  If even one step + comm cannot fit, the client
        # tries anyway — the scheduler will judge it.
        deadline = float(cfg.get("deadline_s", 0.0))
        prof = PROFILES.get(self.device_profile)
        if deadline > 0.0 and prof is not None:
            budget = max(
                1, min(budget, prof.steps_in_budget(
                    max(0.0, deadline - self._comm_time_s(ins, cfg, prof))
                ))
            )
        mu = float(cfg.get("mu", 0.0))
        lr = float(cfg.get("lr", 0.0))
        opt = sgd(lr) if lr else self.optimizer

        # draw every batch of the full schedule even when the budget is
        # smaller: the dataset's numpy RNG must advance exactly as the JAX
        # client's does, or the next round's batches drift apart
        batches = [self.dataset.next_batch(self.batch_size) for _ in range(full_steps)]
        xs = torch.from_numpy(np.stack([b["x"] for b in batches])).to(self.device)
        ys = torch.from_numpy(np.stack([b["y"] for b in batches])).to(self.device)

        global_params = tree_map(lambda t: t.to(self.device), ins.parameters)
        steps_done = min(budget, full_steps)
        params, loss_sum = self._local_sgd(global_params, xs, ys, steps_done, opt, mu)
        self._params = params
        metrics = {
            "loss": float(loss_sum) / max(1, steps_done),
            "steps_done": steps_done,
            "device_profile": self.device_profile,
        }

        codec = cfg.get("codec")
        if codec is not None:
            # compressed uplink: encode the delta (plus the carried error-
            # feedback residual) and ship the actual wire payload
            n_params = tree_size(params)
            residual = self._residual
            if codec.segments is not None:
                # the segmented carry is a tuple of per-segment rows; anything
                # else (a fresh client, a codec switch) starts at zeros
                # inside compress_update
                if not isinstance(residual, tuple) or len(residual) != len(codec.segments):
                    residual = None
            elif (residual is None or isinstance(residual, tuple)
                  or residual.shape != (n_params,)):
                residual = torch.zeros(n_params, dtype=torch.float32, device=self.device)
            enc, self._residual = compress_update(
                codec, params, global_params, residual=residual
            )
            wire = compress_to_wire(codec, enc, n_params)
            metrics["wire_bytes"] = wire.num_bytes
            return FitRes(
                parameters=wire, num_examples=len(self.dataset), metrics=metrics,
            )

        return FitRes(
            parameters=params, num_examples=len(self.dataset), metrics=metrics,
        )

    def evaluate(self, ins: EvaluateIns) -> EvaluateRes:
        n = min(len(self.dataset), 512)
        batch = {
            "x": torch.from_numpy(self.dataset.x[:n]).to(self.device),
            "y": torch.from_numpy(self.dataset.y[:n]).to(self.device),
        }
        params = tree_map(lambda t: t.to(self.device), ins.parameters)
        with torch.no_grad():
            loss, metrics = self.loss_fn(params, batch)
        return EvaluateRes(
            loss=float(loss),
            num_examples=n,
            metrics={k: float(v) for k, v in metrics.items()},
        )
