"""Strategy interface — the paper's pluggable server-side decision maker.

The twin of ``repro.core.strategy.base`` on its python-side surface: the
FL loop (server.py) orchestrates rounds and delegates every decision to
the Strategy, as in Flower's architecture (paper §3, Figure 1): which
clients train, with what config (epochs / tau / codec), and how results
merge into the global model.  ``configure_fit`` performs per-device codec
selection when a ``codec_policy`` is set; ``aggregate_fit`` reduces a
compressed-wire fleet group by group on the codecs' own kernels.  The
round engine (``core/rounds.py``) consumes ``init_state`` and
``server_update``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.utils.pytree import (
    safe_weight_sum, tree_flatten_to_vector, tree_leaves, tree_map, tree_sub,
    tree_unflatten_from_vector,
)

from ..protocol import (
    ClientProperties, CompressedParameters, FitIns, FitRes, Parameters,
    parameters_to_pytree, wire_to_enc, wire_to_pytree,
)

PyTree = Any


@dataclass
class Strategy:
    name: str = "base"
    fraction_fit: float = 1.0
    min_fit_clients: int = 1
    codec_policy: Any = None    # BandwidthCodecPolicy | None: per-device codecs
    # client-sampling seed: the per-round stream is default_rng((seed, rnd))
    seed: int = 10_000
    # python-path server state, carried across aggregate_fit rounds; reset
    # at the start of Server.run
    _server_state: Any = field(default=None, repr=False)

    # ---------------- python-path server state ----------------
    def reset_server_state(self) -> None:
        """Drop the carried server state (Server.run calls this per run)."""
        self._server_state = None

    def _server_state_for(self, global_params: PyTree) -> PyTree:
        """The carried python-path server state, lazily initialized."""
        if self._server_state is None:
            self._server_state = self.init_state(global_params)
        return self._server_state

    # ---------------- python-side orchestration ----------------
    def num_fit_clients(self, available: int) -> int:
        return max(self.min_fit_clients, int(available * self.fraction_fit))

    def sample_clients(self, rnd: int, client_ids: Sequence[int]) -> list[int]:
        if hasattr(client_ids, "profile_codes"):
            # population-backed overload: a packed Population instead of an
            # explicit id list — sample ids without instantiating clients
            return self.sample_cohort(
                rnd, client_ids, self.num_fit_clients(len(client_ids))
            )
        if not client_ids:
            return []  # availability dropouts can empty the eligible pool
        n = min(self.num_fit_clients(len(client_ids)), len(client_ids))
        rng = np.random.default_rng((self.seed, rnd))
        return sorted(rng.choice(client_ids, size=n, replace=False).tolist())

    def sample_cohort(
        self,
        rnd: int,
        population,
        cohort_size: int,
        *,
        exclude=(),
        availability=None,
        cost_model=None,
        deadline_s: float | None = None,
    ) -> list[int]:
        """Draw a cohort of ids from a packed ``Population`` — O(cohort)
        work and memory regardless of population size.

        Candidates are drawn id-first (with replacement, deduplicated) and
        availability is *streamed* over each candidate batch only
        (``AvailabilityTrace.available_for``); no O(N) id list, fleet
        vector, or client object is ever built.  Deterministic in
        ``(self.seed, rnd)`` like ``sample_clients``.  Redraws are bounded,
        so a mostly-unavailable fleet yields a short cohort rather than a
        livelock.  The base strategy samples blind — ``cost_model`` and
        ``deadline_s`` are the hooks ``CostAwareSampling`` ranks with.
        """
        del cost_model, deadline_s  # blind sampling: cost hooks unused
        n = len(population)
        want = min(int(cohort_size), n)
        if want <= 0:
            return []
        rng = np.random.default_rng((self.seed, rnd))
        chosen: list[int] = []
        seen = {int(c) for c in exclude}
        for _ in range(16):
            if len(chosen) >= want:
                break
            cand = rng.integers(0, n, size=max(64, 4 * want))
            if availability is not None:
                cand = cand[availability.available_for(rnd, cand)]
            for c in cand.tolist():
                if c not in seen:
                    seen.add(c)
                    chosen.append(c)
                    if len(chosen) >= want:
                        break
        return sorted(chosen)

    def fit_config(self, rnd: int, client_id: int) -> dict:
        """Per-round, per-client config shipped in FitIns (epochs, tau, lr...)."""
        return {}

    def round_deadline_s(self) -> float | None:
        """The strategy's per-round wall-clock cutoff, if it owns one
        (``scheduler.Deadline(tau=None)`` reads it); None = no deadline."""
        return None

    def codec_for_client(self, client_id: int, properties=None):
        """Per-device codec selection (None = raw pytree transport)."""
        if self.codec_policy is None:
            return None
        props = properties or ClientProperties(client_id=client_id)
        return self.codec_policy.codec_for(props)

    def configure_fit(
        self,
        rnd: int,
        global_params: PyTree,
        client_ids: Sequence[int],
        client_properties: dict[int, ClientProperties] | None = None,
    ) -> list[tuple[int, FitIns]]:
        chosen = self.sample_clients(rnd, client_ids)
        out = []
        for cid in chosen:
            cfg = self.fit_config(rnd, cid)
            codec = self.codec_for_client(
                cid, (client_properties or {}).get(cid)
            )
            if codec is not None:
                cfg = {**cfg, "codec": codec}
            out.append((cid, FitIns(parameters=global_params, config=cfg)))
        return out

    @staticmethod
    def fitres_parameters(res: FitRes, global_params: PyTree) -> PyTree:
        """Materialize a FitRes payload as a params pytree: decodes the
        ``CompressedParameters`` delta wire (against the global the client
        trained from) and the serialized ``Parameters`` wire alike."""
        p = res.parameters
        if isinstance(p, CompressedParameters):
            return wire_to_pytree(p, global_params)
        if isinstance(p, Parameters):
            return parameters_to_pytree(p, global_params)
        return p

    def aggregate_fit(
        self, rnd: int, results: list[tuple[int, FitRes]], global_params: PyTree
    ) -> PyTree:
        """Default: examples-weighted average of returned parameters.

        A compressed-wire fleet of Null/Int8/TopK clients takes the grouped
        kernel-path reduce (``_aggregate_fit_wire``): clients partition by
        codec and each group's payloads feed that codec's own kernel (Int8
        -> fused dequant+reduce, TopK -> scatter-accumulate, Null -> fedavg
        reduce), the partial weighted sums combining under one fleet
        denominator.  Raw-pytree transports and foreign codecs densify per
        client.
        """
        device = tree_leaves(global_params)[0].device
        weights = self._fit_weights(results, device)
        if float(weights.sum()) == 0.0:
            # every sampled client reported zero examples: fall back to an
            # unweighted mean instead of poisoning the global with NaNs
            weights = torch.ones_like(weights)
        server_state = self._server_state_for(global_params)
        grouped = self._aggregate_fit_wire(
            rnd, results, weights, global_params, server_state
        )
        if grouped is not None:
            new_global, new_state = grouped
        else:
            trees = [self.fitres_parameters(r, global_params) for _, r in results]
            stacked = tree_map(lambda *xs: torch.stack(xs), *trees)
            new_global, new_state = self.aggregate(
                stacked, weights, global_params, server_state, rnd
            )
        self._server_state = new_state
        return new_global

    def _fit_weights(self, results: list[tuple[int, FitRes]], device) -> torch.Tensor:
        """Per-result aggregation weights (the ONE hook both the grouped
        wire reduce and the densify path flow through).  Default: example
        counts; ``FedBuffStrategy`` discounts by staleness here."""
        return torch.tensor(
            [float(r.num_examples) for _, r in results], dtype=torch.float32,
            device=device,
        )

    def _grouped_fit_compatible(self) -> bool:
        """The grouped wire reduce computes weighted-mean + ``server_update``;
        that composition is only known to equal ``aggregate`` for the
        in-tree linear aggregators.  A subclass overriding ``aggregate``
        (robust aggregation: median, trimmed mean, ...) or pairing a stock
        ``aggregate`` with a custom ``server_update`` falls back to the
        densify path -- identity checks on the class attributes, so
        overrides anywhere in the MRO disqualify."""
        from .fedavg import FedAvg
        from .fedbuff import FedBuffStrategy
        from .fedopt import FedOpt
        from .fedprox import FedProx
        from .fedtau import FedTau

        cls = type(self)
        if cls.aggregate in (
            FedAvg.aggregate, FedProx.aggregate, FedTau.aggregate,
            FedBuffStrategy.aggregate,
        ):
            return cls.server_update is Strategy.server_update
        if cls.aggregate is FedOpt.aggregate:
            return cls.server_update is FedOpt.server_update
        return False

    def _aggregate_fit_wire(
        self, rnd: int, results, weights: torch.Tensor, global_params: PyTree,
        server_state: PyTree,
    ) -> tuple[PyTree, PyTree] | None:
        """Grouped kernel-path aggregation of a compressed-wire fleet, or
        None to densify.

        Partitions clients by codec (equal-config codecs share a group) and
        reduces each group's payloads on that codec's own kernel.  Each
        group yields its partial weighted delta sum; one fleet-wide
        ``safe_weight_sum`` denominator turns the combined sum into the
        mean that feeds ``server_update`` -- identical to ``aggregate`` over
        stacked decoded params for every strategy ``_grouped_fit_compatible``
        admits.  A TopK-only pseudo-gradient stays EXACTLY zero at
        untransmitted coordinates, so FedOpt leaves them untouched (no
        fp-noise Adam drift).  Segmented Null/Int8/TopK groups reduce
        segment by segment on the same kernels; a structure-changing codec
        (LoRA) densifies per client instead.
        """
        from ..compression import Int8Codec, NullCodec, StructuredUpdate, TopKCodec

        if not results or not self._grouped_fit_compatible():
            return None
        device = weights.device
        cps, encs = [], []
        for _, res in results:
            cp = res.parameters
            # exact types, not isinstance: a codec subclass may redefine
            # the wire format, which only the per-client decode interprets
            if not isinstance(cp, CompressedParameters) or type(cp.codec) not in (
                NullCodec, Int8Codec, TopKCodec
            ):
                return None
            enc = wire_to_enc(cp, device)
            required = (
                {"idx", "val"} if type(cp.codec) is TopKCodec
                else {"q", "scale"} if type(cp.codec) is Int8Codec
                else {"delta"}
            )
            payloads = enc.payloads if isinstance(enc, StructuredUpdate) else (enc,)
            if not all(required <= set(p) for p in payloads):
                return None
            cps.append(cp)
            encs.append(enc)
        n_params = cps[0].n_params
        if any(cp.n_params != n_params for cp in cps):
            return None

        groups: dict[Any, list[int]] = {}
        for i, cp in enumerate(cps):
            groups.setdefault(cp.codec, []).append(i)

        wf = weights.to(torch.float32)
        total = torch.zeros(n_params, dtype=torch.float32, device=device)
        for codec, rows in groups.items():
            total = total + self._group_wire_sum(
                codec, [encs[i] for i in rows], wf[rows], n_params
            )
        avg_delta = total / safe_weight_sum(wf)
        flat_global = tree_flatten_to_vector(global_params)
        avg_params = tree_unflatten_from_vector(flat_global + avg_delta, global_params)
        return self.server_update(avg_params, global_params, server_state, rnd)

    @staticmethod
    def _group_wire_sum(codec, encs: list, w_g: torch.Tensor, n_params: int):
        """One codec group's partial weighted delta sum (N,), on the group's
        own kernel (``normalize=False``: the caller owns the ONE fleet-wide
        denominator).  A segmented group reduces segment by segment, one
        launch a segment, and concatenates the partial sums."""
        if getattr(codec, "segments", None) is not None:
            return torch.cat([
                Strategy._flat_wire_sum(codec, [su.payloads[i] for su in encs], w_g, seg.size)
                for i, seg in enumerate(codec.segments)
            ])
        return Strategy._flat_wire_sum(codec, encs, w_g, n_params)

    @staticmethod
    def _flat_wire_sum(codec, encs: list[dict], w_g: torch.Tensor, n_params: int):
        """The flat-format partial sum of ONE segment (or of the whole
        update for an unsegmented codec)."""
        from ..compression import Int8Codec, TopKCodec

        if type(codec) is TopKCodec:
            rows = [(e["idx"].reshape(-1), e["val"].reshape(-1)) for e in encs]
            # pad rows to the group's k_max with index 0 / value 0: a zero
            # value scatters nothing
            k_max = max(int(i.shape[0]) for i, _ in rows)
            if k_max == 0:
                return torch.zeros(n_params, dtype=torch.float32, device=w_g.device)
            idx = torch.stack([
                torch.nn.functional.pad(i.to(torch.int32), (0, k_max - i.shape[0]))
                for i, _ in rows
            ])
            val = torch.stack([
                torch.nn.functional.pad(v.to(torch.float32), (0, k_max - v.shape[0]))
                for _, v in rows
            ])
            return ops.topk_scatter_reduce(idx, val, w_g, n_params, normalize=False)
        if type(codec) is Int8Codec:
            q = torch.stack([e["q"] for e in encs])
            scale = torch.stack([e["scale"] for e in encs])
            return ops.dequant_reduce(
                q, scale, w_g, block=codec.block, normalize=False
            )[:n_params]
        deltas = torch.stack([e["delta"].to(torch.float32) for e in encs])
        return ops.fedavg_reduce(deltas, w_g, normalize=False)

    # ---------------- aggregation core ----------------
    def init_state(self, global_params: PyTree) -> PyTree:
        return ()

    def aggregate(
        self,
        client_params: PyTree,   # leaves (C, ...): per-client updated params
        weights: torch.Tensor,   # (C,) aggregation weights (num examples)
        global_params: PyTree,
        server_state: PyTree,
        rnd,
    ) -> tuple[PyTree, PyTree]:
        raise NotImplementedError

    def server_update(
        self, avg_params: PyTree, global_params: PyTree, server_state: PyTree, rnd
    ) -> tuple[PyTree, PyTree]:
        """Consume the already-reduced client average.  FedAvg-family: the
        average IS the new global; FedOpt overrides it to apply a server
        optimizer to the pseudo-gradient."""
        return avg_params, server_state

    # client-side loss shaping hook (FedProx adds the proximal term)
    def client_loss_extra(self, params: PyTree, global_params: PyTree) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)


def weighted_mean(client_params: PyTree, weights: torch.Tensor) -> PyTree:
    """Examples-weighted mean across the leading client axis (fp32 accumulate)."""
    wf = weights.to(torch.float32)
    wsum = torch.sum(wf)

    def leaf_mean(x):
        wshape = (x.shape[0],) + (1,) * (x.dim() - 1)
        acc = torch.sum(x.to(torch.float32) * wf.reshape(wshape), dim=0)
        return (acc / wsum).to(x.dtype)

    return tree_map(leaf_mean, client_params)


def pseudo_gradient(client_params: PyTree, weights: torch.Tensor, global_params: PyTree) -> PyTree:
    """FedOpt's server 'gradient': g = global - weighted_mean(clients)."""
    return tree_sub(global_params, weighted_mean(client_params, weights))
