"""Million-client population layer: packed device fleet, resident-only state
(the twin of ``repro.core.population``).

The paper's fleets are six devices; its thesis — quantified system costs
should shape FL algorithm design — is about fleets of millions.  This
module makes that scale representable without making anything per-client:

- ``Population``: N device profiles stored **struct-of-arrays** — one small
  integer profile code per device plus per-*class* columns (step time,
  power, link speeds).  ~1 byte/device instead of a python object/device;
  every per-device quantity is a vectorized ``column[codes[ids]]`` gather
  over just the ids in hand, O(cohort) regardless of N.
- ``CohortState``: the codec error-feedback residual store.  Only the
  *sampled* cohort's rows are ever on the card — as one dense
  ``(C, n_params)`` fp32 block (``gather`` on dispatch, ``scatter`` on
  report); everything else lives in a hashed LRU spill store of fp32 host
  tensors bounded by ``capacity`` rows.
- ``LazyClientPool``: a sequence-like client collection that materializes
  ``Client`` objects on demand (LRU-bounded), spilling/rehydrating their
  error-feedback carry through a ``CohortState`` so ``Server.run`` never
  holds N python clients.

The resident-state contract
---------------------------

Codec client state is on the card **only while sampled**.  ``gather(ids)``
densifies the cohort's rows into one contiguous ``(C, n_params)`` fp32
tensor on the store's ``device`` for one ``round_step`` (missing rows are
zeros); ``scatter(ids, state)`` copies them back to the host.  The round
engine is unchanged shape-wise: it sees exactly what the codec's
``init_client_state(C, n_params, device)`` describes — the dense block for
Int8 / TopK, ``()`` for Null — with row order matching the cohort id
order, and the participation mask / codec contracts apply verbatim
(rounds.py).

The spill store lives on the host because the card cannot hold it: at
the default ``capacity=4096`` the head model's rows (N = 1,974,303) take
32 GB and ResNet-18's (N = 11,173,962) 183 GB.  Each spilled row is an
fp32 CPU tensor with storage of its own — never a view that would keep a
whole (C, n) cohort block alive — and every device-to-host copy into a
row completes (a synchronous ``copy_``) before the row can be handed out.

Eviction semantics: the spill store holds at most ``capacity`` rows; beyond
that the least-recently-sampled client's row is dropped and **eviction
resets the residual to zero** — the next time that client is sampled it
gathers a zero row, exactly the state of a client that never compressed
anything.  Error feedback stays correct under this reset (the residual is
an *optimization* that telescopes past compression error; zeroing it only
forgets error already accounted as such), so a post-eviction round is
bitwise the round of a fresh-residual client.

Python-path twin: ``TorchClient`` owns its residual between ``fit`` calls,
so ``LazyClientPool`` spills it (``Client.export_state``) into the same
store on eviction and rehydrates (``import_state``) on re-materialization
— the same eviction-resets-residual contract, now bounding live *clients*
too.  Keep ``capacity`` above cohort size + in-flight arrivals: evicting a
client with an undelivered fit spills its optimistically-committed
residual, so a later scheduler drop can no longer roll it back.

A segmented codec's rows are leafwise: a stored row is a tuple of
per-segment fp32 host tensors (``()`` for a stateless segment), and
``gather`` returns one (C, seg.size) block a stateful segment, the shape
``init_client_state`` gives.  A ``MixedCodec`` is refused (``TypeError``):
its static assignment binds codecs to client slots, which a cohort
resamples every round.

Not ported yet (ROADMAP.md queue 1): sharded cohort blocks (item 13).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_leaves

from .compression import MixedCodec
from .cost_model import AWS_DEVICE_FARM, PROFILES, DeviceProfile, link_time_s

# the packed per-class columns, in DeviceProfile field order
_COLUMNS = (
    "step_time_s", "active_power_w", "idle_power_w", "uplink_mbps",
    "downlink_mbps",
)


@dataclass(frozen=True)
class Population:
    """N devices as profile codes + per-class columns (struct-of-arrays).

    ``profile_codes`` is ``(N,)`` small-uint indices into ``table`` — the
    only O(N) storage (~1 byte/device).  All hardware numbers live in
    ``(P,)`` per-class column arrays, so any per-device quantity for a set
    of ids is one ``column[codes[ids]]`` gather: O(len(ids)), never O(N).
    """

    profile_codes: np.ndarray
    table: tuple[DeviceProfile, ...]

    def __post_init__(self):
        assert self.table, "a population needs at least one device class"
        codes = np.ascontiguousarray(self.profile_codes)
        assert codes.ndim == 1 and codes.size > 0
        assert int(codes.max()) < len(self.table), "profile code out of range"
        object.__setattr__(self, "profile_codes", codes)
        for name in _COLUMNS:
            col = np.asarray([getattr(p, name) for p in self.table], np.float64)
            object.__setattr__(self, f"{name}_table", col)

    # ------------------------------------------------------------ builders
    @classmethod
    def from_profiles(cls, profiles: Sequence[DeviceProfile]) -> "Population":
        """Pack an explicit per-device profile list (the legacy fleet shape):
        ``pop.profile(i)`` is ``profiles[i]``, deduplicated into classes."""
        table: dict[DeviceProfile, int] = {}
        codes = np.empty(len(profiles), np.int64)
        for i, p in enumerate(profiles):
            codes[i] = table.setdefault(p, len(table))
        dtype = np.min_scalar_type(max(0, len(table) - 1))
        return cls(profile_codes=codes.astype(dtype), table=tuple(table))

    @classmethod
    def synthetic(
        cls,
        n: int,
        mix: dict[str, float] | Sequence[str] | None = None,
        seed: int = 0,
    ) -> "Population":
        """An N-device fleet drawn from a device-class mix.

        ``mix`` maps profile names (``PROFILES``) to sampling weights, or
        lists names for a uniform mix; default is the paper's AWS Device
        Farm classes (Table 1), uniform.  O(N) once, here — everything
        downstream is O(cohort).
        """
        if mix is None:
            mix = AWS_DEVICE_FARM
        if not isinstance(mix, dict):
            mix = {name: 1.0 for name in mix}
        table = tuple(PROFILES[name] for name in mix)
        w = np.asarray(list(mix.values()), np.float64)
        rng = np.random.default_rng(seed)
        dtype = np.min_scalar_type(len(table) - 1)
        codes = rng.choice(len(table), size=n, p=w / w.sum()).astype(dtype)
        return cls(profile_codes=codes, table=table)

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return int(self.profile_codes.shape[0])

    @property
    def n_profiles(self) -> int:
        return len(self.table)

    @property
    def nbytes(self) -> int:
        """Host bytes of the packed representation (the flat-memory claim)."""
        cols = sum(getattr(self, f"{c}_table").nbytes for c in _COLUMNS)
        return int(self.profile_codes.nbytes) + cols

    def profile(self, client_id: int) -> DeviceProfile:
        """One device's class — P distinct objects exist, never N."""
        return self.table[int(self.profile_codes[client_id])]

    def column(self, name: str, ids) -> np.ndarray:
        """Vectorized per-device column gather for ``ids`` (O(len(ids)))."""
        return getattr(self, f"{name}_table")[self.profile_codes[ids]]

    def expected_round_s(
        self, ids, *, steps: int, up_bytes: float, down_bytes: float
    ) -> np.ndarray:
        """Predicted compute+comm round time per id, vectorized over the
        candidate pool (``link_time_s`` is the shared link-time owner)."""
        ids = np.asarray(ids)
        codes = self.profile_codes[ids]
        comm = link_time_s(
            up_bytes, down_bytes,
            self.uplink_mbps_table[codes], self.downlink_mbps_table[codes],
        )
        return steps * self.step_time_s_table[codes] + comm


class CohortState:
    """Resident-only-when-sampled codec client state (see module docstring).

    ``gather(ids)`` -> ``()`` for a stateless codec, else one contiguous
    ``(C, n_params)`` fp32 tensor on ``device`` (None: the card), zeros
    where a client was never seen *or was evicted*; ``scatter(ids, state)``
    copies the engine's updated rows back into the host LRU spill store.
    ``get_row``/``put_row`` are the single-row surface ``LazyClientPool``
    spills python-path clients through: a stored row is an ``(n_params,)``
    fp32 CPU tensor with storage of its own, or for a segmented codec a
    tuple of per-segment ones (``()`` for a stateless segment).
    """

    def __init__(self, codec, n_params: int, *, capacity: int = 4096,
                 device=None, shardings=None):
        if isinstance(codec, MixedCodec):
            raise TypeError(
                "MixedCodec assigns codecs to static client-axis slots; a "
                "population cohort is resampled every round, so per-client "
                "codec choice must come from BandwidthCodecPolicy instead"
            )
        if shardings is not None:
            raise NotImplementedError(
                "sharded cohort blocks (the fsdp archs' param-dim split) are "
                "ROADMAP.md queue 1 item 13"
            )
        assert capacity >= 1
        self.codec = codec
        self.n_params = int(n_params)
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self.stateless = (
            codec is None or not codec.carries_client_state(self.n_params)
        )
        self.segments = getattr(codec, "segments", None)
        if self.segments is not None:
            assert self.segments.n_params == self.n_params, (
                f"codec segment map covers {self.segments.n_params} params, "
                f"store built for {self.n_params}"
            )
            self._seg_stateful = tuple(codec.segment_stateful(seg) for seg in self.segments)
        self._rows: OrderedDict[int, Any] = OrderedDict()
        self.evictions = 0

    @staticmethod
    def _host_copy(row, n: int) -> torch.Tensor:
        """A fresh (n,) fp32 host tensor holding ``row`` (a tensor on any
        device, or array-like).  The copy is synchronous: a row from the
        card has fully landed when this returns."""
        if not isinstance(row, torch.Tensor):
            row = torch.from_numpy(np.asarray(row, np.float32))
        out = torch.empty(n, dtype=torch.float32)
        out.copy_(row.detach().reshape(n))
        return out

    def _pack_row(self, row):
        """The spill form of a row: one (n_params,) host tensor for a flat
        codec; for a segmented one a tuple of per-segment host tensors
        (``()`` for a stateless segment), a flat row being split."""
        if self.segments is None:
            return self._host_copy(row, self.n_params)
        segs = self.segments
        if isinstance(row, (tuple, list)):
            assert len(row) == len(segs), (
                f"segmented row has {len(row)} entries, map has {len(segs)}"
            )
            parts = row
        else:
            parts = segs.split(self._host_copy(row, self.n_params))
        return tuple(
            self._host_copy(r, seg.size) if sf else ()
            for r, seg, sf in zip(parts, segs, self._seg_stateful)
        )

    # ------------------------------------------------------- row-level API
    def get_row(self, client_id: int):
        row = self._rows.get(int(client_id))
        if row is not None:
            self._rows.move_to_end(int(client_id))
        return row

    def put_row(self, client_id: int, row) -> None:
        self._rows[int(client_id)] = self._pack_row(row)
        self._rows.move_to_end(int(client_id))
        while len(self._rows) > self.capacity:
            self._rows.popitem(last=False)  # eviction == residual reset to 0
            self.evictions += 1

    # ------------------------------------------------- cohort (engine) API
    def gather(self, cohort_ids):
        """Round-local dense cohort state, row i belongs to cohort_ids[i].

        The result is what ``codec.init_client_state(C, n_params, device)``
        would build, so the round engine is oblivious to the store."""
        if self.stateless:
            return ()
        if self.segments is None:
            out = torch.zeros(len(cohort_ids), self.n_params, dtype=torch.float32,
                              device=self.device)
            for i, cid in enumerate(cohort_ids):
                row = self.get_row(cid)
                if row is not None:
                    out[i].copy_(row)
            return out
        cols = [
            torch.zeros(len(cohort_ids), seg.size, dtype=torch.float32, device=self.device)
            if sf else ()
            for seg, sf in zip(self.segments, self._seg_stateful)
        ]
        for i, cid in enumerate(cohort_ids):
            row = self.get_row(cid)
            if row is not None:
                for col, r in zip(cols, row):
                    if not isinstance(col, tuple):
                        col[i].copy_(r)
        return tuple(cols)

    def scatter(self, cohort_ids, state) -> None:
        """Return the engine's updated rows to the spill store (same order
        as the ``gather`` that produced them)."""
        if self.stateless:
            return
        if self.segments is None:
            assert tuple(state.shape) == (len(cohort_ids), self.n_params), (
                f"scatter shape {tuple(state.shape)} != ({len(cohort_ids)}, {self.n_params})"
            )
            for cid, row in zip(cohort_ids, state):
                self.put_row(cid, row)
            return
        state = tuple(state)
        assert len(state) == len(self.segments), (
            f"segmented scatter has {len(state)} entries, map has {len(self.segments)}"
        )
        for st, seg, sf in zip(state, self.segments, self._seg_stateful):
            assert not sf or tuple(st.shape) == (len(cohort_ids), seg.size), (
                f"segment {seg.name!r} scatter shape {tuple(st.shape)} != "
                f"({len(cohort_ids)}, {seg.size})"
            )
        for i, cid in enumerate(cohort_ids):
            self.put_row(cid, tuple(st[i] if sf else () for st, sf in zip(state, self._seg_stateful)))

    # ---------------------------------------------------------- accounting
    def __len__(self) -> int:
        return len(self._rows)

    @property
    def nbytes(self) -> int:
        return sum(r.numel() * r.element_size()
                   for row in self._rows.values() for r in tree_leaves(row))

    def reset(self) -> None:
        self._rows.clear()
        self.evictions = 0


class LazyClientPool:
    """Sequence-like client collection over a ``Population``.

    ``pool[cid]`` materializes a ``Client`` via ``factory(cid)`` on first
    access and keeps at most ``capacity`` live objects (LRU).  With a
    ``state_store`` (``CohortState``), an evicted client's error-feedback
    carry is spilled (``Client.export_state``) and rehydrated on the next
    materialization — beyond the store's own capacity the residual resets
    to zero, the module-level eviction contract.
    """

    def __init__(
        self,
        population: Population,
        factory: Callable[[int], Any],
        *,
        capacity: int = 256,
        state_store: CohortState | None = None,
    ):
        assert capacity >= 1
        self.population = population
        self.factory = factory
        self.capacity = int(capacity)
        self.state_store = state_store
        self._live: OrderedDict[int, Any] = OrderedDict()
        self.materializations = 0

    def __len__(self) -> int:
        return len(self.population)

    def __getitem__(self, client_id: int):
        cid = int(client_id)
        client = self._live.get(cid)
        if client is None:
            client = self.factory(cid)
            self.materializations += 1
            if self.state_store is not None:
                row = self.state_store.get_row(cid)
                if row is not None:
                    client.import_state(row)
            self._live[cid] = client
        self._live.move_to_end(cid)
        while len(self._live) > self.capacity:
            old_cid, old = self._live.popitem(last=False)
            if self.state_store is not None:
                row = old.export_state()
                if row is not None:
                    self.state_store.put_row(old_cid, row)
        return client

    @property
    def live(self) -> int:
        return len(self._live)

    def reset_state(self) -> None:
        """Fresh trajectory: drop live clients and any spilled carry
        (``Server.run``'s population-mode twin of per-client reset)."""
        self._live.clear()
        self.materializations = 0
        if self.state_store is not None:
            self.state_store.reset()
