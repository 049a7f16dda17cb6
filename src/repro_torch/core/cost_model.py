"""System-cost model: per-device step time + power -> round time & energy.

The paper's central measurement (§5) is that FL accuracy gains carry *system
costs* — convergence time and energy — that depend on device hardware.  With
no physical fleet here, we keep the *mechanism* and calibrate the constants
to the paper's own tables:

- Table 2a (Jetson TX2 GPU, ResNet-18/CIFAR-10, C=10, 40 rounds):
    E=1: 17.63 min, 10.21 kJ | E=5: 36.83, 50.54 | E=10: 80.32, 100.95
- Table 3: CPU training is 1.27x slower than GPU at equal E
  (102 vs 80.32 min); per-round GPU compute ~1.99 min.
- Table 2b (Android, head model, E=5, 20 rounds):
    C=4: 30.7 min/10.4 kJ | C=7: 31.3/19.72 | C=10: 31.8/28.0

Derivations used for calibration (documented in benchmarks/table2a.py):
per-round GPU time at E=10 is ~1.99 min -> with ~78 steps/epoch that is
~153 ms/step; energy 100.95 kJ / (10 clients * 40 rounds * 780 steps) ~ 32 J
of marginal energy per client-step plus idle draw.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


def link_time_s(up_bytes, down_bytes, uplink_mbps, downlink_mbps):
    """The ONE link-time formula (CostModel charges it, TorchClient truncates
    its deadline budget by it, a late report's wasted work is windowed with
    it, and the population layer evaluates it vectorized over candidate
    pools) — elementwise over arrays, scalar for scalars."""
    return up_bytes * 8 / (uplink_mbps * 1e6) + down_bytes * 8 / (
        downlink_mbps * 1e6
    )


@dataclass(frozen=True)
class DeviceProfile:
    """Hardware profile of one FL client class."""

    name: str
    step_time_s: float          # wall time per local training step (batch fixed)
    active_power_w: float       # board power while training
    idle_power_w: float = 2.0   # draw while waiting (stragglers burn this)
    uplink_mbps: float = 20.0
    downlink_mbps: float = 50.0

    def steps_in_budget(self, tau_s: float) -> int:
        """How many local steps fit in a cutoff budget tau (paper Table 3)."""
        return int(np.floor(tau_s / self.step_time_s))

    def comm_time_s(self, up_bytes: float, down_bytes: float) -> float:
        """Transfer time on this device's links (``link_time_s``)."""
        return link_time_s(
            up_bytes, down_bytes, self.uplink_mbps, self.downlink_mbps
        )


# calibrated against the paper's tables (see module docstring)
JETSON_TX2_GPU = DeviceProfile("jetson-tx2-gpu", step_time_s=0.153, active_power_w=9.0,
                               idle_power_w=2.5, uplink_mbps=80, downlink_mbps=120)
JETSON_TX2_CPU = DeviceProfile("jetson-tx2-cpu", step_time_s=0.194, active_power_w=7.5,
                               idle_power_w=2.0, uplink_mbps=80, downlink_mbps=120)
PIXEL_4 = DeviceProfile("pixel-4", step_time_s=0.210, active_power_w=4.5, idle_power_w=0.8,
                        uplink_mbps=20, downlink_mbps=50)
PIXEL_3 = DeviceProfile("pixel-3", step_time_s=0.290, active_power_w=4.2, idle_power_w=0.8,
                        uplink_mbps=18, downlink_mbps=45)
PIXEL_2 = DeviceProfile("pixel-2", step_time_s=0.370, active_power_w=4.0, idle_power_w=0.7,
                        uplink_mbps=15, downlink_mbps=40)
GALAXY_TAB_S6 = DeviceProfile("galaxy-tab-s6", step_time_s=0.240, active_power_w=5.0,
                              idle_power_w=0.9, uplink_mbps=22, downlink_mbps=55)
GALAXY_TAB_S4 = DeviceProfile("galaxy-tab-s4", step_time_s=0.330, active_power_w=4.8,
                              idle_power_w=0.9, uplink_mbps=18, downlink_mbps=48)
TPU_V5E_CHIP = DeviceProfile("tpu-v5e-chip", step_time_s=0.010, active_power_w=170.0,
                             idle_power_w=60.0, uplink_mbps=400_000, downlink_mbps=400_000)

PROFILES: dict[str, DeviceProfile] = {
    p.name: p
    for p in (
        JETSON_TX2_GPU, JETSON_TX2_CPU, PIXEL_4, PIXEL_3, PIXEL_2,
        GALAXY_TAB_S6, GALAXY_TAB_S4, TPU_V5E_CHIP,
    )
}

# the paper's AWS Device Farm fleet (Table 1)
AWS_DEVICE_FARM = ("pixel-4", "pixel-3", "pixel-2", "galaxy-tab-s6", "galaxy-tab-s4")

# battery-powered device classes sit below this idle draw; they churn (lose
# charge, lose WiFi, get picked up) far more than plugged-in edge boards
_BATTERY_IDLE_W = 1.5


def _stream_uniform(seed: int, rnd: int, stream: int, ids: np.ndarray) -> np.ndarray:
    """Deterministic uniforms in [0, 1) per (seed, rnd, stream, client_id).

    A splitmix64 finalizer over the id array: each client's draw depends
    only on its own id and the (seed, rnd, stream) key, so streaming any
    candidate pool — in any order, of any size — yields the same verdict
    per client as streaming the full fleet.  O(len(ids)), never O(N).
    The arithmetic is numpy uint64 with mod-2^64 wraparound, operation for
    operation the JAX package's: a signed ``torch.int64`` route (no
    unsigned shifts) would draw other bits.
    """
    u64 = np.uint64
    key = (
        seed * 0x9E3779B97F4A7C15
        + rnd * 0xBF58476D1CE4E5B9
        + stream * 0x94D049BB133111EB
    ) & 0xFFFFFFFFFFFFFFFF
    with np.errstate(over="ignore"):  # mod-2^64 wraparound is the algorithm
        x = np.asarray(ids).astype(np.uint64) ^ u64(key)
        x = x + u64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> u64(30))) * u64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> u64(27))) * u64(0x94D049BB133111EB)
        x = x ^ (x >> u64(31))
    return (x >> u64(11)).astype(np.float64) * (1.0 / (1 << 53))


@dataclass(frozen=True)
class AvailabilityTrace:
    """Seeded per-client availability + step-time jitter schedules.

    Real fleets churn: phones drop off charger/WiFi mid-experiment, new
    devices enroll late, and a device's step time wobbles round-to-round
    with thermals and background load.  This trace makes that churn a
    *deterministic function of (seed, round)* so an experiment — and its
    control — can be replayed exactly:

    - ``dropout``: per-client probability of sitting a round out, drawn
      i.i.d. per (seed, round).  ``from_profiles`` derives it from the
      ``DeviceProfile``: battery-class devices (idle draw < 1.5 W) churn at
      ``mobile_dropout``, plugged-in boards at ``plugged_dropout``.
    - ``join_round``: the first round a client exists (late enrollment).
    - ``jitter_std``: sigma of a lognormal multiplicative step-time factor
      (1.0 = nominal), fed to ``CostModel.client_round_cost``.

    ``full(n)`` is the degenerate trace (everyone always up, no jitter) —
    by construction it reproduces the pre-scheduler lockstep fleet.

    Two execution paths, one schedule each:

    - the legacy **full-vector** path (``available`` / ``step_jitter``)
      draws the whole fleet per round from ``default_rng((seed, rnd,
      stream))`` — O(N);
    - the **streamed** path (``available_for`` / ``step_jitter_for``)
      evaluates only the ids handed to it, via a per-(seed, rnd, id)
      splitmix64 hash — O(pool), pool-composition-independent, what
      population-mode sampling uses.  A population-backed trace
      (``from_profiles`` over packed columns) runs the streamed schedule on
      *both* surfaces, so the two views of one trace always agree; a legacy
      per-client-tuple trace keeps its full-vector draws, which are a
      *different* (equally deterministic) schedule from its streamed draws.

    The whole-run (R, C) schedule matrices (``available_matrix``,
    ``step_jitter_matrix``, ``cohort_priority_matrix``) stack those
    per-round draws for the multi-round trainer (``Server.run_scanned``).
    """

    n_clients: int
    seed: int = 0
    dropout: tuple[float, ...] = ()        # () = nobody drops
    join_round: tuple[int, ...] = ()       # () = everyone from round 1
    jitter_std: float = 0.0
    # population-backed traces: one dropout per device *class*, resolved
    # per-id through the packed profile codes — nothing here is O(N)
    class_dropout: tuple[float, ...] = ()
    population: Any = None

    def __post_init__(self):
        if self.dropout:
            assert len(self.dropout) == self.n_clients
        if self.join_round:
            assert len(self.join_round) == self.n_clients
        if self.class_dropout:
            assert self.population is not None and len(self.class_dropout) == (
                self.population.n_profiles
            )
        if self.population is not None:
            assert not self.dropout and not self.join_round, (
                "population-backed traces stream per-class schedules; "
                "per-client tuples would be the O(N) state this layer avoids"
            )

    @classmethod
    def full(cls, n_clients: int) -> "AvailabilityTrace":
        return cls(n_clients=n_clients)

    @classmethod
    def from_profiles(
        cls,
        profiles,
        *,
        seed: int = 0,
        mobile_dropout: float = 0.15,
        plugged_dropout: float = 0.02,
        jitter_std: float = 0.1,
        late_join: int = 0,
    ) -> "AvailabilityTrace":
        """Churn schedule from the fleet's hardware profiles.

        ``profiles`` is either a ``list[DeviceProfile]`` (the legacy
        per-client fleet) or a packed ``Population``: the population path
        reads the per-*class* idle-power column directly and stores one
        dropout rate per class — it never materializes N python objects,
        and the resulting trace streams (``available_for``) on every
        surface.  ``late_join`` > 0 enrolls that many of the slowest
        clients only from round ``late_join + 1`` (a staggered rollout;
        legacy path only — it is inherently a per-client schedule).
        """
        if hasattr(profiles, "profile_codes"):  # a packed Population
            if late_join:
                raise ValueError(
                    "late_join needs a per-client schedule; pass an explicit "
                    "list[DeviceProfile] instead of a packed Population"
                )
            class_drop = tuple(
                mobile_dropout if w < _BATTERY_IDLE_W else plugged_dropout
                for w in profiles.idle_power_w_table
            )
            return cls(
                n_clients=len(profiles), seed=seed, jitter_std=jitter_std,
                class_dropout=class_drop, population=profiles,
            )
        drop = tuple(
            mobile_dropout if p.idle_power_w < _BATTERY_IDLE_W else plugged_dropout
            for p in profiles
        )
        join = [1] * len(profiles)
        if late_join > 0:
            slowest = np.argsort([-p.step_time_s for p in profiles])
            for cid in slowest[:late_join]:
                join[int(cid)] = late_join + 1
        return cls(
            n_clients=len(profiles), seed=seed, dropout=drop,
            join_round=tuple(join), jitter_std=jitter_std,
        )

    def _rng(self, rnd: int, stream: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, rnd, stream))

    def _dropout_for(self, ids: np.ndarray) -> np.ndarray | None:
        if self.population is not None and self.class_dropout:
            codes = self.population.profile_codes[ids]
            return np.asarray(self.class_dropout)[codes]
        if self.dropout:
            return np.asarray(self.dropout)[ids]
        return None

    def available_for(self, rnd: int, ids) -> np.ndarray:
        """Streamed availability: one bool per id in ``ids``, O(len(ids)).

        Each client's draw is a pure function of (seed, rnd, client_id) —
        the verdict for client c is identical whatever candidate pool (or
        full fleet) it is evaluated in.  Population sampling consults it
        for the candidate pool only, never drawing an O(N) fleet vector.
        """
        ids = np.asarray(ids, np.int64)
        up = np.ones(ids.shape, bool)
        drop = self._dropout_for(ids)
        if drop is not None:
            up &= _stream_uniform(self.seed, rnd, 0, ids) >= drop
        if self.join_round:
            up &= np.asarray(self.join_round)[ids] <= rnd
        return up

    def step_jitter_for(self, rnd: int, ids) -> np.ndarray:
        """Streamed lognormal step-time factors per id (Box-Muller over two
        hash streams; same pool-independence contract as available_for)."""
        ids = np.asarray(ids, np.int64)
        if self.jitter_std <= 0.0:
            return np.ones(ids.shape)
        u1 = _stream_uniform(self.seed, rnd, 2, ids)
        u2 = _stream_uniform(self.seed, rnd, 3, ids)
        z = np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)
        return np.exp(self.jitter_std * z)

    def available(self, rnd: int, client_id: int | None = None):
        """(n_clients,) bool — who is up this round (or one client's bool).

        Population-backed traces answer from the streamed schedule (still
        O(N) on *this* surface — prefer ``available_for`` over a pool);
        legacy traces keep their full-vector draws.
        """
        if self.population is not None:
            up = self.available_for(rnd, np.arange(self.n_clients))
            return up if client_id is None else bool(up[client_id])
        up = np.ones(self.n_clients, bool)
        if self.join_round:
            up &= np.asarray(self.join_round) <= rnd
        if self.dropout:
            u = self._rng(rnd, 0).random(self.n_clients)
            up &= u >= np.asarray(self.dropout)
        return up if client_id is None else bool(up[client_id])

    def step_jitter(self, rnd: int) -> np.ndarray:
        """(n_clients,) multiplicative step-time factors for this round."""
        if self.population is not None:
            return self.step_jitter_for(rnd, np.arange(self.n_clients))
        if self.jitter_std <= 0.0:
            return np.ones(self.n_clients)
        return np.exp(
            self._rng(rnd, 1).normal(0.0, self.jitter_std, self.n_clients)
        )

    # ---- the whole run's schedule, for the multi-round trainer ----
    #
    # Rows are the SAME per-round draws Server.run makes (same hash streams
    # and tuple-seeded generators), stacked, so the scanned and the
    # per-round drivers see one schedule.

    def available_matrix(self, rounds) -> np.ndarray:
        """(R, C) float32 0/1 — ``available(r)`` stacked over ``rounds``."""
        return np.stack(
            [self.available(int(r)) for r in rounds]
        ).astype(np.float32)

    def step_jitter_matrix(self, rounds) -> np.ndarray:
        """(R, C) float64 — ``step_jitter(r)`` stacked over ``rounds``."""
        return np.stack([self.step_jitter(int(r)) for r in rounds])

    def cohort_priority_matrix(self, rounds) -> np.ndarray:
        """(R, C) float32 uniforms on hash stream 4 — per-round sampling
        priorities for on-device cohort selection (the lowest-k available
        priorities win; ``rounds.cohort_dispatch_mask``).  Stream 4 is
        unused by dropout (0) and jitter (2, 3), so cohort draws never
        perturb the churn schedule."""
        ids = np.arange(self.n_clients)
        return np.stack(
            [_stream_uniform(self.seed, int(r), 4, ids) for r in rounds]
        ).astype(np.float32)


@dataclass
class ClientCost:
    """Per-round, per-client accounting record.

    ``t_arrival_s`` records when the report lands on the round's *virtual
    timeline* (launch time + t_total on the scheduler's clock).  The Server
    stamps it at dispatch and derives ``scheduler.Arrival.finish_t`` from
    it, so this field is the source of truth the policies ultimately
    schedule against.  0.0 means "not scheduled" (legacy lockstep
    accounting, where only t_total_s matters).
    """

    client_id: int
    profile: str
    steps: int
    t_compute_s: float
    t_comm_s: float
    e_compute_j: float
    e_comm_j: float
    t_arrival_s: float = 0.0

    @property
    def t_total_s(self) -> float:
        return self.t_compute_s + self.t_comm_s

    @property
    def e_total_j(self) -> float:
        return self.e_compute_j + self.e_comm_j


@dataclass
class CostModel:
    """Simulates the fleet's time/energy for each FL round."""

    profiles: list[DeviceProfile]
    update_bytes: int                      # full-precision model payload
    comm_power_w: float = 1.2
    # packed Population: client_id -> device class via profile codes instead
    # of the legacy round-robin over `profiles` (which may then be empty)
    population: Any = None

    def profile_for(self, client_id: int) -> DeviceProfile:
        """The device class behind a client id — the ONE id->profile map
        (every charge below and Server accounting resolve through it)."""
        if self.population is not None:
            return self.population.profile(client_id)
        return self.profiles[client_id % len(self.profiles)]

    def client_round_cost(
        self,
        client_id: int,
        steps: int,
        *,
        uplink_bytes: int | None = None,
        jitter: float = 1.0,
    ) -> ClientCost:
        """Time/energy for one client-round.

        ``uplink_bytes`` overrides only the client->server leg — the codec-
        compressed wire — while the downlink stays the full global model.
        ``jitter`` is a multiplicative step-time factor for this round
        (thermal throttling, background load): an ``AvailabilityTrace``
        draws one per client per round, 1.0 means nominal.
        """
        p = self.profile_for(client_id)
        down = self.update_bytes
        up = down if uplink_bytes is None else uplink_bytes
        t_compute = steps * p.step_time_s * jitter
        t_comm = p.comm_time_s(up, down)
        return ClientCost(
            client_id=client_id,
            profile=p.name,
            steps=steps,
            t_compute_s=t_compute,
            t_comm_s=t_comm,
            e_compute_j=t_compute * p.active_power_w,
            e_comm_j=t_comm * self.comm_power_w,
        )

    def wasted_energy(self, cost: ClientCost, window_s: float) -> float:
        """Burn of an aborted client-round within its first ``window_s``
        seconds — the ONE owner of the phase split a scheduler cutoff
        induces (downlink radio, then compute, then uplink radio; each
        phase charges only the fraction that fit).  A window covering the
        whole round charges the complete cost.
        """
        if window_s >= cost.t_total_s:
            return cost.e_total_j
        p = self.profile_for(cost.client_id)
        window = max(0.0, window_s)
        t_down = p.comm_time_s(0, self.update_bytes)
        t_active = min(cost.t_compute_s, max(0.0, window - t_down))
        t_up_used = max(0.0, window - t_down - cost.t_compute_s)
        return (
            (min(window, t_down) + t_up_used) * self.comm_power_w
            + t_active * p.active_power_w
        )

    @staticmethod
    def _per_client(uplink_bytes, n_clients: int) -> list[int | None]:
        if uplink_bytes is None or isinstance(uplink_bytes, (int, np.integer)):
            return [uplink_bytes] * n_clients
        assert len(uplink_bytes) == n_clients, (
            f"per-client uplink vector ({len(uplink_bytes)}) != clients ({n_clients})"
        )
        return [int(u) for u in uplink_bytes]

    # ---- vectorized fleet accounting (the multi-round trainer) ----

    def fleet_columns(
        self, n_clients: int, *, uplink_bytes=None
    ) -> dict[str, np.ndarray]:
        """Static per-client cost columns as (C,) float64 arrays.

        The id->profile map (``profile_for``) and the per-leg comm-time
        rule, resolved once for the whole fleet: ``step_time_s``,
        ``active_power_w``, ``idle_power_w``, ``up_bytes``, ``t_comm_s``
        (uplink of the codec wire + downlink of the full global) and
        ``t_down_s`` (downlink alone — the first phase of
        ``wasted_energy``'s split).  Everything per-round is
        availability/jitter (the trace's matrices) and the policy verdict.
        """
        profs = [self.profile_for(c) for c in range(n_clients)]
        ups = self._per_client(uplink_bytes, n_clients)
        up = np.asarray(
            [self.update_bytes if u is None else u for u in ups], np.float64
        )
        return {
            "step_time_s": np.asarray([p.step_time_s for p in profs]),
            "active_power_w": np.asarray([p.active_power_w for p in profs]),
            "idle_power_w": np.asarray([p.idle_power_w for p in profs]),
            "up_bytes": up,
            "t_comm_s": np.asarray(
                [p.comm_time_s(u, self.update_bytes) for p, u in zip(profs, up)]
            ),
            "t_down_s": np.asarray(
                [p.comm_time_s(0, self.update_bytes) for p in profs]
            ),
        }

    def fleet_time_matrix(
        self, step_budgets, jitter_matrix, *, uplink_bytes=None
    ) -> np.ndarray:
        """(R, C) finish-time offsets: ``steps*step_time*jitter + t_comm``.

        The arithmetic (and evaluation order) of ``client_round_cost``,
        vectorized over the round axis: entry [r, c] equals
        ``client_round_cost(c, steps[c], jitter=jitter_matrix[r, c])
        .t_total_s`` bitwise.
        """
        cols = self.fleet_columns(jitter_matrix.shape[1], uplink_bytes=uplink_bytes)
        steps = np.asarray(step_budgets, np.float64)
        t_compute = (steps * cols["step_time_s"])[None, :] * jitter_matrix
        return t_compute + cols["t_comm_s"][None, :]

    @staticmethod
    def fleet_uplink_bytes(
        codec, n_params: int, n_clients: int
    ) -> list[int] | None:
        """Per-client uplink charge under a server-level codec: a plain
        codec's wire size for every client, a ``MixedCodec``'s one size a
        client (its group's codec).  None codec -> None (the cost model's
        full-precision default applies)."""
        if codec is None:
            return None
        wb = codec.wire_bytes(n_params)
        if isinstance(wb, list):
            assert len(wb) == n_clients, (
                f"codec charges {len(wb)} clients, round has {n_clients}"
            )
            return wb
        return [int(wb)] * n_clients

    # ---- the paper's tau mechanism (§5, Table 3) ----
    def tau_for_profile(self, reference: str, *, epochs: int, steps_per_epoch: int) -> float:
        """Hardware-specific cutoff: the wall time the *reference* processor
        needs for a full E-epoch round (paper: GPU round time 1.99 min)."""
        ref = PROFILES[reference]
        return epochs * steps_per_epoch * ref.step_time_s

    def steps_under_tau(self, client_id: int, tau_s: float, full_steps: int) -> int:
        """Client ``client_id``'s local step budget under cutoff ``tau_s``:
        the steps its profile fits in tau, at least 1 and at most
        ``full_steps``; tau = 0 means no cutoff (paper notation)."""
        if tau_s <= 0:
            return full_steps
        p = self.profile_for(client_id)
        return max(1, min(full_steps, p.steps_in_budget(tau_s)))
