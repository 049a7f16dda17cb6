"""Virtual-clock execution layer: who reports this round, and when.

The paper's claim is that quantifying per-device system costs "could be
used to design more efficient FL algorithms".  This module is where the
engine *acts* on those costs instead of just reporting them: every client
dispatch becomes an event on a per-round **virtual timeline**, and a
``RoundPolicy`` decides — from arrival times alone — who reports this
round, who is dropped, and who carries a stale update forward.

The event model
---------------

One ``VirtualClock`` per ``Server.run``; time is simulated seconds and
only ever moves forward.  Each round:

1. the Server *dispatches* the sampled, available, not-still-busy clients:
   client ``c`` launched at ``t0 = clock.now`` finishes (compute + uplink)
   at ``t0 + cost.t_total_s`` — an ``Arrival`` event carrying the client's
   result payload and its ``ClientCost`` (whose ``t_arrival_s`` records the
   finish time on this timeline);
2. the policy ``plan``s the round over *all* pending arrivals (this
   round's dispatches plus any still in flight from earlier rounds) and
   partitions them into

   - ``reported``  — consumed by this round's aggregation,
   - ``dropped``   — deadline-missed: work wasted, update discarded,
   - ``expired``   — arrived too stale for the policy to accept,
   - ``carried``   — still in flight; they stay pending and will report in
     a later round with staleness > 0;

3. the clock advances to ``RoundOutcome.round_end`` and the Server
   aggregates the reported payloads (an empty ``reported`` list is a legal
   outcome: the round records, the clock advances, nothing aggregates).

Policies
--------

- ``SyncAll``     — today's lockstep FedAvg: everyone reports, the round
  ends when the slowest client does.
- ``Deadline(tau)`` — the round ends at ``now + tau``; whoever has not
  arrived is dropped (their compute until the cutoff is still charged —
  wasted work is the *point* of measuring this).  ``tau=None`` defers to
  the Strategy's own deadline (``Strategy.round_deadline_s()``), so
  ``FedTau``'s tau and the scheduler's cutoff are the same knob;
  ``tau=inf`` (or a strategy with no deadline) reproduces ``SyncAll``
  exactly — arrival order, round end, and reporters are identical.
- ``BufferedAsync(K, max_staleness)`` — FedBuff-style buffered
  asynchrony: the round ends the moment the ``K``-th pending arrival
  lands; later arrivals stay in flight and report in a subsequent round.
  An arrival consumed at round ``r`` that was launched at round ``l`` has
  **staleness** ``s = r - l``; arrivals with ``s > max_staleness`` are
  expired (discarded, work wasted) instead of reported.

The staleness-weight contract
-----------------------------

Staleness is *decided here* and *applied in the Strategy*: the Server
stamps each reported ``FitRes.staleness = r - l``, and
``FedBuffStrategy`` discounts that client's aggregation weight to
``w_c / (1 + s)**alpha`` (``alpha=0`` recovers plain FedAvg weighting).
A stale update is a *delta* against the global the client trained from;
the compressed wire formats already ship deltas, and the Server rebases
raw-parameter payloads (``current_global + (params - launch_global)``)
before aggregation, so every reported update applies to the current
global regardless of age.  Weight semantics downstream are unchanged:
zero weight == no contribution under the one ``safe_weight_sum``
denominator, which is exactly how the jitted engine's participation mask
realizes a scheduler decision inside ``round_step``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .cost_model import ClientCost


def deadline_feasible(t_total_s, tau: float | None) -> np.ndarray:
    """Which predicted round times fit a ``Deadline`` cutoff — vectorized
    over a candidate pool.  The scheduler owns deadline semantics, so the
    one predicate cost-aware sampling ranks candidates by lives here: a
    client whose compute+comm lands at exactly ``tau`` still reports
    (``Deadline.plan`` keeps ``finish_t <= round_end``); ``tau`` of None or
    inf means no cutoff — everyone is feasible, matching ``Deadline``
    degenerating to ``SyncAll``."""
    t = np.asarray(t_total_s, np.float64)
    if tau is None or not np.isfinite(tau):
        return np.ones(t.shape, bool)
    return t <= tau


@dataclass
class VirtualClock:
    """Monotone simulated time (seconds since ``Server.run`` started)."""

    now: float = 0.0

    def advance_to(self, t: float) -> None:
        assert t >= self.now - 1e-9, f"virtual clock moving backwards: {self.now} -> {t}"
        self.now = max(self.now, t)


@dataclass
class Arrival:
    """One dispatched client-round: an event on the virtual timeline."""

    client_id: int
    launch_rnd: int            # the round (and thus the global) it trained from
    launch_t: float
    finish_t: float            # launch_t + cost.t_total_s
    cost: ClientCost | None    # None when the Server runs without a cost model
    payload: Any = None        # opaque to the scheduler (the Server's FitRes)
    uplink_bytes: int | None = None  # actual wire size (None = fp32 default)

    def staleness_at(self, rnd: int) -> int:
        return rnd - self.launch_rnd


@dataclass
class RoundOutcome:
    """A policy's verdict on one round's pending arrivals."""

    rnd: int
    round_start: float
    round_end: float
    reported: list[Arrival] = field(default_factory=list)
    dropped: list[Arrival] = field(default_factory=list)    # missed the deadline
    expired: list[Arrival] = field(default_factory=list)    # too stale to accept
    carried: list[Arrival] = field(default_factory=list)    # still in flight

    @property
    def wall_time_s(self) -> float:
        return self.round_end - self.round_start

    @property
    def mean_staleness(self) -> float:
        if not self.reported:
            return 0.0
        return sum(a.staleness_at(self.rnd) for a in self.reported) / len(self.reported)


def _by_arrival(pending: list[Arrival]) -> list[Arrival]:
    """Deterministic event order: finish time, then dispatch round, then id."""
    return sorted(pending, key=lambda a: (a.finish_t, a.launch_rnd, a.client_id))


class RoundPolicy:
    """Decides which pending arrivals a round consumes (module docstring).

    Policies whose verdict is a pure function of *this round's* dispatch
    set and finish times also expose ``plan_arrays``: the same decision as
    tensor code with no host sync, which the multi-round trainer
    (``make_multi_round_step``) runs inside its captured CUDA graph.  A
    policy is ``traceable`` iff its verdict carries no cross-round state:
    ``SyncAll`` and ``Deadline`` qualify; ``BufferedAsync`` does not (its
    pending set is data-dependent-size state threaded *between* rounds).
    """

    traceable: bool = False

    def plan(
        self, clock: VirtualClock, pending: list[Arrival], rnd: int,
        strategy: Any = None,
    ) -> RoundOutcome:
        raise NotImplementedError

    def plan_arrays(self, dispatch_mask, t_total, *, tau: float | None = None):
        """Tensor round verdict: ``(participation_mask, round_end)``.

        ``dispatch_mask`` is the float ``(C,)`` 0/1 mask of clients
        launched this round; ``t_total`` their float32 ``(C,)`` finish
        offsets (compute + comm, seconds from round start).  Returns the
        float ``(C,)`` mask of *reporters* (a subset of the dispatch mask)
        and the round's wall-clock duration as a 0-d float32 tensor, on
        the inputs' device and without a host sync, consistent with
        ``plan`` on the same inputs.  ``tau`` is a host float the caller
        resolved first (``Deadline.resolve_tau``, which is host code); it
        enters the float32 comparisons rounded to float32, as the JAX
        package's weakly typed scalar does.
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no tensor form (traceable=False); "
            "use the event-driven Server.run driver"
        )


@dataclass(frozen=True)
class SyncAll(RoundPolicy):
    """Lockstep FedAvg: wait for everyone; the slowest client ends the round."""

    traceable = True

    def plan(self, clock, pending, rnd, strategy=None):
        order = _by_arrival(pending)
        end = max((a.finish_t for a in order), default=clock.now)
        return RoundOutcome(
            rnd=rnd, round_start=clock.now, round_end=max(end, clock.now),
            reported=order,
        )

    def plan_arrays(self, dispatch_mask, t_total, *, tau=None):
        mask = dispatch_mask
        # empty dispatch -> all-zero where -> end 0.0, matching plan's
        # `default=clock.now` (round_end - round_start == 0)
        end = torch.max(torch.where(mask > 0, t_total, 0.0))
        return mask, end


@dataclass(frozen=True)
class Deadline(RoundPolicy):
    """Cut the round at ``now + tau``; late clients are dropped.

    ``tau=None`` reads the Strategy's deadline (``round_deadline_s``) so
    e.g. ``FedTau(tau_s=...)`` and the scheduler cut at the same instant;
    no deadline anywhere (or ``tau=inf``) degenerates to ``SyncAll``.
    """

    tau: float | None = None
    traceable = True

    def resolve_tau(self, strategy=None) -> float:
        tau = self.tau
        if tau is None and strategy is not None:
            tau = getattr(strategy, "round_deadline_s", lambda: None)()
        return math.inf if tau is None or tau <= 0 else float(tau)

    def plan(self, clock, pending, rnd, strategy=None):
        tau = self.resolve_tau(strategy)
        cutoff = clock.now + tau
        order = _by_arrival(pending)
        reported = [a for a in order if a.finish_t <= cutoff]
        dropped = [a for a in order if a.finish_t > cutoff]
        # no stragglers -> the round ends with the last reporter (no point
        # idling until the cutoff); any straggler -> the server waits the
        # full tau before giving up on them
        end = cutoff if dropped else max(
            (a.finish_t for a in reported), default=clock.now
        )
        return RoundOutcome(
            rnd=rnd, round_start=clock.now, round_end=max(end, clock.now),
            reported=reported, dropped=dropped,
        )

    def plan_arrays(self, dispatch_mask, t_total, *, tau=None):
        # a strategy-deferred tau (self.tau=None + Strategy.round_deadline_s)
        # is resolved by the caller through resolve_tau, on the host
        if tau is None:
            tau = math.inf if self.tau is None or self.tau <= 0 else self.tau
        if not math.isfinite(tau):
            return SyncAll.plan_arrays(self, dispatch_mask, t_total)
        sent = dispatch_mask > 0
        mask = torch.where(sent & (t_total <= tau), 1.0, 0.0)
        missed = torch.max(torch.where(sent & (t_total > tau), 1.0, 0.0))
        # plan's wall rule: any straggler -> the server idles out the full
        # tau; none -> the round ends with the last reporter
        end = torch.where(
            missed > 0, tau, torch.max(torch.where(mask > 0, t_total, 0.0))
        )
        return mask, end


@dataclass(frozen=True)
class BufferedAsync(RoundPolicy):
    """FedBuff-style buffered asynchrony: aggregate the first K usable
    arrivals.

    Anything already staler than ``max_staleness`` this round is expired
    up front (discarded — a stale update only gets MORE stale, so holding
    a buffer slot for it would starve the aggregation of usable updates);
    the round then ends when the K-th *usable* arrival lands — an expired
    straggler NEVER gates the round (waiting for a discarded update is
    exactly the straggler wall this policy exists to avoid; one still in
    flight at round end is simply cancelled, and the Server charges only
    the work that fit before the cutoff).  Everyone usable beyond K stays
    in flight and reports in a later round with staleness
    ``consume_round - launch_round``.
    """

    buffer_size: int = 2       # K
    max_staleness: int = 4

    def plan(self, clock, pending, rnd, strategy=None):
        order = _by_arrival(pending)
        expired = [a for a in order if a.staleness_at(rnd) > self.max_staleness]
        usable = [a for a in order if a.staleness_at(rnd) <= self.max_staleness]
        reported = usable[: self.buffer_size]
        carried = usable[self.buffer_size:]
        end = max((a.finish_t for a in reported), default=clock.now)
        return RoundOutcome(
            rnd=rnd, round_start=clock.now, round_end=max(end, clock.now),
            reported=reported, expired=expired, carried=carried,
        )
