"""Cost-aware client sampling (Oort-lite) — the paper's thesis, one level up
(the twin of ``repro.core.strategy.sampling``).

The scheduler (core/scheduler.py) acts on system costs *after* the blind
draw: ``Deadline(tau)`` drops whoever misses the cutoff and charges their
wasted work.  ``CostAwareSampling`` moves the cost knowledge to the draw
itself: it consults the population's packed cost columns (one vectorized
``expected_round_s`` over the candidate pool) plus the streamed
``AvailabilityTrace`` and prefers clients *predicted to make the deadline*
— fewer drops, less wasted energy, at equal cohort size.

Oort-lite, not Oort: no statistical-utility term (no per-client loss
tracking), just the system-speed half — feasible candidates keep their
random draw order (diversity is preserved: any feasible client is as likely
as any other), and only if feasible candidates run short do infeasible ones
fill the remainder, fastest first.

Compose the mixin MRO-first so its ``sample_cohort`` wins::

    @dataclass
    class CostAwareFedAvg(CostAwareSampling, FedAvg): ...

The mixin only changes *which ids* are drawn in population mode; every
other Strategy surface (configure_fit, aggregation, deadlines) is the
composed strategy's own.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..scheduler import deadline_feasible
from .fedavg import FedAvg


@dataclass
class CostAwareSampling:
    """Mixin overriding ``Strategy.sample_cohort`` with deadline-aware
    preference (see module docstring).  ``expected_steps`` is the predicted
    local work per round (epochs x steps/epoch — the strategy cannot see
    client datasets, so the caller calibrates it); ``oversample`` scales
    the candidate pool the ranking chooses from."""

    oversample: float = 4.0
    expected_steps: int = 20

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
        n = len(population)
        want = min(int(cohort_size), n)
        if want <= 0:
            return []
        rng = np.random.default_rng((self.seed, rnd))
        target = min(n, max(want, int(np.ceil(want * max(1.0, self.oversample)))))
        pool: list[int] = []
        seen = {int(c) for c in exclude}
        for _ in range(16):  # bounded redraws, as in the blind sampler
            if len(pool) >= target:
                break
            cand = rng.integers(0, n, size=max(64, 4 * target))
            if availability is not None:
                cand = cand[availability.available_for(rnd, cand)]
            for c in cand.tolist():
                if c not in seen:
                    seen.add(c)
                    pool.append(c)
                    if len(pool) >= target:
                        break
        if not pool:
            return []
        ids = np.asarray(pool, np.int64)
        # conservative wire estimate: full-precision both ways (a codec can
        # only shrink the uplink, making a feasible client more feasible)
        payload = float(cost_model.update_bytes) if cost_model is not None else 0.0
        t = population.expected_round_s(
            ids, steps=int(self.expected_steps),
            up_bytes=payload, down_bytes=payload,
        )
        tau = deadline_s if deadline_s is not None else self.round_deadline_s()
        ok = deadline_feasible(t, tau)
        ranked = np.concatenate([
            ids[ok],                                        # draw order: diverse
            ids[~ok][np.argsort(t[~ok], kind="stable")],    # then fastest-first
        ])
        return sorted(int(c) for c in ranked[:want])


@dataclass
class CostAwareFedAvg(CostAwareSampling, FedAvg):
    """FedAvg whose population-mode cohorts prefer deadline-feasible
    clients (the straggler_bench comparison row)."""

    name: str = "costaware-fedavg"
