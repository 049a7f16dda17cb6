"""Port parity for the paper's tables: ``repro_torch.benchmarks.paper_tables``
against ``benchmarks.paper_tables`` on the CPU, each at one cell.

The twin builds its model inside each table; the test hands it a model
whose ``init(seed)`` returns the JAX package's ``init(jax.random.key(seed))``
as tensors, so both packages start from the same draw and keep the
reference's signatures.  Labels, simulated minutes and kJ are cost-model
arithmetic on identical step counts and bytes, so they must be equal; the
final accuracy (local SGD in two frameworks) within 0.02.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

import benchmarks.paper_tables as jtables
import repro_torch.benchmarks.paper_tables as ttables
from repro_torch.models import build_model, params_from_numpy

CELLS = {
    "table2a": dict(rounds=1, epochs_grid=(1,)),
    "table2b": dict(rounds=1, clients_grid=(4,)),
    "table3": dict(rounds=1, epochs=1),
}


@pytest.fixture
def jax_init(monkeypatch):
    """The twin's models initialize from the JAX package's draw."""
    jhead = jtables._HEAD

    def build(arch, *, device=None):
        m = build_model(arch, device=device)
        init = lambda seed=0: params_from_numpy(
            jax.tree.map(np.asarray, jhead.init(jax.random.key(seed))), m.device)
        return dataclasses.replace(m, init=init)

    monkeypatch.setattr(ttables, "build_model", build)


@pytest.mark.parametrize("table", sorted(CELLS))
def test_paper_table_matches_jax(table, jax_init):
    jrows = getattr(jtables, table)(**CELLS[table])
    trows = getattr(ttables, table)(**CELLS[table], device="cpu")
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    for (label, jacc, jmin, jkj), (_, tacc, tmin, tkj) in zip(jrows, trows, strict=True):
        assert (tmin, tkj) == (jmin, jkj), label
        assert abs(tacc - jacc) <= 0.02, (label, tacc, jacc)
    if table == "table3":
        # the cutoff really cut the CPU fleet's round: less time than tau = 0
        t = {label: minutes for label, _, minutes, _ in trows}
        assert t["CPU tau=GPU"] < t["CPU tau=0"] and t["CPU tau=1.12xGPU"] < t["CPU tau=0"]

