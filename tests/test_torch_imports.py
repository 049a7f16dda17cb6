"""Import hygiene of the port: ``repro_torch``, ``chip_smoke.py``, the
ablation scripts and the card tests' helpers import neither ``jax`` nor
the JAX package ``repro``, so the port runs where JAX is not installed.
An AST scan checks every import statement; a fresh interpreter imports
every kernel module, the mesh launcher, the transformer, the mamba mixer,
the MoE layer, the serving driver, the strategies, the paper-table twin,
the ResNet, the heterogeneous-cutoff example, population mode and the
quickstart, runs a CPU fit (one with FedProx's term), a cost-aware cohort
draw over a packed fleet with a CPU cohort store, a reduced ResNet's loss
and a few reduced CPU decode steps of the dense, the hybrid and the MoE
stack (deepseek-moe-16b), and checks that JAX never loaded; another
imports the paper-table twin and the examples with every CUDA query
refused."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# the mesh tests' rank module runs inside spawned ranks, which start
# without JAX too
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "flash_ablation.py", ROOT / "decode_ablation.py",
    ROOT / "scan_ablation.py", ROOT / "codec_ablation.py", ROOT / "reduce_ablation.py",
    ROOT / "collective_ablation.py", ROOT / "tests" / "torch_mesh_ranks.py",
    ROOT / "tests" / "torch_kernel_models.py",
]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_cpu_fit_never_loads_jax():
    code = """
import sys
import numpy as np
from repro_torch.configs.base import get_config
from repro_torch.core import FitIns, Int8Codec, TorchClient
from repro_torch.data.federated import ClientDataset
from repro_torch.models import build_model
import repro_torch.kernels, repro_torch.launch
import repro_torch.kernels.flash_attention, repro_torch.kernels.decode_attention
import repro_torch.models.transformer, repro_torch.launch.serve
import repro_torch.kernels.selective_scan, repro_torch.models.layers.mamba
import repro_torch.models.layers.moe
from repro_torch.core import CompressedPsum, init_collective_residual
from repro_torch.core import FedAdam, FedBuffStrategy, FedProx, FedTau, STRATEGIES
import repro_torch.benchmarks.paper_tables
import repro_torch.examples.heterogeneous_cutoff
import repro_torch.examples.quickstart
from repro_torch.core import (AvailabilityTrace, CohortState, CostAwareFedAvg, CostModel,
                              LazyClientPool, Population)
from repro_torch.launch.serve import generate

m = build_model(get_config("mobilenet-head-office31").reduced(), device="cpu")
rng = np.random.default_rng(0)
ds = ClientDataset(client_id=0, x=rng.normal(size=(64, 64)).astype(np.float32),
                   y=rng.integers(0, 31, 64).astype(np.int32))
params = m.init(0)
c = TorchClient(client_id=0, loss_fn=m.loss_fn, dataset=ds,
                trainable_mask=m.trainable_mask(params), device="cpu")
res = c.fit(FitIns(parameters=params, config={"epochs": 1, "codec": Int8Codec()}))
assert res.num_examples == 64 and res.metrics["steps_done"] == 2
res = c.fit(FitIns(parameters=params, config=FedProx(mu=0.01).fit_config(1, 0)))
assert res.metrics["steps_done"] == 2
pop = Population.synthetic(1000, seed=0)
cohort = CostAwareFedAvg().sample_cohort(
    1, pop, 8, availability=AvailabilityTrace.from_profiles(pop),
    cost_model=CostModel(profiles=[], update_bytes=1000, population=pop), deadline_s=10.0)
store = CohortState(Int8Codec(), 16, device="cpu")
store.scatter(cohort, store.gather(cohort) + 1.0)
assert len(cohort) == 8 and len(store) == 8
import torch
cnn = build_model(get_config("resnet18-cifar10").reduced(), device="cpu")
loss, met = cnn.loss_fn(cnn.init(0), {"x": torch.zeros(2, 32, 32, 3),
                                      "y": torch.zeros(2, dtype=torch.int32)})
assert loss.isfinite() and set(met) == {"ce", "acc"}
lm = build_model(get_config("qwen3-0.6b").reduced(), device="cpu")
toks = generate(lm, lm.init(0), torch.zeros((1, 8), dtype=torch.int32), n_tokens=3,
                context_len=16)
assert toks.shape == (1, 3)
import dataclasses
hy = build_model(dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(), moe=None),
                 device="cpu")
toks = generate(hy, hy.init(0), torch.zeros((1, 8), dtype=torch.int32), n_tokens=3,
                context_len=16)
assert toks.shape == (1, 3)
moe = build_model(get_config("deepseek-moe-16b").reduced(), device="cpu")
toks = generate(moe, moe.init(0), torch.zeros((1, 8), dtype=torch.int32), n_tokens=3,
                context_len=16)
assert toks.shape == (1, 3)
assert "jax" not in sys.modules and "repro" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_paper_tables_twin_imports_without_a_device():
    """The twin builds its models inside the tables, the example inside
    ``run``: importing them (and the strategies and optimizers they reach)
    asks nothing of CUDA."""
    code = """
import sys
import torch

def refuse(*args, **kw):
    raise AssertionError("CUDA was queried at import")

torch.cuda.is_available = torch.cuda.init = torch.cuda.device_count = refuse
import repro_torch.benchmarks.paper_tables as tables
import repro_torch.examples.heterogeneous_cutoff as example
import repro_torch.examples.quickstart as quickstart
from repro_torch.core import FedAdam, FedAvgM, FedYogi, tau_from_reference_processor
from repro_torch.optim import adam, adamw, yogi
assert callable(tables.table2a) and callable(tables.table2b) and callable(tables.table3)
assert callable(example.run) and callable(quickstart.run)
assert not torch.cuda.is_initialized()
assert "jax" not in sys.modules and "repro" not in sys.modules
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
