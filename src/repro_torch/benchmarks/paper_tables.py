"""Paper-table reproductions on the port (twin of ``benchmarks/paper_tables.py``).

Each function mirrors one table of "On-device Federated Learning with
Flower" with synthetic data and the calibrated cost model, and returns rows
``[(label, accuracy, sim_minutes, sim_kJ)]``.  The claims under test are the
TRENDS: Table 2a, more local epochs cost more time and energy; Table 2b,
more clients cost more energy at a flat wall; Table 3, a processor-specific
cutoff tau brings the CPU fleet's wall down to the GPU fleet's.

Every table runs the frozen-base head model ``mobilenet-head-office31`` at
full width (the JAX package uses it as ResNet-18's stand-in).  The model is
built inside each function on ``device`` (None: the CUDA card), so importing
this module touches no device.  Run:

    python -m repro_torch.benchmarks.paper_tables [--device cpu] [--rounds R]
"""
from __future__ import annotations

import argparse

from repro_torch.core import FedAvg, FedTau, PROFILES, Server, TorchClient
from repro_torch.core.server import make_cost_model_for
from repro_torch.data.federated import dirichlet_partition
from repro_torch.data.synthetic import make_features
from repro_torch.models import build_model

HEAD = "mobilenet-head-office31"


def _row(label: str, hist) -> tuple:
    return (label, hist.final_accuracy(), hist.total_time_s / 60, hist.total_energy_j / 1e3)


def _run(strategy, clients, params, cost_model, rounds: int, device):
    server = Server(strategy=strategy, clients=clients, cost_model=cost_model, device=device)
    server.logger.quiet = True
    return server.run(params, num_rounds=rounds)[1]


def _head_setup(n_clients: int, seed: int, device):
    """``n_clients`` head-model clients on 1200 synthetic feature rows
    (label-Dirichlet alpha = 1), and the model's init from ``seed``."""
    m = build_model(HEAD, device=device)
    data = make_features(n=1200, num_classes=31, feature_dim=m.cfg.feature_dim, seed=seed)
    shards = dirichlet_partition(data, n_clients=n_clients, alpha=1.0, seed=seed)
    params = m.init(seed)
    mask = m.trainable_mask(params)
    clients = [
        TorchClient(client_id=c.client_id, loss_fn=m.loss_fn, dataset=c, batch_size=32,
                    trainable_mask=mask, device=device)
        for c in shards
    ]
    return params, clients


def table2a(rounds: int = 2, epochs_grid=(1, 3, 5), device=None) -> list[tuple]:
    """Vary local epochs E on the Jetson TX2 GPU fleet.

    Paper Table 2a: E up => accuracy up, time up, energy up."""
    rows = []
    for e in epochs_grid:
        params, clients = _head_setup(4, 0, device)
        cm = make_cost_model_for(params, [PROFILES["jetson-tx2-gpu"]] * 4)
        hist = _run(FedAvg(local_epochs=e, local_lr=0.05), clients, params, cm, rounds, device)
        rows.append(_row(f"E={e}", hist))
    return rows


def table2b(rounds: int = 2, clients_grid=(4, 7, 10), device=None) -> list[tuple]:
    """Vary client count C on the Android fleet (head model, Office-31-like).

    Paper Table 2b: C up => accuracy up, energy up, wall ~flat."""
    m = build_model(HEAD, device=device)
    fleet = [PROFILES[name] for name in
             ("pixel-4", "pixel-3", "pixel-2", "galaxy-tab-s6", "galaxy-tab-s4")]
    rows = []
    for c in clients_grid:
        # each participating device contributes ITS OWN data (the paper's
        # setting): total examples scale with C, per-client size is fixed
        data = make_features(n=250 * c, num_classes=31, feature_dim=m.cfg.feature_dim, seed=1)
        shards = dirichlet_partition(data, n_clients=c, alpha=0.5, seed=1)
        params = m.init(1)
        mask = m.trainable_mask(params)
        clients = [
            TorchClient(client_id=s.client_id, loss_fn=m.loss_fn, dataset=s, batch_size=32,
                        trainable_mask=mask, device=device)
            for s in shards
        ]
        cm = make_cost_model_for(params, [fleet[i % len(fleet)] for i in range(c)])
        hist = _run(FedAvg(local_epochs=5, local_lr=0.1), clients, params, cm, rounds, device)
        rows.append(_row(f"C={c}", hist))
    return rows


def table3(rounds: int = 2, epochs: int = 3, device=None) -> list[tuple]:
    """Computational heterogeneity + processor-specific cutoff tau.

    Paper Table 3: CPU (tau=0) ~1.27x the GPU's time at equal accuracy;
    tau = the GPU round time equalizes walls at a small accuracy drop."""

    def run(profile: str, tau_mult: float | None):
        params, clients = _head_setup(4, 2, device)
        spe = clients[0].steps_per_epoch()
        cm = make_cost_model_for(params, [PROFILES[profile]] * 4)
        tau = 0.0 if tau_mult is None else cm.tau_for_profile(
            "jetson-tx2-gpu", epochs=epochs, steps_per_epoch=spe) * tau_mult
        strat = FedTau(local_epochs=epochs, local_lr=0.05, tau_s=tau, cost_model=cm,
                       steps_per_epoch=spe)
        return _run(strat, clients, params, cm, rounds, device)

    return [
        _row("GPU tau=0", run("jetson-tx2-gpu", None)),
        _row("CPU tau=0", run("jetson-tx2-cpu", None)),
        # the paper's tau = 2.23 min is ~1.12x the GPU round
        _row("CPU tau=1.12xGPU", run("jetson-tx2-cpu", 1.12)),
        # the paper's tau = 1.99 min is the GPU round time
        _row("CPU tau=GPU", run("jetson-tx2-cpu", 1.0)),
    ]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    for name, table in (("table2a", table2a), ("table2b", table2b), ("table3", table3)):
        for label, acc, minutes, kj in table(rounds=args.rounds, device=args.device):
            print(f"{name} {label}: acc {acc:.4f}, {minutes:.4f} sim min, {kj:.4f} sim kJ")


if __name__ == "__main__":
    main()
