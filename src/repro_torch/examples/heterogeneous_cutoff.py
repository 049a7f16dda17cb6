"""The paper's Table-3 experiment on the port: computational heterogeneity
+ the processor-specific cutoff tau (the twin of
``examples/heterogeneous_cutoff.py``).

A mixed GPU/CPU Jetson fleet trains ResNet-18 with FedTau; run once with
no cutoff and once with tau = the GPU fleet's round time, so CPU clients
ship partial updates and the round wall-clock equalizes.  The same
hardware facts drive per-device codec selection (``BandwidthCodecPolicy``:
the Jetsons' 80 Mbps uplink ships Int8), and the History charges each
client its actual payload bytes.

    python -m repro_torch.examples.heterogeneous_cutoff [--device cpu]

runs the reduced ResNet, as the JAX script does; ``run`` takes any
``CNNConfig`` (``chip_smoke.py`` calls it at full width on the card).
"""
from __future__ import annotations

import argparse

from repro_torch.configs.resnet18_cifar10 import CNN_CONFIG
from repro_torch.core import BandwidthCodecPolicy, FedTau, PROFILES, Server, TorchClient
from repro_torch.core.server import make_cost_model_for
from repro_torch.data.federated import dirichlet_partition
from repro_torch.data.synthetic import make_classification
from repro_torch.models import resnet

# half the fleet is GPU, half CPU (the paper's heterogeneity scenario)
FLEET = ("jetson-tx2-gpu", "jetson-tx2-cpu") * 2


def run(cfg, *, device, rounds: int = 3, profiles=FLEET) -> list[dict]:
    """Both runs (tau = 0, tau = the GPU's round) of ``rounds`` rounds on
    the fleet ``profiles`` (names in ``PROFILES``), each from
    ``resnet.init_params(cfg, 0)``; prints one line a run and returns, per
    run, its label, tau, History and the clients' step budgets."""
    data = make_classification(n=1200, num_classes=cfg.num_classes,
                               shape=(cfg.image_size, cfg.image_size, 3), noise=1.2)
    shards = dirichlet_partition(data, n_clients=len(profiles), alpha=1.0)
    loss_fn = lambda p, b: resnet.loss_fn(cfg, p, b)  # noqa: E731

    params = resnet.init_params(cfg, 0, device=device)
    clients = [TorchClient(client_id=s.client_id, loss_fn=loss_fn, dataset=s,
                           batch_size=32, device_profile=p, device=device)
               for s, p in zip(shards, profiles)]
    cost_model = make_cost_model_for(params, [PROFILES[p] for p in profiles])
    spe = clients[0].steps_per_epoch()
    # slow uplinks sparsify, edge boards quantize (Jetson uplink=80Mbps -> Int8)
    policy = BandwidthCodecPolicy()

    out = []
    for label, tau in [
        ("no cutoff (tau=0)", 0.0),
        ("tau = GPU round time", cost_model.tau_for_profile(
            "jetson-tx2-gpu", epochs=3, steps_per_epoch=spe)),
    ]:
        strat = FedTau(local_epochs=3, local_lr=0.05, tau_s=tau,
                       cost_model=cost_model, steps_per_epoch=spe,
                       codec_policy=policy)
        server = Server(strategy=strat, clients=clients, cost_model=cost_model,
                        device=device)
        server.logger.quiet = True
        p0 = resnet.init_params(cfg, 0, device=device)
        _, hist = server.run(p0, num_rounds=rounds)
        budgets = strat.client_step_budgets(range(len(profiles)))
        comm_mb = sum(r.comm_bytes for r in hist.rounds) / 1e6
        print(f"{label:>24}: acc={hist.final_accuracy():.3f} "
              f"wall={hist.total_time_s/60:.2f}min energy={hist.total_energy_j/1e3:.1f}kJ "
              f"comm={comm_mb:.1f}MB step-budgets={budgets}")
        out.append({"label": label, "tau_s": tau, "history": hist, "budgets": budgets})
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args()
    run(CNN_CONFIG.reduced(), device=args.device)


if __name__ == "__main__":
    main()
