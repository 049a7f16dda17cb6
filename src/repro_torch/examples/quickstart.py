"""Quickstart: federated training of the paper's Android head model —
Server + FedAvg + on-device-style clients + system-cost accounting — then
the same loop at fleet scale: a 16-client cohort sampled per round from a
100k-device packed population (the twin of ``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]

runs on the card unless ``--device cpu`` is given; ``run`` is the same as a
function.
"""
from __future__ import annotations

import argparse

from repro_torch.core import (
    CostModel, FedAvg, LazyClientPool, PROFILES, Population, Server, TorchClient,
)
from repro_torch.core.server import make_cost_model_for
from repro_torch.data.federated import ClientDataset, dirichlet_partition
from repro_torch.data.synthetic import make_features
from repro_torch.models import build_model
from repro_torch.utils.device import resolve_device


def run(device=None, rounds: tuple[int, int] = (5, 3)) -> dict:
    """The list-of-clients loop for ``rounds[0]`` rounds, then population
    mode for ``rounds[1]``; prints what the JAX script prints and returns
    both runs' final params and History, and the population run's pool."""
    device = resolve_device(device)
    model = build_model("mobilenet-head-office31", device=device)  # frozen base + 2-layer head
    data = make_features(n=2000, num_classes=31, feature_dim=model.cfg.feature_dim)
    shards = dirichlet_partition(data, n_clients=5, alpha=1.0)

    params = model.init(0)
    mask = model.trainable_mask(params)                  # FL trains only the head
    clients = [
        TorchClient(client_id=s.client_id, loss_fn=model.loss_fn, dataset=s,
                    batch_size=32, trainable_mask=mask, device_profile="pixel-4",
                    device=device)
        for s in shards
    ]

    cost_model = make_cost_model_for(params, [PROFILES["pixel-4"]] * 5)
    server = Server(strategy=FedAvg(local_epochs=2, local_lr=0.1),
                    clients=clients, cost_model=cost_model, device=device)

    final_params, history = server.run(params, num_rounds=rounds[0])
    print(f"final accuracy: {history.final_accuracy():.3f}")
    print(f"simulated fleet time: {history.total_time_s/60:.2f} min, "
          f"energy: {history.total_energy_j/1e3:.2f} kJ")

    # ---- population mode: the same loop over a 100k-device fleet ----
    # A packed Population stores ~1 byte/device; each round samples a
    # 16-client cohort id-first, and the LazyClientPool materializes only
    # those clients.
    population = Population.synthetic(100_000, seed=0)

    def make_client(cid: int) -> TorchClient:
        shard = shards[cid % len(shards)]          # demo data: reuse the 5 shards
        return TorchClient(client_id=cid, loss_fn=model.loss_fn, batch_size=32,
                           dataset=ClientDataset(client_id=cid, x=shard.x, y=shard.y),
                           trainable_mask=mask,
                           device_profile=population.profile(cid).name, device=device)

    pool = LazyClientPool(population, make_client, capacity=64)
    fleet_server = Server(
        strategy=FedAvg(local_epochs=2, local_lr=0.1),
        clients=pool,
        cost_model=CostModel(profiles=[], update_bytes=cost_model.update_bytes,
                             population=population),
        population=population, cohort_size=16, device=device,
    )
    fleet_params, fleet_history = fleet_server.run(params, num_rounds=rounds[1])
    print(f"population mode ({len(population):,} devices, cohort 16): "
          f"accuracy {fleet_history.final_accuracy():.3f}, "
          f"fleet time {fleet_history.total_time_s/60:.2f} min")
    return {"params": final_params, "history": history, "fleet_params": fleet_params,
            "fleet_history": fleet_history, "pool": pool}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args()
    run(device=args.device)


if __name__ == "__main__":
    main()
