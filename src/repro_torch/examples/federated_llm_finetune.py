"""End-to-end driver: federated fine-tuning of a transformer LM with the
round step in parallel client mode (``torch.func.vmap`` over the clients)
on a learnable synthetic stream, with a selectable uplink wire format: the
twin of ``examples/federated_llm_finetune.py``.

``--codec lora`` builds the segment-structured ``LoRACodec`` from the model's
own parameter tree (``SegmentMap.from_tree``): matrix leaves ship
rank-``--rank`` factors (int8-quantized), everything else falls back to
plain Int8.  ``--codec int8`` / ``fp32`` run the same loop on the dense wire
for comparison.  The model's attention trains through the hand-written
flash forward and backward kernels on the card, a hybrid's mamba layers
through the selective scan's forward and backward kernels.

Runs a reduced model by default (``--d-model``, ``--layers``); ``--full``
runs the config unreduced (qwen3-0.6b: 596M params, on the card).  The
port trains the dense family (qwen3-0.6b, granite-8b, stablelm-3b), the
MoE family (``--arch mixtral-8x7b`` or ``deepseek-moe-16b``: the loss adds
the router's aux and z terms, and LoRA folds the stacked expert leaves
into matrix segments), MLA (``--arch minicpm3-4b``: LoRA folds the 3-D
projections' leading axes into rows) and the hybrid Mamba stack (``--arch
jamba-1.5-large-398b``: reduced, a mamba and an attention layer with its
4 experts).  An MoE arch, minicpm3-4b or Jamba at ``--full`` does not fit
one card client-parallel (deepseek-moe-16b's 28 layers are 16.4B params,
Mixtral's 32 are 46.7B, minicpm3-4b's 62 are 4.07B, Jamba's 72 are 398B):
train those reduced.  The stream carries tokens alone, as the reference's
does, so a frontend arch (paligemma-3b, musicgen-medium) raises
``ValueError`` for want of ``batch["frontend"]``; xLSTM raises
``NotImplementedError`` naming its ROADMAP.md item.

  python -m repro_torch.examples.federated_llm_finetune --rounds 8
  python -m repro_torch.examples.federated_llm_finetune --device cpu --codec lora
  python -m repro_torch.examples.federated_llm_finetune --arch mixtral-8x7b --codec lora --rank 4
  python -m repro_torch.examples.federated_llm_finetune --arch minicpm3-4b --codec lora
  python -m repro_torch.examples.federated_llm_finetune --arch jamba-1.5-large-398b --codec lora
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import get_config
from repro_torch.core import (
    FedAvg, Int8Codec, LoRACodec, NullCodec, RoundSpec, SegmentMap, make_round_step,
)
from repro_torch.data.loader import lm_round_batch
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.utils.pytree import tree_size


def build_codec(name: str, params, rank: int):
    """-> (codec, int8 reference codec), both on the same segment map so
    the per-round wire comparison is apples-to-apples."""
    segs = SegmentMap.from_tree(params)
    int8 = Int8Codec().with_segments(segs)
    if name == "fp32":
        return NullCodec().with_segments(segs), int8
    if name == "int8":
        return int8, int8
    if name == "lora":
        lora = LoRACodec(
            rank=rank, factor_codec=Int8Codec(), fallback=Int8Codec()
        ).with_segments(segs)
        return lora, int8
    raise ValueError(f"unknown codec {name!r}: expected fp32 | int8 | lora")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="a dense (qwen3-0.6b, granite-8b, stablelm-3b), MoE "
                         "(mixtral-8x7b, deepseek-moe-16b), MLA (minicpm3-4b) or hybrid "
                         "Mamba (jamba-1.5-large-398b) transformer")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--codec", default="fp32", choices=["fp32", "int8", "lora"])
    ap.add_argument("--rank", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="the config unreduced (ignores --d-model and --layers); an MoE "
                         "arch, minicpm3-4b or jamba-1.5-large-398b (398B) unreduced does "
                         "not fit one card")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced(n_layers=args.layers, d_model=args.d_model)
    model = build_model(cfg, device=args.device)
    dev = model.device
    params = model.init(0)
    n_params = tree_size(params)
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M device={dev}")

    codec, int8 = build_codec(args.codec, params, args.rank)
    wire = codec.wire_bytes(n_params)
    print(f"codec={args.codec} uplink {wire/1e3:.1f} KB/client/round "
          f"({int8.wire_bytes(n_params)/wire:.1f}x vs int8 dense)")

    strategy = FedAvg()
    round_step = make_round_step(
        model.loss_fn, sgd(0.1), strategy,
        RoundSpec(max_steps=args.local_steps, execution_mode="parallel", codec=codec),
    )

    weights = torch.ones((args.clients,), device=dev)
    budgets = torch.full((args.clients,), args.local_steps, dtype=torch.int32, device=dev)
    state = strategy.init_state(params)
    client_state = codec.init_client_state(args.clients, n_params, device=dev)
    for rnd in range(1, args.rounds + 1):
        batch = lm_round_batch(
            n_clients=args.clients, steps=args.local_steps, batch_size=args.batch,
            seq_len=args.seq, vocab_size=cfg.vocab_size, seed=rnd,
        )
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, state, client_state, metrics = round_step(
            params, state, client_state, batch, weights, budgets, rnd
        )
        print(f"round {rnd:2d}  mean client CE loss: "
              f"{float(metrics['client_loss_mean']):.4f}")
    return params, float(metrics["client_loss_mean"])


if __name__ == "__main__":
    main()
