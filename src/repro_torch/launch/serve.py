"""Serving driver: prefill + greedy batched decode, the twin of
``repro.launch.serve`` (which runs the ``reduced()`` config, as this
driver's ``main`` does; a config with frontend tokens gets a numpy-drawn
fp32 frontend batch from ``--seed``, as JAX's).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b --device cpu

``--device`` defaults to the card and raises without one.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import Model, build_model


def generate(model: Model, params, tokens: torch.Tensor, *, n_tokens: int,
             context_len: int, frontend: torch.Tensor | None = None) -> torch.Tensor:
    """Prefill ``tokens`` (B, S) int, after ``frontend`` (B, F,
    frontend_dim) embeddings for a config with frontend tokens, then
    ``n_tokens - 1`` greedy decode steps -> the (B, n_tokens) int32 tokens
    generated.  Nothing in the loop waits on the card: the tokens stay on
    it, and the cache's position is a host-side scalar."""
    batch = {"tokens": tokens} if frontend is None else {"tokens": tokens, "frontend": frontend}
    with torch.inference_mode():
        logits, cache = model.prefill(params, batch, context_len)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out = [tok]
        for _ in range(n_tokens - 1):
            logits, cache = model.decode_step(params, {"tokens": tok}, cache, context_len)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            out.append(tok)
        return torch.cat(out, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    tokens = torch.from_numpy(prompt).to(model.device)
    frontend = None
    if cfg.frontend_tokens:
        fd = cfg.frontend_dim or cfg.d_model
        frontend = torch.from_numpy(rng.normal(size=(args.batch, cfg.frontend_tokens, fd))
                                    .astype(np.float32)).to(model.device)

    t0 = time.perf_counter()
    gen = generate(model, params, tokens, n_tokens=args.tokens, context_len=args.context,
                   frontend=frontend)
    gen = gen.cpu().numpy()  # waits for the card
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} generated {gen.shape} tokens in {dt:.2f}s on {model.device}")
    for row in gen[: min(2, args.batch)]:
        print("  ", row.tolist())


if __name__ == "__main__":
    main()
