"""Minimal structured logging for the FL server."""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any


@dataclass
class MetricsLogger:
    """Prints one compact line per event (``quiet`` silences it)."""

    name: str = "repro"
    stream: Any = field(default_factory=lambda: sys.stderr)
    quiet: bool = False

    def log(self, event: str, **kv) -> None:
        if not self.quiet:
            kvs = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in kv.items()
            )
            print(f"[{self.name}] {event} {kvs}", file=self.stream)
