"""Update compression codecs: the flat-vector surface of
``repro.core.compression``.

The paper measures communication as a first-class system cost; these codecs
shrink the client->server payload that the cost model charges for:

- ``Int8Codec``: int8 block quantization (~4x over the fp32 wire) through
  the ``quantize_int8`` kernel; the server decodes a whole Int8 group with
  the fused dequantize + weighted-reduce kernel (``dequant_reduce``).
- ``NullCodec``: the identity fp32 wire, reduced by ``fedavg_reduce``.

Codecs operate on the *delta* (client params - global params) as one flat
fp32 vector in JAX leaf order.  ``wire_payload`` / ``from_wire`` are the
exact fields that cross the wire (Int8 trims the encoder's pad; the
receiver re-pads), and ``wire_bytes(n)`` is the per-client uplink charge.

Not ported yet (ROADMAP.md): ``TopKCodec`` and its scatter reduce (queue 2
item 5), the segmented wire and ``LoRACodec``/``MixedCodec`` (queue 1 item
12), the batched (C, N) round-engine surface (queue 1 item 9) and
``CompressedPsum`` (queue 1 item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.utils.pytree import (
    tree_flatten_to_vector,
    tree_sub,
    tree_unflatten_from_vector,
)

PyTree = Any


class UpdateCodec:
    """Base codec: the flat-vector wire.

    Subclasses implement ``encode``/``decode`` and ``_wire_bytes_scalar``.
    """

    def encode(self, delta_vec: torch.Tensor) -> dict:
        raise NotImplementedError

    def decode(self, enc: dict) -> torch.Tensor:
        raise NotImplementedError

    # ---- wire serialization hooks (protocol.CompressedParameters) ----
    def wire_payload(self, enc: dict) -> dict:
        """The exact fields that cross the wire (tensors + python scalars)."""
        return dict(enc)

    def from_wire(self, payload: dict) -> dict:
        """Rebuild the decodable payload from ``wire_payload`` fields."""
        return dict(payload)

    # ---- uplink accounting ----
    def _wire_bytes_scalar(self, n_params: int) -> int:
        raise NotImplementedError

    def wire_bytes(self, n_params):
        """Uplink bytes for an ``n_params``-sized update.

        Accepts an int (homogeneous fleet) or a sequence of per-client sizes
        and returns an int or list respectively."""
        if isinstance(n_params, (list, tuple, np.ndarray)):
            return [self._wire_bytes_scalar(int(n)) for n in np.asarray(n_params).reshape(-1)]
        return self._wire_bytes_scalar(int(n_params))


@dataclass(frozen=True)
class NullCodec(UpdateCodec):
    """Identity codec: full-precision fp32 wire (the uncompressed baseline)."""

    def _wire_bytes_scalar(self, n_params: int) -> int:
        return 4 * n_params

    def encode(self, delta_vec: torch.Tensor) -> dict:
        return {"delta": delta_vec.to(torch.float32), "n": delta_vec.shape[0]}

    def decode(self, enc: dict) -> torch.Tensor:
        return enc["delta"]


@dataclass(frozen=True)
class Int8Codec(UpdateCodec):
    block: int = 256

    def _n_scales(self, n_params: int) -> int:
        return -(-n_params // self.block)  # ceil: encode pads to a block multiple

    def _wire_bytes_scalar(self, n_params: int) -> int:
        # int8 payload (pad blocks need not cross the wire: the receiver
        # re-pads from n) + one fp32 scale per ceil(n/block) block
        return n_params + 4 * self._n_scales(n_params)

    def encode(self, delta_vec: torch.Tensor) -> dict:
        n = delta_vec.shape[0]
        padded = F.pad(delta_vec, (0, (-n) % self.block))
        q, scale = ops.quantize_int8(padded, block=self.block)
        return {"q": q, "scale": scale, "n": n}

    def decode(self, enc: dict) -> torch.Tensor:
        vec = ops.dequantize_int8(enc["q"], enc["scale"], block=self.block)
        return vec[: enc["n"]]

    def wire_payload(self, enc: dict) -> dict:
        # pad int8s never cross the wire: trim to n, the receiver re-pads
        return {"q": enc["q"][: enc["n"]], "scale": enc["scale"], "n": enc["n"]}

    def from_wire(self, payload: dict) -> dict:
        n = payload["n"]
        return {
            "q": F.pad(payload["q"], (0, (-n) % self.block)),
            "scale": payload["scale"],
            "n": n,
        }


@dataclass(frozen=True)
class BandwidthCodecPolicy:
    """Per-device codec selection from the client's measured uplink.

    The Strategy consults this in ``configure_fit``: mid-tier edge boards
    get Int8 and datacenter-class backbone links ship the full-precision
    wire.  Phone-class uplinks (below ``topk_below_mbps``) get TopK in the
    JAX package; the port raises for them until TopK is ported.
    """

    topk_below_mbps: float = 30.0       # Pixel-class cellular uplinks
    null_above_mbps: float = 100_000.0  # TPU-class datacenter backbone
    int8: Int8Codec = Int8Codec()
    null: NullCodec = NullCodec()

    def codec_for(self, properties) -> UpdateCodec:
        """properties: protocol.ClientProperties (or any .uplink_mbps owner)."""
        if properties.uplink_mbps >= self.null_above_mbps:
            return self.null
        if properties.uplink_mbps < self.topk_below_mbps:
            raise NotImplementedError(
                f"a {properties.uplink_mbps} Mbit/s uplink gets TopKCodec, which "
                "is not ported yet (ROADMAP.md queue 2 item 5)"
            )
        return self.int8


def compress_update(
    codec, new_params: PyTree, global_params: PyTree, residual=None
) -> tuple[dict, torch.Tensor]:
    """-> (codec payload, new_residual) for error feedback.

    ``residual`` is the client's carried error-feedback state (one
    (n_params,) fp32 vector, folded into the delta before encoding); None
    means no carried state."""
    delta = tree_flatten_to_vector(tree_sub(new_params, global_params))
    if residual is not None:
        delta = delta + residual
    enc = codec.encode(delta)
    new_residual = delta - codec.decode(enc)
    return enc, new_residual


def decompress_update(codec, enc: dict, global_params: PyTree) -> PyTree:
    delta = codec.decode(enc)
    flat_global = tree_flatten_to_vector(global_params)
    return tree_unflatten_from_vector(flat_global + delta, global_params)
