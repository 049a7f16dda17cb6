"""Update compression codecs: the flat-vector surface of
``repro.core.compression`` and its batched (C, N) round-engine surface.

The paper measures communication as a first-class system cost; these codecs
shrink the client->server payload that the cost model charges for:

- ``Int8Codec``: int8 block quantization (~4x over the fp32 wire) through
  the ``quantize_int8`` kernel; the server decodes a whole Int8 group with
  the fused dequantize + weighted-reduce kernel (``dequant_reduce``).
- ``TopKCodec``: the k largest-|.| entries with error feedback, for
  phone-class uplinks; the server reduces the (idx, val) wires with the
  scatter-accumulate kernel (``topk_scatter_reduce``) in O(C*k), never a
  dense (C, N) matrix.
- ``NullCodec``: the identity fp32 wire, reduced by ``fedavg_reduce`` (or,
  in the round engine, a leafwise weighted mean).

Codecs operate on the *delta* (client params - global params) as one flat
fp32 vector in JAX leaf order.  ``wire_payload`` / ``from_wire`` are the
exact fields that cross the wire (Int8 trims the encoder's pad; the
receiver re-pads), and ``wire_bytes(n)`` is the per-client uplink charge.

The round engine (``core/rounds.py``) programs against the batched
surface: ``init_client_state`` (the per-client error-feedback residual
rows, none for Null), ``aggregate_updates`` / ``aggregate_batch`` (fold the
residual in, encode the (C, N) deltas, reduce straight off the encoded
payload, return the new residual) and ``transmit_tree`` (one client's
encode -> decode, for the sequential mode).

One layer down, ``CompressedPsum`` is the wire of the mesh round step's
all-reduce (``collective="int8"``): each rank's partial weighted sum as
int8-valued codes on a block scale shared by every rank.

Not ported yet (ROADMAP.md): the segmented wire and ``LoRACodec`` /
``MixedCodec`` (queue 1 item 12).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, ClassVar

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (
    safe_weight_sum,
    tree_flatten_to_vector,
    tree_leaves,
    tree_map,
    tree_sub,
    tree_unflatten_from_vector,
)

PyTree = Any


class UpdateCodec:
    """Base codec: error-feedback residual state + flat-vector wire.

    Subclasses implement the wire format (``encode``/``decode``, their
    batched variants, ``reduce`` and ``_wire_bytes_scalar``); the state and
    transport machinery below is shared.  ``NullCodec`` overrides the state
    hooks to be stateless/identity.
    """

    def encode(self, delta_vec: torch.Tensor) -> dict:
        raise NotImplementedError

    def decode(self, enc: dict) -> torch.Tensor:
        raise NotImplementedError

    def encode_batch(self, deltas: torch.Tensor) -> dict:
        raise NotImplementedError

    def decode_batch(self, enc: dict) -> torch.Tensor:
        raise NotImplementedError

    def reduce(self, enc: dict, weights: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # ---- per-client state (carried by round_step across rounds) ----
    def init_client_state(self, n_clients: int, n_params: int, device=None) -> PyTree:
        """Zero error-feedback state: one flat fp32 residual row per client,
        on ``device`` (None: the card)."""
        return torch.zeros(n_clients, n_params, dtype=torch.float32,
                           device=resolve_device(device))

    def carries_client_state(self, n_params: int = 1) -> bool:
        """Whether this codec owns round-to-round per-client state (probes a
        one-client state on the meta device, which allocates nothing)."""
        return bool(tree_leaves(self.init_client_state(1, n_params, device="meta")))

    # ---- batched (C, N) surface: the parallel round step ----
    def aggregate_updates(self, client_params: PyTree, global_params: PyTree,
                          weights: torch.Tensor, state):
        """Per-client params (leaves lead with C) -> (avg params, state):
        flatten the deltas to the (C, N) wire layout and aggregate off the
        encoded payload (``aggregate_batch``)."""
        flat_global = tree_flatten_to_vector(global_params)
        c = tree_leaves(client_params)[0].shape[0]
        deltas = torch.cat(
            [x.to(torch.float32).reshape(c, -1) for x in tree_leaves(client_params)], dim=1
        ) - flat_global
        avg_delta, new_state = self.aggregate_batch(deltas, weights, state)
        return tree_unflatten_from_vector(flat_global + avg_delta, global_params), new_state

    def aggregate_batch(self, deltas: torch.Tensor, weights: torch.Tensor, state):
        """(C, N) deltas + state -> (weighted-mean decoded delta (N,), new
        state).  Error feedback in, encode, reduce off the encoded payload;
        what was not transmitted becomes the next residual."""
        eff = deltas + state
        enc = self.encode_batch(eff)
        new_state = eff - self.decode_batch(enc)
        return self.reduce(enc, weights), new_state

    # ---- per-client surface: the sequential round step ----
    def transmit_tree(self, delta_tree: PyTree, state_row):
        """One client's uplink: -> (decoded delta tree, new state row), the
        tree holding exactly what survives encode -> decode."""
        vec = tree_flatten_to_vector(delta_tree)
        dec, new_row = self.transmit_segment(vec, state_row)
        return tree_unflatten_from_vector(dec, delta_tree), new_row

    def transmit_segment(self, vec: torch.Tensor, state_row):
        """One client's flat uplink: (vec (N,), residual row) -> (decoded
        (N,), new row)."""
        eff = vec + state_row
        dec = self.decode(self.encode(eff))
        return dec, eff - dec

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
    """Identity codec: full-precision fp32 wire (the uncompressed baseline).

    Stateless: ``init_client_state`` is empty, ``transmit_tree`` is the
    identity on the delta pytree, and ``aggregate_updates`` is a leafwise
    weighted mean that never builds the flat (C, N) matrix.
    """

    def _wire_bytes_scalar(self, n_params: int) -> int:
        return 4 * n_params

    def init_client_state(self, n_clients: int, n_params: int, device=None) -> PyTree:
        return ()

    def aggregate_updates(self, client_params, global_params, weights, state):
        """Leafwise fp32 weighted mean: the fp32 wire loses nothing."""
        wf = weights.to(torch.float32)
        wsum = safe_weight_sum(wf)

        def leaf_mean(xs, g):
            wshape = (xs.shape[0],) + (1,) * (xs.dim() - 1)
            gf = g.to(torch.float32)
            acc = torch.sum((xs.to(torch.float32) - gf) * wf.reshape(wshape), dim=0)
            return (gf + acc / wsum).to(g.dtype)

        return tree_map(leaf_mean, client_params, global_params), state

    def aggregate_batch(self, deltas, weights, state):
        return self.reduce(self.encode_batch(deltas), weights), state

    def transmit_tree(self, delta_tree, state_row):
        return delta_tree, state_row

    def encode(self, delta_vec: torch.Tensor) -> dict:
        return {"delta": delta_vec.to(torch.float32), "n": delta_vec.shape[0]}

    def decode(self, enc: dict) -> torch.Tensor:
        return enc["delta"]

    def encode_batch(self, deltas: torch.Tensor) -> dict:
        return {"delta": deltas.to(torch.float32), "n": deltas.shape[1]}

    def decode_batch(self, enc: dict) -> torch.Tensor:
        return enc["delta"]

    def reduce(self, enc: dict, weights: torch.Tensor) -> torch.Tensor:
        return ops.fedavg_reduce(enc["delta"], weights)


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
        # the codes of the delta padded with zeros to a block multiple: on
        # the card the pad is inside the one quantize launch
        q, scale = ops.quantize_int8(delta_vec, block=self.block)
        return {"q": q, "scale": scale, "n": delta_vec.shape[0]}

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

    # ---- batched (C, N) wire path used inside the round step ----
    def encode_batch(self, deltas: torch.Tensor) -> dict:
        """(C, N) -> q (C, Np) int8 + scales (C, Np/block); Np = padded N.
        Rows are padded to a block multiple, so the flattened (C*Np,) keeps
        every block inside one client row: one quantize launch."""
        c, n = deltas.shape
        padded = F.pad(deltas, (0, (-n) % self.block))
        np_ = padded.shape[1]
        q, scale = ops.quantize_int8(padded.reshape(-1), block=self.block)
        return {"q": q.reshape(c, np_), "scale": scale.reshape(c, np_ // self.block), "n": n}

    def decode_batch(self, enc: dict) -> torch.Tensor:
        c = enc["q"].shape[0]
        vec = ops.dequantize_int8(
            enc["q"].reshape(-1), enc["scale"].reshape(-1), block=self.block
        )
        return vec.reshape(c, -1)[:, : enc["n"]]

    def reduce(self, enc: dict, weights: torch.Tensor) -> torch.Tensor:
        """Weighted-mean decode straight off the int8 payload (fused kernel)."""
        avg = ops.dequant_reduce(enc["q"], enc["scale"], weights, block=self.block)
        return avg[: enc["n"]]


@dataclass(frozen=True)
class TopKCodec(UpdateCodec):
    """Keep the k largest-|.| entries; the residual feeds back next round.

    Wire contract (the O(C*k) reduce rests on it), the JAX package's bit
    for bit:

    - selection is deterministic: a stable ascending sort of -|x| (ties go
      to the lower index, NaN sorts last), the first k, re-sorted to the
      canonical ascending-index wire order;
    - ``idx`` is int32 on the wire (8 bytes an entry with the fp32 value);
    - every consumer treats duplicate indices as scatter-ADD and drops
      out-of-range ones, so a foreign payload means the same on all paths;
    - ``reduce`` consumes (idx, val) through the scatter-accumulate kernel;
      ``decode_batch`` is the explicit densify for callers that want the
      dense per-client matrix (no reduce or error-feedback path calls it).
    """

    frac: float = 0.01

    def k_of(self, n_params: int) -> int:
        return max(1, math.floor(n_params * self.frac))

    def _wire_bytes_scalar(self, n_params: int) -> int:
        return self.k_of(n_params) * 8  # int32 index + fp32 value

    @staticmethod
    def _topk_idx(mags: torch.Tensor, k: int) -> torch.Tensor:
        """Top-k positions along the last axis, ascending, int32.  Not
        ``torch.topk`` (unstable ties) and not ``descending=True`` (which
        puts NaN first, where JAX's ascending sort of -|x| puts it last)."""
        order = torch.sort(-mags.to(torch.float32), dim=-1, stable=True).indices
        return torch.sort(order[..., :k], dim=-1).values.to(torch.int32)

    @staticmethod
    def _scatter_add(zeros: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
        """zeros[..., idx] += val along the last axis; out-of-range indices
        are dropped (never wrapped), as the reduce drops them."""
        n = zeros.shape[-1]
        valid = (idx >= 0) & (idx < n)
        safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
        return zeros.scatter_add_(-1, safe, torch.where(valid, val, torch.zeros_like(val)))

    def encode(self, delta_vec: torch.Tensor) -> dict:
        n = delta_vec.shape[0]
        idx = self._topk_idx(delta_vec.abs(), self.k_of(n))
        return {"idx": idx, "val": delta_vec[idx.long()], "n": n}

    def decode(self, enc: dict) -> torch.Tensor:
        val = enc["val"]
        return self._scatter_add(
            torch.zeros(enc["n"], dtype=val.dtype, device=val.device), enc["idx"], val
        )

    def encode_batch(self, deltas: torch.Tensor) -> dict:
        n = deltas.shape[1]
        idx = self._topk_idx(deltas.abs(), self.k_of(n))  # (C, k)
        return {"idx": idx, "val": torch.gather(deltas, 1, idx.long()), "n": n}

    def decode_batch(self, enc: dict) -> torch.Tensor:
        """Densify: the dense (C, n) matrix, for callers that want it."""
        val = enc["val"]
        zeros = torch.zeros(val.shape[0], enc["n"], dtype=val.dtype, device=val.device)
        return self._scatter_add(zeros, enc["idx"], val)

    def aggregate_batch(self, deltas: torch.Tensor, weights: torch.Tensor, state):
        """O(C*k) end to end: encode, scatter-reduce straight off the
        payload, and zero the transmitted coordinates out of the residual
        (TopK transmits exact values), no dense decode."""
        eff = deltas + state
        enc = self.encode_batch(eff)
        new_state = eff.scatter(1, enc["idx"].long(), 0.0)
        return self.reduce(enc, weights), new_state

    def transmit_segment(self, vec: torch.Tensor, state_row):
        """One client: the decode stays (N,), and the next residual row
        zeroes the transmitted coordinates in O(k)."""
        eff = vec + state_row
        enc = self.encode(eff)
        return self.decode(enc), eff.index_fill(0, enc["idx"].long(), 0.0)

    def reduce(self, enc: dict, weights: torch.Tensor) -> torch.Tensor:
        return ops.topk_scatter_reduce(enc["idx"], enc["val"], weights, enc["n"])


@dataclass(frozen=True)
class BandwidthCodecPolicy:
    """Per-device codec selection from the client's measured uplink.

    The Strategy consults this in ``configure_fit``: slow phone-class
    uplinks get TopK sparsification, mid-tier edge boards get Int8, and
    datacenter-class backbone links ship the full-precision wire.
    """

    topk_below_mbps: float = 30.0       # Pixel-class cellular uplinks
    null_above_mbps: float = 100_000.0  # TPU-class datacenter backbone
    topk: TopKCodec = TopKCodec(frac=0.01)
    int8: Int8Codec = Int8Codec()
    null: NullCodec = NullCodec()

    def codec_for(self, properties) -> UpdateCodec:
        """properties: protocol.ClientProperties (or any .uplink_mbps owner)."""
        if properties.uplink_mbps >= self.null_above_mbps:
            return self.null
        if properties.uplink_mbps < self.topk_below_mbps:
            return self.topk
        return self.int8


# ---------------- compressed collective: the mesh all-reduce's wire ----------------
@dataclass(frozen=True)
class CompressedPsum:
    """int8 wire-compressed hierarchical all-reduce for the mesh round step.

    The twin of ``repro.core.compression.CompressedPsum``, with
    ``torch.distributed`` process groups in place of shard_map's axes.  Per
    operand (one model leaf):

    1. fold in this rank's error-feedback residual: ``eff = wx + r``;
    2. per-256-block absmax of ``eff``, then a MAX all-reduce over every
       tier's group, inner tier first: a 4-byte-a-block sidecar that makes
       the scale a collective decision, so every rank rounds against the
       same grid and the codes sum exactly;
    3. pack: int8-valued codes in an int32 container (|q| <= 127, so the
       int32 sum cannot overflow below a 2**31/127 ~= 16.9M fan-in);
    4. a SUM all-reduce of the codes per tier, inner tier first (the fp32
       path's hop order);
    5. one unpack after the last hop.

    The residual ``eff - unpack(pack(eff))`` stays on the rank that made
    it, so the quantized sum telescopes across rounds like the uplink
    codecs' error feedback.  ``groups`` are the tiers' process groups
    ordered outer -> inner like the mesh's client axes; an empty sequence
    reduces over nothing (one rank).  The block is the kernels' 256.

    ``psum_leaves`` runs every leaf of the operand tree at once, as the
    mesh round step calls it: one ``ops.collective_absmax``, one MAX
    all-reduce a tier over all leaves' absmax, one
    ``ops.collective_pack_leaves``, one SUM all-reduce a tier over all
    codes, one ``ops.collective_unpack``.  MAX over fp32 and SUM over int32
    are elementwise and exact, so that is bitwise the reference's per-leaf
    ``psum``.
    """

    block: ClassVar[int] = ops.BLOCK

    def psum_leaves(self, ds, wf, residuals, groups, live=None):
        """Every leaf's compressed hierarchical all-reduce, at once.

        ``ds``: (n_i,) fp32 leaves whose weighted sum is reduced, ``wf``: this
        rank's weight, one fp32 on their device, folded in as ``d * wf``
        (None: the leaves are already weighted); ``residuals``: (n_i,) fp32,
        this rank's error-feedback rows; ``live``: one bool, False for a
        masked rank, which sends nothing (not even its residual) and keeps
        its rows (None: the rank takes part).  Returns ``(totals,
        new_residuals)``, lists of (n_i,) fp32 views of two flat buffers:
        the sum over ranks of the quantized ``d * wf + residual``, and this
        rank's next residuals."""
        absmax = ops.collective_absmax(ds, wf, residuals, live)
        for group in reversed(tuple(groups)):
            dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        q, scales, new_flat = ops.collective_pack_leaves(ds, wf, residuals, absmax, live)
        for group in reversed(tuple(groups)):
            dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
        total_flat = ops.collective_unpack(q, scales)
        starts = [b * self.block for b in ops.first_blocks(d.shape[0] for d in ds)]
        totals = [total_flat[a:a + d.shape[0]] for a, d in zip(starts, ds)]
        return totals, [new_flat[a:a + d.shape[0]] for a, d in zip(starts, ds)]

    def psum(self, wx: torch.Tensor, residual: torch.Tensor, groups):
        """One operand's compressed hierarchical all-reduce.

        ``wx``: (n,) fp32, this rank's partial weighted sum; ``residual``:
        (n,) fp32, its error-feedback carry (zeros for a masked rank: the
        caller owns participation).  Returns ``(total, new_residual)``: the
        fp32 sum over ranks of the quantized ``wx + residual``, and this
        rank's next residual."""
        (total,), (new_residual,) = self.psum_leaves([wx], None, [residual], groups)
        return total, new_residual

    def collective_bytes(self, n: int) -> int:
        """Bytes ONE rank moves across ONE hop for an n-element operand:
        the int8 payload (1 B/elem; int32 is the accumulator, not the wire),
        the fp32 scale sidecar and the 4-byte fp32 weight denominator."""
        return int(n) + 4 * math.ceil(int(n) / self.block) + 4


def fp32_collective_bytes(n: int) -> int:
    """The uncompressed counterpart of ``CompressedPsum.collective_bytes``:
    the fp32 payload + the same 4-byte weight-denominator sidecar a hop."""
    return 4 * int(n) + 4


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
