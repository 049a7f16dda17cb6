"""Update compression codecs: the twin of ``repro.core.compression``.

The paper measures communication as a first-class system cost; these codecs
shrink the client->server payload that the cost model charges for:

- ``Int8Codec``: int8 block quantization (~4x over the fp32 wire) through
  the ``quantize_int8`` kernel; the server decodes a whole Int8 group with
  the fused dequantize + weighted-reduce kernel (``dequant_reduce``).
- ``TopKCodec``: the k largest-|.| entries with error feedback, for
  phone-class uplinks; the server reduces the (idx, val) wires with the
  scatter-accumulate kernel (``topk_scatter_reduce``) in O(C*k), never a
  dense (C, N) matrix.
- ``LoRACodec``: low-rank factors for matrix-shaped segments (the wire
  format below), a fallback codec for the rest.
- ``NullCodec``: the identity fp32 wire, reduced by ``fedavg_reduce`` (or,
  in the round engine, a leafwise weighted mean).
- ``MixedCodec``: a codec bank with a static per-client group assignment,
  so a heterogeneous fleet runs one round with each group on its own
  kernels (the mixed-batch contract below).

Codecs operate on the *delta* (client params - global params) as fp32 in
JAX leaf order.  ``wire_payload`` / ``from_wire`` are the exact fields that
cross the wire (Int8 trims the encoder's pad; the receiver re-pads), and
``wire_bytes(n)`` is the per-client uplink charge.

The segmented wire (``SegmentMap`` / ``StructuredUpdate``)
----------------------------------------------------------

A ``SegmentMap`` is a static tuple of ``Segment(name, shape, offset)``
records tiling ``[0, n_params)``: one a model leaf (``from_tree``, named as
``jax.tree_util.keystr`` names them), or the one segment of
``SegmentMap.flat(n)``.  ``codec.with_segments(segmap)`` returns a
segmented copy; with ``segments=None`` every codec runs the flat code, and
``SegmentMap.flat(n)`` is bitwise that flat code.  Under a map:

- ``init_client_state`` is a tuple with one entry a segment: (C, seg.size)
  fp32 residual rows for a stateful segment, ``()`` for a stateless one;
- encode and decode run per segment (``encode_segment`` /
  ``decode_segment``), and a whole update's payload is a
  ``StructuredUpdate``: the map and one payload a segment, whose wire
  fields the protocol names ``s{i}.<key>``;
- ``aggregate_updates`` and ``transmit_tree`` work leaf by leaf when the
  map matches the model's leaves, and slice the flat vector otherwise;
  ``aggregate_batch`` reduces each segment's column block on the same
  kernels as the flat path, so every kernel sees per-segment shapes (a
  segment's start in a flat vector is any multiple of 4 bytes);
- ``wire_bytes`` is the sum of ``segment_wire_bytes(seg)``;
- TopK keeps ``k_of(seg.size)`` entries of every segment, so a segmented
  TopK run is not the flat run; only ``SegmentMap.flat`` is.

The LoRA wire (``LoRACodec``)
-----------------------------

A matrix segment (``seg.ndim >= 2``, folded to ``(prod(shape[:-1]),
shape[-1])``) whose factors at the effective rank ``r = min(rank, m, n)``
are strictly cheaper than the fallback's wire ships PowerSGD-style factors:
``A (m, r)``, the orthonormalized ``X @ q``, and ``B (r, n) = A.T @ X``,
each through ``factor_codec``.  The random basis ``q`` comes from ``(seed,
seg.offset)`` alone (``segment_basis``), so clients and server agree on it
and it never crosses the wire.  It is the port's own draw (a CPU
``torch.Generator``), not the JAX package's threefry draw: a port LoRA run
reconstructs from other bases than a JAX run under the same wire contract.
The factorization error feeds back through the segment's residual rows.
Every other segment belongs to ``fallback`` (default Int8) wholesale.

The mixed-batch contract (``MixedCodec``)
-----------------------------------------

The assignment is static python data, so the client axis splits into
per-codec groups when the round is built; each group's index tensor is
made once a device and kept, so a captured round copies nothing from the
host.  Each group encodes and reduces on its own codec's path and yields
its partial weighted sum; the groups combine under one fleet-wide
``safe_weight_sum`` denominator.  ``init_client_state`` is a tuple, one
entry a bank codec; ``wire_bytes`` is one size a client.  The per-client
surfaces raise ``TypeError`` (a client belongs to one group: dispatch
through ``groups()``).  Bank codecs may carry one segment map
(``with_segments`` maps the whole bank); conflicting maps are refused.

The round engine (``core/rounds.py``) programs against the batched
surface: ``init_client_state``, ``aggregate_updates`` / ``aggregate_batch``
(fold the residual in, encode the (C, N) deltas, reduce straight off the
encoded payload, return the new residual) and ``transmit_tree`` (one
client's encode -> decode, for the sequential mode).

One layer down, ``CompressedPsum`` is the wire of the mesh round step's
all-reduce (``collective="int8"``): each rank's partial weighted sum as
int8-valued codes on a block scale shared by every rank.
"""
from __future__ import annotations

import dataclasses
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
    tree_leaves_with_path,
    tree_map,
    tree_sub,
    tree_unflatten,
    tree_unflatten_from_vector,
)

PyTree = Any


# ---------------- segment map: the static leaf layout of an update ----------------
@dataclass(frozen=True)
class Segment:
    """One contiguous span of the flat update: a leaf's shape at an offset."""

    name: str
    shape: tuple
    offset: int

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(d) for d in self.shape))
        object.__setattr__(self, "offset", int(self.offset))

    @property
    def size(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def matrix_shape(self) -> tuple:
        """The 2-D view a low-rank codec factorizes: leading axes fold into
        rows, (..., m, n) -> (prod(leading) * m, n)."""
        assert self.ndim >= 2, f"segment {self.name!r} has no matrix view"
        return (math.prod(self.shape[:-1]), int(self.shape[-1]))


@dataclass(frozen=True)
class SegmentMap:
    """A static, contiguous tuple of ``Segment``s covering [0, n_params).

    ``flat(n)`` is the one-segment layout; ``from_tree`` builds one segment
    a model leaf in ``tree_leaves`` order (the order
    ``tree_flatten_to_vector`` concatenates), so offsets line up with the
    flat vector."""

    segments: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "segments", tuple(self.segments))
        off = 0
        for seg in self.segments:
            assert seg.offset == off, (
                f"segment {seg.name!r} at offset {seg.offset}, expected {off}"
                " -- segments must tile the flat vector contiguously"
            )
            off += seg.size

    @classmethod
    def flat(cls, n_params: int) -> "SegmentMap":
        return cls((Segment("flat", (n_params,), 0),))

    @classmethod
    def from_tree(cls, tree: PyTree) -> "SegmentMap":
        segs, off = [], 0
        for path, leaf in tree_leaves_with_path(tree):
            seg = Segment(path or "leaf", tuple(leaf.shape), off)
            segs.append(seg)
            off += seg.size
        return cls(tuple(segs))

    @property
    def n_params(self) -> int:
        return sum(s.size for s in self.segments)

    def __iter__(self):
        return iter(self.segments)

    def __len__(self) -> int:
        return len(self.segments)

    def __getitem__(self, i):
        return self.segments[i]

    def matches_leaves(self, leaves) -> bool:
        """Do these leaves line up 1:1 with the segments (count and shapes)?
        Then segmented codecs work leaf by leaf and never build the flat
        vector."""
        return len(leaves) == len(self.segments) and all(
            tuple(leaf.shape) == seg.shape for leaf, seg in zip(leaves, self.segments)
        )

    def split(self, vec: torch.Tensor) -> list:
        """Views of a flat (n_params,) vector, one a segment."""
        return [vec[s.offset : s.offset + s.size] for s in self.segments]


@dataclass(frozen=True, eq=False)
class StructuredUpdate:
    """A segmented wire payload: the map and one codec payload a segment."""

    segments: SegmentMap
    payloads: tuple


_GROUP_ROWS: dict = {}


def _rows_on(idx, device) -> torch.Tensor:
    """A static index list as an int64 tensor on ``device``, made once a
    device and kept: a round captured into a CUDA graph then reads it
    instead of copying a host list (which capture cannot take)."""
    key = (tuple(idx), str(device))
    rows = _GROUP_ROWS.get(key)
    if rows is None:
        rows = _GROUP_ROWS[key] = torch.tensor(key[0], dtype=torch.int64, device=device)
    return rows


class UpdateCodec:
    """Base codec: error-feedback residual state + the flat-vector wire.

    Subclasses implement the wire format (``encode``/``decode``, their
    batched variants, ``reduce`` and ``_wire_bytes_scalar``); the state and
    transport machinery below is shared.  With ``segments`` set, the public
    surface dispatches per segment through the ``*_segment`` hooks, whose
    defaults apply the flat format to the segment's slice, so Null, Int8
    and TopK are segment-ready and one flat segment is the flat path.
    """

    # dataclass subclasses redeclare this as a field
    segments: SegmentMap | None = None

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

    def with_segments(self, segments: SegmentMap) -> "UpdateCodec":
        """A copy of this codec bound to a static segment map."""
        if dataclasses.is_dataclass(self):
            return dataclasses.replace(self, segments=segments)
        raise TypeError(f"{type(self).__name__} cannot carry a segment map")

    def segment_map(self, n_params: int | None = None) -> SegmentMap:
        if self.segments is not None:
            if n_params is not None:
                assert self.segments.n_params == n_params, (
                    f"{type(self).__name__} segment map covers "
                    f"{self.segments.n_params} params, caller has {n_params}"
                )
            return self.segments
        assert n_params is not None, "flat codec needs n_params for a map"
        return SegmentMap.flat(n_params)

    # ---- per-client state (carried by round_step across rounds) ----
    def init_client_state(self, n_clients: int, n_params: int, device=None) -> PyTree:
        """Zero error-feedback state on ``device`` (None: the card): one
        flat fp32 residual row a client, or (under a segment map) a tuple
        of per-segment entries."""
        if self.segments is not None:
            self.segment_map(n_params)
            return tuple(
                self.init_segment_state(n_clients, seg, device) for seg in self.segments
            )
        return self._init_flat_state(n_clients, n_params, device)

    def _init_flat_state(self, n_clients: int, n_params: int, device=None) -> PyTree:
        return torch.zeros(n_clients, n_params, dtype=torch.float32,
                           device=resolve_device(device))

    def init_segment_state(self, n_clients: int, seg: Segment, device=None) -> PyTree:
        return self._init_flat_state(n_clients, seg.size, device)

    def segment_stateful(self, seg: Segment) -> bool:
        return bool(tree_leaves(self.init_segment_state(1, seg, device="meta")))

    def carries_client_state(self, n_params: int = 1) -> bool:
        """Whether this codec owns round-to-round per-client state (probes a
        one-client state on the meta device, which allocates nothing)."""
        if self.segments is not None:
            n_params = self.segments.n_params
        return bool(tree_leaves(self.init_client_state(1, n_params, device="meta")))

    # ---- batched (C, N) surface: the parallel round step ----
    def aggregate_updates(self, client_params: PyTree, global_params: PyTree,
                          weights: torch.Tensor, state):
        """Per-client params (leaves lead with C) -> (avg params, state).

        Flat: the deltas flattened to the (C, N) wire layout and aggregated
        off the encoded payload (``aggregate_batch``).  Segmented: each
        leaf's (C, seg.size) delta block aggregates on its own when the map
        matches the leaves (no (C, N) concatenation), else the flat matrix
        is sliced per segment."""
        leaves_g = tree_leaves(global_params)
        if self.segments is not None and self.segments.matches_leaves(leaves_g):
            new_state, new_leaves = list(state), []
            for i, (seg, lc, lg) in enumerate(
                zip(self.segments, tree_leaves(client_params), leaves_g)
            ):
                block = lc.to(torch.float32).reshape(lc.shape[0], -1) - lg.to(torch.float32).reshape(-1)
                mean_i, new_state[i] = self.aggregate_segment_batch(block, weights, state[i], seg)
                new_leaves.append((lg.to(torch.float32) + mean_i.reshape(lg.shape)).to(lg.dtype))
            return tree_unflatten(global_params, new_leaves), tuple(new_state)
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
        what was not transmitted becomes the next residual.  Under a map,
        each segment's column block reduces through
        ``aggregate_segment_batch``."""
        if self.segments is None:
            return self._aggregate_batch_flat(deltas, weights, state)
        segs = self.segment_map(deltas.shape[1])
        parts, new_state = [], list(state)
        for i, seg in enumerate(segs):
            part, new_state[i] = self.aggregate_segment_batch(
                deltas[:, seg.offset : seg.offset + seg.size], weights, state[i], seg
            )
            parts.append(part)
        return torch.cat(parts), tuple(new_state)

    def _aggregate_batch_flat(self, deltas, weights, state):
        eff = deltas + state
        enc = self.encode_batch(eff)
        new_state = eff - self.decode_batch(enc)
        return self.reduce(enc, weights), new_state

    def aggregate_segment_batch(self, deltas, weights, state, seg: Segment):
        """One segment's (C, seg.size) block -> (mean (seg.size,), new
        state): the flat wire format on the block."""
        return self._aggregate_batch_flat(deltas, weights, state)

    # ---- per-client surface: the sequential round step ----
    def transmit_tree(self, delta_tree: PyTree, state_row):
        """One client's uplink: -> (decoded delta tree, new state row), the
        tree holding exactly what survives encode -> decode.  Under a map
        matching the tree, each leaf transmits on its own."""
        if self.segments is None:
            vec = tree_flatten_to_vector(delta_tree)
            dec, new_row = self.transmit_segment(vec, state_row, Segment("flat", vec.shape, 0))
            return tree_unflatten_from_vector(dec, delta_tree), new_row
        leaves = tree_leaves(delta_tree)
        if self.segments.matches_leaves(leaves):
            decs, rows = [], []
            for leaf, row, seg in zip(leaves, state_row, self.segments):
                dec, new_row = self.transmit_segment(leaf.to(torch.float32).reshape(-1), row, seg)
                decs.append(dec.reshape(leaf.shape).to(leaf.dtype))
                rows.append(new_row)
            return tree_unflatten(delta_tree, decs), tuple(rows)
        vec = tree_flatten_to_vector(delta_tree)
        segs = self.segment_map(vec.shape[0])
        decs, rows = [], []
        for part, row, seg in zip(segs.split(vec), state_row, segs):
            dec, new_row = self.transmit_segment(part, row, seg)
            decs.append(dec.reshape(-1))
            rows.append(new_row)
        return tree_unflatten_from_vector(torch.cat(decs), delta_tree), tuple(rows)

    def transmit_segment(self, vec: torch.Tensor, state_row, seg: Segment):
        """One client's uplink for ONE segment: (vec (seg.size,), row) ->
        (decoded (seg.size,), new row); ``state_row`` is ``()`` for a
        stateless segment."""
        stateful = not isinstance(state_row, tuple)
        eff = vec + state_row if stateful else vec
        dec = self.decode_segment(self.encode_segment(eff, seg), seg)
        return dec, (eff - dec if stateful else ())

    # ---- per-segment wire hooks (defaults: the flat format on the slice) ----
    def encode_segment(self, vec: torch.Tensor, seg: Segment):
        return self.encode(vec)

    def decode_segment(self, enc, seg: Segment) -> torch.Tensor:
        return self.decode(enc)

    def encode_structured(self, delta_vec: torch.Tensor) -> StructuredUpdate:
        """Flat (n_params,) delta -> per-segment payloads (protocol path)."""
        segs = self.segment_map(int(delta_vec.shape[0]))
        return StructuredUpdate(segs, tuple(
            self.encode_segment(part, seg) for part, seg in zip(segs.split(delta_vec), segs)
        ))

    def decode_structured(self, su: StructuredUpdate) -> torch.Tensor:
        """Dense (n_params,) fp32 decode of a ``StructuredUpdate``."""
        return torch.cat([
            self.decode_segment(p, seg).reshape(-1).to(torch.float32)
            for seg, p in zip(su.segments, su.payloads)
        ])

    # ---- wire serialization hooks (protocol.CompressedParameters) ----
    def wire_payload(self, enc: dict) -> dict:
        """The exact fields that cross the wire (tensors + python scalars)."""
        return dict(enc)

    def from_wire(self, payload: dict) -> dict:
        """Rebuild the decodable payload from ``wire_payload`` fields."""
        return dict(payload)

    def segment_wire_payload(self, payload, seg: Segment) -> dict:
        """Wire fields of ONE segment's payload (the protocol names them
        ``s{i}.<key>``)."""
        return self.wire_payload(payload)

    def segment_from_wire(self, fields: dict, seg: Segment):
        return self.from_wire(fields)

    # ---- uplink accounting ----
    def _wire_bytes_scalar(self, n_params: int) -> int:
        raise NotImplementedError

    def segment_wire_bytes(self, seg: Segment) -> int:
        """Uplink bytes of ONE segment (the flat format on its slice)."""
        return self._wire_bytes_scalar(seg.size)

    def wire_bytes(self, n_params):
        """Uplink bytes for an ``n_params``-sized update.

        Accepts an int (homogeneous fleet) or a sequence of per-client sizes
        and returns an int or list respectively; under a map the scalar is
        the sum of the segments' wire sizes."""
        sizes = (np.asarray(n_params).reshape(-1)
                 if isinstance(n_params, (list, tuple, np.ndarray)) else None)
        if self.segments is not None:
            total = sum(self.segment_wire_bytes(seg) for seg in self.segments)
            for n in (sizes if sizes is not None else [n_params]):
                self.segment_map(int(n))
            return total if sizes is None else [total] * len(sizes)
        if sizes is not None:
            return [self._wire_bytes_scalar(int(n)) for n in sizes]
        return self._wire_bytes_scalar(int(n_params))


@dataclass(frozen=True)
class NullCodec(UpdateCodec):
    """Identity codec: full-precision fp32 wire (the uncompressed baseline).

    Stateless: ``init_client_state`` is empty (a tuple of ``()`` under a
    map), ``transmit_tree`` is the identity on the delta pytree, and
    ``aggregate_updates`` is a leafwise weighted mean that never builds the
    flat (C, N) matrix.
    """

    segments: Any = None

    def _wire_bytes_scalar(self, n_params: int) -> int:
        return 4 * n_params

    def _init_flat_state(self, n_clients: int, n_params: int, device=None) -> PyTree:
        return ()

    def aggregate_updates(self, client_params, global_params, weights, state):
        """Leafwise fp32 weighted mean: the fp32 wire loses nothing.  The
        state passes through (``()`` flat, a tuple of ``()`` segmented)."""
        wf = weights.to(torch.float32)
        wsum = safe_weight_sum(wf)

        def leaf_mean(xs, g):
            wshape = (xs.shape[0],) + (1,) * (xs.dim() - 1)
            gf = g.to(torch.float32)
            acc = torch.sum((xs.to(torch.float32) - gf) * wf.reshape(wshape), dim=0)
            return (gf + acc / wsum).to(g.dtype)

        return tree_map(leaf_mean, client_params, global_params), state

    def _aggregate_batch_flat(self, deltas, weights, state):
        return self.reduce(self.encode_batch(deltas), weights), state

    def transmit_tree(self, delta_tree, state_row):
        return delta_tree, state_row

    def encode(self, delta_vec: torch.Tensor) -> dict:
        return {"delta": delta_vec.to(torch.float32), "n": delta_vec.shape[0]}

    def decode(self, enc: dict) -> torch.Tensor:
        return enc["delta"]

    def encode_batch(self, deltas: torch.Tensor) -> dict:
        # a segment's column block is a strided view; the reduce takes rows
        return {"delta": deltas.to(torch.float32).contiguous(), "n": deltas.shape[1]}

    def decode_batch(self, enc: dict) -> torch.Tensor:
        return enc["delta"]

    def reduce(self, enc: dict, weights: torch.Tensor) -> torch.Tensor:
        return ops.fedavg_reduce(enc["delta"], weights)


@dataclass(frozen=True)
class Int8Codec(UpdateCodec):
    block: int = 256
    segments: Any = None

    def _n_scales(self, n_params: int) -> int:
        return -(-n_params // self.block)  # ceil: encode pads to a block multiple

    def _wire_bytes_scalar(self, n_params: int) -> int:
        # int8 payload (pad blocks need not cross the wire: the receiver
        # re-pads from n) + one fp32 scale per ceil(n/block) block
        return n_params + 4 * self._n_scales(n_params)

    def encode(self, delta_vec: torch.Tensor) -> dict:
        # the codes of the delta padded with zeros to a block multiple: on
        # the card the pad is inside the one quantize launch, which takes a
        # segment's slice at any 4-byte start
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
      dense per-client matrix (no reduce or error-feedback path calls it);
    - under a segment map each segment keeps its own ``k_of(seg.size)``.
    """

    frac: float = 0.01
    segments: Any = None

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

    def _aggregate_batch_flat(self, deltas: torch.Tensor, weights: torch.Tensor, state):
        """O(C*k) end to end: encode, scatter-reduce straight off the
        payload, and zero the transmitted coordinates out of the residual
        (TopK transmits exact values), no dense decode."""
        eff = deltas + state
        enc = self.encode_batch(eff)
        new_state = eff.scatter(1, enc["idx"].long(), 0.0)
        return self.reduce(enc, weights), new_state

    def transmit_segment(self, vec: torch.Tensor, state_row, seg: Segment):
        """One client: the decode stays (seg.size,), and the next residual
        row zeroes the transmitted coordinates in O(k)."""
        eff = vec + state_row
        enc = self.encode_segment(eff, seg)
        return self.decode_segment(enc, seg), eff.index_fill(0, enc["idx"].long(), 0.0)

    def reduce(self, enc: dict, weights: torch.Tensor) -> torch.Tensor:
        return ops.topk_scatter_reduce(enc["idx"], enc["val"], weights, enc["n"])


def segment_basis(seed: int, seg: Segment, n: int, r: int) -> torch.Tensor:
    """LoRA's random projection for ``seg``: (n, r) fp32 standard normals
    on the CPU from ``(seed, seg.offset)`` alone, so every client and the
    server draw the same basis on any device."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(((int(seed) & 0xFFFFFFFF) << 32) | (seg.offset & 0xFFFFFFFF))
    return torch.randn((n, r), generator=gen, dtype=torch.float32)


_CARD_BASES: dict = {}


@dataclass(frozen=True)
class LoRACodec(UpdateCodec):
    """Low-rank factor wire for matrix segments; ``fallback`` elsewhere.

    The wire format is the module docstring's ("The LoRA wire").  Config:
    ``rank`` (each matrix segment uses ``min(rank, m, n)``),
    ``factor_codec`` (the codec of each factor's flat vector: Int8 codes
    the factors, Null ships them fp32), ``fallback`` (owns non-matrix
    segments wholesale: encode, state and wire accounting),
    ``power_iters`` (subspace iterations; 1 = project, orthonormalize,
    project back) and ``seed`` (``segment_basis``).

    Segment-structured by construction: build it with a map
    (``LoRACodec(...).with_segments(SegmentMap.from_tree(params))``).  The
    flat-vector surface raises ``TypeError``.
    """

    rank: int = 8
    factor_codec: UpdateCodec = NullCodec()
    fallback: UpdateCodec = Int8Codec()
    power_iters: int = 1
    seed: int = 0
    segments: Any = None

    def __post_init__(self):
        assert self.rank >= 1, f"rank must be >= 1, got {self.rank}"
        assert self.power_iters >= 1
        assert self.factor_codec.segments is None, "factor_codec is flat-per-factor"
        assert self.fallback.segments is None, "fallback inherits LoRA's segments"

    # ---- which segments get the low-rank wire ----
    def _eff_rank(self, seg: Segment) -> int:
        m, n = seg.matrix_shape
        return min(self.rank, m, n)

    def _use_lora(self, seg: Segment) -> bool:
        """Low rank wins when the segment has a matrix view and the factor
        wire is strictly smaller than the fallback's."""
        if seg.ndim < 2:
            return False
        m, n = seg.matrix_shape
        r = min(self.rank, m, n)
        return (
            self.factor_codec._wire_bytes_scalar(m * r)
            + self.factor_codec._wire_bytes_scalar(r * n)
            < self.fallback.segment_wire_bytes(seg)
        )

    def _basis(self, seg: Segment, device) -> torch.Tensor:
        """``segment_basis`` on ``device``.  A card keeps its copy, so a
        round captured into a CUDA graph copies nothing from the host."""
        n = seg.matrix_shape[1]
        r = self._eff_rank(seg)
        if torch.device(device).type != "cuda":
            return segment_basis(self.seed, seg, n, r).to(device)
        key = (self.seed, seg.offset, n, r, str(device))
        q = _CARD_BASES.get(key)
        if q is None:
            q = _CARD_BASES[key] = segment_basis(self.seed, seg, n, r).to(device)
        return q

    # ---- the factorization (PowerSGD-style, shared basis) ----
    def _factorize(self, x: torch.Tensor, q: torch.Tensor):
        """x (..., m, n) fp32, q (n, r) -> A (..., m, r) orthonormal
        columns, B (..., r, n) = A^T x; batched over leading axes."""
        p = x @ q
        for _ in range(self.power_iters - 1):
            p = torch.linalg.qr(p).Q
            p = x @ (x.transpose(-2, -1) @ p)
        a = torch.linalg.qr(p).Q
        return a, a.transpose(-2, -1) @ x

    # ---- per-segment wire ----
    def encode_segment(self, vec: torch.Tensor, seg: Segment):
        if not self._use_lora(seg):
            return self.fallback.encode_segment(vec, seg)
        m, n = seg.matrix_shape
        a, b = self._factorize(vec.reshape(m, n).to(torch.float32), self._basis(seg, vec.device))
        return {
            "a": self.factor_codec.encode(a.reshape(-1)),
            "b": self.factor_codec.encode(b.reshape(-1)),
        }

    def decode_segment(self, enc, seg: Segment) -> torch.Tensor:
        if not self._use_lora(seg):
            return self.fallback.decode_segment(enc, seg)
        m, n = seg.matrix_shape
        r = self._eff_rank(seg)
        a = self.factor_codec.decode(enc["a"]).reshape(m, r)
        b = self.factor_codec.decode(enc["b"]).reshape(r, n)
        return (a @ b).reshape(-1)

    # ---- per-segment state: residual rows on LoRA segments, fallback's otherwise ----
    def init_segment_state(self, n_clients: int, seg: Segment, device=None) -> PyTree:
        if self._use_lora(seg):
            return torch.zeros(n_clients, seg.size, dtype=torch.float32,
                               device=resolve_device(device))
        return self.fallback.init_segment_state(n_clients, seg, device)

    # ---- batched aggregation: factorize every client, reduce the reconstructions ----
    def aggregate_segment_batch(self, deltas, weights, state, seg: Segment):
        if not self._use_lora(seg):
            return self.fallback.aggregate_segment_batch(deltas, weights, state, seg)
        c = deltas.shape[0]
        m, n = seg.matrix_shape
        r = self._eff_rank(seg)
        eff = deltas.to(torch.float32) + state
        # one shared basis: clients and server agree on it
        a, b = self._factorize(eff.reshape(c, m, n), self._basis(seg, eff.device))
        # the factor wire's round trip: what the server can actually see
        fa = self.factor_codec.decode_batch(
            self.factor_codec.encode_batch(a.reshape(c, m * r))
        ).reshape(c, m, r)
        fb = self.factor_codec.decode_batch(
            self.factor_codec.encode_batch(b.reshape(c, r * n))
        ).reshape(c, r, n)
        dec = torch.einsum("cmr,crn->cmn", fa, fb)
        wf = weights.to(torch.float32)
        mean = torch.einsum("c,cmn->mn", wf, dec) / safe_weight_sum(wf)
        return mean.reshape(-1), eff - dec.reshape(c, -1)

    # ---- per-segment serialization: factor payloads named a./b. ----
    def segment_wire_payload(self, payload, seg: Segment) -> dict:
        if not self._use_lora(seg):
            return self.fallback.segment_wire_payload(payload, seg)
        return {
            f"{fk}.{k}": v
            for fk in ("a", "b")
            for k, v in self.factor_codec.wire_payload(payload[fk]).items()
        }

    def segment_from_wire(self, fields: dict, seg: Segment):
        if not self._use_lora(seg):
            return self.fallback.segment_from_wire(fields, seg)

        def sub(prefix):
            return self.factor_codec.from_wire({
                k[len(prefix):]: v for k, v in fields.items() if k.startswith(prefix)
            })

        return {"a": sub("a."), "b": sub("b.")}

    # ---- wire accounting: restated per segment (factors, not dense) ----
    def segment_wire_bytes(self, seg: Segment) -> int:
        if not self._use_lora(seg):
            return self.fallback.segment_wire_bytes(seg)
        m, n = seg.matrix_shape
        r = self._eff_rank(seg)
        return (
            self.factor_codec._wire_bytes_scalar(m * r)
            + self.factor_codec._wire_bytes_scalar(r * n)
        )

    # ---- the flat-vector surface is meaningless for a structured codec ----
    def _no_flat_surface(self, name: str):
        raise TypeError(
            f"LoRACodec.{name}: the low-rank wire needs matrix shapes -- build "
            "the codec with a SegmentMap (with_segments(SegmentMap.from_tree(params)))"
        )

    def _wire_bytes_scalar(self, n_params: int) -> int:
        self._no_flat_surface("wire_bytes")

    def _init_flat_state(self, n_clients: int, n_params: int, device=None):
        self._no_flat_surface("init_client_state")

    def encode(self, delta_vec):
        self._no_flat_surface("encode")

    def decode(self, enc):
        self._no_flat_surface("decode")

    def encode_batch(self, deltas):
        self._no_flat_surface("encode_batch")

    def decode_batch(self, enc):
        self._no_flat_surface("decode_batch")

    def reduce(self, enc, weights):
        self._no_flat_surface("reduce")


@dataclass(frozen=True)
class MixedCodec(UpdateCodec):
    """Shape-static per-client codec bank: a mixed fleet in ONE round.

    ``codecs`` is the bank (one entry a group); ``assignment`` maps each
    client to a bank index and is static python data, so the round splits
    the client axis into per-codec groups when it is built (the module
    docstring's mixed-batch contract).  Build one from the fleet's
    hardware with ``MixedCodec.from_policy``.

    Population mode refuses it: its static assignment binds codecs to
    client-axis slots, while a population round resamples who sits in each
    slot (per-device codecs there come from ``BandwidthCodecPolicy``).
    """

    codecs: tuple = ()
    assignment: tuple = ()

    def __post_init__(self):
        assert self.codecs, "MixedCodec needs a non-empty codec bank"
        assert all(
            0 <= int(g) < len(self.codecs) for g in self.assignment
        ), f"assignment {self.assignment} out of range for {len(self.codecs)} codecs"
        object.__setattr__(self, "codecs", tuple(self.codecs))
        object.__setattr__(self, "assignment", tuple(int(g) for g in self.assignment))
        maps = {c.segments for c in self.codecs if c.segments is not None}
        if len(maps) > 1:
            raise ValueError(
                "MixedCodec bank codecs carry conflicting segment maps -- the "
                "client axis shares one model, so every segmented group must "
                "use the same leaf layout (use MixedCodec.with_segments)"
            )

    def with_segments(self, segments: SegmentMap) -> "MixedCodec":
        """Thread one segment map through every codec of the bank."""
        return dataclasses.replace(
            self, codecs=tuple(c.with_segments(segments) for c in self.codecs)
        )

    @classmethod
    def from_policy(cls, policy, fleet) -> "MixedCodec":
        """The static assignment from per-device facts: ``fleet`` holds one
        ``ClientProperties`` / ``DeviceProfile`` (anything with
        ``.uplink_mbps``) a client, in client order; equal codecs share
        one bank entry (frozen dataclasses compare by config)."""
        bank: list = []
        assignment = []
        for props in fleet:
            codec = policy.codec_for(props)
            if codec not in bank:
                bank.append(codec)
            assignment.append(bank.index(codec))
        return cls(codecs=tuple(bank), assignment=tuple(assignment))

    @property
    def n_clients(self) -> int:
        return len(self.assignment)

    def groups(self):
        """-> [(bank index, codec, client-index list)] for every NON-EMPTY
        group, in bank order."""
        return [
            (g, codec, idx)
            for g, codec in enumerate(self.codecs)
            if (idx := [i for i, a in enumerate(self.assignment) if a == g])
        ]

    # ---- per-client state: one entry a bank codec ----
    def init_client_state(self, n_clients: int, n_params: int, device=None) -> PyTree:
        assert n_clients == self.n_clients, (
            f"MixedCodec assigns {self.n_clients} clients, got {n_clients}"
        )
        return tuple(
            codec.init_client_state(self.assignment.count(g), n_params, device)
            for g, codec in enumerate(self.codecs)
        )

    def _check_clients(self, c: int) -> None:
        assert c == self.n_clients, (
            f"batch carries {c} clients, MixedCodec assigns {self.n_clients}"
        )

    # ---- batched pytree surface: the parallel round step ----
    def aggregate_updates(self, client_params, global_params, weights, state):
        """Each group's rows gathered by their index tensor and aggregated
        by the group's own codec; the group means scaled back to partial
        weighted sums and combined under one fleet-wide denominator."""
        self._check_clients(weights.shape[0])
        wf = weights.to(torch.float32)
        wsum = safe_weight_sum(wf)
        total = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                         global_params)
        new_states = list(state)
        for g, codec, idx in self.groups():
            rows = _rows_on(idx, wf.device)
            w_g = wf[rows]
            avg_g, new_states[g] = codec.aggregate_updates(
                tree_map(lambda x: x[rows], client_params), global_params, w_g, state[g]
            )
            wsum_g = torch.sum(w_g)  # group mean * mass = partial sum
            total = tree_map(
                lambda t, a, gp: t + (a.to(torch.float32) - gp.to(torch.float32)) * wsum_g,
                total, avg_g, global_params,
            )
        new_global = tree_map(
            lambda gp, t: (gp.to(torch.float32) + t / wsum).to(gp.dtype), global_params, total
        )
        return new_global, tuple(new_states)

    # ---- batched flat surface ----
    def aggregate_batch(self, deltas: torch.Tensor, weights: torch.Tensor, state):
        self._check_clients(deltas.shape[0])
        wf = weights.to(torch.float32)
        total = torch.zeros(deltas.shape[1], dtype=torch.float32, device=deltas.device)
        new_states = list(state)
        for g, codec, idx in self.groups():
            rows = _rows_on(idx, wf.device)
            w_g = wf[rows]
            mean_g, new_states[g] = codec.aggregate_batch(deltas[rows], w_g, state[g])
            total = total + mean_g.to(torch.float32) * torch.sum(w_g)
        return total / safe_weight_sum(wf), tuple(new_states)

    # ---- per-group wire accounting ----
    def wire_bytes(self, n_params):
        """One uplink size a client (its group codec's ``wire_bytes``), in
        client order, from an int or a per-client vector of sizes."""
        ns = np.asarray(n_params).reshape(-1)
        if ns.size == 1:
            ns = np.full(self.n_clients, int(ns[0]))
        assert len(ns) == self.n_clients, (
            f"per-client size vector ({len(ns)}) != clients ({self.n_clients})"
        )
        return [self.codecs[g].wire_bytes(int(n)) for g, n in zip(self.assignment, ns)]

    def _wire_bytes_scalar(self, n_params: int) -> int:
        raise TypeError("MixedCodec has no scalar wire size; use wire_bytes")

    def _no_per_client_surface(self, name: str):
        raise TypeError(
            f"MixedCodec.{name}: per-client codec surfaces are group-owned; "
            "dispatch through groups()"
        )

    def encode(self, delta_vec):
        self._no_per_client_surface("encode")

    def decode(self, enc):
        self._no_per_client_surface("decode")

    def encode_batch(self, deltas):
        self._no_per_client_surface("encode_batch")

    def decode_batch(self, enc):
        self._no_per_client_surface("decode_batch")

    def reduce(self, enc, weights):
        self._no_per_client_surface("reduce")

    def transmit_tree(self, delta_tree, state_row):
        self._no_per_client_surface("transmit_tree")


@dataclass(frozen=True)
class BandwidthCodecPolicy:
    """Per-device codec selection from the client's measured uplink.

    The Strategy consults this in ``configure_fit``: slow phone-class
    uplinks get TopK sparsification, mid-tier edge boards get Int8, and
    datacenter-class backbone links ship the full-precision wire.  Codecs
    that carry one segment map give a segmented fleet.
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


def _init_residual_rows(codec, segs: SegmentMap, device) -> tuple:
    return tuple(
        torch.zeros(seg.size, dtype=torch.float32, device=device)
        if codec.segment_stateful(seg) else ()
        for seg in segs
    )


def compress_update(codec, new_params: PyTree, global_params: PyTree, residual=None):
    """-> (codec payload, new_residual) for error feedback.

    ``residual`` is the client's carried error-feedback state (folded into
    the delta before encoding); None means no carried state.  Flat codecs
    take and return one (n_params,) fp32 vector; segmented codecs take and
    return a tuple of per-segment rows (``()`` for a stateless segment) and
    emit a ``StructuredUpdate``."""
    if codec.segments is not None:
        segs = codec.segments
        delta_tree = tree_sub(new_params, global_params)
        leaves = tree_leaves(delta_tree)
        if segs.matches_leaves(leaves):
            vecs = [leaf.to(torch.float32).reshape(-1) for leaf in leaves]
        else:
            flat = tree_flatten_to_vector(delta_tree)
            codec.segment_map(int(flat.shape[0]))
            vecs = segs.split(flat)
        if residual is None:
            residual = _init_residual_rows(codec, segs, leaves[0].device)
        encs, new_res = [], []
        for vec, res, seg in zip(vecs, residual, segs):
            stateful = not isinstance(res, tuple)
            eff = vec + res if stateful else vec
            enc = codec.encode_segment(eff, seg)
            encs.append(enc)
            new_res.append(eff - codec.decode_segment(enc, seg) if stateful else ())
        return StructuredUpdate(segs, tuple(encs)), tuple(new_res)

    delta = tree_flatten_to_vector(tree_sub(new_params, global_params))
    if residual is not None:
        delta = delta + residual
    enc = codec.encode(delta)
    new_residual = delta - codec.decode(enc)
    return enc, new_residual


def decompress_update(codec, enc, global_params: PyTree) -> PyTree:
    if isinstance(enc, StructuredUpdate):
        delta = codec.decode_structured(enc)
    else:
        delta = codec.decode(enc)
    flat_global = tree_flatten_to_vector(global_params)
    return tree_unflatten_from_vector(flat_global + delta, global_params)
