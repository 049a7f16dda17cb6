"""The Flower protocol, as in-process message dataclasses.

The twin of ``repro.core.protocol``: the same messages (FitIns/FitRes/
EvaluateIns/EvaluateRes with an opaque config mapping) and the same two
parameter wire formats, byte for byte:

- ``Parameters``: the full-precision pytree wire (list of raw buffers +
  dtype/shape manifest) — what FitIns downlinks carry.
- ``CompressedParameters``: a codec-encoded *delta* payload (the serialized
  output of ``codec.encode`` via ``codec.wire_payload``, so e.g. Int8
  encoder padding never crosses the wire; a segmented codec's
  ``StructuredUpdate`` with segment i's fields named ``s{i}.<key>``).
  ``num_bytes`` equals ``codec.wire_bytes(n_params)`` by construction.

The wire is host bytes: tensors leave the card through ``numpy.tobytes``
and arrive on the decoding side's device.  Leaves serialize in JAX leaf
order (dict keys sorted), bfloat16 as its uint16 pattern, so a wire from
either package decodes in the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.utils.pytree import tensor_from_numpy, tree_leaves, tree_unflatten

PyTree = Any


# ---------------- tensor buffer codec (shared by both wire formats) ----------------
def _encode_array(t: torch.Tensor) -> tuple[bytes, str, tuple[int, ...]]:
    """-> (raw buffer, dtype name, shape); bfloat16 ships as a uint16 view
    (numpy has no bfloat16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().tobytes(), "bfloat16", tuple(t.shape)
    arr = t.numpy()
    return arr.tobytes(), arr.dtype.name, tuple(arr.shape)


def _decode_array(buf: bytes, dtype: str, shape: tuple[int, ...], device) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return tensor_from_numpy(bits, device).view(torch.bfloat16)
    return tensor_from_numpy(np.frombuffer(buf, dtype=dtype).reshape(shape), device)


# ---------------- parameter wire format ----------------
@dataclass
class Parameters:
    """Serialized pytree: list of raw ndarray buffers + dtype/shape manifest."""

    tensors: list[bytes]
    manifest: list[tuple[str, tuple[int, ...]]]  # (dtype_str, shape)

    @property
    def num_bytes(self) -> int:
        return sum(len(t) for t in self.tensors)


def pytree_to_parameters(tree: PyTree) -> Parameters:
    tensors, manifest = [], []
    for leaf in tree_leaves(tree):
        buf, dtype, shape = _encode_array(leaf)
        tensors.append(buf)
        manifest.append((dtype, shape))
    return Parameters(tensors=tensors, manifest=manifest)


def parameters_to_pytree(params: Parameters, like: PyTree) -> PyTree:
    """Decode onto the template's devices, leaf by leaf."""
    leaves = tree_leaves(like)
    if len(leaves) != len(params.tensors):
        raise ValueError("wire/client structure mismatch")
    out = [
        _decode_array(buf, dtype, shape, leaf.device)
        for buf, (dtype, shape), leaf in zip(params.tensors, params.manifest, leaves)
    ]
    return tree_unflatten(like, out)


# ---------------- compressed-delta wire format ----------------
@dataclass
class CompressedParameters:
    """A codec-encoded delta payload: what the compressed uplink carries.

    ``tensors``/``manifest`` serialize the array fields of the codec's wire
    payload (named by ``fields``); python scalars (e.g. the unpadded length
    ``n``) ride in ``aux``.  Decode against the global params the client
    trained from: ``global + codec.decode(payload)``.
    """

    codec: Any                                   # UpdateCodec (registry key in RPC)
    tensors: list[bytes]
    manifest: list[tuple[str, tuple[int, ...]]]  # (dtype_str, shape)
    fields: list[str]                            # payload dict key per tensor
    aux: dict = field(default_factory=dict)      # non-array payload fields
    n_params: int = 0

    @property
    def num_bytes(self) -> int:
        """Actual uplink payload size (== codec.wire_bytes(n_params))."""
        return sum(len(t) for t in self.tensors)


def compress_to_wire(codec, enc, n_params: int) -> CompressedParameters:
    """Serialize a codec payload into the uplink wire object: a flat
    ``codec.encode`` payload dict, or a ``StructuredUpdate`` whose segment
    i's ``codec.segment_wire_payload`` fields are named ``s{i}.<key>`` (one
    flat field list, so tensors, aux and ``num_bytes`` are shared)."""
    from .compression import StructuredUpdate

    if isinstance(enc, StructuredUpdate):
        items = [
            (f"s{i}.{key}", value)
            for i, (seg, p) in enumerate(zip(enc.segments, enc.payloads))
            for key, value in codec.segment_wire_payload(p, seg).items()
        ]
    else:
        items = list(codec.wire_payload(enc).items())
    tensors, manifest, fields, aux = [], [], [], {}
    for key, value in items:
        if isinstance(value, (int, float)):
            aux[key] = value
            continue
        buf, dtype, shape = _encode_array(value)
        tensors.append(buf)
        manifest.append((dtype, shape))
        fields.append(key)
    return CompressedParameters(
        codec=codec, tensors=tensors, manifest=manifest, fields=fields,
        aux=aux, n_params=n_params,
    )


def wire_to_enc(cp: CompressedParameters, device):
    """Rebuild the decodable codec payload on ``device`` from the wire
    object: aux scalars + deserialized tensors through ``codec.from_wire``,
    or for a segmented codec a ``StructuredUpdate`` through
    ``codec.segment_from_wire`` per segment.  The ONE place the
    CompressedParameters deserialization lives — both the per-client dense
    decode and the Strategy's grouped kernel reduce use it."""
    from .compression import StructuredUpdate

    payload = dict(cp.aux)
    for key, buf, (dtype, shape) in zip(cp.fields, cp.tensors, cp.manifest):
        payload[key] = _decode_array(buf, dtype, shape, device)
    codec = cp.codec
    segs = getattr(codec, "segments", None)
    if segs is None:
        return codec.from_wire(payload)
    per: list[dict] = [{} for _ in segs]
    for key, value in payload.items():
        si, sub = key.split(".", 1)
        per[int(si[1:])][sub] = value
    return StructuredUpdate(segs, tuple(
        codec.segment_from_wire(fields, seg) for fields, seg in zip(per, segs)
    ))


def wire_to_pytree(cp: CompressedParameters, global_params: PyTree) -> PyTree:
    """Decode a compressed uplink against the round's global parameters."""
    from .compression import decompress_update

    device = tree_leaves(global_params)[0].device
    return decompress_update(cp.codec, wire_to_enc(cp, device), global_params)


# ---------------- messages ----------------
@dataclass
class FitIns:
    parameters: Parameters | PyTree
    config: dict = field(default_factory=dict)   # e.g. {"epochs": 5, "tau_s": 120.0}


@dataclass
class FitRes:
    parameters: Parameters | CompressedParameters | PyTree  # update (or delta)
    num_examples: int
    metrics: dict = field(default_factory=dict)  # incl. steps_done, t_compute_s
    # rounds elapsed between the global this update trained from and the
    # round that consumes it; the scheduler-driven Server stamps it when a
    # buffered-async arrival is aggregated late (0 = fresh, the default)
    staleness: int = 0


@dataclass
class EvaluateIns:
    parameters: Parameters | PyTree
    config: dict = field(default_factory=dict)


@dataclass
class EvaluateRes:
    loss: float
    num_examples: int
    metrics: dict = field(default_factory=dict)


@dataclass
class ClientProperties:
    """What the RPC layer knows about a device (drives tau + codec choice)."""

    client_id: int
    device_profile: str = "generic"
    uplink_mbps: float = 20.0
    downlink_mbps: float = 50.0
