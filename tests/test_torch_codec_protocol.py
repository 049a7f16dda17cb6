"""Port parity: the Null, Int8 and TopK uplink codecs and the wire protocol.

The same numpy delta goes through the JAX package's and the port's
``encode``/``decode``/``compress_update``; the serialized
``CompressedParameters`` must be byte-identical, and a wire serialized by
either package must decode in the other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)

from repro.core import compression as jc
from repro.core import protocol as jp
from repro_torch.core import compression as tc
from repro_torch.core import protocol as tp
from repro_torch.utils.pytree import tree_leaves, tree_map

CODECS = [
    pytest.param(jc.NullCodec(), tc.NullCodec(), id="null"),
    pytest.param(jc.Int8Codec(), tc.Int8Codec(), id="int8"),
    pytest.param(jc.TopKCodec(), tc.TopKCodec(), id="topk"),
]


def _delta(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * 1e-3).astype(np.float32)


def _params(seed, shapes=(("a", (3, 70)), ("b", (5,)))):
    """A small nested params dict: {"head": {...}, "base": {...}} with keys
    out of sorted order, as numpy."""
    rng = np.random.default_rng(seed)
    return {
        "head": {k: rng.normal(size=s).astype(np.float32) for k, s in shapes},
        "base": {"w": rng.normal(size=(4, 4)).astype(np.float32)},
    }


def _wire_equal(a, b):
    assert a.tensors == b.tensors
    assert [(d, tuple(s)) for d, s in a.manifest] == [(d, tuple(s)) for d, s in b.manifest]
    assert a.fields == b.fields and a.aux == b.aux and a.n_params == b.n_params
    assert a.num_bytes == b.num_bytes


@pytest.mark.parametrize("jcodec,tcodec", CODECS)
@pytest.mark.parametrize("n", [1, 255, 257, 1000, 1024])
def test_encode_decode_and_wire_bytes_match(jcodec, tcodec, n):
    d = _delta(n, n)
    je, te = jcodec.encode(jnp.asarray(d)), tcodec.encode(torch.from_numpy(d))
    for key in je:
        if key == "n":
            assert je[key] == te[key] == n
        else:
            np.testing.assert_array_equal(np.asarray(je[key]), te[key].numpy())
    np.testing.assert_array_equal(np.asarray(jcodec.decode(je)), tcodec.decode(te).numpy())
    assert tcodec.wire_bytes(n) == jcodec.wire_bytes(n)
    assert tcodec.wire_bytes([n, 7]) == jcodec.wire_bytes([n, 7])
    _wire_equal(tp.compress_to_wire(tcodec, te, n), jp.compress_to_wire(jcodec, je, n))


@pytest.mark.parametrize("jcodec,tcodec", CODECS)
def test_compress_update_with_residual_matches(jcodec, tcodec):
    g, p = _params(0), _params(1)
    n = sum(x.size for x in jax.tree.leaves(g))
    res = _delta(n, 2)
    je, jres = jc.compress_update(
        jcodec, jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        residual=jnp.asarray(res),
    )
    te, tres = tc.compress_update(
        tcodec, tree_map(torch.from_numpy, p), tree_map(torch.from_numpy, g),
        residual=torch.from_numpy(res),
    )
    np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
    jw, tw = jp.compress_to_wire(jcodec, je, n), tp.compress_to_wire(tcodec, te, n)
    _wire_equal(tw, jw)
    # decode against the global on both sides
    jdec = jp.wire_to_pytree(jw, jax.tree.map(jnp.asarray, g))
    tdec = tp.wire_to_pytree(tw, tree_map(torch.from_numpy, g))
    for a, b in zip(jax.tree.leaves(jdec), tree_leaves(tdec)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("jcodec,tcodec", CODECS)
def test_jax_wire_decodes_in_port(jcodec, tcodec):
    """A wire the JAX package serialized (bytes, manifest, fields, aux)
    decodes in the port to the JAX decode, bitwise."""
    n = 777
    d = _delta(n, 4)
    jw = jp.compress_to_wire(jcodec, jcodec.encode(jnp.asarray(d)), n)
    tw = tp.CompressedParameters(
        codec=tcodec, tensors=list(jw.tensors), manifest=list(jw.manifest),
        fields=list(jw.fields), aux=dict(jw.aux), n_params=jw.n_params,
    )
    enc = tp.wire_to_enc(tw, torch.device("cpu"))
    np.testing.assert_array_equal(
        tcodec.decode(enc).numpy(), np.asarray(jcodec.decode(jp.wire_to_enc(jw)))
    )
    assert tw.num_bytes == tcodec.wire_bytes(n)


def test_parameters_wire_roundtrip_both_ways():
    """``Parameters`` bytes match in JAX leaf order (keys sorted), bf16 as
    its uint16 pattern, and each package decodes the other's wire."""
    g = _params(5)
    g["head"]["h"] = np.asarray(jnp.asarray(np.linspace(-2, 2, 6), jnp.bfloat16))
    jtree = jax.tree.map(jnp.asarray, g)
    ttree = tree_map(
        lambda a: torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        if a.dtype.name == "bfloat16" else torch.from_numpy(a), g,
    )
    jw, tw = jp.pytree_to_parameters(jtree), tp.pytree_to_parameters(ttree)
    assert tw.tensors == jw.tensors and tw.manifest == jw.manifest
    back = tp.parameters_to_pytree(jw, ttree)
    assert back["head"]["h"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), b.float().numpy())
    jback = jp.parameters_to_pytree(tw, jtree)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), np.asarray(b.astype(jnp.float32)))


def test_bandwidth_policy_matches_and_topk_waits():
    """The same codec for every uplink class on both sides: phone-class
    (< 30 Mbit/s) TopK at 1%, edge boards Int8, datacenter links Null."""
    jpol, tpol = jc.BandwidthCodecPolicy(), tc.BandwidthCodecPolicy()
    for mbps, kind in ((15.0, "TopKCodec"), (29.9, "TopKCodec"), (30.0, "Int8Codec"),
                       (80.0, "Int8Codec"), (400_000.0, "NullCodec")):
        props = tp.ClientProperties(client_id=0, uplink_mbps=mbps)
        assert type(tpol.codec_for(props)).__name__ == kind
        assert type(jpol.codec_for(props)).__name__ == kind
    assert tpol.topk.frac == jpol.topk.frac == 0.01
