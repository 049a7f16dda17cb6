"""Port parity for ResNet-18 (``repro_torch.models.resnet``, ``groupnorm``,
the ``cnn`` family of ``build_model``) and the heterogeneous-cutoff example
twin (``repro_torch.examples.heterogeneous_cutoff``), against the JAX
package on the CPU.  Every input comes from a numpy seed and every param
is JAX's draw carried across with ``params_from_numpy``.

Tolerances (fp32 on both sides; the sums run in another order):
- ``conv2d``: atol 1e-5 on outputs of magnitude ~5 (seen: 4e-6).  The
  symmetric pad that ``F.conv2d(padding=k // 2)`` gives is off by O(1)
  at stride 2 on an even size, so the pad rule is tested, not assumed.
- ``groupnorm``: atol 1e-5 on unit-variance outputs (seen: 1e-6).
- the model: logits atol 1e-5 (seen: 1.1e-6 at full width), loss and
  accuracy 1e-6, gradients within 1e-4 of each leaf's largest |gradient|
  (seen: 4.5e-6).
- the example, one round: labels, simulated minutes, kJ, comm bytes and
  step budgets equal (cost-model arithmetic on equal step counts and
  bytes); accuracy within 0.005 (local SGD in two frameworks over ~30
  steps; seen at 32 x 32: equal to 1e-9 after one round, within 8.3e-4
  after two).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (each xdist worker's share of the cores)
import torch.nn.functional as F

from repro.configs.base import get_config as jget_config
from repro.configs.resnet18_cifar10 import CNN_CONFIG as JCNN
from repro.core import protocol as jprotocol
from repro.models import build_model as jbuild_model
from repro.models import resnet as jresnet
from repro.models.layers.norms import groupnorm as jgroupnorm
from repro_torch.configs.base import get_config
from repro_torch.configs.resnet18_cifar10 import CNN_CONFIG
from repro_torch.core import protocol as tprotocol
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import resnet
from repro_torch.models.layers.norms import groupnorm
from repro_torch.utils.pytree import tree_leaves, tree_unflatten

ARCH = "resnet18-cifar10"
SIZES = {False: (62, 11_173_962), True: (20, 19_994)}  # (leaves, values) by reduced


def _arch(reduced: bool):
    return get_config(ARCH).reduced() if reduced else get_config(ARCH)


@functools.cache
def _jax(reduced: bool):
    jm = jbuild_model(jget_config(ARCH).reduced() if reduced else jget_config(ARCH))
    return jm, jm.init(jax.random.key(0))


def _carried(reduced: bool):
    return params_from_numpy(jax.tree.map(np.asarray, _jax(reduced)[1]), "cpu")


def _images(seed: int, n: int = 4, size: int = 32, c: int = 3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, size, size, c)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _jconv(x, w, stride):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))


@pytest.mark.parametrize("size", [32, 16, 7, 1])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_matches_lax_same(stride, k, size):
    rng = np.random.default_rng(100 * stride + 10 * k + size)
    x = rng.normal(size=(2, size, size, 8)).astype(np.float32)
    w = (rng.normal(size=(k, k, 8, 16)) / np.sqrt(8 * k * k)).astype(np.float32)
    want = _jconv(x, w, stride)
    got = resnet.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
    assert got.shape == want.shape == (2, -(-size // stride), -(-size // stride), 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_symmetric_pad_fails_at_stride_2():
    """XLA's SAME pads a 3x3 stride-2 conv on an even size (0, 1); the
    symmetric (1, 1) of ``F.conv2d(padding=1)`` samples other pixels and
    is far off, while the port's conv matches."""
    x, _ = _images(7, n=2, size=32, c=16)
    w = (np.random.default_rng(8).normal(size=(3, 3, 16, 32)) / 12).astype(np.float32)
    want = _jconv(x, w, 2)
    sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
    assert sym.shape[2:] == want.shape[1:3]
    assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 0.5
    assert resnet._same_pads(32, 3, 2) == (0, 1) and resnet._same_pads(32, 1, 2) == (0, 0)
    got = resnet.conv2d(torch.from_numpy(x), torch.from_numpy(w), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [16, 64, 512])
def test_groupnorm_matches_jax(c):
    rng = np.random.default_rng(c)
    x = (rng.normal(size=(3, 8, 8, c)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32)
    want = np.asarray(jgroupnorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    got = groupnorm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@functools.cache
def _jax_outputs(reduced: bool, seed: int):
    jm, jp = _jax(reduced)
    x, y = _images(seed)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    logits = jax.jit(lambda p: jresnet.forward(jm.cfg, p, batch["x"]))(jp)
    (loss, met), grads = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(p, batch),
                                                    has_aux=True))(jp)
    return (np.asarray(logits), float(loss), float(met["acc"]),
            [np.asarray(g) for g in jax.tree.leaves(grads)])


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full-width"])
def test_forward_loss_and_grads_match_jax(reduced):
    """Batch 4 through JAX's params: logits, ce, acc and every leaf's
    gradient (module docstring's tolerances)."""
    tm = build_model(_arch(reduced), device="cpu")
    x, y = _images(1)
    jlogits, jloss, jacc, jgrads = _jax_outputs(reduced, 1)
    leaves = [t.requires_grad_() for t in tree_leaves(_carried(reduced))]
    params = tree_unflatten(_carried(reduced), leaves)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    logits = resnet.forward(tm.cfg, params, batch["x"])
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, rtol=0, atol=1e-5)
    loss, met = tm.loss_fn(params, batch)
    assert set(met) == {"ce", "acc"} and met["ce"] is loss
    assert abs(float(loss.detach()) - jloss) <= 1e-6 and abs(float(met["acc"]) - jacc) <= 1e-6
    grads = torch.autograd.grad(loss, leaves)
    assert len(grads) == len(jgrads) == SIZES[reduced][0]
    for g, jg in zip(grads, jgrads, strict=True):
        assert g.shape == jg.shape
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full-width"])
def test_param_tree_matches_jax(reduced):
    """The reference's tree and leaf order, 62 / 20 leaves of 11,173,962 /
    19,994 values (``fc_b`` first: the dict keys sort), and the wire bytes
    of ``pytree_to_parameters`` equal to JAX's."""
    jm, jp = _jax(reduced)
    tp = _carried(reduced)
    assert sorted(tp) == sorted(jp) == ["fc_b", "fc_w", "stages", "stem", "stem_n"]
    assert [len(s) for s in tp["stages"]] == list(jm.cfg.stage_sizes)
    jleaves, tleaves = jax.tree.leaves(jp), tree_leaves(tp)
    n_leaves, n_values = SIZES[reduced]
    assert len(jleaves) == len(tleaves) == n_leaves
    assert sum(t.numel() for t in tleaves) == n_values
    assert [tuple(t.shape) for t in tleaves] == [x.shape for x in jleaves]
    assert tuple(tleaves[0].shape) == (10,)
    jw, tw = jprotocol.pytree_to_parameters(jp), tprotocol.pytree_to_parameters(tp)
    assert tw.manifest == jw.manifest and tw.tensors == jw.tensors


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full-width"])
def test_init_shapes_dtypes_and_scale(reduced):
    """The port draws its own numbers (torch's generator): the reference's
    shapes, dtypes and leaf order; convs He-normal (std sqrt(2 / fan_in)),
    ``fc_w`` std 1 / sqrt(width), norms at scale 1 and bias 0, ``fc_b`` 0;
    the same seed draws the same params, another seed others."""
    tm = build_model(_arch(reduced), device="cpu")
    p = tm.init(0)
    shapes = jax.eval_shape(lambda: _jax(reduced)[0].init(jax.random.key(0)))
    jleaves = jax.tree.leaves(shapes)
    tleaves = tree_leaves(p)
    assert [tuple(t.shape) for t in tleaves] == [x.shape for x in jleaves]
    assert all(t.dtype == torch.float32 and x.dtype == np.float32
               for t, x in zip(tleaves, jleaves))
    convs = [p["stem"]] + [b[k] for s in p["stages"] for b in s
                           for k in ("conv1", "conv2", "proj") if k in b]
    for w in convs:
        fan_in = w.shape[0] * w.shape[1] * w.shape[2]
        std = float(w.std()) / np.sqrt(2.0 / fan_in)
        assert abs(std - 1.0) < 6 / np.sqrt(2 * w.numel()), (tuple(w.shape), std)
        assert abs(float(w.mean())) < 6 * np.sqrt(2.0 / fan_in / w.numel())
    width = tm.cfg.stage_widths[-1]
    assert abs(float(p["fc_w"].std()) * np.sqrt(width) - 1.0) < 6 / np.sqrt(2 * p["fc_w"].numel())
    norms = [p["stem_n"]] + [b[k] for s in p["stages"] for b in s
                             for k in ("n1", "n2", "proj_n") if k in b]
    assert all(torch.equal(n["scale"], torch.ones_like(n["scale"]))
               and not n["bias"].any() for n in norms)
    assert not p["fc_b"].any()
    again, other = tree_leaves(tm.init(0)), tree_leaves(tm.init(1))
    assert all(torch.equal(a, b) for a, b in zip(tleaves, again))
    assert not torch.equal(tleaves[2], other[2])


def test_build_model_cnn_family_and_the_card_default(monkeypatch):
    """Both configs build on the CPU with the reference's CNN config; the
    default device is the card, which raises without one."""
    for reduced, cfg in ((False, CNN_CONFIG), (True, CNN_CONFIG.reduced())):
        tm = build_model(_arch(reduced), device="cpu")
        assert tm.cfg == cfg and tm.trainable_mask is None
        assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(
            JCNN.reduced() if reduced else JCNN)
        assert tm.device.type == "cpu" and tree_leaves(tm.init(0))[0].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.init_params(CNN_CONFIG.reduced(), 0)


# the example parity test's images: 8 x 8 (the reduced config's 32 x 32 cut;
# every conv, pad and stride of the reduced net still runs), so the JAX
# loop's scanned CPU convs take ~20 s instead of ~110 (8 CPU cores)
EXAMPLE_IMAGE = 8


def _jax_example(rounds: int):
    """The JAX example's loop (``examples/heterogeneous_cutoff.py``, which
    runs at import) at ``rounds`` rounds on ``EXAMPLE_IMAGE`` images: per
    run the label, History and step budgets."""
    from repro.core import BandwidthCodecPolicy, FedTau, JaxClient, PROFILES, Server
    from repro.core.server import make_cost_model_for
    from repro.data.federated import dirichlet_partition
    from repro.data.synthetic import make_classification

    cfg = dataclasses.replace(JCNN.reduced(), image_size=EXAMPLE_IMAGE)
    data = make_classification(n=1200, num_classes=cfg.num_classes,
                               shape=(cfg.image_size, cfg.image_size, 3), noise=1.2)
    shards = dirichlet_partition(data, n_clients=4, alpha=1.0)
    loss_fn = lambda p, b: jresnet.loss_fn(cfg, p, b)  # noqa: E731
    profiles = [PROFILES["jetson-tx2-gpu"], PROFILES["jetson-tx2-cpu"]] * 2
    params = jresnet.init_params(jax.random.key(0), cfg)
    clients = [JaxClient(client_id=s.client_id, loss_fn=loss_fn, dataset=s,
                         batch_size=32, device_profile=p.name)
               for s, p in zip(shards, profiles)]
    cost_model = make_cost_model_for(params, profiles)
    spe = clients[0].steps_per_epoch()
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
        server = Server(strategy=strat, clients=clients, cost_model=cost_model)
        server.logger.quiet = True
        _, hist = server.run(jresnet.init_params(jax.random.key(0), cfg), num_rounds=rounds)
        out.append({"label": label, "history": hist,
                    "budgets": strat.client_step_budgets(range(4))})
    return out


def test_example_matches_the_jax_example(monkeypatch, capsys):
    """``run`` at the reduced config on ``EXAMPLE_IMAGE`` images, one round,
    from JAX's init, against the JAX example's loop: labels, simulated
    minutes and kJ, comm bytes (the Jetsons' Int8 wires and the downlinks)
    and FedTau's step budgets equal; accuracy within 0.005."""
    from repro_torch.examples import heterogeneous_cutoff as example

    jinit = jresnet.init_params
    monkeypatch.setattr(resnet, "init_params", lambda cfg, seed=0, *, device=None:
                        params_from_numpy(jax.tree.map(np.asarray, jinit(
                            jax.random.key(seed), cfg)), device))
    want = _jax_example(rounds=1)
    got = example.run(dataclasses.replace(CNN_CONFIG.reduced(), image_size=EXAMPLE_IMAGE),
                      device="cpu", rounds=1)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all("step-budgets=" in line for line in lines)
    assert [g["label"] for g in got] == [w["label"] for w in want]
    for g, w in zip(got, want, strict=True):
        gh, wh = g["history"], w["history"]
        assert g["budgets"] == w["budgets"]
        assert (gh.total_time_s / 60, gh.total_energy_j / 1e3) == (
            wh.total_time_s / 60, wh.total_energy_j / 1e3)
        assert [r.comm_bytes for r in gh.rounds] == [r.comm_bytes for r in wh.rounds]
        assert [r.steps for r in gh.rounds] == [r.steps for r in wh.rounds]
        assert abs(gh.final_accuracy() - wh.final_accuracy()) <= 0.005, (
            g["label"], gh.final_accuracy(), wh.final_accuracy())
    # the cutoff cut the CPU clients' steps and the round's simulated time
    assert got[1]["budgets"] != got[0]["budgets"]
    assert got[1]["history"].total_time_s < got[0]["history"].total_time_s


def test_chip_smoke_resnet_constants():
    """The sizes ``chip_smoke.py``'s phase 10 holds the card to are the
    model's and its codecs': N and the leaf count from JAX's
    ``eval_shape``, the Int8 wire and padded length, TopK's k at 1%."""
    import importlib.util
    from pathlib import Path

    from repro_torch.core import Int8Codec, TopKCodec

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    leaves = jax.tree.leaves(jax.eval_shape(lambda: _jax(False)[0].init(jax.random.key(0))))
    n = sum(x.size for x in leaves)
    assert (chip_smoke.RESNET_N, len(leaves)) == (n, 62)
    assert chip_smoke.RESNET_NP == -(-n // 256) * 256
    assert chip_smoke.RESNET_INT8_WIRE == Int8Codec().wire_bytes(n)
    assert chip_smoke.RESNET_TOPK_K == TopKCodec(frac=0.01).k_of(n)
