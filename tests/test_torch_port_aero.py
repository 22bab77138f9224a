"""The port's whole Aero forward against aero_tpu's with the same weights
(float32, CPU), its state_dict layout at canonical width, and its built-in
canonical config against the YAML."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aero_tpu.models.aero import Aero as JaxAero
from aero_tpu.models.init import rescale_tree
from aero_tpu.train.torch_import import export_aero_state
from aero_tpu.utils.config import load_config
from aero_tpu_torch.models.aero import Aero
from aero_tpu_torch.models.factory import CANONICAL_AERO_4_16, build_generator
from aero_tpu_torch.train.from_jax import state_dict_from_jax

pytestmark = pytest.mark.torch_port

CONF = os.path.join(os.path.dirname(__file__), "..", "conf")

TINY = dict(load_config(CONF, "main_config", ["experiment=tiny"])
            .experiment.aero)
# the canonical structure (strides 4,4,2,2, FTB on every encoder, BLSTM and
# LocalState in enc2/enc3) at a third of its width
NARROW = dict(CANONICAL_AERO_4_16, channels=16)


def _perturbed(tree, rng, path=()):
    """LayerScale to O(1), norm affines and BatchNorm statistics off their
    defaults, so every branch reaches the output."""
    if isinstance(tree, dict):
        return {k: _perturbed(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    name, parent = path[-1], path[-2]
    if parent.endswith("_scale"):
        return rng.uniform(0.5, 1.0, a.shape).astype(np.float32)
    if parent in ("gn", "bn") and name == "scale":
        return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if parent in ("gn", "bn") and name == "bias" or name == "mean":
        return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    if name == "var":
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    return a


def _jax_kwargs(kw):
    kw = dict(kw)
    kw["strides"] = tuple(kw["strides"])
    return kw


@pytest.mark.parametrize("config,seconds", [(TINY, 1.0), (NARROW, 3.0)],
                         ids=["tiny", "narrow_canonical"])
def test_forward_matches_jax(config, seconds):
    """narrow_canonical at 3 s: T = 751 frames, so BLSTM chunking and the
    T > 512 attention dispatch both run."""
    jm = JaxAero(**_jax_kwargs(config))
    rng = np.random.default_rng(0)
    x = (0.1 * rng.standard_normal((2, 1, int(4000 * seconds)))).astype(
        np.float32)
    v = jax.jit(lambda k, y: jm.init(k, y, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": rescale_tree(v["params"], config["rescale"]),
         "batch_stats": v["batch_stats"]}
    v = _perturbed(jax.tree.map(np.asarray, v), rng)
    want = np.asarray(jax.jit(lambda vv, y: jm.apply(vv, y, train=False))(
        v, jnp.asarray(x)))

    port = Aero(**config).eval()
    port.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 4 * x.shape[-1])
    # float32 on the CPU; relative to the output's scale
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_canonical_state_dict_layout_matches_export():
    """Keys and shapes of the JAX init, exported, equal the port's."""
    jm = JaxAero(**_jax_kwargs(CANONICAL_AERO_4_16))
    abstract = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 1, 8000)), train=False),
        jax.random.PRNGKey(0))
    zeros = {coll: jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                abstract[coll])
             for coll in ("params", "batch_stats")}
    want = {k: tuple(v.shape) for k, v in export_aero_state(zeros).items()}
    port = build_generator(CANONICAL_AERO_4_16, device="cpu")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want


def test_canonical_config_equals_yaml():
    exp = load_config(CONF, "main_config",
                      ["experiment=aero_4-16_512_64"]).experiment
    assert dict(exp.aero) == CANONICAL_AERO_4_16


def test_seeded_init_is_deterministic_and_rescaled():
    a = build_generator(TINY, device="cpu", seed=3).state_dict()
    b = build_generator(TINY, device="cpu", seed=3).state_dict()
    c = build_generator(TINY, device="cpu", seed=4).state_dict()
    raw = build_generator(dict(TINY, rescale=0), device="cpu",
                          seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.0.conv.weight"],
                           c["encoder.0.conv.weight"])
    decay = "encoder.1.dconv.layers.0.time_attn.query_decay.bias"
    assert torch.all(raw[decay] == -2.0)
    conv1d = [k[:-len(".weight")] for k, v in a.items()
              if k.endswith(".weight") and v.dim() == 3]
    # per encoder: FTB conv1d, DConv conv1 and conv2; in enc1 LocalState x5
    assert len(conv1d) == 11
    for name in conv1d:  # weight and bias / sqrt(std(weight) / 0.1)
        scale = (raw[name + ".weight"].std(unbiased=False) / 0.1).sqrt()
        for leaf in ("weight", "bias"):
            torch.testing.assert_close(a[f"{name}.{leaf}"],
                                       raw[f"{name}.{leaf}"] / scale)


@pytest.mark.parametrize("config", [TINY, NARROW],
                         ids=["tiny", "narrow_canonical"])
def test_port_export_equals_aero_tpu_export(config):
    """The port's own copy of the variable -> reference-key mapping gives
    aero_tpu's keys, shapes and values, leaf for leaf."""
    from aero_tpu_torch.train.from_jax import export_aero_state as port_export

    jm = JaxAero(**_jax_kwargs(config))
    abstract = jax.eval_shape(
        lambda k: jm.init(k, jnp.zeros((1, 1, 4000)), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    variables = {coll: jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        abstract[coll]) for coll in ("params", "batch_stats")}
    want = export_aero_state(variables)
    got = port_export(variables)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
