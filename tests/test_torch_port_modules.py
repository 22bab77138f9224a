"""The port's FTB, BLSTM, LocalState and DConv against the JAX modules with
the same weights, carried over by the state_dict bridge. float32, CPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aero_tpu.models import modules as jm
from aero_tpu_torch.models import modules as pm
from aero_tpu_torch.train.from_jax import state_dict_from_jax

pytestmark = pytest.mark.torch_port

ATOL = 2e-5  # float32, both on the CPU; sums in different orders


def perturb(tree, rng, path=()):
    """Move the init's constant leaves (norm affines and statistics,
    LayerScale) off their defaults, so the mapping of each is exercised."""
    if isinstance(tree, dict):
        return {k: perturb(v, rng, path + (k,)) for k, v in tree.items()}
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


def _jax_vars(module, *args, seed=0):
    v = module.init(jax.random.PRNGKey(seed), *args)
    v = {k: jax.tree.map(np.asarray, v[k]) for k in ("params", "batch_stats")
         if k in v}
    return perturb(v, np.random.default_rng(seed))


def _port_state(variables, nest, prefix):
    """Nest a module's variables where it sits in an Aero, export the Aero
    keys, keep those under ``prefix`` and strip it."""
    def wrap(tree):
        for name in reversed(nest):
            tree = {name: tree}
        return tree

    full = {coll: wrap(tree) for coll, tree in variables.items()}
    sd = state_dict_from_jax(full)
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _load(module, variables, nest, prefix):
    module.load_state_dict(_port_state(variables, nest, prefix), strict=True)
    return module.eval()


def test_ftb_eval():
    b, f, t, c = 2, 16, 40, 6
    x = np.random.default_rng(1).standard_normal((b, f, t, c)).astype(
        np.float32)
    jmod = jm.FTB(input_dim=f, in_channel=c)
    v = _jax_vars(jmod, jnp.asarray(x), False)
    want = np.asarray(jmod.apply(v, jnp.asarray(x), False))
    port = _load(pm.FTB(f, c), v, ("encoder_0", "freq_attn_block"),
                 "encoder.0.freq_attn_block.")
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL, rtol=1e-5)


def test_blstm_chunked():
    """T = 450 > max_steps = 200: overlapped chunks and the stitch trim."""
    n, t, c = 3, 450, 8
    x = np.random.default_rng(2).standard_normal((n, t, c)).astype(np.float32)
    jmod = jm.BLSTM(c, layers=2, max_steps=200, skip=True)
    v = _jax_vars(jmod, jnp.asarray(x), False)
    want = np.asarray(jmod.apply(v, jnp.asarray(x), False))
    port = _load(pm.BLSTM(c), v,
                 ("encoder_0", "dconv", "layers_0_lstm"),
                 "encoder.0.dconv.layers.0.lstm.")
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=ATOL)


@pytest.mark.parametrize("t", [300, 600])
def test_local_state(t):
    """T = 300 is the JAX dense branch, T = 600 its query-block scan."""
    n, c = 2, 16
    x = np.random.default_rng(3).standard_normal((n, t, c)).astype(np.float32)
    jmod = jm.LocalState(c, heads=4, ndecay=4)
    v = _jax_vars(jmod, jnp.asarray(x))
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    port = _load(pm.LocalState(c, heads=4, ndecay=4), v,
                 ("encoder_0", "dconv", "layers_0_time_attn"),
                 "encoder.0.dconv.layers.0.time_attn.")
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=ATOL)


def test_local_state_nfreqs_not_ported():
    with pytest.raises(NotImplementedError):
        pm.LocalState(16, nfreqs=2)


def test_dconv_with_lstm_and_attention():
    """The enc2/enc3 DConv: depth 2 (dilations 1, 2), Snake per frequency,
    BLSTM and LocalState, on [B, F, T, C] rows batched as B*F."""
    b, f, t, c = 2, 4, 240, 16
    x = np.random.default_rng(4).standard_normal((b, f, t, c)).astype(
        np.float32)
    kw = dict(compress=4, depth=2, init_value=1e-3, time_attn=True,
              lstm=True, act_func="snake", freq_dim=f)
    jmod = jm.DConv(c, reshape=True, **kw)
    v = _jax_vars(jmod, jnp.asarray(x), False)
    want = np.asarray(jmod.apply(v, jnp.asarray(x), False))
    port = _load(pm.DConv(c, **kw), v, ("encoder_0", "dconv"),
                 "encoder.0.dconv.")
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL)


def test_unfold_time_matches_jax():
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)  # [B, T, C]
    want = np.asarray(jm.unfold_time(jnp.asarray(x), 4, 2))  # [B, n, W, C]
    got = pm.unfold_time(torch.from_numpy(x).transpose(1, 2), 4, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("shape", [(4, 5, 16, 30), (3, 6, 40)])
def test_batchnorm_train_mode_matches_jax(shape):
    """Batch statistics in float32 (biased variance to normalise), output
    and gradient against _RawBatchNorm(train=True); the running statistics
    after the port's update against JAX's (momentum 0.1, unbiased var)."""
    x = (1.5 + np.random.default_rng(5).standard_normal(shape)).astype(
        np.float32)
    c = shape[1]
    jmod = jm._RawBatchNorm()
    v = _jax_vars(jmod, jnp.asarray(x), False, 1, seed=5)
    v["params"] = perturb(v["params"], np.random.default_rng(6), ("bn",))
    v["batch_stats"] = perturb(v["batch_stats"], np.random.default_rng(7),
                               ("bn",))
    g = np.random.default_rng(8).standard_normal(shape).astype(np.float32)

    def jfwd(params, xx):
        y, upd = jmod.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx, True, 1,
                            mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (want, upd)), want_grads = jax.value_and_grad(
        jfwd, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    port = pm.BatchNorm(c)
    port.load_state_dict({
        "weight": torch.from_numpy(v["params"]["scale"]),
        "bias": torch.from_numpy(v["params"]["bias"]),
        "running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(v["batch_stats"]["var"])})
    port.train()
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt)
    got_grads = torch.autograd.grad(got, (port.weight, port.bias, xt),
                                    torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    for a, e in zip(got_grads, (want_grads[0]["scale"],
                                want_grads[0]["bias"], want_grads[1])):
        e = np.asarray(e)
        np.testing.assert_allclose(a.numpy(), e,
                                   atol=1e-5 * max(1, np.abs(e).max()))
    port.update_running_stats(*port.batch_stats)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6)
    port.eval()  # the running statistics normalise again
    with torch.no_grad():
        y = port(xt)
    mean, var = port.running_mean, port.running_var
    ref = (xt - mean.view(1, -1, *[1] * (len(shape) - 2))) * torch.rsqrt(
        var + 1e-5).view(1, -1, *[1] * (len(shape) - 2))
    ref = ref * port.weight.view(1, -1, *[1] * (len(shape) - 2)) \
        + port.bias.view(1, -1, *[1] * (len(shape) - 2))
    np.testing.assert_allclose(y.numpy(), ref.detach().numpy(), atol=ATOL)
