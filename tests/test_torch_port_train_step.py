"""The port's whole GAN train step against aero_tpu's ``make_train_step``
on the CPU in float32: the tiny config of ``tests/test_train_step.py`` with
1 s segments (T = 251 frames > 200, so the BLSTM's chunking runs), from
JAX-initialised variables carried across, with ``accum_steps`` 1 and 2.

Both steps see the same microbatches of 4: batch 4 at accum 1 and batch 8
at accum 2, so one jitted JAX gradient function serves both."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aero_tpu.train import build as jbuild
from aero_tpu.train.train_step import (
    LossComputer as JaxLossComputer, init_state, make_train_step)
from aero_tpu_torch.models import modules as M
from aero_tpu_torch.train import build as pbuild
from aero_tpu_torch.train.from_jax import (
    export_aero_state, export_melgan_state, melgan_state_dict_from_jax,
    state_dict_from_jax)
from aero_tpu_torch.train.train_step import TrainStep
from aero_tpu_torch.utils.config import Config
from test_train_step import tiny_args

pytestmark = pytest.mark.torch_port

MICRO = 4                # microbatch size of every case
METRIC_RTOL = 1e-4       # float32; sums in different orders
# Gradients, every leaf against that leaf's own max |grad|: the
# discriminator's to GRAD_TOL, the generator's to GEN_LEAF_TOL. Against
# the float64 gradient (the port's, run in float64), the JAX package's own
# float32 generator gradient is off by up to 2.3e-2 of a leaf's max on
# this config, in its small FTB BatchNorm, GroupNorm, Snake and LayerScale
# leaves, and the port's by up to 2.6e-3
# (``test_generator_grads_against_float64``): a per-leaf 1e-3 against JAX
# would measure JAX's rounding. The whole flattened generator gradient is
# held to GRAD_TOL in relative L2, and the leaves whose gradient is zero
# in exact arithmetic (``_nought_leaves``) to GRAD_TOL of the network's
# max.
GRAD_TOL = 1e-3
GEN_LEAF_TOL = 5e-2
F64_PORT_TOL = 1e-2      # port float32 vs port float64, of a leaf's max
NOUGHT_F64 = 1e-12       # a nought leaf in float64, of the network's max
BN_ATOL = 1e-5           # running statistics, O(1)
WEIGHT_ATOL = 1e-6       # Adam's first step moves a weight by ~lr = 3e-4
ACCUMS = [1, 2]


def _args(accum):
    args = tiny_args()
    args.experiment.segment = 1.0
    args.experiment.batch_size = MICRO * accum
    args["accum_steps"] = accum
    return args


@pytest.fixture(scope="module")
def jax_side():
    """JAX models, initialised variables and a jitted gradient function
    of one microbatch through the JAX LossComputer's losses."""
    args = _args(1)
    models = jbuild.build_models(args)
    lr_shape, hr_shape = jbuild.segment_shapes(args)
    variables = jax.tree.map(np.asarray, jbuild.init_variables(
        args, models, jax.random.PRNGKey(0), lr_shape, hr_shape))
    lc = JaxLossComputer(args, models)
    gen = models["generator"]

    def gen_loss(params, batch_stats, disc_params, lr, hr):
        pr, _ = gen.apply({"params": params, "batch_stats": batch_stats}, lr,
                          train=True, mutable=["batch_stats"])
        losses = lc.generator_losses(pr, hr, disc_params, {}, train=True)
        return sum(losses.values()), pr

    def disc_loss(disc_params, pr, hr):
        losses, _ = lc.discriminator_losses(pr, hr, disc_params, {},
                                            train=True)
        return sum(losses.values())

    @jax.jit
    def grads(params, batch_stats, disc_params, lr, hr):
        (_, pr), g_gen = jax.value_and_grad(gen_loss, has_aux=True)(
            params, batch_stats, disc_params, lr, hr)
        g_disc = jax.grad(disc_loss)(disc_params, jax.lax.stop_gradient(pr),
                                     hr)
        return g_gen, g_disc

    return models, variables, grads


def _batch(accum):
    rng = np.random.default_rng(accum)
    n = MICRO * accum
    lr = (0.1 * rng.standard_normal((n, 1, 4000))).astype(np.float32)
    hr = (0.1 * rng.standard_normal((n, 1, 16000))).astype(np.float32)
    return lr, hr


def _port_models(accum, variables, n_layers):
    """(config, the port's models on the CPU with the JAX variables)."""
    pargs = Config._wrap(dict(_args(accum)))
    pm = pbuild.build_models(pargs, device="cpu")
    pm["generator"].load_state_dict(
        state_dict_from_jax(variables["generator"]), strict=True)
    pm["msd_melgan"].load_state_dict(melgan_state_dict_from_jax(
        variables["msd_melgan"]["params"], n_layers), strict=True)
    return pargs, pm


@pytest.fixture(scope="module")
def runs(jax_side):
    """Per accum: the JAX step's result and mean microbatch gradients, and
    the port's gradients, metrics and state after its step."""
    models, variables, grads = jax_side
    n_layers = models["msd_melgan"].n_layers
    out = {}
    for accum in ACCUMS:
        args = _args(accum)
        lr, hr = _batch(accum)
        gvars = variables["generator"]
        dparams = {"msd_melgan": variables["msd_melgan"]["params"]}
        step = make_train_step(args, models, mesh=None, donate=False)
        state = init_state(args, models, variables, jax.random.PRNGKey(1))
        new_state, jax_metrics = step(state, jnp.asarray(lr), jnp.asarray(hr))
        g_gen, g_disc = [], []
        for i in range(accum):
            sl = slice(i * MICRO, (i + 1) * MICRO)
            gg, dg = grads(gvars["params"], gvars["batch_stats"], dparams,
                           jnp.asarray(lr[sl]), jnp.asarray(hr[sl]))
            g_gen.append(export_aero_state({"params": jax.tree.map(
                np.asarray, gg)}))
            g_disc.append(export_melgan_state(jax.tree.map(
                np.asarray, dg["msd_melgan"]), n_layers))

        def mean(dicts):
            return {k: np.mean([d[k] for d in dicts], axis=0)
                    for k in dicts[0]}

        pargs, pm = _port_models(accum, variables, n_layers)
        ts = TrainStep(pargs, pm, device="cpu")
        p_gen, p_disc, p_metrics, _ = ts.grads(lr, hr)
        names = ([n for n, _ in pm["generator"].named_parameters()],
                 [n for n, _ in pm["msd_melgan"].named_parameters()])
        step_metrics = ts(lr, hr)
        out[accum] = dict(
            jax_metrics={k: float(v) for k, v in jax_metrics.items()},
            jax_state=jax.tree.map(np.asarray, new_state),
            jax_grads=(mean(g_gen), mean(g_disc)),
            port_grads=(dict(zip(names[0], p_gen)),
                        dict(zip(names[1], p_disc))),
            port_metrics=(p_metrics, step_metrics), port_models=pm)
    return out


@pytest.mark.parametrize("accum", ACCUMS)
def test_metrics_match_jax(runs, accum):
    r = runs[accum]
    want = r["jax_metrics"]
    for got in r["port_metrics"]:  # from grads() and from the step
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - want[k]) <= METRIC_RTOL * abs(want[k]), (
                k, got[k], want[k])


def _nought_leaves(model):
    """Generator leaves whose gradient is zero in exact arithmetic, so that
    float32 leaves only rounding (float64 gives <= 1e-15 of the network's
    max): the bias of a conv whose next layer normalises each of its
    channels alone (BatchNorm, or GroupNorm with one channel per group),
    and LocalState's key bias, which shifts every score of a query by the
    same amount."""
    out = set()
    for name, m in model.named_modules():
        if isinstance(m, M.LocalState):
            out.add(f"{name}.key.bias")
        if isinstance(m, torch.nn.Sequential) and len(m) > 1:
            norm = m[1]
            conv = (torch.nn.Conv1d, torch.nn.Conv2d)
            if isinstance(m[0], conv) and m[0].bias is not None and (
                    isinstance(norm, M.BatchNorm)
                    or (isinstance(norm, M.GroupNorm)
                        and norm.num_groups == norm.num_channels)):
                out.add(f"{name}.0.bias")
    return out


def _grad_bands(want, net, model):
    """{leaf: max |got - want| allowed} (see GRAD_TOL)."""
    if net == "discriminator":
        return {k: GRAD_TOL * float(np.abs(w).max()) for k, w in want.items()}
    nought = _nought_leaves(model)
    assert nought <= set(want)
    net_band = GRAD_TOL * max(float(np.abs(w).max()) for w in want.values())
    return {k: net_band if k in nought
            else GEN_LEAF_TOL * float(np.abs(w).max()) for k, w in want.items()}


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_grads_match_jax(runs, accum, net):
    i = 0 if net == "generator" else 1
    want, got = runs[accum]["jax_grads"][i], runs[accum]["port_grads"][i]
    assert sorted(got) == sorted(want)
    model = runs[accum]["port_models"]["generator" if i == 0 else "msd_melgan"]
    bands = _grad_bands(want, net, model)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= bands[k], (
            k, float(np.abs(g - w).max()), bands[k])
    flat_w = np.concatenate([w.ravel() for w in want.values()])
    flat_g = np.concatenate([got[k].numpy().ravel() for k in want])
    assert (np.linalg.norm(flat_g - flat_w)
            <= GRAD_TOL * np.linalg.norm(flat_w))


def _float64_grads(accum, variables, n_layers, lr, hr, monkeypatch):
    """The port's generator gradient in float64: weights, inputs, compute
    dtypes and every float32 cast of the port (``Tensor.float``, the Hann
    window) lifted to float64."""
    pargs, pm = _port_models(accum, variables, n_layers)
    for model in pm.values():
        model.double()
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
    to_f32, hann = torch.Tensor.float, torch.hann_window
    monkeypatch.setattr(torch.Tensor, "float", lambda x, *a, **k: (
        x if x.dtype == torch.float64 else to_f32(x, *a, **k)))
    monkeypatch.setattr(torch, "hann_window", lambda *a, **k: hann(
        *a, **{**k, "dtype": torch.float64}))
    ts = TrainStep(pargs, pm, device="cpu")
    ts._tensor = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64)
    grads = ts.grads(lr, hr)[0]
    assert all(g.dtype == torch.float64 for g in grads)
    names = [n for n, _ in pm["generator"].named_parameters()]
    return {n: g.numpy() for n, g in zip(names, grads)}


@pytest.mark.parametrize("accum", ACCUMS)
def test_generator_grads_against_float64(jax_side, runs, accum, monkeypatch):
    """What GEN_LEAF_TOL and the nought leaves rest on, against the port's
    float64 gradient: the nought leaves read zero, the port's float32
    gradient is within F64_PORT_TOL of each leaf's max, and the JAX
    package's float32 gradient within GEN_LEAF_TOL."""
    models, variables, _ = jax_side
    lr, hr = _batch(accum)
    want = _float64_grads(accum, variables, models["msd_melgan"].n_layers,
                          lr, hr, monkeypatch)
    net_max = max(float(np.abs(w).max()) for w in want.values())
    nought = _nought_leaves(runs[accum]["port_models"]["generator"])
    sides = {"port": {k: g.numpy() for k, g in
                      runs[accum]["port_grads"][0].items()},
             "jax": runs[accum]["jax_grads"][0]}
    worst = dict.fromkeys(sides, (0.0, ""))
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if k in nought:
            assert scale <= NOUGHT_F64 * net_max, (k, scale / net_max)
            continue
        for side, got in sides.items():
            worst[side] = max(worst[side],
                              (float(np.abs(got[k] - w).max()) / scale, k))
    print(f"accum {accum}, worst leaf against float64, of its max: {worst}")
    assert worst["port"][0] <= F64_PORT_TOL, worst
    assert worst["jax"][0] <= GEN_LEAF_TOL, worst


def test_accum_grads_are_the_microbatch_mean(jax_side, runs):
    """accum_steps = 2 gives exactly the mean of the two microbatches'
    gradients, each taken alone from the same state."""
    models, variables, _ = jax_side
    lr, hr = _batch(2)
    halves = []
    for i in range(2):
        pargs, pm = _port_models(1, variables, models["msd_melgan"].n_layers)
        sl = slice(i * MICRO, (i + 1) * MICRO)
        halves.append(TrainStep(pargs, pm, device="cpu").grads(
            lr[sl], hr[sl])[0])
    got = runs[2]["port_grads"][0].values()
    for g, a, b in zip(got, *halves):
        torch.testing.assert_close(g, (a + b) / 2, rtol=0, atol=0)


@pytest.mark.parametrize("accum", ACCUMS)
def test_batchnorm_running_stats_match_jax(runs, accum):
    r = runs[accum]
    want = export_aero_state({"batch_stats": r["jax_state"].gen_state[
        "batch_stats"]})
    got = r["port_models"]["generator"].state_dict()
    assert want and all(k.endswith(("running_mean", "running_var"))
                        for k in want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, atol=BN_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("accum", ACCUMS)
def test_updated_weights_match_jax(runs, accum):
    """Adam's first step is about lr * sign(g), so compare each weight only
    where the sign of g is settled: |g| > 1e-6 and beyond twice the band
    the gradient test allows."""
    r = runs[accum]
    s = r["jax_state"]
    n_layers = r["port_models"]["msd_melgan"].n_layers
    pairs = [
        (export_aero_state({"params": s.gen_params}), r["jax_grads"][0],
         r["port_models"]["generator"], "generator"),
        (export_melgan_state(s.disc_params["msd_melgan"], n_layers),
         r["jax_grads"][1], r["port_models"]["msd_melgan"], "discriminator"),
    ]
    moved = 0
    for want, grads, model, net in pairs:
        got = dict(model.named_parameters())
        bands = _grad_bands(grads, net, model)
        for k, w in want.items():
            mask = np.abs(grads[k]) > max(1e-6, 2 * bands[k])
            g = got[k].detach().numpy()
            np.testing.assert_allclose(g[mask], w[mask], atol=WEIGHT_ATOL,
                                       err_msg=k)
            moved += int(mask.sum())
    assert moved > 0


def test_indivisible_batch_raises(runs):
    pm = runs[1]["port_models"]
    ts = TrainStep(Config._wrap(dict(_args(2))), pm, device="cpu")
    lr, hr = _batch(1)
    with pytest.raises(ValueError):
        ts.grads(lr[:3], hr[:3])
