"""The port's HiFi-GAN path against aero_tpu on the CPU in float32: the mel
filterbank and spectrogram, the MPD and MSD (spectral norm included), the
LS-GAN and feature losses, the whole train step against
``make_train_step`` for ``[mpd, msd_hifi]`` and ``[hifi]`` at
``accum_steps`` 1 and 2, and ``.atpu`` packages with both discriminators
in both directions.

The discriminators are those of ``tests/test_train_step_hifi.py`` (MPD
hidden 4, periods 2 and 3; MSD hidden 16, num_D 2; mel n_fft 512, hop 128,
32 mels). Its generator takes DConv activations the port does not have
(GELU), so the train step's generator is ``tiny_args``' Aero with one
encoder and decoder, without FTB, BLSTM or attention: the discriminators
are what this file holds. The weights are JAX variables carried into the
port; inputs come from a numpy seed. The JAX step's gradient is its
Adam's first moment after one update from zero, which is (1 - b1) = 0.1
times the gradient, so one compile per case."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aero_tpu.losses import adversarial as jadv
from aero_tpu.models import discriminators as jdisc
from aero_tpu.ops import mel as jmel
from aero_tpu.train import build as jbuild
from aero_tpu.train import checkpoint as jckpt
from aero_tpu.train.train_step import init_state, make_train_step
from aero_tpu_torch.losses import adversarial as padv
from aero_tpu_torch.models import discriminators as pdisc
from aero_tpu_torch.models.factory import build_discriminators
from aero_tpu_torch.ops import mel as pmel
from aero_tpu_torch.train import build as pbuild
from aero_tpu_torch.train import checkpoint as pckpt
from aero_tpu_torch.train.from_jax import (
    export_aero_state, export_hifi_state, hifi_state_dict_from_jax,
    state_dict_from_jax)
from aero_tpu_torch.train.train_step import TrainStep
from aero_tpu_torch.utils.config import Config
from test_torch_port_train_step import GRAD_TOL, _grad_bands
from test_train_step import tiny_args

pytestmark = pytest.mark.torch_port

MPD = dict(hidden=4, periods=(2, 3))
MSD = dict(hidden=16, num_D=2)
MEL = dict(n_fft=512, hop_length=128, win_length=512, n_mels=32)
# 3000 samples fold into whole periods of 2 and 3, 3001 into neither
LENGTHS = (3000, 3001)
GRAD_LENGTH = 3001
FWD_TOL = 1e-5       # relative L2 of logits and feature maps
LOSS_TOL = 1e-6      # relative, the losses on the same outputs
DISC_GRAD_TOL = 1e-4  # of each leaf's max |grad|
U_TOL = 1e-6         # stored u, unit vectors
METRIC_RTOL = 1e-4
MICRO = 2
CONFIGS = {"mpd+msd_hifi": ["mpd", "msd_hifi"], "hifi": ["hifi"]}
ACCUMS = [1, 2]


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def _disc_variables(module, seed):
    """JAX variables of a HiFi discriminator from a numpy seed: kernels
    and biases uniform within 1/sqrt(fan_in) as the JAX init draws them,
    g = ||v|| times U(0.5, 1.5) (so that the norm matters), u ~ N(0, 1)."""
    x = jnp.zeros((1, 64, 1))
    shapes = jax.eval_shape(lambda k: module.init(k, x, x),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(tree):
        if "bias" not in tree:
            return {k: draw(v) for k, v in tree.items()}
        w = "v" if "v" in tree else "kernel"
        shape = tree[w].shape
        bound = 1 / np.sqrt(np.prod(shape[:-1]))
        out = {w: rng.uniform(-bound, bound, shape).astype(np.float32),
               "bias": rng.uniform(-bound, bound, tree["bias"].shape)
               .astype(np.float32)}
        if "g" in tree:
            norm = np.sqrt((out["v"] ** 2).sum(axis=tuple(range(len(shape)
                                                                - 1))))
            out["g"] = (norm * rng.uniform(0.5, 1.5, norm.shape)).astype(
                np.float32)
        return out

    variables = {"params": draw(shapes["params"])}
    if "spectral_stats" in shapes:
        variables["spectral_stats"] = jax.tree.map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32),
            shapes["spectral_stats"])
    return variables


def _port(cls, kw, variables):
    model = cls(**kw)
    model.load_state_dict(hifi_state_dict_from_jax(variables), strict=True)
    return model


def _signals(t, seed):
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal((2, 1, t))).astype(np.float32)
            for _ in range(2)]


def _tc(x):  # [B, C, T] -> JAX's [B, T, C]
    return jnp.asarray(np.swapaxes(x, 1, 2))


# --------------------------------------------------------------------------
# The mel spectrogram


@pytest.mark.parametrize("cfg", [(16000, 1024, 80, 0.0, None),
                                 (16000, 512, 32, 20.0, 7000.0)])
def test_mel_filterbank_equals_jax_bit_for_bit(cfg):
    got, want = pmel.mel_filterbank(*cfg), jmel.mel_filterbank(*cfg)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_mel_spectrogram_matches_jax():
    x = _signals(3001, 0)[0]
    kw = dict(n_fft=1024, hop_length=256, win_length=1024, n_mels=80)
    want = np.asarray(jmel.mel_spectrogram(jnp.asarray(x), 16000, **kw))
    got = pmel.mel_spectrogram(torch.from_numpy(x), 16000, **kw).numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= 1e-5


# --------------------------------------------------------------------------
# The discriminators and losses on the same weights and inputs


@pytest.fixture(scope="module")
def discs():
    """Per length: JAX's outputs of both discriminators (not storing) and
    the three losses on them; at GRAD_LENGTH also the gradient of the
    discriminator loss with the storing MSD call, and its new u; and the
    JAX variables."""
    msd, mpd = (jdisc.MultiScaleDiscriminator(**MSD),
                jdisc.MultiPeriodDiscriminator(**MPD))
    msd_v, mpd_v = _disc_variables(msd, 1), _disc_variables(mpd, 2)

    @jax.jit
    def run(msd_v, mpd_v, y, y_hat):
        outs = {"msd_hifi": msd.apply(msd_v, y, y_hat, train=False),
                "mpd": mpd.apply(mpd_v, y, y_hat)}
        return outs, {n: (jadv.hifi_feature_loss(o[2], o[3]),
                          jadv.hifi_discriminator_loss(o[0], o[1]),
                          jadv.hifi_generator_loss(o[1]))
                      for n, o in outs.items()}

    @jax.jit
    def grads(msd_v, mpd_v, y, y_hat):
        def disc_loss(params):
            (yr, yg, _, _), upd = msd.apply(
                {"params": params["msd_hifi"],
                 "spectral_stats": msd_v["spectral_stats"]},
                y, y_hat, train=True, mutable=["spectral_stats"])
            pr, pg, _, _ = mpd.apply({"params": params["mpd"]}, y, y_hat)
            return (jadv.hifi_discriminator_loss(yr, yg)
                    + jadv.hifi_discriminator_loss(pr, pg)), upd

        return jax.grad(disc_loss, has_aux=True)(
            {"msd_hifi": msd_v["params"], "mpd": mpd_v["params"]})

    out = {}
    for t in LENGTHS:
        y, y_hat = _signals(t, t)
        args = (msd_v, mpd_v, _tc(y), _tc(y_hat))
        res = run(*args) + (grads(*args) if t == GRAD_LENGTH else (None,) * 2)
        out[t] = (y, y_hat) + tuple(jax.tree.map(np.asarray, res))
    return {"msd_hifi": msd_v, "mpd": mpd_v}, out


PORTS = {"msd_hifi": (pdisc.MultiScaleDiscriminator, MSD),
         "mpd": (pdisc.MultiPeriodDiscriminator, MPD)}


def _port_maps(maps):
    """JAX feature maps, channels-last, in the port's layout."""
    return [[np.moveaxis(f, -1, 1) for f in fmap] for fmap in maps]


@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("name", ["msd_hifi", "mpd"])
def test_discriminator_outputs_match_jax(discs, name, t):
    variables, runs = discs
    y, y_hat, outs, _, _, _ = runs[t]
    cls, kw = PORTS[name]
    port = _port(cls, kw, variables[name])
    u0 = {k: v.clone() for k, v in port.state_dict().items()
          if k.endswith("weight_u")}
    with torch.no_grad():
        got = port(torch.from_numpy(y), torch.from_numpy(y_hat))
    want = outs[name]
    for g_logits, w_logits in zip(got[:2], want[:2]):
        assert len(g_logits) == len(w_logits) == len(port.discriminators)
        for g, w in zip(g_logits, w_logits):
            assert g.shape == w.shape
            assert _rel_l2(g.numpy(), w) <= FWD_TOL
    for g_maps, w_maps in zip(got[2:], want[2:]):
        for g_fmap, w_fmap in zip(g_maps, _port_maps(w_maps)):
            assert len(g_fmap) == len(w_fmap)
            for g, w in zip(g_fmap, w_fmap):
                assert g.shape == w.shape
                assert _rel_l2(g.numpy(), w) <= FWD_TOL
    # a call that does not store leaves u as it was
    for k, v in u0.items():
        assert torch.equal(port.state_dict()[k], v)


@pytest.mark.parametrize("t", LENGTHS)
def test_hifi_losses_match_jax(discs, t):
    """The three losses of the port on JAX's own outputs."""
    _, runs = discs
    _, _, outs, losses, _, _ = runs[t]
    for name, (feat, disc, gen) in losses.items():
        yr, yg, fr, fg = outs[name]

        def tensors(xs):
            return [torch.from_numpy(np.array(x)) for x in xs]

        got = (padv.hifi_feature_loss(
                   [tensors(m) for m in _port_maps(fr)],
                   [tensors(m) for m in _port_maps(fg)]),
               padv.hifi_discriminator_loss(tensors(yr), tensors(yg)),
               padv.hifi_generator_loss(tensors(yg)))
        for g, w in zip(got, (feat, disc, gen)):
            assert abs(float(g) - float(w)) <= LOSS_TOL * abs(float(w)), (
                name, float(g), float(w))


@pytest.fixture(scope="module")
def port_disc_grads(discs):
    """The port's gradient of the discriminator loss with the storing MSD
    call at GRAD_LENGTH, and the MSD's u after it."""
    variables, runs = discs
    y, y_hat = (torch.from_numpy(a) for a in runs[GRAD_LENGTH][:2])
    msd = _port(*PORTS["msd_hifi"], variables["msd_hifi"])
    mpd = _port(*PORTS["mpd"], variables["mpd"])
    yr, yg, _, _ = msd(y, y_hat, store=True)
    pr, pg, _, _ = mpd(y, y_hat)
    loss = (padv.hifi_discriminator_loss(yr, yg)
            + padv.hifi_discriminator_loss(pr, pg))
    grads = {}
    for name, m in (("msd_hifi", msd), ("mpd", mpd)):
        names = [n for n, _ in m.named_parameters()]
        g = torch.autograd.grad(loss, list(m.parameters()),
                                retain_graph=True)
        grads[name] = dict(zip(names, (x.numpy() for x in g)))
    return grads, {k: v.numpy() for k, v in msd.state_dict().items()
                   if k.endswith("weight_u")}


def test_disc_grads_match_jax(discs, port_disc_grads):
    """Every leaf, the spectral-normed scale's weight_orig (its gradient
    runs through sigma) among them, within DISC_GRAD_TOL of its max."""
    want_all = discs[1][GRAD_LENGTH][4]
    got_all = port_disc_grads[0]
    n = 0
    for name in ("msd_hifi", "mpd"):
        want = export_hifi_state({"params": want_all[name]})
        got = got_all[name]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].shape == w.shape, k
            err = float(np.abs(got[k] - w).max())
            assert err <= DISC_GRAD_TOL * float(np.abs(w).max()), (k, err)
            n += 1
    assert any(k.endswith("weight_orig") for k in got_all["msd_hifi"])
    assert n == 40 + 36  # MSD: 16 spectral-normed, 24 weight-normed leaves


def test_stored_u_matches_jax(discs, port_disc_grads):
    want = export_hifi_state(
        {"spectral_stats": discs[1][GRAD_LENGTH][5]["spectral_stats"]})
    got = port_disc_grads[1]
    assert sorted(got) == sorted(want) and len(want) == 8
    u0 = export_hifi_state({"spectral_stats":
                            discs[0]["msd_hifi"]["spectral_stats"]})
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= U_TOL, k
        assert np.abs(w - u0[k]).max() > 1e-3, k  # it did move


def test_hifi_keys_are_the_reference_layout(discs):
    """weight_v/weight_g/bias on every weight-normed conv, weight_orig/
    weight_u/bias on the spectral-normed scale, 4-D MPD kernels."""
    variables, _ = discs
    for name, (cls, kw) in PORTS.items():
        port = cls(**kw)
        want = export_hifi_state(variables[name])
        assert set(port.state_dict()) == set(want)
        for k, v in port.state_dict().items():
            assert tuple(v.shape) == want[k].shape, k
    sd = PORTS["msd_hifi"][0](**MSD).state_dict()
    assert "discriminators.0.convs.0.weight_orig" in sd
    assert "discriminators.0.conv_post.weight_u" in sd
    assert not any(k.startswith("discriminators.0.")
                   and k.endswith("weight_v") for k in sd)


def test_seeded_hifi_init():
    """The factory builds msd_hifi and mpd for 'hifi', from a seed: v, the
    kernel and the bias within 1/sqrt(fan_in), g = ||v||, u an
    unnormalised N(0, 1) draw."""
    exp = Config._wrap(dict(adversarial=True, discriminator_models=["hifi"],
                            msd=MSD, mpd=MPD))
    a = build_discriminators(exp, device="cpu", seed=5)
    b = build_discriminators(exp, device="cpu", seed=5)
    assert list(a) == ["msd_hifi", "mpd"]
    for name in a:
        assert all(torch.equal(x, y) for x, y in
                   zip(a[name].state_dict().values(),
                       b[name].state_dict().values()))
    a["msd_hifi"].requires_grad_(False)
    a["mpd"].requires_grad_(False)
    n_sn = 0
    for m in a["msd_hifi"].modules():
        if isinstance(m, pdisc.SNConv1d):
            bound = 1 / np.sqrt(m.weight_orig[0].numel())
            assert float(m.weight_orig.abs().max()) <= bound
            assert float(m.bias.abs().max()) <= bound
            assert abs(float(m.weight_u.norm()) - 1) > 1e-3
            n_sn += 1
    assert n_sn == 8
    for m in list(a["msd_hifi"].modules()) + list(a["mpd"].modules()):
        if isinstance(m, pdisc._WeightNorm):
            bound = 1 / np.sqrt(m.weight_v[0].numel())
            assert float(m.weight_v.abs().max()) <= bound
            torch.testing.assert_close(m.weight(), m.weight_v)


# --------------------------------------------------------------------------
# The whole train step


def _args(names, accum):
    args = tiny_args(losses=("l1",))
    args.experiment.aero.update(strides=[4], enc_freq_attn=4,
                                norm_starts=1, dconv_time_attn=9,
                                dconv_lstm=9)
    exp = args.experiment
    exp.batch_size = MICRO * accum
    exp.discriminator_models = list(names)
    exp.mpd = Config._wrap(dict(MPD, periods=list(MPD["periods"])))
    exp.msd = Config._wrap(dict(MSD))
    exp.mel_spectrogram = Config._wrap(dict(MEL))
    exp.mel_spec_loss_lambda = 45
    args["accum_steps"] = accum
    return args


def _batch(accum):
    rng = np.random.default_rng(10 + accum)
    n = MICRO * accum
    return ((0.1 * rng.standard_normal((n, 1, 1000))).astype(np.float32),
            (0.1 * rng.standard_normal((n, 1, 4000))).astype(np.float32))


def _port_models(args, variables):
    pargs = Config._wrap(dict(args))
    pm = pbuild.build_models(pargs, device="cpu")
    assert list(pm) == ["generator", "msd_hifi", "mpd"]
    pm["generator"].load_state_dict(
        state_dict_from_jax(variables["generator"]), strict=True)
    for name in ("msd_hifi", "mpd"):
        pm[name].load_state_dict(hifi_state_dict_from_jax(variables[name]),
                                 strict=True)
    return pargs, pm


@pytest.fixture(scope="module")
def variables():
    """The JAX variables shared by every case: the generator's from the
    port's seeded init (Aero's init, the rescale included; through the
    port's inverse map, which ``test_torch_port_checkpoint`` holds against
    JAX's importer bit for bit; a jitted JAX init would cost a compile),
    both discriminators' from ``_disc_variables``."""
    args = _args(["hifi"], 1)
    models = jbuild.build_models(args)
    gen = pbuild.build_models(Config._wrap(dict(args)), device="cpu")[
        "generator"]
    return {"generator": pckpt.aero_variables(gen.state_dict()),
            "msd_hifi": _disc_variables(models["msd_hifi"], 3),
            "mpd": _disc_variables(models["mpd"], 4)}


def _disc_names(ts):
    return [f"{n}.{k}" for n, m in ts.disc_models.items()
            for k, _ in m.named_parameters()]


@pytest.fixture(scope="module")
def steps(variables):
    """Per (config, accum): JAX's step (metrics, the new state, the
    gradients from its Adam's first moment, reference keys) and the
    port's (gradients, metrics, models and TrainStep after its step)."""
    out = {}
    for cfg, names in CONFIGS.items():
        for accum in ACCUMS:
            args = _args(names, accum)
            models = jbuild.build_models(args)
            lr, hr = _batch(accum)
            state = init_state(args, models, variables, jax.random.PRNGKey(1))
            new_state, metrics = make_train_step(
                args, models, mesh=None, donate=False)(
                state, jnp.asarray(lr), jnp.asarray(hr))
            new_state = jax.tree.map(np.asarray, new_state)
            mu, dmu = (new_state.gen_opt_state[0].mu,
                       new_state.disc_opt_state[0].mu)
            want_gen = {k: v / np.float32(0.1) for k, v in
                        export_aero_state({"params": mu}).items()}
            want_disc = {f"{n}.{k}": v / np.float32(0.1)
                         for n in ("msd_hifi", "mpd") for k, v in
                         export_hifi_state({"params": dmu[n]}).items()}

            pargs, pm = _port_models(args, variables)
            ts = TrainStep(pargs, pm, device="cpu")
            p_gen, p_disc, p_metrics, _ = ts.grads(lr, hr)
            gen_names = [n for n, _ in pm["generator"].named_parameters()]
            port_grads = (dict(zip(gen_names, p_gen)),
                          dict(zip(_disc_names(ts), p_disc)))
            step_metrics = ts(lr, hr)
            out[cfg, accum] = dict(
                jax_metrics={k: float(v) for k, v in metrics.items()},
                jax_state=new_state, jax_grads=(want_gen, want_disc),
                port_grads=port_grads,
                port_metrics=(p_metrics, step_metrics), port_models=pm,
                train_step=ts, args=args, models=models, batch=(lr, hr))
    return out


CASES = [(c, a) for c in CONFIGS for a in ACCUMS]


@pytest.mark.parametrize("cfg,accum", CASES)
def test_train_step_metrics_match_jax(steps, cfg, accum):
    r = steps[cfg, accum]
    want = r["jax_metrics"]
    names = {"mpd+msd_hifi": {
        "generator_l1", "generator_adversarial_msd", "generator_features_msd",
        "generator_adversarial_mpd", "generator_features_mpd",
        "discriminator_msd", "discriminator_mpd", "total"},
        "hifi": {"generator_l1", "generator_adversarial_hifi",
                 "discriminator_hifi", "total"}}[cfg]
    assert set(want) == names
    for got in r["port_metrics"]:  # from grads() and from the step
        assert set(got) == names
        for k in want:
            assert abs(got[k] - want[k]) <= METRIC_RTOL * abs(want[k]), (
                k, got[k], want[k])


@pytest.mark.parametrize("net", ["generator", "discriminator"])
@pytest.mark.parametrize("cfg,accum", CASES)
def test_train_step_grads_match_jax(steps, cfg, accum, net):
    """At the tolerances of ``test_torch_port_train_step``: each leaf of
    the discriminators to GRAD_TOL of its max; the generator's leaves to
    GEN_LEAF_TOL of their max and, flattened, to GRAD_TOL in relative L2."""
    r = steps[cfg, accum]
    i = 0 if net == "generator" else 1
    want = r["jax_grads"][i]
    got = {k: v.numpy() for k, v in r["port_grads"][i].items()}
    assert sorted(got) == sorted(want)
    bands = _grad_bands(want, net, r["port_models"]["generator"])
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= bands[k], (
            k, float(np.abs(got[k] - w).max()), bands[k])
    flat_w = np.concatenate([w.ravel() for w in want.values()])
    flat_g = np.concatenate([got[k].ravel() for k in want])
    assert np.linalg.norm(flat_g - flat_w) <= GRAD_TOL * np.linalg.norm(
        flat_w)


@pytest.mark.parametrize("cfg,accum", CASES)
def test_train_step_stores_jax_u(steps, variables, cfg, accum):
    """After the step the MSD holds the u of JAX's step: two power
    iterations from u0 (the real and the fake forward of the storing
    call), averaged over the microbatches."""
    r = steps[cfg, accum]
    want = export_hifi_state(
        {"spectral_stats": r["jax_state"].disc_state["msd_hifi"][
            "spectral_stats"]})
    got = r["port_models"]["msd_hifi"].state_dict()
    u0 = export_hifi_state(
        {"spectral_stats": variables["msd_hifi"]["spectral_stats"]})
    assert len(want) == 8
    for k, w in want.items():
        assert np.abs(got[k].numpy() - w).max() <= U_TOL, k
        assert np.abs(w - u0[k]).max() > 1e-3, k


# --------------------------------------------------------------------------
# .atpu packages with both HiFi discriminators


def _port_adam(opt, named):
    """{network: {key: (step, exp_avg, exp_avg_sq)}} of a torch Adam."""
    return {net: {k: tuple(opt.state[p][s] for s in
                           ("step", "exp_avg", "exp_avg_sq"))
                  for k, p in params}
            for net, (_m, params) in named.items()}


def _bits_equal(got, want, where):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    assert got.tobytes() == want.tobytes(), where


def test_port_atpu_restores_in_jax_and_back(steps, variables, tmp_path):
    """The port writes weights, u and both Adam states after its step;
    JAX's ``load_package``/``state_from_package`` restore each leaf bit
    for bit (read through the weights' map, which the parity tests above
    hold), and JAX's package of that state resumes the port bit for bit."""
    r = steps["hifi", 1]
    pm, ts, args = r["port_models"], r["train_step"], r["args"]
    path = str(tmp_path / "checkpoint.atpu")
    history = [{"total_loss": 1.5}]
    pckpt.save_package(path, pckpt.package_from_training(
        pm, ts, history, None, {"experiment": {"model": "aero"}}, 1))

    template = init_state(args, r["models"], variables,
                          jax.random.PRNGKey(1))
    state = jax.tree.map(np.asarray, jckpt.state_from_package(
        jckpt.load_package(path), template))
    assert int(state.step) == 1
    n = 0
    for name in ("msd_hifi", "mpd"):
        got = export_hifi_state({"params": state.disc_params[name],
                                 **state.disc_state.get(name, {})})
        want = pm[name].state_dict()
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            _bits_equal(got[k], w.numpy(), (name, k))
            n += 1
    adam = state.disc_opt_state[0]
    groups = dict((key, named) for key, _opt, named in
                  pckpt.optimizer_groups(pm, ts))
    port = _port_adam(ts.disc_opt, groups["disc_optimizer"])
    assert int(adam.count) == 1
    for name in ("msd_hifi", "mpd"):
        for part, i in (("mu", 1), ("nu", 2)):
            got = export_hifi_state({"params": getattr(adam, part)[name]})
            assert sorted(got) == sorted(port[name])
            for k, entry in port[name].items():
                _bits_equal(got[k], entry[i].numpy(), (name, part, k))
                n += 1
    gen = export_aero_state({"params": state.gen_params, **state.gen_state})
    for k, w in pm["generator"].state_dict().items():
        _bits_equal(gen[k], w.numpy(), k)
    assert n == 48 + 36 + 2 * (40 + 36)  # states with u, then mu and nu

    # JAX writes the state it restored; the port resumes from it
    back = str(tmp_path / "from_jax.atpu")
    jckpt.save_package(back, jckpt.package_from_state(
        state, history, None, {"experiment": {"model": "aero"}}))
    pargs, pm2 = _port_models(args, variables)
    ts2 = TrainStep(pargs, pm2, device="cpu")
    assert pckpt.restore_training(pckpt.load_package(back), pm2, ts2) == 1
    for name in pm:
        for (k, a), b in zip(pm[name].state_dict().items(),
                             pm2[name].state_dict().values()):
            assert torch.equal(a, b), (name, k)
    for (key, opt, named), (_, opt2, named2) in zip(
            pckpt.optimizer_groups(pm, ts), pckpt.optimizer_groups(pm2, ts2)):
        want, got = _port_adam(opt, named), _port_adam(opt2, named2)
        assert list(got) == list(want)
        for net in want:
            for k, entry in want[net].items():
                for a, b in zip(got[net][k], entry):
                    assert torch.equal(a, b), (key, net, k)


def test_solver_skips_hifi_states_of_reference_th(tmp_path, caplog):
    """continue_from=<.th>: the generator and its Adam state are restored;
    the HiFi discriminators and their Adam state are logged and keep their
    fresh initialization, as in the JAX Solver."""
    from aero_tpu_torch.train.solver import Solver
    from aero_tpu_torch.utils.config import load_config

    conf = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "conf")
    args = load_config(conf, "main_config", [
        "experiment=tiny", "device=cpu", "checkpoint=false",
        "experiment.discriminator_models=[hifi]"])
    exp = args.experiment
    exp.msd, exp.mpd = Config._wrap(dict(MSD)), Config._wrap(dict(MPD))
    exp.mel_spectrogram = Config._wrap(dict(MEL))
    src = pbuild.build_models(args, device="cpu", seed=0)
    step = TrainStep(args, src, device="cpu")
    rng = np.random.default_rng(5)
    step((0.1 * rng.standard_normal((2, 1, 2000))).astype(np.float32),
         (0.1 * rng.standard_normal((2, 1, 8000))).astype(np.float32))
    path = str(tmp_path / "checkpoint.th")
    torch.save({"models": {n: {"class": None, "kwargs": {},
                               "state": m.state_dict()}
                           for n, m in src.items()},
                "optimizers": {"optimizer": step.gen_opt.state_dict(),
                               "disc_optimizer": step.disc_opt.state_dict()},
                "history": [{"train": 1.0}], "best_states": {}}, path)

    args.continue_from = path
    fresh = pbuild.build_models(args, device="cpu", seed=7)
    init = {n: {k: v.clone() for k, v in fresh[n].state_dict().items()}
            for n in ("msd_hifi", "mpd")}
    solver = Solver({"tr_loader": None, "cv_loader": None,
                     "tt_loader": None}, fresh, args, device="cpu")
    for k, v in src["generator"].state_dict().items():
        assert torch.equal(fresh["generator"].state_dict()[k], v), k
    for name, sd in init.items():
        for k, v in sd.items():
            assert torch.equal(fresh[name].state_dict()[k], v), (name, k)
        assert f"no torch importer for discriminator '{name}'" in caplog.text
    want = step.gen_opt.state_dict()["state"]
    got = solver.train_step.gen_opt.state_dict()["state"]
    assert len(got) == len(want) > 10
    assert all(torch.equal(got[i]["exp_avg"], e["exp_avg"])
               for i, e in want.items())
    assert not solver.train_step.disc_opt.state_dict()["state"]
    assert solver.history == [{"train": 1.0}]
