"""The port's Seanet against aero_tpu on the CPU in float32: the sinc
resample of a tensor, the forward on a narrow config (ngf 4, ratios 2 and
2, one residual block) with weights drawn into JAX variables and carried
across, the reference key layout against the JAX importer, ``.atpu``
packages both ways, and the predict CLI serving a port-written package."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aero_tpu.models import discriminators as jdisc
from aero_tpu.models.seanet import Seanet as JaxSeanet
from aero_tpu.ops.resample import resample as jax_resample
from aero_tpu.train import build as jbuild
from aero_tpu.train import checkpoint as jckpt
from aero_tpu.train import torch_import
from aero_tpu.train.train_step import init_state, make_train_step
from aero_tpu_torch import predict as ppredict
from aero_tpu_torch.data import audio_io
from aero_tpu_torch.models.factory import build_generator
from aero_tpu_torch.models.seanet import Seanet
from aero_tpu_torch.ops.resample import resample
from aero_tpu_torch.train import build as pbuild
from aero_tpu_torch.train import checkpoint as pckpt
from aero_tpu_torch.train.from_jax import (
    export_melgan_state, export_seanet_state, melgan_state_dict_from_jax,
    seanet_modules, seanet_state_dict_from_jax)
from aero_tpu_torch.train.train_step import TrainStep
from aero_tpu_torch.utils.config import Config, load_config
from test_torch_port_train_step import GRAD_TOL, METRIC_RTOL

pytestmark = pytest.mark.torch_port

CONF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conf")
NARROW = dict(latent_space_size=8, ngf=4, n_residual_layers=1,
              ratios=(2, 2), lr_sr=4000, hr_sr=16000)
FWD_TOL = 1e-5       # relative L2, whole forward
RESAMPLE_TOL = 1e-6  # relative L2
# (upsample, input length): 250 samples become 1000, a valid length of
# ratios (2, 2); 999 samples without the resample need one of zero pad
CASES = [(True, 250), (False, 999)]


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("rates", [(4000, 16000), (16000, 4000)])
def test_resample_matches_jax(rates):
    x = np.random.default_rng(0).standard_normal((2, 1, 1001)).astype(
        np.float32)
    want = np.asarray(jax_resample(jnp.asarray(x), *rates))
    got = resample(torch.from_numpy(x), *rates).numpy()
    assert got.shape == want.shape == (2, 1, -(-1001 * rates[1]
                                               // rates[0]))
    assert _rel_l2(got, want) <= RESAMPLE_TOL


def _jax_variables(module, t, seed):
    """JAX Seanet variables from a numpy seed: v and the bias uniform
    within torch's 1/sqrt(fan_in) (a transposed conv's fan_in is out * k),
    g = ||v|| (per output channel, per input channel of a transposed conv)
    times U(0.5, 1.5)."""
    shapes = jax.eval_shape(lambda k: module.init(k, jnp.zeros((1, 1, t))),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(tree, name=""):
        if "v" not in tree:
            return {k: draw(v, k) for k, v in tree.items()}
        k, cin, cout = tree["v"].shape
        tr = name.endswith("convtr")
        bound = 1 / np.sqrt(k * (cout if tr else cin))
        v = rng.uniform(-bound, bound, (k, cin, cout)).astype(np.float32)
        norm = np.sqrt((v ** 2).sum(axis=(0, 2) if tr else (0, 1)))
        return {"v": v, "g": (norm * rng.uniform(0.5, 1.5, norm.shape))
                .astype(np.float32),
                "bias": rng.uniform(-bound, bound, cout).astype(np.float32)}

    return {"params": draw(shapes["params"])}


@pytest.fixture(scope="module")
def forwards():
    """Per case: the input, JAX's forward and the JAX variables."""
    out = {}
    for upsample, t in CASES:
        module = JaxSeanet(**NARROW, upsample=upsample)
        variables = _jax_variables(module, t, seed=t)
        x = (0.1 * np.random.default_rng(t).standard_normal((2, 1, t))
             ).astype(np.float32)
        y = jax.jit(module.apply)(variables, jnp.asarray(x))
        out[upsample, t] = x, np.asarray(y), variables
    return out


@pytest.mark.parametrize("upsample,t", CASES)
def test_seanet_forward_matches_jax(forwards, upsample, t):
    x, want, variables = forwards[upsample, t]
    port = Seanet(**NARROW, upsample=upsample)
    port.load_state_dict(seanet_state_dict_from_jax(variables), strict=True)
    n = t * (4 if upsample else 1)
    assert (port.estimate_output_length(n) > n) == (not upsample)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, n)
    assert _rel_l2(got, want) <= FWD_TOL


def test_reference_state_dict_loads_strict(forwards):
    """The port's reference state_dict of JAX variables is what JAX's own
    ``import_seanet_state`` reads: it consumes every key and gives the
    same variables back bit for bit; the port loads it with strict=True,
    and its own inverse map returns the variables too."""
    _, _, variables = forwards[True, 250]
    sd = export_seanet_state(variables)
    back = torch_import.import_seanet_state(sd, variables)
    want, got = dict(_leaves(variables)), dict(_leaves(back))
    assert got.keys() == want.keys() and len(want) == 3 * len(
        seanet_modules(2, 1))
    for k, w in want.items():
        assert np.asarray(got[k]).tobytes() == w.tobytes(), k
    port = Seanet(**NARROW)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         strict=True)
    assert list(sd) == list(port.state_dict())  # the reference's order
    mine = dict(_leaves(pckpt.seanet_variables(port.state_dict())))
    for k, w in want.items():
        assert mine[k].tobytes() == w.tobytes(), k
    assert port.decoder[1][1].weight_g.shape == (16, 1, 1)  # per input


def _seanet_args(adversarial=False):
    args = load_config(CONF, "main_config", [
        "experiment=seanet_4-16", "losses=[l1]",
        "experiment.seanet.ngf=4", "experiment.seanet.ratios=[2,2]",
        "experiment.seanet.n_residual_layers=1",
        "experiment.seanet.latent_space_size=8",
        f"experiment.adversarial={str(adversarial).lower()}",
        "experiment.batch_size=2", "experiment.segment=0.25"])
    return args


def test_seanet_atpu_round_trip(forwards, tmp_path):
    """The port's package after one step (weights and Adam moments) is
    restored by JAX's ``state_from_package`` bit for bit, and JAX's
    package of it resumes the port bit for bit."""
    args = _seanet_args()
    _, _, variables = forwards[True, 250]
    pm = pbuild.build_models(args, device="cpu")
    assert isinstance(pm["generator"], Seanet) and list(pm) == ["generator"]
    pm["generator"].load_state_dict(seanet_state_dict_from_jax(variables),
                                    strict=True)
    ts = TrainStep(args, pm, device="cpu")
    rng = np.random.default_rng(1)
    ts((0.1 * rng.standard_normal((2, 1, 1000))).astype(np.float32),
       (0.1 * rng.standard_normal((2, 1, 4000))).astype(np.float32))
    path = str(tmp_path / "checkpoint.atpu")
    pckpt.save_package(path, pckpt.package_from_training(
        pm, ts, [], None, {"experiment": {"model": "seanet"}}, 1))

    jargs = Config._wrap(dict(args))
    jmodels = jbuild.build_models(jargs)
    template = init_state(jargs, jmodels, {"generator": variables},
                          jax.random.PRNGKey(0))
    state = jax.tree.map(np.asarray, jckpt.state_from_package(
        jckpt.load_package(path), template))
    adam = state.gen_opt_state[0]
    assert int(state.step) == 1 and int(adam.count) == 1
    params = dict(pm["generator"].named_parameters())
    opt = ts.gen_opt.state
    for tree, want in ((state.gen_params, {k: p.detach() for k, p in
                                           params.items()}),
                       (adam.mu, {k: opt[p]["exp_avg"]
                                  for k, p in params.items()}),
                       (adam.nu, {k: opt[p]["exp_avg_sq"]
                                  for k, p in params.items()})):
        got = export_seanet_state({"params": tree})
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].tobytes() == w.numpy().tobytes(), k

    back = str(tmp_path / "from_jax.atpu")
    jckpt.save_package(back, jckpt.package_from_state(
        state, [], None, {"experiment": {"model": "seanet"}}))
    pm2 = pbuild.build_models(args, device="cpu", seed=3)
    ts2 = TrainStep(args, pm2, device="cpu")
    assert pckpt.restore_training(pckpt.load_package(back), pm2, ts2) == 1
    for (k, a), b in zip(pm["generator"].state_dict().items(),
                         pm2["generator"].state_dict().values()):
        assert torch.equal(a, b), k
    for p, p2 in zip(pm["generator"].parameters(),
                     pm2["generator"].parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(ts.gen_opt.state[p][key],
                               ts2.gen_opt.state[p2][key]), key
    # the serving loader reads the generator of either package
    for f in (path, back):
        sd = pckpt.generator_state_dict(f)
        assert all(torch.equal(sd[k], v) for k, v in
                   pm["generator"].state_dict().items())


def test_seanet_step_trains_against_melgan():
    """seanet_4-16's recipe at narrow width: the MelGAN losses and both
    updates; the generator's rescale trick is Aero's alone."""
    args = _seanet_args(adversarial=True)
    args.experiment.melgan_discriminator.update(ndf=4, n_layers=2, num_D=2)
    pm = pbuild.build_models(args, device="cpu")
    assert list(pm) == ["generator", "msd_melgan"]
    fresh = build_generator(args.experiment.seanet, device="cpu",
                            model="seanet")
    for (k, a), b in zip(pm["generator"].state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k  # the seeded init, not rescaled
    before = {n: [p.detach().clone() for p in m.parameters()]
              for n, m in pm.items()}
    rng = np.random.default_rng(2)
    metrics = TrainStep(args, pm, device="cpu")(
        (0.1 * rng.standard_normal((2, 1, 1000))).astype(np.float32),
        (0.1 * rng.standard_normal((2, 1, 4000))).astype(np.float32))
    assert set(metrics) == {
        "generator_l1", "generator_adversarial_melgan",
        "generator_features_melgan", "discriminator_msd_melgan", "total"}
    assert all(np.isfinite(v) for v in metrics.values())
    for name, m in pm.items():  # both networks moved
        assert max(float((p.detach() - q).abs().max())
                   for p, q in zip(m.parameters(), before[name])) > 0, name


@pytest.fixture(scope="module")
def seanet_steps(forwards):
    """seanet_4-16's step with its MelGAN at narrow width, through JAX's
    ``make_train_step`` and the port's ``TrainStep`` on the same variables
    and batch. JAX's gradients are its Adam's first moment after one
    update from zero, which is 0.1 times the gradient (the step's Adam has
    b1 = 0.9 whatever the config's ``beta1``)."""
    args = _seanet_args(adversarial=True)
    args.experiment.melgan_discriminator.update(ndf=4, n_layers=2, num_D=2)
    jargs = Config._wrap(dict(args))
    models = jbuild.build_models(jargs)
    n_layers = models["msd_melgan"].n_layers
    _, hr_shape = jbuild.segment_shapes(jargs)
    variables = {"generator": forwards[True, 250][2],
                 "msd_melgan": jax.tree.map(np.asarray, dict(
                     models["msd_melgan"].init(
                         jax.random.PRNGKey(5),
                         jnp.zeros((1, hr_shape[2], 1)))))}
    rng = np.random.default_rng(6)
    lr = (0.1 * rng.standard_normal((2, 1, 1000))).astype(np.float32)
    hr = (0.1 * rng.standard_normal((2, 1, 4000))).astype(np.float32)
    state = init_state(jargs, models, variables, jax.random.PRNGKey(1))
    new_state, metrics = make_train_step(jargs, models, mesh=None,
                                         donate=False)(
        state, jnp.asarray(lr), jnp.asarray(hr))
    new_state = jax.tree.map(np.asarray, new_state)
    first = np.float32(0.1)
    want = ({k: v / first for k, v in export_seanet_state(
                {"params": new_state.gen_opt_state[0].mu}).items()},
            {k: v / first for k, v in export_melgan_state(
                new_state.disc_opt_state[0].mu["msd_melgan"],
                n_layers).items()})

    pm = pbuild.build_models(args, device="cpu")
    pm["generator"].load_state_dict(
        seanet_state_dict_from_jax(variables["generator"]), strict=True)
    pm["msd_melgan"].load_state_dict(melgan_state_dict_from_jax(
        variables["msd_melgan"]["params"], n_layers), strict=True)
    p_gen, p_disc, p_metrics, _ = TrainStep(args, pm, device="cpu").grads(
        lr, hr)
    got = tuple({n: g.numpy() for (n, _), g in zip(
        pm[name].named_parameters(), grads)} for name, grads in
        (("generator", p_gen), ("msd_melgan", p_disc)))
    return dict(jax_metrics={k: float(v) for k, v in metrics.items()},
                port_metrics=p_metrics, jax_grads=want, port_grads=got)


def test_seanet_step_metrics_match_jax(seanet_steps):
    want, got = seanet_steps["jax_metrics"], seanet_steps["port_metrics"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_RTOL * abs(want[k]), (
            k, got[k], want[k])


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_seanet_step_grads_match_jax(seanet_steps, net):
    """Every leaf to GRAD_TOL of its max: Seanet has no normalisation
    layer, so no leaf is left to rounding alone."""
    i = 0 if net == "generator" else 1
    want, got = seanet_steps["jax_grads"][i], seanet_steps["port_grads"][i]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= GRAD_TOL * np.abs(w).max(), (
            k, float(np.abs(got[k] - w).max()), float(np.abs(w).max()))


@pytest.mark.parametrize("ratio", [3, 2])
def test_odd_ratio_transposed_conv_follows_jax(ratio):
    """The decoder's transposed conv at ratios (3, 2) is the JAX package's
    ``WNConvTranspose1d`` with the same weights, the output_padding sample
    of an odd ratio included: zeros plus the bias, where torch's
    ``ConvTranspose1d`` (and so the reference) computes that sample from
    the kernel. Every other sample is torch's as well. The whole generator
    at ratios (3, 2) equals JAX's Seanet."""
    port = build_generator(dict(NARROW, ratios=[3, 2]),
                           device="cpu", model="seanet", seed=7)
    i = (3, 2).index(ratio)
    conv = port.decoder[i + 1][1]
    assert conv.output_padding == ratio % 2
    w = conv.weight().detach()
    x = torch.from_numpy(np.random.default_rng(ratio).standard_normal(
        (2, w.shape[0], 37)).astype(np.float32))
    with torch.no_grad():
        got = conv(x).numpy()
    jconv = jdisc.WNConvTranspose1d(w.shape[1], 2 * ratio, stride=ratio,
                                    padding=ratio // 2 + ratio % 2,
                                    output_padding=ratio % 2)
    params = {"v": conv.weight_v.detach().numpy().transpose(2, 0, 1),
              "g": conv.weight_g.detach().numpy().reshape(-1),
              "bias": conv.bias.detach().numpy()}
    want = np.asarray(jconv.apply({"params": params}, jnp.asarray(
        x.numpy().transpose(0, 2, 1)))).transpose(0, 2, 1)
    assert got.shape == want.shape == (2, w.shape[1], 37 * ratio)
    assert _rel_l2(got, want) <= FWD_TOL

    ref = torch.nn.ConvTranspose1d(w.shape[0], w.shape[1], 2 * ratio,
                                   ratio, ratio // 2 + ratio % 2,
                                   ratio % 2)
    with torch.no_grad():
        ref.weight.copy_(w)
        ref.bias.copy_(conv.bias)
        torch_y = ref(x).numpy()
    cut = got.shape[-1] - ratio % 2
    assert np.abs(got[..., :cut] - torch_y[..., :cut]).max() <= (
        1e-6 * np.abs(torch_y).max())
    if ratio % 2:
        np.testing.assert_array_equal(
            got[..., -1], np.broadcast_to(params["bias"][None],
                                          got[..., -1].shape))
        assert np.abs(torch_y[..., -1] - got[..., -1]).max() > 1e-3

    lr = (0.1 * np.random.default_rng(8).standard_normal((1, 1, 301))
          ).astype(np.float32)
    with torch.no_grad():
        y = port(torch.from_numpy(lr)).numpy()
    jgen = JaxSeanet(**dict(NARROW, ratios=(3, 2)))
    jy = np.asarray(jgen.apply(pckpt.seanet_variables(port.state_dict()),
                               jnp.asarray(lr)))
    assert y.shape == jy.shape == (1, 1, 4 * 301)
    assert _rel_l2(y, jy) <= FWD_TOL


def test_predict_serves_port_written_seanet(tmp_path, monkeypatch):
    """The predict CLI with seanet_4-16 at narrow width, from an .atpu the
    port wrote: the output is exactly 4x the input, and the file's
    forward."""
    overrides = ["experiment=seanet_4-16", "dset=debug",
                 "experiment.seanet.ngf=4", "experiment.seanet.ratios=[2,2]",
                 "experiment.seanet.n_residual_layers=1",
                 "experiment.seanet.latent_space_size=8", "device=cpu"]
    args = load_config(CONF, "main_config", overrides)
    gen = build_generator(args.experiment.seanet, device="cpu",
                          model="seanet", seed=4)
    ckpt = str(tmp_path / "seanet.atpu")
    pckpt.save_package(ckpt, {"models": pckpt.model_variables(
        {"generator": gen})})
    n = 5001
    wav = str(tmp_path / "in.wav")
    audio_io.save(wav, (0.3 * np.sin(np.arange(n) / 5.0))[None]
                  .astype(np.float32), 4000)
    monkeypatch.chdir(tmp_path)
    out = ppredict.main(overrides + [f"+filename={wav}",
                                     f"+output={tmp_path / 'out'}",
                                     f"checkpoint_file={ckpt}",
                                     "eval_bucket_s=0"])
    assert out["in_samples"] == n and out["out_samples"] == 4 * n
    got = audio_io.load(out["path"])[0]
    with torch.no_grad():
        want = gen(torch.from_numpy(audio_io.load(wav)[0][None])).numpy()[0]
    want = want / max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape == (1, 4 * n)
    assert np.abs(got - want).max() <= 2.0 / 32768
