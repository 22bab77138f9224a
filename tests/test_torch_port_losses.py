"""The port's training losses and MelGAN discriminator against aero_tpu's
on the CPU in float32: the non-normalised STFT, the multi-resolution STFT
loss (value and gradient), the discriminator's feature maps with weights
carried across, its state_dict layout, and both MelGAN losses."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aero_tpu.losses import adversarial as jadv
from aero_tpu.losses import stft_loss as jstft
from aero_tpu.models import discriminators as jdisc
from aero_tpu.models import modules as jmodules
from aero_tpu.ops import spec as jspec
from aero_tpu.train.torch_import import melgan_torch_prefix
from aero_tpu_torch.losses import adversarial as padv
from aero_tpu_torch.losses import stft_loss as pstft
from aero_tpu_torch.models import discriminators as pdisc
from aero_tpu_torch.models.factory import build_discriminators
from aero_tpu_torch.ops import spec as pspec
from aero_tpu_torch.train.from_jax import melgan_state_dict_from_jax
from aero_tpu_torch.utils.config import Config

pytestmark = pytest.mark.torch_port

RESOLUTIONS = [(1024, 120, 600), (2048, 240, 1200), (512, 50, 240)]
# (num_D, ndf, n_layers, downsampling): the tiny test config and the
# canonical one of every experiment config
MELGAN = [(2, 4, 2, 4), (3, 16, 4, 4)]


def _signal(shape, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


@pytest.fixture
def jax_float32():
    """The JAX discriminators read a process-wide compute dtype."""
    old = jmodules.compute_dtype()
    jmodules.set_compute_dtype(jnp.float32)
    yield
    jmodules.set_compute_dtype(old)


@pytest.mark.parametrize("n_fft,hop,win", RESOLUTIONS)
def test_stft_matches_jax(n_fft, hop, win):
    x = _signal((2, 8000), 0)
    want = np.asarray(jspec.stft(jnp.asarray(x), n_fft, hop, win,
                                 normalized=False))
    got = pspec.stft(torch.from_numpy(x), n_fft, hop, win)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * np.abs(
        want).max())


def test_multi_resolution_stft_loss_and_grad_match_jax():
    x, y = _signal((2, 8000), 1), _signal((2, 8000), 2)

    def jloss(a):
        sc, mag = jstft.multi_resolution_stft_loss(a, jnp.asarray(y),
                                                   factor_sc=0.5,
                                                   factor_mag=0.5)
        return sc + mag

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    sc, mag = pstft.multi_resolution_stft_loss(xt, torch.from_numpy(y),
                                               factor_sc=0.5, factor_mag=0.5)
    (grad,) = torch.autograd.grad(sc + mag, xt)
    np.testing.assert_allclose(float((sc + mag).detach()), float(want),
                               rtol=1e-5)
    # the log-magnitude term's gradient goes as 1 / |X|^2, which amplifies
    # float32 rounding at bins of small magnitude
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               atol=1e-3 * np.abs(np.asarray(want_grad)).max())


def _melgan_pair(cfg, seed=0):
    num_d, ndf, n_layers, down = cfg
    jmod = jdisc.MelganDiscriminator(num_D=num_d, ndf=ndf, n_layers=n_layers,
                                     downsampling_factor=down)
    params = jax.tree.map(np.asarray, jmod.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4000, 1)))["params"])
    port = pdisc.MelganDiscriminator(num_d, ndf, n_layers, down)
    port.load_state_dict(melgan_state_dict_from_jax(params, n_layers),
                         strict=True)
    return jmod, params, port


@pytest.mark.parametrize("cfg", MELGAN, ids=["tiny", "canonical"])
def test_melgan_feature_maps_match_jax(cfg, jax_float32):
    jmod, params, port = _melgan_pair(cfg)
    x = _signal((2, 1, 4000), 3)
    want = jmod.apply({"params": params}, jnp.asarray(x).transpose(0, 2, 1))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == cfg[0]
    for g_scale, w_scale in zip(got, want):
        assert len(g_scale) == len(w_scale) == cfg[2] + 3
        for g, w in zip(g_scale, w_scale):
            w = np.asarray(w).transpose(0, 2, 1)  # [B, T, C] -> [B, C, T]
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w,
                                       atol=1e-5 * max(1, np.abs(w).max()))


def test_melgan_keys_are_the_reference_layout():
    """The port's parameter names are what melgan_torch_prefix names."""
    _, params, port = _melgan_pair(MELGAN[1])
    want = {f"{melgan_torch_prefix(d, n, 4)}.{leaf}"
            for d, layers in params.items() for n in layers
            for leaf in ("weight_v", "weight_g", "bias")}
    assert set(port.state_dict()) == want


def test_seeded_melgan_init():
    """v and the bias uniform within 1/sqrt(fan_in), g = ||v||: the
    initial weight is v."""
    exp = Config._wrap(dict(adversarial=True,
                            discriminator_models=["msd_melgan"],
                            melgan_discriminator=dict(
                                n_layers=4, num_D=3, downsampling_factor=4,
                                ndf=16)))
    a = build_discriminators(exp, device="cpu", seed=5)["msd_melgan"]
    b = build_discriminators(exp, device="cpu", seed=5)["msd_melgan"]
    assert all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))
    for m in a.modules():
        if isinstance(m, pdisc.WNConv1d):
            bound = 1 / np.sqrt(m.weight_v[0].numel())
            assert float(m.weight_v.abs().max()) <= bound
            assert float(m.bias.abs().max()) <= bound
            torch.testing.assert_close(m.weight(), m.weight_v)


@pytest.mark.parametrize("name", ["msd_hifi", "mpd", "hifi"])
def test_later_discriminators_raise(name):
    """The HiFi names, ported after the MelGAN, build their networks
    (``hifi`` both); a name the JAX factory does not know raises."""
    hifi = dict(msd=dict(hidden=16, num_D=2), mpd=dict(hidden=2, periods=[2]))
    exp = Config._wrap(dict(adversarial=True, discriminator_models=[name],
                            **hifi))
    assert list(build_discriminators(exp, device="cpu")) == {
        "msd_hifi": ["msd_hifi"], "mpd": ["mpd"],
        "hifi": ["msd_hifi", "mpd"]}[name]
    exp = Config._wrap(dict(adversarial=True,
                            discriminator_models=[name + "_v2"], **hifi))
    with pytest.raises(ValueError):
        build_discriminators(exp, device="cpu")


def _feature_lists(cfg, seed):
    """Random [B, C, T] feature maps shaped like a MelGAN output."""
    rng = np.random.default_rng(seed)
    num_d, _, n_layers, _ = cfg
    return [[rng.standard_normal((2, 3 + j, 50 - 5 * i)).astype(np.float32)
             for j in range(n_layers + 3)] for i in range(num_d)]


def _jax_maps(maps):
    return [[jnp.asarray(m.transpose(0, 2, 1)) for m in s] for s in maps]


def _torch_maps(maps):
    return [[torch.from_numpy(m) for m in s] for s in maps]


@pytest.mark.parametrize("cfg", MELGAN, ids=["tiny", "canonical"])
def test_melgan_losses_match_jax(cfg):
    fake, real = _feature_lists(cfg, 4), _feature_lists(cfg, 5)
    want_d = jadv.melgan_discriminator_loss(_jax_maps(fake), _jax_maps(real))
    got_d = padv.melgan_discriminator_loss(_torch_maps(fake),
                                           _torch_maps(real))
    want_adv, want_feat = jadv.melgan_generator_losses(
        _jax_maps(fake), _jax_maps(real), n_layers=cfg[2], num_d=cfg[0])
    got_adv, got_feat = padv.melgan_generator_losses(
        _torch_maps(fake), _torch_maps(real), n_layers=cfg[2], num_d=cfg[0])
    for got, want in ((got_d, want_d), (got_adv, want_adv),
                      (got_feat, want_feat)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_melgan_feature_loss_detaches_real():
    cfg = MELGAN[0]
    fake = [[m.requires_grad_() for m in s]
            for s in _torch_maps(_feature_lists(cfg, 6))]
    real = [[m.requires_grad_() for m in s]
            for s in _torch_maps(_feature_lists(cfg, 7))]
    _, feat = padv.melgan_generator_losses(fake, real, n_layers=cfg[2],
                                           num_d=cfg[0])
    feat.backward()
    assert all(m.grad is None for s in real for m in s)
    assert all(m.grad is not None for s in fake for m in s[:-1])
