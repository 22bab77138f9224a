"""The port's HiFi-GAN training path against the benchmark's plain reference
(``benchmark/reference/hifi.py``) on the CPU in float32, with no JAX: the
mel filterbank, the MPD's and MSD's logits and feature maps (and the u a
storing MSD forward keeps), the LS-GAN, feature and mel losses, and one
``TrainStep`` of ``discriminator_models=[hifi]`` against
``ReferenceHifiStep``: both losses, every leaf's gradient and every stored
u after the update.

Seeded weights from ``benchmark/weights_hifi.py`` at a tiny size: Aero with
one encoder (no LSTM, no attention), MPD hidden 4 with periods 2 and 3, MSD
hidden 16 with 2 scales (the grouped convs take 16 groups, so 16 is the
least width), mel n_fft 256 with 16 mels, B 2 x 0.25 s."""

import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from aero_tpu_torch.losses import adversarial as padv  # noqa: E402
from aero_tpu_torch.models.discriminators import SNConv1d  # noqa: E402
from aero_tpu_torch.ops import mel as pmel  # noqa: E402
from aero_tpu_torch.train.train_step import TrainStep  # noqa: E402
from benchmark import harness, weights_hifi  # noqa: E402
from benchmark.drivers import train_hifi  # noqa: E402
from benchmark.reference import hifi as H  # noqa: E402

pytestmark = pytest.mark.torch_port

SEED = 2 ** 31 + 18
# the same float32 convolutions on both sides; the weight norm's and the
# STFT's sums may run in another order, a few ulps through six layers
FWD_TOL = 1e-5
# losses of the same tensors: one reduction each
LOSS_TOL = 1e-6
# a step's losses, from two implementations of the generator (GroupNorm,
# FTB, the STFT loss) whose float32 sums differ in order
STEP_LOSS_TOL = 1e-5
# each leaf's ||g - g_ref|| / max(||g_ref||, the median leaf's): float32
# round-off of the whole step's backward, ~1e-6 measured
GRAD_TOL = 1e-4
# the stored u are unit vectors of one power iteration each from the same
# matrices
U_TOL = 1e-6


def _cfg():
    cfg = copy.deepcopy(harness.load_json(
        harness.ROOT / "benchmark/configs/aero_4-16_512_64_hifi.json"))
    cfg["precision"] = "float32"
    exp = cfg["experiment"]
    exp["segment"] = 0.25
    exp["aero"].update(channels=8, strides=[4])
    exp["msd"] = {"hidden": 16, "num_D": 2}
    exp["mpd"] = {"hidden": 4, "periods": [2, 3]}
    exp["mel_spectrogram"] = {"n_fft": 256, "hop_length": 64,
                              "win_length": 256, "n_mels": 16}
    return cfg


def _models(cfg):
    """(reference models, the program's models holding their weights)."""
    reference = weights_hifi.seeded_reference(cfg, SEED, "cpu")
    return reference, train_hifi.program_models(cfg, reference, "cpu", True)


def _batch(cfg, rows=2):
    exp = cfg["experiment"]
    rng = np.random.default_rng(18)
    lr_t = int(exp["segment"] * exp["lr_sr"])
    lr = 0.1 * rng.standard_normal((rows, 1, lr_t))
    hr = 0.1 * rng.standard_normal((rows, 1, lr_t * exp["hr_sr"]
                                    // exp["lr_sr"]))
    return (torch.from_numpy(lr.astype(np.float32)),
            torch.from_numpy(hr.astype(np.float32)))


def _rel(got, want) -> float:
    want = want.detach().double()
    return float((got.detach().double() - want).norm()
                 / want.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def nets():
    cfg = _cfg()
    reference, program = _models(cfg)
    return cfg, reference, program


@pytest.mark.parametrize("sr,n_fft,n_mels", [(16000, 1024, 80),
                                              (16000, 256, 16)])
def test_mel_filterbank_is_the_formula(sr, n_fft, n_mels):
    want = torch.from_numpy(pmel.mel_filterbank(sr, n_fft, n_mels))
    got = H.mel_filterbank(sr, n_fft, n_mels, "cpu")
    assert got.shape == (n_fft // 2 + 1, n_mels)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("length", [4000, 4001])
@pytest.mark.parametrize("name", ["mpd", "msd_hifi"])
def test_discriminator_forward(nets, name, length):
    """Logits and every feature map; 4001 samples fold into no whole
    period and pool to odd lengths. The MSD runs a storing forward on both
    sides from the same u, which each keeps."""
    _, reference, program = nets
    x = 0.1 * torch.from_numpy(np.random.default_rng(length).standard_normal(
        (2, 1, length)).astype(np.float32))
    kw = {"store": True} if name == "msd_hifi" else {}
    ref, prog = copy.deepcopy(reference[name]), copy.deepcopy(program[name])
    with torch.no_grad():
        want_y, want_f = ref.discriminate(x, **kw)
        got_y, got_f = prog.discriminate(x, **kw)
    assert len(got_y) == len(want_y) and len(got_f) == len(want_f)
    for g, w in zip(got_y, want_y):
        assert g.shape == w.shape and _rel(g, w) < FWD_TOL
    for gs, ws in zip(got_f, want_f):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert g.shape == w.shape and _rel(g, w) < FWD_TOL
    us = [(n, b) for n, b in prog.named_buffers() if n.endswith("weight_u")]
    want_u = dict(ref.named_buffers())
    assert len(us) == (8 if name == "msd_hifi" else 0)
    for n, u in us:
        if u.numel() > 1:  # conv_post's u, of one output, is +-1 alone
            assert not torch.equal(u, reference[name].get_buffer(n))
        assert float((u - want_u[n]).norm()) < U_TOL


def test_losses(nets):
    """The port's LS-GAN, feature and mel losses against the reference's
    on the same tensors."""
    cfg, reference, program = nets
    lr, hr = _batch(cfg)
    with torch.no_grad():
        pr = 0.1 * torch.tanh(program["generator"](lr))
        msd, mpd = reference["msd_hifi"], reference["mpd"]
        (yr, fr), (yg, fg) = msd.discriminate(hr), msd.discriminate(pr)
        (pyr, pfr), (pyg, pfg) = mpd.discriminate(hr), mpd.discriminate(pr)
    pairs = [
        (padv.hifi_generator_loss(yg + pyg), H.generator_loss(yg + pyg)),
        (padv.hifi_discriminator_loss(yr + pyr, yg + pyg),
         H.discriminator_loss(yr + pyr, yg + pyg)),
        (padv.hifi_feature_loss(fr, fg), H.feature_loss(fr, fg)),
        (padv.hifi_feature_loss(pfr, pfg), H.feature_loss(pfr, pfg))]
    exp = cfg["experiment"]
    kw = exp["mel_spectrogram"]
    got_mel = torch.mean(torch.abs(
        pmel.mel_spectrogram(hr, exp["hr_sr"], **kw)
        - pmel.mel_spectrogram(pr, exp["hr_sr"], **kw)))
    want_mel = torch.mean(torch.abs(
        H.mel_spectrogram(hr, exp["hr_sr"], **kw)
        - H.mel_spectrogram(pr, exp["hr_sr"], **kw)))
    pairs.append((got_mel, want_mel))
    for got, want in pairs:
        assert float(want) > 0
        assert abs(float(got) - float(want)) <= LOSS_TOL * abs(float(want))


@pytest.fixture(scope="module")
def stepped():
    """One step of each side from the same weights, u and batch: the
    program's ``TrainStep.grads`` then ``apply``, the reference's
    ``grads`` (which stores its u as it goes)."""
    cfg = _cfg()
    reference, program = _models(cfg)
    lr, hr = _batch(cfg)
    step = TrainStep(harness.port_args(cfg), program, "cpu")
    gen_g, disc_g, metrics, stats = step.grads(lr, hr)
    step.apply(gen_g, disc_g, stats)
    ref = H.ReferenceHifiStep(cfg, reference, adam=False)
    want_gen, want_disc, losses = ref.grads(lr, hr)
    names = {"generator": [n for n, _ in ref.gen.named_parameters()],
             "discriminators": [f"{k}.{n}" for k in ("msd_hifi", "mpd")
                                for n, _ in reference[k].named_parameters()]}
    return {"metrics": metrics, "losses": losses, "names": names,
            "grads": {"generator": (gen_g, want_gen),
                      "discriminators": (disc_g, want_disc)},
            "u": (train_hifi.stored_u(program), ref.us)}


def test_step_losses(stepped):
    got, want = stepped["metrics"], stepped["losses"]
    assert set(got) == {"generator_stft", "generator_adversarial_hifi",
                        "discriminator_hifi", "total"}
    for key, ref_key in (("total", "total"),
                         ("discriminator_hifi", "discriminator")):
        w = float(want[ref_key])
        assert abs(got[key] - w) <= STEP_LOSS_TOL * abs(w), key


@pytest.mark.parametrize("net", ["generator", "discriminators"])
def test_step_gradients(stepped, net):
    got, want = stepped["grads"][net]
    names = stepped["names"][net]
    assert len(got) == len(want) == len(names)
    norms = np.array([float(w.norm()) for w in want])
    floor = np.median(norms)
    assert floor > 0
    for name, g, w, n in zip(names, got, want, norms):
        assert g.shape == w.shape, name
        gap = float((g - w).norm()) / max(n, floor)
        assert gap < GRAD_TOL, (name, gap)


def test_step_stored_u(stepped):
    """After the update the program stores iter(iter(u0)), as the
    reference's discriminator pass leaves it."""
    got, want = stepped["u"]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert float((g - w).norm()) < U_TOL
        assert abs(float(g.norm()) - 1) < 1e-6


def test_power_iterations_are_counted(nets):
    """Each spectral-normed conv counts one iteration a forward."""
    _, _, program = nets
    msd = copy.deepcopy(program["msd_hifi"])
    before = SNConv1d.power_iterations
    with torch.no_grad():
        msd.discriminate(torch.zeros(1, 1, 4000))
        msd.step_u()
    assert SNConv1d.power_iterations - before == 16
