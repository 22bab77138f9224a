"""The port's spans and counters on the CPU, at a tiny width: the span names
of one train step (MelGAN, and HiFi's MPD, MSD and mel loss) and one chunked
file under ``torch.profiler``, each inside its parent and none a user
annotation; ``annotate`` with no profiler active; the device work put down
to the spans, on recorded events; ``EvalForward``'s sample counters; the
spectral norm's power iterations; ``profiling.counters``."""

import copy
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aero_tpu_torch.eval.forward import ChunkedInference, EvalForward
from aero_tpu_torch.models.discriminators import SNConv1d
from aero_tpu_torch.models.factory import build_discriminators
from aero_tpu_torch.ops.attention import local_attention, periodic_attention
from aero_tpu_torch.ops.ftb import ftb_tail
from aero_tpu_torch.ops.group_norm import group_norm
from aero_tpu_torch.ops.lstm import lstm_recurrence
from aero_tpu_torch.train.build import build_models
from aero_tpu_torch.train.train_step import TrainStep
from aero_tpu_torch.utils import profiling
from aero_tpu_torch.utils.config import Config, load_config

pytestmark = pytest.mark.torch_port

CONF = os.path.join(os.path.dirname(__file__), "..", "conf")
SR = 4000
TRAIN_SPANS = {"train.step", "train.upload", "train.gen_forward",
               "train.disc_real", "train.gen_losses", "train.gen_backward",
               "train.disc_losses", "train.disc_backward",
               "train.reduce_fetch", "train.gen_adam", "train.disc_adam",
               "aero.encoder", "aero.decoder", "aero.blstm"}
SERVE_SPANS = {"serve.file", "serve.split", "serve.upload", "serve.forward",
               "serve.download", "serve.join", "aero.encoder", "aero.decoder",
               "aero.blstm"}


@pytest.fixture(scope="module")
def models():
    args = load_config(CONF, "main_config",
                       ["experiment=tiny", "dset=debug", "device=cpu"])
    args.experiment.segment = 0.5
    return args, build_models(args, device="cpu")


def _spans(prof):
    """[(name, start us, end us)] of the program's spans in the trace; none
    is a user annotation, which the profiler would draw on the device's
    timeline too."""
    spans = [e for e in prof.profiler.kineto_results.events()
             if e.name().startswith(profiling.PREFIXES)]
    assert not any(e.is_user_annotation() for e in spans)
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3) for e in spans]


def _parents(spans):
    """{name: the names of the innermost spans that hold its spans}."""
    out = {}
    for name, lo, hi in spans:
        holders = [s for s in spans if s[1] <= lo and hi <= s[2]
                   and (s[1], s[2]) != (lo, hi)]
        inner = min(holders, key=lambda s: s[2] - s[1])[0] if holders \
            else None
        out.setdefault(name, set()).add(inner)
    return out


def test_train_step_spans_nest(models):
    """The step's spans nest; its generator forward runs each GroupNorm
    once, on aten's autograd path, and launches no kernel pair."""
    from aero_tpu_torch.models.modules import GroupNorm

    args, m = models
    step = TrainStep(args, m, "cpu")
    rng = np.random.default_rng(0)
    lr = (0.1 * rng.standard_normal((2, 1, 2000))).astype(np.float32)
    hr = (0.1 * rng.standard_normal((2, 1, 8000))).astype(np.float32)
    before = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(lr, hr)
    after = profiling.counters()
    sites = sum(isinstance(mod, GroupNorm)
                for mod in m["generator"].modules())
    assert sites > 0 and (after["group_norm.autograd_calls"]
                          - before["group_norm.autograd_calls"]) == sites
    assert after["group_norm.calls"] == before["group_norm.calls"]
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert set(names) == TRAIN_SPANS and names.count("train.step") == 1
    parents = _parents(spans)
    for name in TRAIN_SPANS - {"train.step", "aero.encoder", "aero.decoder",
                               "aero.blstm"}:
        assert parents[name] == {"train.step"}, name
    assert parents["train.step"] == {None}
    assert parents["aero.encoder"] == {"train.gen_forward"}
    assert parents["aero.decoder"] == {"train.gen_forward"}
    assert parents["aero.blstm"] == {"aero.encoder"}


def test_hifi_step_spans_nest(models):
    """``discriminator_models=[hifi]``: each MPD and MSD forward (real, the
    generator's fake, the discriminator's fake) opens ``hifi.mpd`` /
    ``hifi.msd`` inside the step's part that runs it, the mel L1 opens
    ``loss.mel`` inside ``train.gen_losses``, and the spectral-normed scale
    (8 convs) counts 8 power iterations in each of its three forwards and
    in the discriminator pass's ``step_u``. ``grads`` alone: the shared
    generator keeps its weights."""
    args, m = models
    args = copy.deepcopy(args)
    exp = args.experiment
    exp.discriminator_models = ["hifi"]
    exp.msd = Config._wrap(dict(hidden=16, num_D=2))
    exp.mpd = Config._wrap(dict(hidden=4, periods=[2, 3]))
    exp.mel_spectrogram = Config._wrap(dict(
        n_fft=256, hop_length=64, win_length=256, n_mels=16))
    exp.mel_spec_loss_lambda = 45
    step = TrainStep(args, {"generator": m["generator"],
                            **build_discriminators(exp, device="cpu")}, "cpu")
    rng = np.random.default_rng(2)
    lr = (0.1 * rng.standard_normal((2, 1, 2000))).astype(np.float32)
    hr = (0.1 * rng.standard_normal((2, 1, 8000))).astype(np.float32)
    before = SNConv1d.power_iterations
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step.grads(lr, hr)
    assert SNConv1d.power_iterations - before == 4 * 8
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert names.count("hifi.mpd") == names.count("hifi.msd") == 3
    assert names.count("loss.mel") == 1
    parents = _parents(spans)
    for name in ("hifi.mpd", "hifi.msd"):
        assert parents[name] == {"train.disc_real", "train.gen_losses",
                                 "train.disc_losses"}, name
    assert parents["loss.mel"] == {"train.gen_losses"}


@pytest.mark.parametrize("pad_tail", [False, True])
def test_chunked_file_spans_nest(models, pad_tail):
    """Two full chunks and a tail: one ``serve.file``, a ``pad_tail``
    recursion included."""
    gen = models[1]["generator"].eval()
    chunked = ChunkedInference(EvalForward(gen, 4, SR, "cpu"), SR,
                               segment_s=1.0, batch_chunks=True,
                               pad_tail=pad_tail, scale=4)
    x = np.random.default_rng(1).standard_normal(
        (1, 1, 2 * SR + 1500)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = chunked(x)
    assert y.shape == (1, 1, 4 * x.shape[-1])
    spans = _spans(prof)
    names = [s[0] for s in spans]
    assert set(names) == SERVE_SPANS and names.count("serve.file") == 1
    assert names.count("serve.forward") == (1 if pad_tail else 2)
    parents = _parents(spans)
    for name in ("serve.split", "serve.upload", "serve.forward",
                 "serve.download", "serve.join"):
        assert parents[name] == {"serve.file"}, name
    assert parents["aero.encoder"] == {"serve.forward"}


def test_annotate_without_profiler_records_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "_Span",
                        lambda name: entered.append(name))
    span = profiling.annotate("serve.file")
    assert span is profiling.annotate("train.step")
    with span:
        torch.ones(2).sum()
    assert entered == []


def _host(name, lo, hi, corr=0, annotation=False):
    return profiling.Event(name, False, lo, hi, corr, annotation)


def _device(name, lo, hi, corr, annotation=False):
    return profiling.Event(name, True, lo, hi, corr, annotation)


# one step (us): the forward's kernel launched inside its span; the
# backward's launched by another thread (its host op is not in the trace)
# while the caller sits in the backward span; Adam's kernel inside torch's
# own user range, whose image on the device is no work; a kernel whose
# launch is not in the trace; a copy launched outside every span
STEP = [
    _host("train.step", 0, 1000, corr=1),
    _host("train.gen_forward", 10, 200, corr=2),
    _host("aten::conv2d", 20, 60, corr=3),
    _host("cudaLaunchKernel", 30, 35, corr=101),
    _host("train.gen_backward", 300, 600, corr=4),
    _host("cudaLaunchKernel", 400, 405, corr=102),
    _host("train.gen_adam", 700, 900, corr=5),
    _host("Optimizer.step#Adam.step", 705, 890, corr=6, annotation=True),
    _host("cudaLaunchKernel", 715, 718, corr=103),
    _host("cudaMemcpyAsync", 1100, 1105, corr=105),
    _device("conv_kernel", 40, 140, corr=101),
    _device("bwd_kernel", 410, 590, corr=102),
    _device("adam_kernel", 720, 760, corr=103),
    _device("Optimizer.step#Adam.step", 720, 760, corr=6, annotation=True),
    _device("lost_kernel", 800, 810, corr=104),
    _device("Memcpy HtoD", 1110, 1120, corr=105),
]


def test_attribution_by_launch_time():
    got = profiling.attribute(STEP)
    assert got["spans"]["train.step"] == {"count": 1, "host_s": 1e-3}
    assert got["device_s"] == pytest.approx({
        "train.step": 320e-6, "train.gen_forward": 100e-6,
        "train.gen_backward": 180e-6, "train.gen_adam": 40e-6})
    assert got["launches"] == {"train.step": 3, "train.gen_forward": 1,
                               "train.gen_backward": 1, "train.gen_adam": 1}
    assert got["unattributed_s"] == pytest.approx(10e-6)
    assert got["outside_s"] == pytest.approx(10e-6)
    assert profiling.table(got)["train.gen_backward"] == [1, 0.3, 0.18, 1]


def test_attribution_of_repeated_spans():
    """Two steps: a span's count, host time and device time add up."""
    second = [e._replace(start_us=e.start_us + 5000, end_us=e.end_us + 5000,
                         correlation=e.correlation + 1000) for e in STEP]
    got = profiling.attribute(STEP + second)
    assert got["spans"]["train.gen_forward"]["count"] == 2
    assert got["spans"]["train.gen_forward"]["host_s"] == pytest.approx(
        380e-6)
    assert got["device_s"]["train.step"] == pytest.approx(640e-6)
    assert got["launches"]["train.step"] == 6


def test_trace_logs_spans_and_counters(tmp_path, caplog, models):
    gen = models[1]["generator"].eval()
    forward = EvalForward(gen, 4, SR, "cpu", bucket_s=1.0)
    chunked = ChunkedInference(forward, SR, segment_s=1.0,
                               batch_chunks=True, scale=4)
    x = np.zeros((1, 1, SR + 1000), np.float32)  # a chunk and a tail of 1000
    with caplog.at_level("INFO", logger=profiling.__name__):
        with profiling.trace(str(tmp_path)):
            chunked(x)
    text = caplog.text
    assert '"serve.file": [1, ' in text and '"aero.encoder": [' in text
    assert ('"EvalForward.samples": 8000' in text
            and '"EvalForward.padded_samples": 3000' in text)
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1


def _stub(x):
    return x.repeat_interleave(4, dim=-1)


@pytest.mark.parametrize("rows,t,padded", [(1, 1, SR), (1, SR, SR),
                                           (1, SR + 1, 2 * SR),
                                           (3, 5000, 2 * SR)])
def test_eval_forward_counts_samples(rows, t, padded):
    forward = EvalForward(_stub, 4, SR, "cpu", bucket_s=1.0)
    before = (EvalForward.samples, EvalForward.padded_samples)
    y = forward(np.zeros((rows, 1, t), np.float32))
    assert y.shape == (rows, 1, 4 * t)
    assert EvalForward.samples - before[0] == rows * padded
    assert EvalForward.padded_samples - before[1] == rows * (padded - t)


def test_counters_hold_every_counter():
    owners = {"local_attention": local_attention,
              "periodic_attention": periodic_attention,
              "lstm_recurrence": lstm_recurrence, "ftb_tail": ftb_tail,
              "group_norm": group_norm, "EvalForward": EvalForward,
              "SNConv1d": SNConv1d}
    got = profiling.counters()
    assert set(got) == {
        "local_attention.launches", "local_attention.mma_launches",
        "local_attention.banded_launches",
        "local_attention.backward_launches",
        "local_attention.backward_mma_launches", "periodic_attention.calls",
        "lstm_recurrence.launches", "lstm_recurrence.mma_launches",
        "ftb_tail.launches", "ftb_tail.mma_launches", "group_norm.calls",
        "group_norm.autograd_calls", "EvalForward.samples",
        "EvalForward.padded_samples", "EvalForward.graph_captures",
        "EvalForward.graph_replays", "EvalForward.eager_forwards",
        "SNConv1d.power_iterations"}
    for key, value in got.items():
        owner, attr = key.split(".")
        assert value == getattr(owners[owner], attr)
