"""The generator options no shipped config sets, the port against aero_tpu
on the CPU in float32, the same weights on both sides (JAX variables,
loaded into the port by ``state_dict_from_jax``): decoder DConv (``dconv_mode`` 3), time-axis layers
(``freq_ends`` < depth - 1), GELU and ReLU DConv activations, LocalState
with ``nfreqs`` and with ``ndecay`` 0, the ``debug`` shape log; the weights
and checkpoints of such a generator, predict with ``upsample``, and the
Solver's ``profile`` trace and ``checkify_step``."""

import contextlib
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aero_tpu.eval.forward import EvalForward as JaxEvalForward
from aero_tpu.models import modules as jm
from aero_tpu.models.aero import Aero as JaxAero
from aero_tpu.ops.resample import resample_np as jax_resample_np
from aero_tpu.train.torch_import import (
    export_aero_state as jax_export_aero_state, import_aero_state)
from aero_tpu_torch import predict as ppredict
from aero_tpu_torch.data.prep import make_dummy_dataset
from aero_tpu_torch.models import modules as pm
from aero_tpu_torch.models.aero import Aero
from aero_tpu_torch.models.factory import build_generator
from aero_tpu_torch.ops import attention
from aero_tpu_torch.train import __main__ as ptrain
from aero_tpu_torch.train import checkpoint as pckpt
from aero_tpu_torch.train.from_jax import (
    export_aero_state, state_dict_from_jax)
from aero_tpu_torch.train.train_step import TrainStep
from aero_tpu_torch.utils import profiling
from aero_tpu_torch.utils.config import load_config
from test_torch_port_modules import ATOL, _load, perturb
from test_torch_port_serving import _StubState
from test_torch_port_train_step import GRAD_TOL, _grad_bands

pytestmark = pytest.mark.torch_port

CONF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conf")
TINY = dict(load_config(CONF, "main_config", ["experiment=tiny"])
            .experiment.aero)
# (dconv_mode, freq_ends, act_func); the tiny config has 2 layers, so
# freq_ends 0 puts layer 1 on the time axis
OPTIONS = [(3, 4, "snake"), (1, 0, "gelu"), (3, 1, "relu")]
# whole forward, float32 on the CPU, of max |out| (test_torch_port_aero.py)
FWD_TOL = 1e-5
SECONDS = 1.0  # T = 251 frames: the BLSTM's chunking runs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers
    share few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(dconv_mode, freq_ends, act_func, **kw):
    return dict(TINY, dconv_mode=dconv_mode, freq_ends=freq_ends,
                act_func=act_func, **kw)


def _jax_model(config):
    return JaxAero(**dict(config, strides=tuple(config["strides"])))


@pytest.fixture(scope="module")
def jax_generators():
    """{options: (JAX Aero, its variables)} for every case of the file. The
    weights are the port's seeded init (JAX's init rules and rescale, drawn
    from a torch generator) mapped to the JAX variables by
    ``checkpoint.aero_variables``, then moved off their constant leaves: a
    jitted JAX init costs ~13 s a config on the CPU, the eval_shape of
    JAX's init checks the tree."""
    out = {}
    for i, opts in enumerate(OPTIONS + [(3, 0, "snake")]):
        config = _config(*opts)
        model = _jax_model(config)
        v = pckpt.aero_variables(build_generator(
            config, device="cpu", seed=i).state_dict())
        abstract = jax.eval_shape(lambda k: model.init(
            k, jnp.zeros((1, 1, 4000)), train=False), jax.random.PRNGKey(0))
        assert jax.tree.map(np.shape, v) == jax.tree.map(
            lambda a: a.shape, {k: abstract[k] for k in v})
        out[opts] = (model, perturb(v, np.random.default_rng(i)))
    return out


def _port(config, variables):
    port = Aero(**config)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return port


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: "-".join(map(str, o)))
def test_aero_forward_matches_jax(jax_generators, opts):
    model, v = jax_generators[opts]
    x = (0.1 * np.random.default_rng(5).standard_normal(
        (2, 1, int(4000 * SECONDS)))).astype(np.float32)
    want = np.asarray(jax.jit(lambda vv, y: model.apply(vv, y, train=False))(
        v, jnp.asarray(x)))
    port = _port(_config(*opts), v).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 4 * x.shape[-1])
    np.testing.assert_allclose(got, want, atol=FWD_TOL * np.abs(want).max())


@pytest.mark.parametrize("t", [300, 600])
@pytest.mark.parametrize("kw", [dict(nfreqs=2), dict(ndecay=0)],
                         ids=["nfreqs2", "ndecay0"])
def test_local_state_option_matches_jax(kw, t):
    """T = 300 is the JAX dense branch, T = 600 its query-block scan; the
    port takes the counted plain route for ``nfreqs``, ``local_attention``
    for ``ndecay`` 0."""
    n, c = 2, 16
    x = np.random.default_rng(6).standard_normal((n, t, c)).astype(np.float32)
    jmod = jm.LocalState(c, heads=4, **kw)
    v = {"params": perturb(jax.tree.map(np.asarray, jmod.init(
        jax.random.PRNGKey(1), jnp.asarray(x))["params"]),
        np.random.default_rng(7))}
    want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    port = _load(pm.LocalState(c, heads=4, **kw), v,
                 ("encoder_0", "dconv", "layers_0_time_attn"),
                 "encoder.0.dconv.layers.0.time_attn.")
    calls = attention.periodic_attention.calls
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2))
    assert attention.periodic_attention.calls - calls == int("nfreqs" in kw)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=ATOL)


def test_generator_grads_match_jax(jax_generators):
    """dconv_mode 3 with layer 1 on the time axis, train mode: the gradient
    of mean |pr - hr| against JAX's value_and_grad of the same loss, held
    as ``test_torch_port_train_step.py`` holds the generator's (each leaf
    to 5e-2 of its max, the leaves that are zero in exact arithmetic and
    the whole gradient to 1e-3)."""
    opts = (3, 0, "snake")
    model, v = jax_generators[opts]
    rng = np.random.default_rng(8)
    lr = (0.1 * rng.standard_normal((2, 1, 4000))).astype(np.float32)
    hr = (0.1 * rng.standard_normal((2, 1, 16000))).astype(np.float32)

    def loss(params, y, target):
        pr, _ = model.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, y,
                            train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.abs(pr - target))

    want_loss, g = jax.jit(jax.value_and_grad(loss))(
        v["params"], jnp.asarray(lr), jnp.asarray(hr))
    want = export_aero_state({"params": jax.tree.map(np.asarray, g)})

    port = _port(_config(*opts), v).train()
    got_loss = (port(torch.from_numpy(lr)) - torch.from_numpy(hr)).abs().mean()
    got_loss.backward()
    got = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert abs(got_loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    assert sorted(got) == sorted(want)
    bands = _grad_bands(want, "generator", port)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.abs(got[k] - w).max() <= bands[k], (
            k, float(np.abs(got[k] - w).max()), bands[k])
    flat_w = np.concatenate([w.ravel() for w in want.values()])
    flat_g = np.concatenate([got[k].ravel() for k in want])
    assert np.linalg.norm(flat_g - flat_w) <= GRAD_TOL * np.linalg.norm(flat_w)


def test_seeded_init_rescales_what_jax_rescales():
    """``rescale`` divides exactly the leaves that JAX's ``rescale_tree``
    divides (a rank-3 kernel and its bias, but for a ``conv_tr``): the
    decoders' DConv convs, not the time-axis (1, k) conv nor the time-axis
    ConvTranspose, whose JAX kernel is rank 3 too."""
    config = _config(3, 0, "snake")
    model = _jax_model(config)
    abstract = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 1, 4000)), train=False), jax.random.PRNGKey(0))

    def marked(node, name=""):  # 1 where rescale_tree divides, else 0
        if not isinstance(node, dict):
            return np.zeros(node.shape, np.float32)
        hit = ("kernel" in node and len(node["kernel"].shape) == 3
               and name != "conv_tr")
        return {k: np.full(v.shape, float(hit), np.float32)
                if hit and k in ("kernel", "bias") else marked(v, k)
                for k, v in node.items()}

    want = {k for k, v in export_aero_state(
        {"params": marked(abstract["params"])}).items() if v.any()}
    a = build_generator(config, device="cpu", seed=4).state_dict()
    raw = build_generator(dict(config, rescale=0), device="cpu",
                          seed=4).state_dict()
    assert {k for k in a if not torch.equal(a[k], raw[k])} == want
    assert any(k.startswith("decoder.") and ".dconv." in k for k in want)


@pytest.mark.parametrize("freq_ends", [1, 0])
def test_checkpoint_round_trip_and_reference_keys(freq_ends, tmp_path):
    """A dconv_mode 3 generator (freq_ends 0: layer 1 on the time axis):
    the reference state_dict has JAX's ``export_aero_state`` keys, and
    JAX's ``import_aero_state`` takes every one at its flax shape (the
    time-axis ConvTranspose as the reference's [in, out, 1, k], which
    JAX's own export writes [in, out, k, 1]); ``.atpu`` weights and Adam
    moments round trip bit for bit."""
    config = _config(3, freq_ends, "relu")
    model = _jax_model(config)
    abstract = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 1, 4000)), train=False),
        jax.random.PRNGKey(0))
    zeros = {coll: jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                abstract[coll])
             for coll in ("params", "batch_stats")}
    gen = build_generator(config, device="cpu", seed=2)
    sd = {k: v.numpy() for k, v in gen.state_dict().items()}
    assert sorted(sd) == sorted(jax_export_aero_state(zeros))
    imported = import_aero_state(sd, zeros)
    assert sorted(export_aero_state(imported)) == sorted(sd)
    for k, w in export_aero_state(imported).items():
        np.testing.assert_array_equal(w, sd[k], err_msg=k)
    time_tr = [k for k, w in sd.items()
               if k.endswith("conv_tr.weight") and w.shape[-1] > 1]
    assert len(time_tr) == (1 if freq_ends == 0 else 0)

    opt = torch.optim.Adam(gen.parameters(), lr=1e-3)
    for p in gen.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    named = {"generator": (gen, list(gen.named_parameters()))}
    path = str(tmp_path / "checkpoint.atpu")
    pckpt.save_package(path, {
        "models": pckpt.model_variables({"generator": gen}),
        "optimizers": {"optimizer": pckpt.adam_to_optax(opt, named)}})
    package = pckpt.load_package(path)
    back = build_generator(config, device="cpu", seed=3)
    pckpt.load_model_variables({"generator": back}, package["models"])
    for (k, a), b in zip(gen.state_dict().items(),
                         back.state_dict().values()):
        assert torch.equal(a, b), k
    opt_back = torch.optim.Adam(back.parameters(), lr=1e-3)
    pckpt.optax_to_adam(opt_back, {"generator": (
        back, list(back.named_parameters()))},
        package["optimizers"]["optimizer"])
    for p, q in zip(gen.parameters(), back.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][key], opt_back.state[q][key])
        assert float(opt_back.state[q]["step"]) == 1.0


def test_predict_upsample_matches_jax(tmp_path, monkeypatch):
    """``upsample=true``: the port's resample to hr_sr and the forward at
    scale 1 of a ``spec_upsample=false`` generator, through
    ``predict_file``, against JAX's ``resample_np`` and ``EvalForward``."""
    from aero_tpu_torch.data import audio_io

    config = _config(1, 4, "snake", spec_upsample=False)
    model = _jax_model(config)
    v = pckpt.aero_variables(build_generator(config, device="cpu",
                                             seed=3).state_dict())
    n = 2100  # 0.525 s at 4 kHz
    wav = str(tmp_path / "in.wav")
    t = np.arange(n) / 4000
    audio_io.save(wav, 0.3 * np.sin(2 * np.pi * 440 * t)[None], 4000)
    lr, sr = audio_io.load(wav)
    hr_in = jax_resample_np(lr, sr, 16000)
    state = _StubState(v["params"], {"batch_stats": v["batch_stats"]})
    want = np.asarray(JaxEvalForward(model, state, scale=1.0, lr_sr=16000)(
        hr_in[None]))[0]

    written = {}
    monkeypatch.setattr(ppredict, "write_wav", lambda wav, path, rate:
                        written.update(wav=np.asarray(wav), rate=rate))
    out = ppredict.predict_file(_port(config, v).eval(), wav,
                                str(tmp_path / "out"), 4000, 16000, "cpu",
                                upsample=True)
    assert out["in_samples"] == hr_in.shape[-1] == 4 * n
    assert out["out_samples"] == hr_in.shape[-1] and written["rate"] == 16000
    np.testing.assert_allclose(written["wav"], want,
                               atol=FWD_TOL * np.abs(want).max())


def test_debug_logs_each_stage(caplog):
    gen = build_generator(_config(1, 0, "gelu", debug=True), device="cpu")
    with caplog.at_level(logging.INFO, logger="aero_tpu_torch.models.aero"):
        with torch.no_grad():
            gen(torch.zeros(1, 1, 2000))
    lines = [r.getMessage() for r in caplog.records]
    assert lines[0] == "aero in shape: (1, 1, 2000)"
    assert "encoder 1 out shape: (1, 8, 64, 32)" in lines
    assert lines[-1] == "aero out - trimmed shape: (1, 1, 8000)"


def test_solver_profile_writes_a_trace(tmp_path, monkeypatch):
    """``profile=true``: epoch 0's step 1 is traced into ``profile_dir``;
    the trace names the LocalState attention (its plain version here) and
    the program's spans. ``debug_nans=true`` trains in autograd's anomaly
    mode, off after."""
    make_dummy_dataset(str(tmp_path / "egs"), n_files=4, duration=1.2,
                       seed=0)
    monkeypatch.chdir(tmp_path)
    traced = []
    trace = profiling.trace

    def spy(logdir):
        traced.append(logdir)
        return trace(logdir)

    monkeypatch.setattr(profiling, "trace", spy)
    anomaly = []
    step = TrainStep.__call__

    def spy_step(self, *args):
        anomaly.append(torch.is_anomaly_enabled())
        return step(self, *args)

    monkeypatch.setattr(TrainStep, "__call__", spy_step)
    ptrain.main(["experiment=tiny", "dset=debug", "device=cpu",
                 "visqol=false", "num_workers=0", "dset.train=egs/tr",
                 "dset.valid=egs/val", "dset.test=egs/val", "epochs=1",
                 "eval_every=2", "profile=true", "profile_dir=prof",
                 "debug_nans=true"])
    run_dir = tmp_path / "outputs" / "debug" / "tiny-nfft=512-hl=64"
    traces = list((run_dir / "prof").glob("*.pt.trace.json"))
    assert traced == ["prof"] and len(traces) == 1
    assert anomaly and all(anomaly) and not torch.is_anomaly_enabled()
    text = traces[0].read_text()
    assert "aten::softmax" in text
    assert '"train.step"' in text and '"aero.encoder"' in text


def test_annotate_timer_and_nan_debugging():
    """``annotate`` names a range of the trace while a profiler is active
    and is a null context otherwise, ``enable_nan_debugging`` turns
    autograd's anomaly mode on (inside its block when used as one)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("aero_step"):
            torch.ones(4).sum()
    assert "aero_step" in {e.key for e in prof.key_averages()}
    assert isinstance(profiling.annotate("aero_step"),
                      contextlib.nullcontext)
    before = torch.is_anomaly_enabled()
    with profiling.enable_nan_debugging():
        assert torch.is_anomaly_enabled()
    assert torch.is_anomaly_enabled() == before


def test_checkify_step_raises_on_nan():
    step = profiling.checkify_step(
        lambda x: {"loss": float(x.sum()), "out": [x, x * 0 + 1]})
    err, out = step(torch.ones(3))
    err.throw()
    assert out["loss"] == 3.0 and err.get() is None
    err, _ = step(torch.tensor([1.0, float("nan")]))
    assert err.get() == "non-finite value in out['loss']"
    with pytest.raises(FloatingPointError, match="non-finite"):
        err.throw()
