"""The port's evaluation against aero_tpu's on the CPU: LSD and ViSQOL
(through the repository's scorer binary), ``evaluate`` over two dummy
files with the same weights, and the Solver's exact-length valid losses
against the JAX Solver's bucketed, masked ones."""

import os

import numpy as np
import pytest
import torch

import jax

from aero_tpu.data.datasets import LrHrSet as JLrHrSet
from aero_tpu.data.loader import Loader as JLoader
from aero_tpu.eval import evaluate as jevaluate
from aero_tpu.eval import metrics as jmetrics
from aero_tpu.eval.forward import EvalForward as JEvalForward
from aero_tpu.eval.forward import make_spec_fns as jmake_spec_fns
from aero_tpu.train import build as jbuild
from aero_tpu.train.solver import Solver as JSolver
from aero_tpu.train.train_step import TrainState, init_state
from aero_tpu.utils.config import Config as JConfig
from aero_tpu.utils.config import load_config as jload_config
from aero_tpu_torch.data.datasets import LrHrSet
from aero_tpu_torch.data.loader import Loader
from aero_tpu_torch.data.prep import make_dummy_dataset
from aero_tpu_torch.eval import evaluate as pevaluate
from aero_tpu_torch.eval import metrics as pmetrics
from aero_tpu_torch.eval.forward import EvalForward, make_spec_fns
from aero_tpu_torch.train import build as pbuild
from aero_tpu_torch.train.from_jax import (
    melgan_state_dict_from_jax, state_dict_from_jax)
from aero_tpu_torch.train.solver import Solver
from aero_tpu_torch.train.train_step import TrainStep
from aero_tpu_torch.utils.config import Config, load_config
from test_train_step import tiny_args

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes on few cores, and torch's thread pools in
    each would contend for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

CONF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conf")
LSD_RTOL = 1e-4    # evaluate's average LSD, port vs JAX forward in float32
VALID_RTOL = 1e-5  # each valid loss, exact length vs bucketed and masked


def _signals(seed, shape):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    return clean, (clean + 0.05 * noise).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 16000), (3, 9001)])
def test_lsd_matches_jax(shape):
    clean, est = _signals(sum(shape), shape)
    assert pmetrics.get_lsd(clean, est) == jmetrics.get_lsd(clean, est)
    np.testing.assert_array_equal(pmetrics.stft_mag_np(est),
                                  jmetrics.stft_mag_np(est))


@pytest.mark.parametrize("shape", [(257, 40), (65, 251)])
def test_heatmap_png_matches_jax(tmp_path, shape):
    """The port's spectrogram PNGs (its own inferno table) equal the JAX
    package's (matplotlib's) pixel for pixel."""
    from PIL import Image

    from aero_tpu.utils import viz as jviz
    from aero_tpu_torch.utils import viz as pviz

    spec = np.log(np.random.default_rng(shape[0]).gamma(
        0.5, size=shape) + 1e-8).astype(np.float32)
    np.testing.assert_array_equal(pviz.convert_spectrogram_to_heatmap(spec),
                                  jviz.convert_spectrogram_to_heatmap(spec))
    pviz.save_heatmap_png(spec, str(tmp_path / "port.png"))
    jviz.save_heatmap_png(spec, str(tmp_path / "jax.png"))
    with Image.open(tmp_path / "port.png") as a, \
            Image.open(tmp_path / "jax.png") as b:
        assert a.mode == b.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("visqol", [False, True])
def test_run_metrics_matches_jax(tmp_path, monkeypatch, visqol):
    """With ``visqol=true`` both packages run native/bazel-bin/visqol on
    the same 16-bit wavs and must read the same MOS and scorer stamp."""
    scorer = pmetrics.default_visqol_path()
    if visqol and (scorer is None or pmetrics.probe_scorer_version(scorer)
                   == "unknown"):
        pytest.skip("the repository's ViSQOL scorer does not run here")
    monkeypatch.chdir(tmp_path)
    cfg = {"visqol": visqol, "experiment": {"hr_sr": 16000,
                                            "speech_mode": True}}
    clean, est = _signals(7, (1, 1, 16000))
    got = pmetrics.run_metrics(clean, est, Config._wrap(cfg), "f1")
    want = jmetrics.run_metrics(clean, est, JConfig._wrap(cfg), "f1")
    assert got == want
    if visqol:
        assert 1.0 < got[1] < 5.0
        assert pmetrics.visqol_scorer_version(scorer) == \
            jmetrics.visqol_scorer_version(scorer)
    assert os.listdir(tmp_path) == []  # the temporary wavs are gone


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny experiment's JAX generator and variables, the port's
    generator with the same weights, and two dummy files."""
    root = tmp_path_factory.mktemp("eval")
    make_dummy_dataset(str(root / "egs"), n_files=2, duration=1.4, seed=2)
    jargs = jload_config(CONF, "main_config", ["experiment=tiny",
                                               "visqol=false"])
    models = jbuild.build_models(jargs)
    lr_shape, hr_shape = jbuild.segment_shapes(jargs)
    variables = jax.tree.map(np.asarray, jbuild.init_variables(
        jargs, models, jax.random.PRNGKey(0), lr_shape, hr_shape))
    pargs = load_config(CONF, "main_config", ["experiment=tiny",
                                              "visqol=false"])
    pm = pbuild.build_models(pargs, device="cpu")
    pm["generator"].load_state_dict(
        state_dict_from_jax(variables["generator"]), strict=True)
    pm["generator"].eval()
    return root, jargs, models, variables, pargs, pm


def test_evaluate_matches_jax(tiny):
    root, jargs, models, variables, pargs, pm = tiny
    egs = str(root / "egs" / "val")
    gen_vars = dict(variables["generator"])
    state = TrainState(step=0, gen_params=gen_vars.pop("params"),
                       gen_state=gen_vars, gen_opt_state=(), disc_params={},
                       disc_state={}, disc_opt_state=(),
                       rng=jax.random.PRNGKey(0))
    jargs.samples_dir = str(root / "jax_samples")
    pargs.samples_dir = str(root / "port_samples")
    loader_kw = dict(batch_size=1, shuffle=False, num_workers=1,
                     pad_shards=False)
    want = jevaluate.evaluate(
        jargs, JLoader(JLrHrSet(egs, 4000, 16000, with_path=True,
                                upsample=False), **loader_kw), 0,
        JEvalForward(models["generator"], state, scale=4.0, lr_sr=4000,
                     return_spec=True),
        spec_fns=jmake_spec_fns(jargs, models["generator"]))
    got = pevaluate.evaluate(
        pargs, Loader(LrHrSet(egs, 4000, 16000, with_path=True,
                              upsample=False), **loader_kw), 0,
        EvalForward(pm["generator"], scale=4.0, lr_sr=4000, device="cpu",
                    return_spec=True),
        spec_fns=make_spec_fns(pargs, pm["generator"]))
    assert got[2] == want[2] == ["p000", "p001"]
    assert abs(got[0] - want[0]) <= LSD_RTOL * want[0]
    assert got[1] == want[1] == 0.0
    assert sorted(os.listdir(pargs.samples_dir)) == \
        sorted(os.listdir(jargs.samples_dir))


@pytest.fixture(scope="module")
def valid_setup():
    args = tiny_args()
    models = jbuild.build_models(args)
    lr_shape, hr_shape = jbuild.segment_shapes(args)
    variables = jax.tree.map(np.asarray, jbuild.init_variables(
        args, models, jax.random.PRNGKey(0), lr_shape, hr_shape))
    return args, models, variables


@pytest.mark.parametrize("n_hr", [21345, 16000])
def test_valid_losses_match_jax_masked(valid_setup, n_hr):
    """JAX pads pr and hr to 1 s buckets and masks its losses to the valid
    length; the port computes them at the exact length."""
    args, models, variables = valid_setup
    jsolver = JSolver.__new__(JSolver)
    jsolver.args, jsolver.models = args, models
    jsolver.valid_loss_fn = jsolver._make_loss_only()
    jstate = init_state(args, models, variables, jax.random.PRNGKey(1))

    pargs = Config._wrap(dict(args))
    pm = pbuild.build_models(pargs, device="cpu")
    pm["msd_melgan"].load_state_dict(melgan_state_dict_from_jax(
        variables["msd_melgan"]["params"], pm["msd_melgan"].n_layers),
        strict=True)
    psolver = Solver.__new__(Solver)
    psolver.train_step = TrainStep(pargs, pm, device="cpu")
    psolver.device = torch.device("cpu")

    hr, pr = _signals(n_hr, (1, 1, n_hr))
    want = {k: float(v) for k, v in
            jsolver._valid_losses(jstate, pr, hr).items()}
    got = {k: float(v) for k, v in psolver.valid_losses(pr, hr).items()}
    assert sorted(got) == sorted(want) and len(want) == 6
    for k in want:
        assert abs(got[k] - want[k]) <= VALID_RTOL * abs(want[k]), (
            k, got[k], want[k])
