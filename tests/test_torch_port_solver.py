"""The port's Solver slice end to end on the CPU, through the CLIs' entry
points (``main`` of ``python -m aero_tpu_torch.train``, ``.test`` and
``.predict``), with ``experiment=tiny`` on a dummy dataset: train 2 epochs
with cross-validation and evaluation, resume for a third, score the test
set, predict one file from ``checkpoint.atpu``; then the JAX package reads
that checkpoint and its generator forward equals the port's."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aero_tpu.train import build as jbuild
from aero_tpu.train import checkpoint as jckpt
from aero_tpu.utils.config import load_config as jload_config
from aero_tpu_torch import predict as ppredict
from aero_tpu_torch import test as ptest
from aero_tpu_torch.data import audio_io
from aero_tpu_torch.data.prep import make_dummy_dataset
from aero_tpu_torch.train import __main__ as ptrain
from aero_tpu_torch.train import checkpoint as pckpt
from aero_tpu_torch.train.build import build_models, load_generator_state
from aero_tpu_torch.train.solver import Solver
from aero_tpu_torch.utils.config import load_config

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
FWD_TOL = 1e-5  # generator forward, port vs JAX in float32, of max |out|


def test_train_resume_test_predict_tiny_cpu(tmp_path, monkeypatch):
    make_dummy_dataset(str(tmp_path / "egs"), n_files=4, duration=1.2,
                       seed=0)
    monkeypatch.chdir(tmp_path)
    base = ["experiment=tiny", "dset=debug", "device=cpu", "visqol=false",
            "num_workers=0", "eval_bucket_s=0.5", "dset.train=egs/tr",
            "dset.valid=egs/val", "dset.test=egs/val"]
    train = base + ["cross_valid=true", "cross_valid_every=1",
                    "eval_every=2"]
    run_dir = tmp_path / "outputs" / "debug" / "tiny-nfft=512-hl=64"

    epochs_run = []
    run_one_epoch = Solver._run_one_epoch

    def spy(self, epoch):
        epochs_run.append(epoch)
        return run_one_epoch(self, epoch)

    monkeypatch.setattr(Solver, "_run_one_epoch", spy)
    history = ptrain.main(train + ["epochs=2"])
    assert len(history) == 2 and epochs_run == [0, 1]
    assert os.getcwd() == str(tmp_path)
    history = ptrain.main(train + ["epochs=3"])
    assert epochs_run == [0, 1, 2]  # resumed at len(history)
    with open(run_dir / "history.json") as f:
        assert json.load(f) == history
    assert len(history) == 3
    for entry in history:
        numbers = [v for v in entry.values() if isinstance(v, float)]
        assert numbers and all(np.isfinite(numbers))
    for key in ("total_loss", "valid_evaluation_loss", "best_loss",
                "generator_stft_loss", "discriminator_msd_melgan_loss"):
        assert key in history[-1]
    assert history[-1]["Average lsd"] > 0
    assert (run_dir / "best.atpu").exists()
    samples = sorted(os.listdir(run_dir / "samples"))
    for stem in ("p000", "p001", "p002", "p003"):
        for kind in ("lr.wav", "hr.wav", "pr.wav", "lr_spec.png",
                     "pr_spec.png", "hr_spec.png"):
            assert f"{stem}_{kind}" in samples

    # continue_from an .atpu with continue_best resumes its last weights
    # and their Adam moments, as aero_tpu's Solver does
    args = load_config(CONF, "main_config", base + [
        "checkpoint=false", "continue_best=true",
        f"continue_from={run_dir / 'checkpoint.atpu'}"])
    package = pckpt.load_package(str(run_dir / "checkpoint.atpu"))
    last = build_models(args, "cpu", seed=1)
    pckpt.load_model_variables(last, package["models"])
    resumed = Solver({"tr_loader": None, "cv_loader": None,
                      "tt_loader": None}, build_models(args, "cpu", seed=2),
                     args, "cpu")
    for a, b in zip(last["generator"].state_dict().values(),
                    resumed.gen.state_dict().values()):
        assert torch.equal(a, b)
    steps = {float(st["step"])
             for st in resumed.train_step.gen_opt.state.values()}
    assert steps == {float(np.asarray(
        package["optimizers"]["optimizer"]["0"]["count"]))}

    results = ptest.main(base)
    assert results["n_files"] == 4 and np.isfinite(results["lsd"])
    with open(run_dir / "test_results.json") as f:
        assert json.load(f)["lsd"] == results["lsd"]

    n = 5000
    audio_io.save(str(tmp_path / "in.wav"),
                  (0.3 * np.sin(np.arange(n) / 5.0))[None], 4000)
    out = ppredict.main(base + ["+filename=in.wav", "+output=pred"])
    assert out["out_samples"] == 4 * n
    assert audio_io.load(out["path"])[0].shape == (1, 4 * n)

    # the JAX package reads the port's checkpoint
    jargs = jload_config(CONF, "main_config", ["experiment=tiny"])
    models = jbuild.build_models(jargs)
    lr_shape, _ = jbuild.segment_shapes(jargs)
    template = jax.eval_shape(
        lambda k: models["generator"].init(k, jnp.zeros(lr_shape),
                                           train=False),
        jax.random.PRNGKey(0))
    variables = jckpt.load_generator_variables(
        str(run_dir / "checkpoint.atpu"), dict(template))
    x = (0.1 * np.random.default_rng(3).standard_normal((2, 1, 3000))
         ).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: models["generator"].apply(
        v, x, train=False))(variables, jnp.asarray(x)))
    args = load_config(CONF, "main_config", base)
    monkeypatch.chdir(run_dir)
    gen = load_generator_state(args, "cpu")
    with torch.no_grad():
        got = gen(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FWD_TOL * np.abs(want).max()


def test_seanet_train_resume_test_cpu(tmp_path, monkeypatch):
    """seanet_4-16 at narrow width through the same CLIs: one epoch with
    its MelGAN, cross-validation and evaluation (the waveform forward, the
    spectra by ``make_spec_fns``' non-Aero branch), a resume from its
    ``checkpoint.atpu`` for a second epoch that starts from the first's
    last weights and Adam step, then the test CLI."""
    make_dummy_dataset(str(tmp_path / "egs"), n_files=4, duration=1.2,
                       seed=1)
    monkeypatch.chdir(tmp_path)
    base = ["experiment=seanet_4-16", "dset=debug", "device=cpu",
            "visqol=false", "num_workers=0", "eval_bucket_s=0.5",
            "dset.train=egs/tr", "dset.valid=egs/val", "dset.test=egs/val",
            "experiment.seanet.ngf=4", "experiment.seanet.ratios=[2,2]",
            "experiment.seanet.n_residual_layers=1",
            "experiment.seanet.latent_space_size=8",
            "experiment.melgan_discriminator.ndf=4",
            "experiment.melgan_discriminator.n_layers=2",
            "experiment.melgan_discriminator.num_D=2",
            "experiment.segment=1", "experiment.stride=1",
            "experiment.batch_size=2"]
    train = base + ["cross_valid=true", "cross_valid_every=1",
                    "eval_every=1"]
    run_dir = tmp_path / "outputs" / "debug" / "seanet"

    starts = {}
    run_one_epoch = Solver._run_one_epoch

    def spy(self, epoch):
        starts[epoch] = (
            {k: v.clone() for k, v in self.gen.state_dict().items()},
            {float(st["step"])
             for st in self.train_step.gen_opt.state.values()})
        return run_one_epoch(self, epoch)

    monkeypatch.setattr(Solver, "_run_one_epoch", spy)
    history = ptrain.main(train + ["epochs=1"])
    assert len(history) == 1 and list(starts) == [0]
    assert not starts[0][1]  # fresh Adam
    package = pckpt.load_package(str(run_dir / "checkpoint.atpu"))
    saved = pckpt.generator_state_dict(str(run_dir / "checkpoint.atpu"))
    count = float(np.asarray(
        package["optimizers"]["optimizer"]["0"]["count"]))
    assert count > 0

    history = ptrain.main(train + ["epochs=2"])
    assert list(starts) == [0, 1] and len(history) == 2
    weights, steps = starts[1]
    assert sorted(weights) == sorted(saved)
    for k, v in saved.items():
        assert torch.equal(weights[k], v), k
    assert steps == {count}
    for entry in history:
        numbers = [v for v in entry.values() if isinstance(v, float)]
        assert numbers and all(np.isfinite(numbers))
        for key in ("total_loss", "valid_evaluation_loss", "best_loss",
                    "generator_stft_loss", "generator_adversarial_melgan_loss",
                    "discriminator_msd_melgan_loss", "Average lsd"):
            assert key in entry, key
    assert (run_dir / "best.atpu").exists()
    samples = sorted(os.listdir(run_dir / "samples"))
    for kind in ("lr.wav", "hr.wav", "pr.wav", "lr_spec.png",
                 "pr_spec.png", "hr_spec.png"):
        assert f"p000_{kind}" in samples

    results = ptest.main(base)
    assert results["n_files"] == 4 and np.isfinite(results["lsd"])
    with open(run_dir / "test_results.json") as f:
        assert json.load(f)["lsd"] == results["lsd"]
