"""The port's train CLI as a data-parallel job on the CPU (gloo), and split
predict over a device list.

``python -m aero_tpu_torch.train ddp=true +ddp_workers=N device=cpu`` at
``experiment=tiny`` on a port-made dummy dataset, one epoch: at 2 workers
the epoch's train loss is the one-process run's, rank 0 alone writes the
run's files and rank 1 logs to ``trainer.log.1``; at 3 workers over 2
test files (rank 2's shard is empty) the LSD the run records is the test
CLI's over both files with the run's checkpoint. Killing a worker ends
the job. ``ChunkedInference`` split over ``["cpu", "cpu"]`` equals the one
device's output.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from aero_tpu_torch import test as ptest
from aero_tpu_torch.data.prep import make_dummy_dataset
from aero_tpu_torch.eval.forward import ChunkedInference, EvalForward
from aero_tpu_torch.parallel import mesh
from aero_tpu_torch.train import __main__ as ptrain
from aero_tpu_torch.train.__main__ import PACKAGE_ROOT
from aero_tpu_torch.train.build import build_models
from aero_tpu_torch.utils.config import load_config

pytestmark = pytest.mark.torch_port

CONF = os.path.join(PACKAGE_ROOT, "conf")
RUN = os.path.join("outputs", "debug", "tiny-nfft=512-hl=64")
LOSS_RTOL = 1e-5    # the epoch's train loss, float32
# the valid loss scores the weights after the epoch's updates: Adam's first
# steps move a weight by about lr x sign(g), so a gradient entry at the
# rounding level moves it by up to 2 lr between two runs (4.8e-5 measured;
# the LSD of those weights moves 9.9e-4, too close to hold, and the
# 3-worker test holds the LSD's averaging on one checkpoint instead)
TRAINED_RTOL = 1e-3
LSD_RTOL = 1e-6     # one checkpoint scored by two routes
WORKER_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (its workers get one
    too): the suite runs in several worker processes on few cores, and
    torch's thread pools in each would contend for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def egs(tmp_path_factory):
    """2 files of 2-2.25 s, listed as train, valid and test files (the
    valid list under another directory, so that the evaluation forwards
    the test files rather than scoring the saved samples): 8 segments of
    0.5 s, two global batches of 4."""
    root = tmp_path_factory.mktemp("ddp_cli")
    make_dummy_dataset(str(root / "egs"), n_files=2, duration=2.0, seed=0)
    shutil.copytree(root / "egs" / "val", root / "egs" / "cv")
    return root


def _overrides(egs, *extra):
    return ["experiment=tiny", "dset=debug", "device=cpu", "visqol=false",
            "num_workers=0", "eval_bucket_s=0.5", "epochs=1",
            "cross_valid=true", "cross_valid_every=1", "eval_every=1",
            "seed=1234", f"dset.train={egs}/egs/tr",
            f"dset.valid={egs}/egs/cv", f"dset.test={egs}/egs/val",
            *extra]


def _launch(cwd, overrides, **kwargs):
    env = dict(os.environ, PYTHONPATH=PACKAGE_ROOT, OMP_NUM_THREADS="1")
    os.makedirs(cwd, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-m", "aero_tpu_torch.train", *overrides],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, **kwargs)


def _history(run_dir):
    with open(os.path.join(run_dir, "history.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jobs(egs):
    """The 2- and 3-worker jobs (started together) and the one-process
    run, in this process meanwhile."""
    procs = {n: _launch(str(egs / f"workers{n}"), _overrides(
        egs, "ddp=true", f"+ddp_workers={n}", f"experiment.batch_size={n * 2}"
        if n == 3 else "experiment.batch_size=4")) for n in (2, 3)}
    cwd = os.getcwd()
    os.chdir(egs)
    try:
        single = ptrain.main(_overrides(egs, "experiment.batch_size=4"))
    finally:
        os.chdir(cwd)
    outs = {}
    for n, proc in procs.items():
        out, _ = proc.communicate(timeout=WORKER_TIMEOUT_S)
        assert proc.returncode == 0, out[-4000:]
        outs[n] = (out, str(egs / f"workers{n}" / RUN))
    return single, outs


def test_two_workers_train_as_one_process(jobs):
    single, outs = jobs
    out, run_dir = outs[2]
    hist = _history(run_dir)
    assert len(hist) == len(single) == 1
    got, want = hist[0]["total_loss"], single[0]["total_loss"]
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)
    k = "valid_evaluation_loss"
    assert abs(hist[0][k] - single[0][k]) <= TRAINED_RTOL * abs(single[0][k])
    assert hist[0]["Average lsd"] > 0
    files = sorted(os.listdir(run_dir))
    assert [f for f in files if f.endswith(".atpu")] == [
        "best.atpu", "checkpoint.atpu"]
    assert "trainer.log" in files and "trainer.log.1" in files
    with open(os.path.join(run_dir, "trainer.log.1")) as f:
        log1 = f.read()
    assert "rank 1/2" in log1
    assert "All workers completed successfully" in out


def test_empty_shard_joins_the_averages(jobs, egs):
    """3 workers, 2 test files: rank 2 scores none. The LSD of the run's
    last epoch is the test CLI's over both files in one process with the
    run's checkpoint, and the job ran 3 ranks."""
    _, outs = jobs
    _, run_dir = outs[3]
    hist = _history(run_dir)
    with open(os.path.join(run_dir, "trainer.log.2")) as f:
        assert "rank 2/3" in f.read()
    cwd = os.getcwd()
    os.chdir(egs / "workers3")
    try:
        results = ptest.main(_overrides(egs))
    finally:
        os.chdir(cwd)
    assert results["n_files"] == 2
    want, got = results["lsd"], hist[0]["Average lsd"]
    assert want > 0 and abs(got - want) <= LSD_RTOL * want, (got, want)
    assert np.isfinite(hist[0]["valid_evaluation_loss"])


def test_rank_above_0_writes_no_run_files(egs, monkeypatch, tmp_path):
    """A rank other than 0 trains and scores (writing the samples of its
    own test files) but leaves the history and the checkpoints to rank
    0."""
    monkeypatch.setattr(mesh, "rank", lambda: 1)
    monkeypatch.chdir(tmp_path)
    hist = ptrain.main(_overrides(egs, "experiment.batch_size=4"))
    assert len(hist) == 1 and np.isfinite(hist[0]["total_loss"])
    assert sorted(p.name for p in (tmp_path / RUN).iterdir()) == [
        "samples", "trainer.log"]


def _children(pid):
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        return [int(c) for c in f.read().split()]


def test_a_dead_worker_ends_the_job(egs):
    proc = _launch(str(egs / "killed"), _overrides(
        egs, "ddp=true", "+ddp_workers=2", "experiment.batch_size=4",
        "epochs=1000"))
    try:
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        log1 = egs / "killed" / RUN / "trainer.log.1"
        while not (log1.exists() and "Training..." in log1.read_text()):
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        workers = _children(proc.pid)
        assert len(workers) == 2
        os.kill(workers[1], signal.SIGKILL)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode != 0
        assert "Worker died" in out
        for pid in workers:
            assert not os.path.exists(f"/proc/{pid}") or open(
                f"/proc/{pid}/stat").read().split()[2] == "Z"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def generator():
    args = load_config(CONF, "main_config", ["experiment=tiny"])
    return build_models(args, "cpu", seed=0)["generator"]


@pytest.mark.parametrize("batch_chunks", [True, False])
@pytest.mark.parametrize("pad_tail", [True, False])
def test_chunked_inference_split_over_devices(generator, batch_chunks,
                                              pad_tail):
    """7 s at 4 kHz in chunks of 2 s (3 full, padded to 4 over the two
    devices, and a 1 s tail) split over ``["cpu", "cpu"]``, one replica a
    device, equals one device."""
    x = (0.1 * np.random.default_rng(0).standard_normal((1, 1, 28000))
         ).astype(np.float32)

    def forward(device):
        return EvalForward(generator, scale=4, lr_sr=4000, device=device,
                           bucket_s=0.5)

    kw = dict(segment_s=2.0, batch_chunks=batch_chunks, pad_tail=pad_tail,
              scale=4)
    with torch.no_grad():
        want = ChunkedInference(forward("cpu"), 4000, **kw)(x)
        got = ChunkedInference(forward("cpu"), 4000, replicas=[
            forward(d) for d in ("cpu", "cpu")], **kw)(x)
    assert got.shape == want.shape == (1, 1, 4 * 28000)
    assert (np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want))
