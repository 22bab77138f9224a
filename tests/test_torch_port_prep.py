"""The port's data preparation against the JAX package's: the ViSQOL
calibration signal, the egs-json and resampling command lines (the root
``data_prep/`` scripts), and the port's VCTK repro script's dry run."""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from aero_tpu.data import audio_io as jaudio_io
from aero_tpu.data.prep import make_speech_like as jax_speech_like
from aero_tpu_torch.data.prep import make_speech_like
from aero_tpu_torch.data_prep import create_meta_files as pmeta
from aero_tpu_torch.data_prep import resample_data as presample

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REPRO = os.path.join(ROOT, "aero_tpu_torch", "tools", "repro_vctk.sh")


def _root_script(name):
    """``data_prep/<name>.py`` of the repository root, as a module."""
    spec = importlib.util.spec_from_file_location(
        f"root_data_prep_{name}", os.path.join(ROOT, "data_prep",
                                               f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_root(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    _root_script(name).main()


@pytest.mark.parametrize("sr", [16000, 48000])
@pytest.mark.parametrize("seed", [0, 1, 99])
def test_make_speech_like_equals_jax_bit_for_bit(sr, seed):
    got = make_speech_like(sr, 0.5, seed=seed)
    want = jax_speech_like(sr, 0.5, seed=seed)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (int(sr * 0.5),)
    assert got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def vctk_tree(tmp_path_factory):
    """10 speakers x 2 utterances of 0.05 s at 48 kHz, VCTK's layout
    (``p<id>/p<id>_<utt>_mic1.wav``), plus one file the pattern skips."""
    root = tmp_path_factory.mktemp("vctk") / "wav48"
    rng = np.random.default_rng(3)
    for s in range(10):
        d = root / f"p{225 + s}"
        d.mkdir(parents=True)
        for u in range(2):
            n = 2400 + int(rng.integers(0, 480))
            sig = (0.1 * rng.standard_normal(n)).astype(np.float32)
            jaudio_io.save(str(d / f"p{225 + s}_{u:03d}_mic1.wav"),
                           sig[None], 48000)
    jaudio_io.save(str(root / "p225" / "p225_000_mic2.wav"),
                   np.zeros((1, 480), np.float32), 48000)
    return str(root)


def _tree_bytes(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("options", [
    [], ["--no-speaker-split"], ["--n_samples_limit", "3"],
    ["--pattern", "*"]], ids=["split", "no_split", "limit", "pattern"])
def test_create_meta_files_cli_matches_root_script(vctk_tree, tmp_path,
                                                   monkeypatch, options):
    pmeta.main([vctk_tree, str(tmp_path / "port"), "lr", *options])
    _run_root("create_meta_files",
              [vctk_tree, str(tmp_path / "jax"), "lr", *options],
              monkeypatch)
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(got) == sorted(want) == ["tr/lr.json", "val/lr.json"]
    assert got == want
    tr = json.loads(got["tr/lr.json"])
    assert tr and all(p.startswith(vctk_tree) for p, _ in tr)


@pytest.mark.parametrize("target_sr", [16000, 4000])
def test_resample_data_cli_matches_root_script(vctk_tree, tmp_path,
                                               monkeypatch, target_sr):
    presample.main([vctk_tree, str(tmp_path / "port"), str(target_sr)])
    _run_root("resample_data",
              [vctk_tree, str(tmp_path / "jax"), str(target_sr)],
              monkeypatch)
    got, want = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert len(want) == 21 and got.keys() == want.keys()
    for name, data in want.items():
        assert got[name] == data, name


def _commands(script_text):
    """{"TRAIN_CMD": [...], "TEST_CMD": [...]} of a repro script, as
    written in its bash arrays."""
    out = {}
    for name in ("TRAIN_CMD", "TEST_CMD"):
        body = re.search(name + r"=\((.*?)\)\n", script_text, re.S).group(1)
        out[name] = body.split()
    return out


def test_repro_dry_run_passes(tmp_path):
    """One subprocess: synthesis, both resamples and both egs jsons for
    real, the 100/8 split asserted, and the port's train and test commands
    printed with the root script's overrides."""
    env = dict(os.environ, PYTHON=sys.executable)
    res = subprocess.run(["bash", REPRO, "--dry-run", str(tmp_path / "out")],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "split OK: 100 train / 8 test speakers" in res.stdout
    assert "dry-run PASSED" in res.stdout
    egs = tmp_path / "out" / "egs" / "vctk" / "4-16"
    for split in ("tr", "val"):
        for name in ("lr.json", "hr.json"):
            assert (egs / split / name).is_file()

    lines = res.stdout.splitlines()
    printed = lines[lines.index("[repro] dry-run: would execute:") + 1:][:2]
    with open(os.path.join(ROOT, "tools", "repro_vctk.sh")) as f:
        root = _commands(f.read())
    for line, name, module in ((printed[0], "TRAIN_CMD", "train"),
                               (printed[1], "TEST_CMD", "test")):
        argv = line.split()
        assert argv[:3] == [sys.executable, "-m", f"aero_tpu_torch.{module}"]
        want = [a.replace("$EGS", str(egs)).strip('"')
                for a in root[name][2:]]
        assert argv[3:] == want
        assert not any(a.startswith("device=") for a in argv)
