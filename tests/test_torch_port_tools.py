"""The port's quality tools against the JAX package's ``tools/``: the
attention band probe's capture and report, the training tools' command
lines and summaries, and the ViSQOL matrix's scorer calls."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from aero_tpu.data.prep import make_speech_like as jax_speech_like
from aero_tpu.ops.resample import resample_np as jax_resample
from aero_tpu.train import build as jbuild
from aero_tpu_torch.data.prep import make_speech_like
from aero_tpu_torch.data.resample import resample_np
from aero_tpu_torch.eval import metrics as pmetrics
from aero_tpu_torch.models.factory import build_generator
from aero_tpu_torch.tools import ab_precision, attn_band_probe
from aero_tpu_torch.tools import train_variants, visqol_divergence_matrix
from aero_tpu_torch.train.checkpoint import generator_state_dict

pytestmark = pytest.mark.torch_port

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "fixtures", "golden_tiny.atpu")
CAPTURE_TOL = 1e-5  # float32 forward, port vs JAX, relative L2 per tensor
ROW_TOL = 1e-6      # band_report rows on the same arrays, relative
WIDTHS = [8, 32, 128]


def _jax_tool(name, monkeypatch):
    """``tools/<name>.py`` as a module, imported on the CPU with the tests'
    XLA cache; its changes to the environment and ``sys.path`` are undone
    after the test."""
    monkeypatch.setenv("AERO_PLATFORM", "cpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       jax.config.jax_compilation_cache_dir or "")
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(np.asarray(want, np.float64)), 1e-30))


@pytest.fixture(scope="module")
def golden_sites():
    """The golden checkpoint's generator on one 1 s probe input: the port's
    recorded LocalState inputs in call order ([(name, (q, k, v, w))], the
    tensors) and the JAX package's sown ``attn_inputs`` in sow order, as
    float32 numpy."""
    sys.path.insert(0, os.path.join(HERE, "fixtures"))
    try:
        from make_golden import golden_args
    finally:
        sys.path.pop(0)
    args = golden_args()
    args["checkpoint_file"] = FIXTURE
    x = attn_band_probe.probe_input(int(args.experiment.lr_sr), 1.0)

    models = jbuild.build_models(args)
    state = jbuild.load_generator_state(args, models)
    variables = {"params": state.gen_params, **state.gen_state}
    _, inter = jax.jit(lambda v, y: models["generator"].apply(
        v, y, train=False, mutable=["intermediates"]))(variables,
                                                       jnp.asarray(x))
    want = []

    def walk(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        else:
            want.extend(tuple(np.asarray(a, np.float32) for a in item)
                        for item in tree)

    walk(dict(inter)["intermediates"])

    gen = build_generator(dict(args.experiment.aero), "float32", "cpu")
    gen.load_state_dict(generator_state_dict(FIXTURE), strict=True)
    _, sites = attn_band_probe.capture(gen, x)
    return sites, want


def test_probe_captures_the_sown_attention_inputs(golden_sites):
    sites, want = golden_sites
    got = [attn_band_probe.numpy_site(s) for _, s in sites]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == b.shape
            assert _rel_l2(a, b) <= CAPTURE_TOL


def test_band_report_rows_equal_jax(golden_sites, monkeypatch, capsys):
    jprobe = _jax_tool("attn_band_probe", monkeypatch)
    _, want_sites = golden_sites
    for site in want_sites:
        got = attn_band_probe.band_report(*site, WIDTHS, "port")
        want = jprobe.band_report(*site, WIDTHS, "jax")
        assert len(got) == len(want) == len(WIDTHS)
        for g, w in zip(got, want):
            assert g[0] == w[0]
            np.testing.assert_allclose(g[1:], w[1:], rtol=ROW_TOL, atol=0)
    out = capsys.readouterr().out
    assert out.count("tail_max   tail_p999") == 2 * len(want_sites)


def test_probe_report_prints_the_worst_rows(golden_sites, capsys):
    sites, _ = golden_sites
    per_site, worst = attn_band_probe.report(sites, WIDTHS)
    assert sorted(worst) == WIDTHS and len(per_site) == 2
    for W in WIDTHS:
        assert worst[W][1] == max(rows[WIDTHS.index(W)][3]
                                  for rows in per_site.values())
    assert "== overall worst over all attention sites ==" in \
        capsys.readouterr().out


def _fake_runs(calls):
    """A ``subprocess.run`` that records each command and writes a
    synthetic history of ``epochs=`` entries where the train CLI would."""
    def run(cmd, cwd=None, **_kwargs):
        calls.append(list(cmd))
        epochs = int(next(a for a in cmd if a.startswith("epochs="))[7:])
        seed = len(calls) % 2
        history = [{"train": 1.0 / (ep + 1), "evaluation_loss": 0.1 * ep
                    + seed, "Average lsd": 1.5 - 0.01 * ep + seed,
                    "Average visqol": 2.0 + 0.1 * ep}
                   for ep in range(epochs)]
        run_dir = os.path.join(cwd, "outputs", "debug", "run")
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "history.json"), "w") as f:
            json.dump(history, f)
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")
    return run


def _summary(text, marker):
    return text[text.index(marker):]


@pytest.mark.parametrize("tool,argv,marker", [
    ("train_variants", ["which=8-24,11-44", "epochs=6"],
     "=== trajectories"),
    ("ab_precision", ["epochs=3", "n_files=2"], "=== A/B summary"),
], ids=["train_variants", "ab_precision"])
def test_tool_argv_and_summary_equal_jax(tool, argv, marker, tmp_path,
                                           monkeypatch, capsys):
    """The same overrides, in the same order, save the entry point (the
    root train.py there, ``-m aero_tpu_torch.train`` here); the same
    printed summary."""
    jtool = _jax_tool(tool, monkeypatch)
    port = {"train_variants": train_variants,
            "ab_precision": ab_precision}[tool]
    argv = argv + [f"out={tmp_path}"]
    jax_calls, port_calls = [], []
    monkeypatch.setattr(subprocess, "run", _fake_runs(jax_calls))
    monkeypatch.setattr(sys, "argv", [f"{tool}.py", *argv])
    assert jtool.main() == 0
    jax_out = capsys.readouterr().out
    monkeypatch.setattr(subprocess, "run", _fake_runs(port_calls))
    assert port.main(argv) == 0
    port_out = capsys.readouterr().out

    assert len(port_calls) == len(jax_calls) == 2
    for got, want in zip(port_calls, jax_calls):
        assert got[:3] == [sys.executable, "-m", "aero_tpu_torch.train"]
        assert want[1] == os.path.join(ROOT, "train.py")
        assert got[3:] == want[2:]
    assert _summary(port_out, marker) == _summary(jax_out, marker)


def test_visqol_matrix_scores_equal_jax(monkeypatch):
    """The mildest low-pass and a 0.05 s shift of the calibration signal,
    scored through both packages' matrix code."""
    scorer = pmetrics.default_visqol_path()
    if scorer is None or pmetrics.probe_scorer_version(scorer) == "unknown":
        pytest.skip("the repository's ViSQOL scorer does not run here")
    jmatrix = _jax_tool("visqol_divergence_matrix", monkeypatch)
    sr = 16000
    sig = make_speech_like(sr, 3.0, seed=0)[None]
    jsig = jax_speech_like(sr, 3.0, seed=0)[None]
    assert sig.tobytes() == jsig.tobytes()
    low = resample_np(resample_np(sig, sr, 8000), 8000, sr)[:, :sig.shape[-1]]
    jlow = jax_resample(jax_resample(jsig, sr, 8000), 8000,
                        sr)[:, :sig.shape[-1]]
    shifted = np.concatenate([np.zeros((1, int(0.05 * sr)), np.float32), sig],
                             axis=-1)
    for deg, jdeg in ((low, jlow), (shifted, shifted)):
        got = visqol_divergence_matrix.run_visqol(sig, deg)
        want = jmatrix.run_visqol(jsig, jdeg)
        assert 1.0 < got <= 5.0
        assert got == want
