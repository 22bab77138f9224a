"""The port's checkpoint I/O against aero_tpu's on the CPU.

- ``.atpu``: the port's msgpack decoder against flax on the golden
  fixture; a package the port writes (weights, BatchNorm statistics, the
  MelGAN, both Adam states) restored by the JAX package, every leaf bit for
  bit equal to the JAX importer's map of the port's tensors; the generator
  forward and one Adam update from restored weights and moments, port
  against JAX.
- ``.th``: a reference-style package that pickles a class from a
  test-local module loads without importing it or running its code, and
  resumes the Solver with its weights and Adam state.
- the predict CLI reads ``checkpoint_file`` in the run directory and
  honours ``continue_best``.
"""

import json
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from aero_tpu.train import build as jbuild
from aero_tpu.train import checkpoint as jckpt
from aero_tpu.train import torch_import
from aero_tpu.train.train_step import init_state
from aero_tpu_torch import predict as ppredict
from aero_tpu_torch.data import audio_io
from aero_tpu_torch.models.factory import build_generator
from aero_tpu_torch.train import build as pbuild
from aero_tpu_torch.train import checkpoint as pckpt
from aero_tpu_torch.train.from_jax import (
    export_aero_state, load_reference_checkpoint, load_torch_package,
    melgan_state_dict_from_jax, state_dict_from_jax)
from aero_tpu_torch.train.solver import Solver
from aero_tpu_torch.train.train_step import TrainStep
from aero_tpu_torch.utils.config import Config, load_config

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

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "golden_tiny.atpu")
SUMS = os.path.join(HERE, "fixtures", "golden_tiny_sums.json")
CONF = os.path.join(os.path.dirname(HERE), "conf")
SUM_RTOL = 1e-6   # abs-sums of the golden's trees (float32 leaves)
FWD_TOL = 1e-5    # generator forward, port vs JAX in float32, of max |out|
# Parameters after one Adam update, per leaf: ADAM_TOL of the leaf's max
# |p| plus UPDATE_TOL of its max |update|. optax computes the bias
# correction 1 - 0.999**count in float32 (torch in float64), which at count
# 2 is off by up to 3e-5 of itself: 1.5e-5 of the update, measured here
ADAM_TOL = 1e-6
UPDATE_TOL = 1e-4


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _bits_equal(got, want, where=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, where
    assert got.tobytes() == want.tobytes(), where


def _abs_sum(tree):
    return float(sum(np.abs(np.asarray(x, np.float64)).sum()
                     for _, x in _leaves(tree)
                     if not isinstance(x, (str, bytes, type(None)))))


@pytest.fixture(scope="module")
def golden():
    """The golden fixture's config, its JAX models and initial variables,
    and the initial TrainState (the template the package restores into)."""
    sys.path.insert(0, os.path.join(HERE, "fixtures"))
    try:
        from make_golden import golden_args
    finally:
        sys.path.pop(0)
    args = golden_args()
    models = jbuild.build_models(args)
    lr_shape, hr_shape = jbuild.segment_shapes(args)
    variables = jax.tree.map(np.asarray, jbuild.init_variables(
        args, models, jax.random.PRNGKey(0), lr_shape, hr_shape))
    template = init_state(args, models, variables, jax.random.PRNGKey(1))
    return args, models, variables, lr_shape, hr_shape, template


def test_golden_atpu_decodes_as_flax():
    from flax import serialization

    with open(FIXTURE, "rb") as f:
        blob = f.read()
    got = dict(_leaves(pckpt.unpackb(blob)))
    want = dict(_leaves(serialization.msgpack_restore(blob)))
    assert got.keys() == want.keys() and len(want) > 800
    for path, w in want.items():
        if isinstance(w, np.ndarray):
            _bits_equal(got[path], w, path)
        else:
            assert got[path] == w and type(got[path]) is type(w), path
    # and the encoder writes the same bytes back
    assert pckpt.packb(pckpt.unpackb(blob)) == blob

    with open(SUMS) as f:
        sums = json.load(f)
    package = pckpt.load_package(FIXTURE)
    models, opts = package["models"], package["optimizers"]
    for got_sum, key in (
            (_abs_sum(models["generator"]["params"]), "gen_params_abssum"),
            (_abs_sum(models["msd_melgan"]["params"]), "disc_params_abssum"),
            (_abs_sum(opts["optimizer"]), "gen_opt_abssum"),
            (_abs_sum(opts["disc_optimizer"]), "disc_opt_abssum")):
        assert abs(got_sum - sums[key]) <= SUM_RTOL * sums[key], key
    assert int(package["step"]) == sums["step"]
    assert len(list(_leaves(models["generator"]["params"]))) == \
        sums["n_gen_leaves"]
    assert pckpt.history_from_package(package)[0]["valid"] == 2.345


def test_chunked_leaf_is_refused():
    import msgpack

    blob = msgpack.packb({"a": {"__msgpack_chunked_array__": True,
                                "shape": {"0": 3}, "chunks": {}}})
    with pytest.raises(ValueError, match="chunked array"):
        pckpt.unpackb(blob)


def test_bfloat16_leaf_widens_exactly():
    x = np.array([1.0, -2.5, 3.140625, 65280.0], np.float32)
    bf16 = (x.view(np.uint32) >> 16).astype(np.uint16)
    import msgpack

    payload = msgpack.packb(((4,), "bfloat16", bf16.tobytes()),
                            use_bin_type=True)
    blob = msgpack.packb({"w": msgpack.ExtType(1, payload)})
    np.testing.assert_array_equal(pckpt.unpackb(blob)["w"], x)


def _port_models(args, variables):
    pargs = Config._wrap(dict(args))
    pm = pbuild.build_models(pargs, device="cpu")
    pm["generator"].load_state_dict(
        state_dict_from_jax(variables["generator"]), strict=True)
    pm["msd_melgan"].load_state_dict(melgan_state_dict_from_jax(
        variables["msd_melgan"]["params"], pm["msd_melgan"].n_layers),
        strict=True)
    return pargs, pm


def _batch(lr_shape, hr_shape, seed):
    rng = np.random.default_rng(seed)
    return ((0.1 * rng.standard_normal(lr_shape)).astype(np.float32),
            (0.1 * rng.standard_normal(hr_shape)).astype(np.float32))


def _numpy_adam_sd(opt):
    """A torch Adam state_dict in the numpy form of
    ``torch_import.load_torch_checkpoint``."""
    return {"state": {i: {"step": float(e["step"]),
                          "exp_avg": e["exp_avg"].numpy(),
                          "exp_avg_sq": e["exp_avg_sq"].numpy()}
                      for i, e in opt.state_dict()["state"].items()}}


def test_port_atpu_restores_in_jax_bit_for_bit(golden, tmp_path):
    args, models, variables, lr_shape, hr_shape, template = golden
    pargs, pm = _port_models(args, variables)
    step = TrainStep(pargs, pm, device="cpu")
    for seed in (1, 2):  # two updates: moments and BatchNorm stats move
        step(*_batch(lr_shape, hr_shape, seed))
    best = {n: {k: v.clone() for k, v in m.state_dict().items()}
            for n, m in pm.items()}
    history = [{"total_loss": 1.5, "Average lsd": 2.0}]
    path = str(tmp_path / "checkpoint.atpu")
    pckpt.save_package(path, pckpt.package_from_training(
        pm, step, history, best, {"experiment": {"model": "aero"}}, 2))
    assert not os.path.exists(path + ".tmp")

    package = jckpt.load_package(path)
    state = jckpt.state_from_package(package, template)
    assert int(np.asarray(state.step)) == 2
    assert jckpt.history_from_package(package) == history

    # independent map: the JAX package's own importer of the port's tensors
    gen_sd = {k: v.numpy() for k, v in pm["generator"].state_dict().items()}
    want_gen = torch_import.import_aero_state(gen_sd, variables["generator"])
    n_layers = pm["msd_melgan"].n_layers
    mel_sd = {k: v.numpy() for k, v in pm["msd_melgan"].state_dict().items()}
    want_mel = torch_import.import_melgan_state(
        mel_sd, variables["msd_melgan"]["params"], n_layers)
    mu, nu, count = torch_import.import_aero_adam_moments(
        _numpy_adam_sd(step.gen_opt), list(gen_sd), want_gen["params"])
    dmu, dnu, dcount = torch_import.import_melgan_adam_moments(
        _numpy_adam_sd(step.disc_opt), list(mel_sd),
        want_mel, n_layers)
    adam, dadam = state.gen_opt_state[0], state.disc_opt_state[0]
    assert int(adam.count) == count == 2 and int(dadam.count) == dcount == 2
    pairs = [(state.gen_params, want_gen["params"]),
             (state.gen_state["batch_stats"], want_gen["batch_stats"]),
             (state.disc_params["msd_melgan"], want_mel),
             (adam.mu, mu), (adam.nu, nu),
             (dadam.mu["msd_melgan"], dmu), (dadam.nu["msd_melgan"], dnu)]
    n = 0
    for got_tree, want_tree in pairs:
        got = dict(_leaves(jax.tree.map(np.asarray, got_tree)))
        want = dict(_leaves(want_tree))
        assert got.keys() == want.keys()
        for k in want:
            _bits_equal(got[k], np.asarray(want[k], np.float32), k)
            n += 1
    assert n > 400
    best_gen = jckpt.best_states_from_package(package)["generator"]
    for k, w in _leaves(want_gen):
        _bits_equal(dict(_leaves(best_gen))[k], w, k)

    # and the port reads its own package back exactly
    _, pm2 = _port_models(args, variables)
    step2 = TrainStep(pargs, pm2, device="cpu")
    assert pckpt.restore_training(pckpt.load_package(path), pm2, step2) == 2
    for name in pm:
        for (k, a), b in zip(pm[name].state_dict().items(),
                             pm2[name].state_dict().values()):
            assert torch.equal(a, b), (name, k)
    for opt, opt2 in ((step.gen_opt, step2.gen_opt),
                      (step.disc_opt, step2.disc_opt)):
        for e, e2 in zip(opt.state_dict()["state"].values(),
                         opt2.state_dict()["state"].values()):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(e[key], e2[key]), key
        # a fused Adam (the port's on CUDA) takes only moments laid out
        # as their parameters
        for p, st in opt2.state.items():
            assert st["exp_avg"].stride() == st["exp_avg_sq"].stride() \
                == p.stride()


def test_golden_generator_forward_matches_jax(golden):
    args, models, variables, _, _, template = golden
    state = jckpt.state_from_package(jckpt.load_package(FIXTURE), template)
    pargs, pm = _port_models(args, variables)  # the fresh init, replaced
    pckpt.restore_training(pckpt.load_package(FIXTURE), pm,
                           TrainStep(pargs, pm, device="cpu"))
    x = _batch((2, 1, 4000), (2, 1, 16000), 4)[0]
    want = np.asarray(jax.jit(lambda v, x: models["generator"].apply(
        v, x, train=False))({"params": state.gen_params, **state.gen_state},
                            jnp.asarray(x)))
    with torch.no_grad():
        got = pm["generator"].eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FWD_TOL * np.abs(want).max()


@pytest.mark.parametrize("count_shift", [0, 1])
def test_adam_update_from_restored_moments_matches_optax(golden,
                                                         count_shift):
    """One update from the golden's moments (count 1) with a fixed
    gradient: torch Adam against optax.adam(b1=0.9). With the count shifted
    by one on the torch side, bias correction differs and the check must
    fail: it sees the count."""
    args, models, variables, _, _, template = golden
    state = jckpt.state_from_package(jckpt.load_package(FIXTURE), template)
    pargs, pm = _port_models(args, variables)
    step = TrainStep(pargs, pm, device="cpu")
    pckpt.restore_training(pckpt.load_package(FIXTURE), pm, step)
    gen = pm["generator"]
    for st in step.gen_opt.state.values():
        st["step"] += count_shift

    rng = np.random.default_rng(9)
    grads = jax.tree.map(
        lambda p: (1e-2 * rng.standard_normal(np.shape(p))).astype(
            np.float32), jax.tree.map(np.asarray, state.gen_params))
    opt = optax.adam(learning_rate=float(args.lr), b1=0.9,
                     b2=float(args.beta2), eps=1e-8)
    updates, _ = opt.update(grads, state.gen_opt_state, state.gen_params)
    want = export_aero_state({"params": jax.tree.map(
        np.asarray, optax.apply_updates(state.gen_params, updates))})
    update = export_aero_state({"params": jax.tree.map(np.asarray,
                                                       updates)})

    torch_grads = export_aero_state({"params": grads})
    for name, p in gen.named_parameters():
        p.grad = torch.from_numpy(np.array(torch_grads[name]))
    step.gen_opt.step()
    worst = max(float(np.abs(p.detach().numpy() - want[name]).max())
                / (ADAM_TOL * float(np.abs(want[name]).max())
                   + UPDATE_TOL * float(np.abs(update[name]).max()))
                for name, p in gen.named_parameters())
    if count_shift:
        assert worst > 100
    else:
        assert worst <= 1


# ---------------------------------------------------------------------------
# Reference .th packages

_REF_MODULE = '''
import os

TRIGGERED = []


def side_effect(path):
    with open(path, "w") as f:
        f.write("ran")
    return path


class Trap:
    """Unpickling an instance calls side_effect(marker)."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return side_effect, (self.marker,)


class Aero:
    """Stands for the reference model class that a package pickles."""

    def __setstate__(self, state):
        side_effect(state["marker"])
'''


def _reference_th(tmp_path, models, train_step, history):
    """A reference-style checkpoint.th of the port's models: each model's
    class from a test-local module, a Trap instance in its args, the Adam
    state_dicts, best states and history. The module is gone from
    ``sys.path`` and ``sys.modules`` after saving."""
    mod_dir = tmp_path / "refpkg"
    mod_dir.mkdir()
    (mod_dir / "ref_model_mod.py").write_text(_REF_MODULE)
    marker = str(tmp_path / "marker")
    sys.path.insert(0, str(mod_dir))
    try:
        import ref_model_mod as ref

        cls_obj = ref.Aero()
        cls_obj.marker = marker
        package = {
            "models": {name: {"class": ref.Aero, "args": [ref.Trap(marker)],
                              "kwargs": {"channels": 4}, "object": cls_obj,
                              "state": {k: v.clone() for k, v in
                                        m.state_dict().items()}}
                       for name, m in models.items()},
            "optimizers": {"optimizer": train_step.gen_opt.state_dict(),
                           "disc_optimizer":
                               train_step.disc_opt.state_dict()},
            "history": history,
            "best_states": {"models": {
                name: {"class": ref.Aero, "state": {
                    k: v + 1 if v.is_floating_point() else v
                    for k, v in m.state_dict().items()}}
                for name, m in models.items()}},
            "args": {"lr": 3e-4},
        }
        path = str(tmp_path / "checkpoint.th")
        torch.save(package, path)
    finally:
        sys.path.remove(str(mod_dir))
        sys.modules.pop("ref_model_mod", None)
    assert not os.path.exists(marker)
    return path, marker


@pytest.fixture(scope="module")
def tiny_training():
    args = load_config(CONF, "main_config", ["experiment=tiny",
                                             "device=cpu"])
    models = pbuild.build_models(args, device="cpu", seed=0)
    step = TrainStep(args, models, device="cpu")
    lr_shape, hr_shape = pbuild.segment_shapes(args.experiment)
    for seed in (1, 2):
        step(*_batch(lr_shape, hr_shape, seed))
    return args, models, step


def test_reference_th_loads_without_running_its_code(tmp_path,
                                                     tiny_training):
    _, models, step = tiny_training
    history = [{"train": 1.0}, {"train": 0.5}]
    path, marker = _reference_th(tmp_path, models, step, history)
    # the unrestricted loader would import the module and run the trap
    with pytest.raises(Exception):
        torch.load(path, map_location="cpu", weights_only=True)

    package = load_torch_package(path)
    assert not os.path.exists(marker)
    assert "ref_model_mod" not in sys.modules
    assert package["history"] == history
    assert package["kwargs"]["generator"] == {"channels": 4}
    for name, m in models.items():
        for k, v in m.state_dict().items():
            assert torch.equal(package["models"][name][k], v.float()), k
            assert torch.equal(package["best_states"][name][k], v + 1), k
    state, kwargs = load_reference_checkpoint(path, load_best=True)
    assert kwargs == {"channels": 4}
    assert torch.equal(state["freq_emb.embedding.weight"],
                       models["generator"].freq_emb.embedding.weight + 1)
    assert set(package["optimizers"]) == {"optimizer", "disc_optimizer"}


@pytest.mark.parametrize("continue_best", [False, True])
def test_solver_resumes_from_reference_th(tmp_path, tiny_training,
                                          continue_best):
    """continue_from=<.th>: the networks (or their best states), the
    history, the best states and, for the last state, both Adam states
    with every parameter's moments and step."""
    args, models, step = tiny_training
    history = [{"valid_evaluation_loss": 3.0}]
    path, marker = _reference_th(tmp_path, models, step, history)
    args2 = load_config(CONF, "main_config", [
        "experiment=tiny", "device=cpu", f"continue_from={path}",
        f"continue_best={str(continue_best).lower()}", "checkpoint=false"])
    fresh = pbuild.build_models(args2, device="cpu", seed=5)
    solver = Solver({"tr_loader": None, "cv_loader": None,
                     "tt_loader": None}, fresh, args2, device="cpu")
    assert not os.path.exists(marker)
    assert solver.history == history
    shift = 1 if continue_best else 0
    for name, m in models.items():
        for k, v in m.state_dict().items():
            assert torch.equal(fresh[name].state_dict()[k], v + shift), k
            assert torch.equal(solver.best_states[name][k], v + 1), k
    for opt, opt2 in ((step.gen_opt, solver.train_step.gen_opt),
                      (step.disc_opt, solver.train_step.disc_opt)):
        got = opt2.state_dict()["state"]
        if continue_best:
            assert not got
            continue
        want = opt.state_dict()["state"]
        assert len(got) == len(want) > 10
        for i, e in want.items():
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(got[i][key], e[key]), (i, key)


# ---------------------------------------------------------------------------
# The predict CLI's checkpoint


def test_predict_reads_run_dir_checkpoint_and_continue_best(tmp_path,
                                                            monkeypatch):
    """checkpoint_file resolves in outputs/<dset>/<experiment>/, as the JAX
    CLI's; continue_best reads the package's best state."""
    args = load_config(CONF, "main_config", ["experiment=tiny"])
    exp = args.experiment
    last = build_generator(exp.aero, "float32", "cpu", seed=1)
    best = build_generator(exp.aero, "float32", "cpu", seed=2)
    run_dir = tmp_path / "outputs" / "debug" / "tiny-nfft=512-hl=64"
    run_dir.mkdir(parents=True)
    package = {"models": {"generator": pckpt.aero_variables(
        last.state_dict())}, "best_states": {
        "generator": pckpt.aero_variables(best.state_dict())}}
    pckpt.save_package(str(run_dir / "checkpoint.atpu"), package)
    torch.save({"models": {"generator": {
        "class": None, "kwargs": dict(exp.aero),
        "state": last.state_dict()}}, "best_states": {
        "generator": {"state": best.state_dict()}}},
        str(run_dir / "ref.th"))

    n = 6000
    wav = str(tmp_path / "in.wav")
    x = (0.3 * np.sin(np.arange(n) / 7.0))[None].astype(np.float32)
    audio_io.save(wav, x, 4000)
    x = audio_io.load(wav)[0][None]
    with torch.no_grad():
        want = {g: m(torch.from_numpy(x)).numpy()[0] for g, m in
                (("last", last), ("best", best))}
    monkeypatch.chdir(tmp_path)
    for extra, which in (([], "last"), (["continue_best=true"], "best"),
                         (["checkpoint_file=ref.th"], "last"),
                         (["checkpoint_file=ref.th", "continue_best=true"],
                          "best")):
        out = ppredict.main(["experiment=tiny", "dset=debug",
                             f"+filename={wav}",
                             f"+output={tmp_path / 'out'}", "device=cpu",
                             "eval_bucket_s=0"] + extra)
        assert os.getcwd() == str(tmp_path)
        got = audio_io.load(out["path"])[0]
        ref = want[which] / max(float(np.abs(want[which]).max()), 1.0)
        assert got.shape == ref.shape
        # 16-bit PCM of the file against the float forward
        assert np.abs(got - ref).max() <= 2.0 / 32768, (extra, which)
        other = want["best" if which == "last" else "last"]
        assert np.abs(got - other).max() > 1e-3
