"""The port's data-parallel step on the CPU: 2 gloo ranks, each with half
of the global batch, against one process on the whole batch, and against JAX's
``make_train_step`` on the same global batch (rank 0's rows first, as
``make_array_from_process_local_data`` assembles it).

``test_torch_port_train_step``'s tiny config, weights and batches (1 s
segments, microbatches of 4 rows, the MelGAN and the STFT loss) at
``accum_steps`` 1 and 2, two steps; then HiFi (the tiny config of
``conf/`` against ``[hifi]`` with narrow MPD and MSD, from the seeded
init); then the collectives alone at 3 ranks.

In float32 the split alone reorders sums, and this config's generator
gradient amplifies rounding: one process on the same 4 rows in another
order already moves it by 5.4e-6 (1 s) to 5.4e-3 (0.25 s) relative L2.
So the ranks are held against one process in float64 (the port run with
its float32 casts lifted, as ``test_torch_port_train_step`` does), to
``RTOL`` relative, and in float32 against JAX at that test's tolerances.

The ranks are spawned processes (``aero_tpu_torch.entry.spawn``) that
import this module for their worker functions, so this module imports
JAX and the JAX package only inside the functions that run JAX; each rank
reports that it never imported JAX.
"""

import contextlib
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from aero_tpu_torch import entry
from aero_tpu_torch.parallel import mesh
from aero_tpu_torch.train.build import build_models
from aero_tpu_torch.train.train_step import TrainStep
from aero_tpu_torch.utils.config import Config, to_plain

pytestmark = pytest.mark.torch_port

RANKS = 2
# steps of each run: float64 holds the step, float32 the ranks' weights
# bit for bit after two
STEPS = {"f64": 1, "f32": 2}
ACCUMS = [1, 2]
# floats in the tensor a rank returns: large enough that a result read
# after its rank exits shows
TENSOR_BACK = 1 << 20
RTOL = 1e-5  # float64, ranks against one process, of each quantity's max
# HiFi's networks at test_torch_port_hifi's narrow widths
MPD = dict(hidden=4, periods=[2, 3])
MSD = dict(hidden=16, num_D=2)
MEL = dict(n_fft=512, hop_length=128, win_length=512, n_mels=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (its ranks get one too):
    the suite runs in several worker processes on few cores, and torch's
    thread pools in each would contend for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def _float64():
    """The port in float64: ``Tensor.float`` keeps float64, the Hann window
    and the train step's inputs are float64 (models: ``_double``)."""
    to_f32, hann, tensor = torch.Tensor.float, torch.hann_window, \
        TrainStep._tensor
    torch.Tensor.float = lambda x, *a, **k: (
        x if x.dtype == torch.float64 else to_f32(x, *a, **k))
    torch.hann_window = lambda *a, **k: hann(
        *a, **{**k, "dtype": torch.float64})
    TrainStep._tensor = lambda self, x: torch.as_tensor(
        np.asarray(x), dtype=torch.float64).to(self.device)
    try:
        yield
    finally:
        torch.Tensor.float, torch.hann_window = to_f32, hann
        TrainStep._tensor = tensor


def _double(models):
    for model in models.values():
        model.double()
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64


def _hifi_args():
    """The tiny config with 1 s segments against ``[hifi]`` (narrow MPD
    and MSD), global batch 4."""
    args = entry.dryrun_args(batch=4, segment=1.0)
    exp = args.experiment
    exp.discriminator_models = ["hifi"]
    exp.mpd, exp.msd = Config._wrap(dict(MPD)), Config._wrap(dict(MSD))
    exp.mel_spectrogram = Config._wrap(dict(MEL))
    exp.mel_spec_loss_lambda = 45
    return args


def _run(args, init, lr, hr, f64, steps):
    """``entry.run_steps`` of the config ``args`` (a plain dict) on the rows
    ``lr``, ``hr``, from the networks' states ``init`` (numpy, strict; None:
    the seeded init), in float64 or float32."""
    args = Config._wrap(args)
    with _float64() if f64 else contextlib.nullcontext():
        models = build_models(args, "cpu", seed=0)
        for name, sd in (init or {}).items():
            models[name].load_state_dict(
                {k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        if f64:
            _double(models)
        return entry.run_steps(args, models, lr, hr, steps)


def _rank(args, init, lr, hr, dtypes):
    """A rank's worker: its rows of the global batch (``lr``, ``hr``) in
    each of ``dtypes`` (``STEPS`` steps each)."""
    out = {d: _run(args, init, entry.rank_rows(lr), entry.rank_rows(hr),
                   d == "f64", STEPS[d]) for d in dtypes}
    out["jax_imported"] = "jax" in sys.modules
    return out


def _collectives(values, count, code):
    """A rank's worker for the collectives alone: ``global_weighted_average``
    of its (values, count), and ``regroup_for_accum`` at k = 2 of 2 rows
    ``code`` and ``code + 1`` (each row holds its global index)."""
    rows = torch.arange(code, code + 2, dtype=torch.float32)
    lr = rows[:, None, None].expand(2, 1, 3).contiguous()
    hr = rows[:, None, None].expand(2, 1, 5).contiguous()
    lr_k, hr_k = mesh.regroup_for_accum(lr, hr, 2)
    mesh.barrier()
    return (mesh.global_weighted_average(values, count),
            lr_k[:, 0, 0].tolist(), hr_k[:, 0, -1].tolist(),
            "jax" in sys.modules)


def _tensor_back(n):
    """A rank's worker that returns a tensor of ``n`` floats (its rank
    plus 0 .. n - 1) and exits at once."""
    return torch.arange(n, dtype=torch.float32) + mesh.rank()


# --------------------------------------------------------------------------
# The runs


def _melgan_cases():
    """Per accum: (config, JAX variables, the port's initial states, lr,
    hr): ``test_torch_port_train_step``'s tiny config, JAX-initialised
    weights and batches (microbatches of 4 rows), where that test's
    tolerances were set."""
    import jax

    from aero_tpu.train import build as jbuild
    from aero_tpu_torch.train.from_jax import (
        melgan_state_dict_from_jax, state_dict_from_jax)
    from test_torch_port_train_step import _args, _batch

    args = _args(1)
    models = jbuild.build_models(args)
    lr_shape, hr_shape = jbuild.segment_shapes(args)
    variables = jax.tree.map(np.asarray, jbuild.init_variables(
        args, models, jax.random.PRNGKey(0), lr_shape, hr_shape))
    init = {"generator": state_dict_from_jax(variables["generator"]),
            "msd_melgan": melgan_state_dict_from_jax(
                variables["msd_melgan"]["params"],
                models["msd_melgan"].n_layers)}
    init = {n: {k: v.numpy() for k, v in sd.items()}
            for n, sd in init.items()}
    return {accum: (to_plain(_args(accum)), variables, init, *_batch(accum))
            for accum in ACCUMS}


def _jax_step(args, variables, lr, hr):
    """JAX's ``make_train_step`` on the global batch: its metrics, its
    gradients (from Adam's first moment, 0.1 x the gradient after one
    update from zero) and the new state, under the port's
    "<network>.<key>" names."""
    import jax
    import jax.numpy as jnp

    from aero_tpu.train import build as jbuild
    from aero_tpu.train.train_step import init_state, make_train_step
    from aero_tpu_torch.train.from_jax import (
        export_aero_state, export_melgan_state)

    from aero_tpu.utils.config import Config as JaxConfig

    args = JaxConfig._wrap(args)
    models = jbuild.build_models(args)
    state = init_state(args, models, variables, jax.random.PRNGKey(1))
    new, metrics = make_train_step(args, models, mesh=None, donate=False)(
        state, jnp.asarray(lr), jnp.asarray(hr))
    new = jax.tree.map(np.asarray, new)
    n_layers = models["msd_melgan"].n_layers

    def named(net, sd):
        return {f"{net}.{k}": np.asarray(v, np.float64) for k, v in sd.items()}

    mu, dmu = new.gen_opt_state[0].mu, new.disc_opt_state[0].mu
    grads = {**named("generator", export_aero_state({"params": mu})),
             **named("msd_melgan",
                     export_melgan_state(dmu["msd_melgan"], n_layers))}
    state = {**named("generator", export_aero_state(
        {"params": new.gen_params, "batch_stats": new.gen_state[
            "batch_stats"]})),
        **named("msd_melgan", export_melgan_state(
            new.disc_params["msd_melgan"], n_layers))}
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: v / 0.1 for k, v in grads.items()},
            "state": state}


def _one_process(runs):
    """The one-process float64 steps of ``runs``, {name: (config, initial
    states, lr, hr)}, in a process of its own."""
    return {name: _run(args, init, lr, hr, True, 1)
            for name, (args, init, lr, hr) in runs.items()}


@pytest.fixture(scope="module")
def runs():
    """The ranks' runs, the one-process float64 steps (on the whole batch,
    and on rank 0's rows alone) and ``dryrun_multichip(2)``, each spawned
    while this process runs JAX."""
    hifi = to_plain(_hifi_args())
    hifi_batch = entry.global_batch(Config._wrap(hifi), seed=3)
    with ThreadPoolExecutor(max_workers=2) as pool:
        spawned = {"hifi": pool.submit(
            entry.spawn, _rank, [(hifi, None, *hifi_batch, ("f64",))] * RANKS),
            "collectives": pool.submit(
                entry.spawn, _collectives,
                [([1.0, 2.0], 3, 0), ([4.0, 5.0], 0, 2), ([0.5, 1.5], 1, 4)]),
            "dryrun": pool.submit(entry.dryrun_multichip, 2),
            "tensors": pool.submit(entry.spawn, _tensor_back,
                                   [(TENSOR_BACK,)] * RANKS)}
        cases = _melgan_cases()
        one = {"hifi": (hifi, None, *hifi_batch)}
        for accum, (args, _, init, lr, hr) in cases.items():
            half = lr.shape[0] // RANKS
            one[accum] = (args, init, lr, hr)
            one[f"alone{accum}"] = (args, init, lr[:half], hr[:half])
        spawned["one"] = pool.submit(entry.spawn, _one_process, [(one,)])
        spawned.update({accum: pool.submit(
            entry.spawn, _rank, [(args, init, lr, hr, ("f64", "f32"))] * RANKS)
            for accum, (args, _, init, lr, hr) in cases.items()})
        out = {"jax": {accum: _jax_step(args, variables, lr, hr)
                       for accum, (args, variables, _, lr, hr)
                       in cases.items()}}
        out["ranks"] = {k: f.result() for k, f in spawned.items()}
    out["dryrun"] = out["ranks"].pop("dryrun")
    out["tensors"] = out["ranks"].pop("tensors")
    one = out["ranks"].pop("one")[0]
    out["one"] = {k: one[k] for k in ACCUMS + ["hifi"]}
    out["alone"] = {accum: one[f"alone{accum}"] for accum in ACCUMS}
    out["cases"] = cases
    return out


# --------------------------------------------------------------------------
# Gaps


def _nought(args):
    """Generator leaves zero in exact arithmetic (``_nought_leaves``) of
    the config ``args``."""
    from test_torch_port_train_step import _nought_leaves

    return {f"generator.{k}" for k in _nought_leaves(
        build_models(Config._wrap(to_plain(args)), "cpu")["generator"])}


def _gaps(got, want, nought=frozenset()):
    """{quantity: gap}, each of its own max: the metrics of every step,
    each gradient leaf (a nought leaf of its network's max) and each state
    entry after the first step."""
    gaps = {}
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert list(g) == list(w)
        for k in w:
            gaps[f"step {i + 1} {k}"] = abs(g[k] - w[k]) / abs(w[k])
    net_max = {}
    for k, w in want["grads"].items():
        net = k.split(".")[0]
        net_max[net] = max(net_max.get(net, 0.0), float(np.abs(w).max()))
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        scale = float(np.abs(w).max())
        if k in nought or scale == 0:
            scale = net_max[k.split(".")[0]]
        gaps[f"grad {k}"] = float(np.abs(got["grads"][k] - w).max()) / scale
    assert sorted(got["state"]) == sorted(want["state"])
    for k, w in want["state"].items():
        gaps[f"state {k}"] = float(np.abs(got["state"][k] - w).max()) / max(
            float(np.abs(w).max()), 1e-30)
    return gaps


@pytest.mark.parametrize("accum", ACCUMS)
def test_ranks_equal_one_process_float64(runs, accum):
    """Each rank's metrics, gradients, BatchNorm running statistics and
    updated weights equal one process's on the 4 global rows."""
    want = runs["one"][accum]
    nought = _nought(runs["cases"][accum][0])
    for rank, res in enumerate(runs["ranks"][accum]):
        gaps = _gaps(res["f64"], want, nought)
        worst = max(gaps, key=gaps.get)
        print(f"accum {accum} rank {rank}: worst gap {gaps[worst]:.2e} "
              f"({worst}) of {len(gaps)}")
        assert gaps[worst] <= RTOL, (worst, gaps[worst])
        assert any(k.startswith("state generator.") and "running_var" in k
                   for k in gaps)


@pytest.mark.parametrize("accum", ACCUMS)
def test_ranks_hold_the_same_weights(runs, accum):
    """The weights, BatchNorm statistics and u are bit for bit the same on
    every rank after each step, in both dtypes (float32: two steps)."""
    ranks = runs["ranks"][accum]
    for dtype, steps in STEPS.items():
        sums = [res[dtype]["checksums"] for res in ranks]
        assert len(sums[0]) == steps
        assert all(s == sums[0] for s in sums[1:]), dtype
    assert ranks[0]["f32"]["checksums"][0] != ranks[0]["f32"]["checksums"][1]


@pytest.mark.parametrize("accum", ACCUMS)
def test_per_rank_statistics_would_fail(runs, accum):
    """The control: one process on rank 0's 2 rows alone (its own
    BatchNorm statistics and spectral convergence, as a rank without the
    reductions would have) misses the global step by far more than RTOL,
    in the metrics, the gradient of each network and the BatchNorm
    statistics, so the test above sees a missing reduction."""
    want = runs["one"][accum]
    alone = runs["alone"][accum]
    want1 = dict(want, metrics=want["metrics"][:1])
    gaps = _gaps(alone, want1, _nought(runs["cases"][accum][0]))

    def worst(prefix):
        return max(v for k, v in gaps.items() if k.startswith(prefix))

    parts = {"metrics": worst("step 1"), "generator": worst("grad generator"),
             "discriminator": worst("grad msd_melgan"),
             "batchnorm": max(v for k, v in gaps.items()
                              if k.startswith("state") and "running" in k)}
    print(f"accum {accum}, rank 0's rows alone against the global step, "
          f"worst gap of each: {parts}")
    assert all(v > 10 * RTOL for v in parts.values()), parts


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("net", ["generator", "msd_melgan"])
def test_ranks_equal_jax_float32(runs, accum, net):
    """In float32 each rank's metrics, gradients, BatchNorm running
    statistics and updated weights equal JAX's step on the global batch,
    at ``test_torch_port_train_step``'s tolerances: each network's whole
    gradient to GRAD_TOL in relative L2, every leaf to GEN_LEAF_TOL of its
    max (a nought leaf to GRAD_TOL of the network's). The discriminator's
    leaves too: its hinge loss has a kink, so the rounding that the split
    adds to the prediction moves a leaf's float32 gradient in steps (1.6e-3
    of its max on the MelGAN's last conv of scale 0 at accum 1, against
    the float64 gradient, where one process is at 9.5e-5), and the float64
    test above holds the ranks to the one-process step exactly."""
    from test_torch_port_train_step import (
        BN_ATOL, GEN_LEAF_TOL, GRAD_TOL, METRIC_RTOL, WEIGHT_ATOL)

    jx = runs["jax"][accum]
    nought = _nought(runs["cases"][accum][0])
    want = {k: w for k, w in jx["grads"].items() if k.startswith(net + ".")}
    net_max = max(float(np.abs(w).max()) for w in want.values())
    for res in runs["ranks"][accum]:
        got = res["f32"]
        for k, w in jx["metrics"].items():
            assert abs(got["metrics"][0][k] - w) <= METRIC_RTOL * abs(w), k
        bands = {k: GRAD_TOL * net_max if k in nought else
                 GEN_LEAF_TOL * float(np.abs(w).max())
                 for k, w in want.items()}
        for k, w in want.items():
            assert np.abs(got["grads"][k] - w).max() <= bands[k], k
        flat_w = np.concatenate([w.ravel() for w in want.values()])
        flat_g = np.concatenate([got["grads"][k].ravel() for k in want])
        assert (np.linalg.norm(flat_g - flat_w)
                <= GRAD_TOL * np.linalg.norm(flat_w))
        moved = 0
        for k, w in jx["state"].items():
            if not k.startswith(net + "."):
                continue
            g = got["state"][k]
            if "running" in k:
                np.testing.assert_allclose(g, w, atol=BN_ATOL, err_msg=k)
                continue
            # Adam's first step is about lr * sign(g): compare where the
            # sign of the gradient is settled
            mask = np.abs(want[k]) > max(1e-6, 2 * bands[k])
            np.testing.assert_allclose(g[mask], w[mask], atol=WEIGHT_ATOL,
                                       err_msg=k)
            moved += int(mask.sum())
        assert moved > 0


def test_hifi_ranks_equal_one_process(runs):
    """``discriminator_models=[hifi]`` at 2 ranks: the metrics (the mel L1
    inside ``generator_adversarial_hifi``), both gradients, the BatchNorm
    statistics, the weights and the stored u of the MSD's spectral-normed
    convs equal one process's, in float64; u is the same bit for bit on
    every rank."""
    want = runs["one"]["hifi"]
    ranks = runs["ranks"]["hifi"]
    assert "generator_adversarial_hifi" in want["metrics"][0]
    u_keys = [k for k in want["state"] if k.endswith("weight_u")]
    assert u_keys
    for res in ranks:
        gaps = _gaps(res["f64"], want, _nought(_hifi_args()))
        worst = max(gaps, key=gaps.get)
        assert gaps[worst] <= RTOL, (worst, gaps[worst])
        for k in u_keys:
            np.testing.assert_array_equal(res["f64"]["state"][k],
                                          ranks[0]["f64"]["state"][k])
    assert ranks[0]["f64"]["checksums"] == ranks[1]["f64"]["checksums"]


def test_collectives_at_three_ranks(runs):
    """``global_weighted_average`` over 3 ranks, one with count 0, is the
    average over every item, the same on each rank; ``regroup_for_accum``
    at k = 2 gives rank r global rows r and 3 + r (6 rows, microbatches
    of 3, one row of each a rank)."""
    res = runs["ranks"]["collectives"]
    want = ([(1.0 * 3 + 0.5 * 1) / 4, (2.0 * 3 + 1.5 * 1) / 4], 4)
    for rank, (avg, lr_rows, hr_rows, jax_imported) in enumerate(res):
        assert avg[1] == want[1]
        np.testing.assert_allclose(avg[0], want[0], rtol=1e-12)
        assert lr_rows == hr_rows == [rank, 3 + rank]
        assert not jax_imported


def test_ranks_import_no_jax(runs):
    for key in ACCUMS + ["hifi"]:
        assert not any(res["jax_imported"] for res in runs["ranks"][key])


def test_helpers_are_the_identity_without_a_group():
    x = torch.randn(3, requires_grad=True)
    assert not mesh.is_distributed() and mesh.world_size() == 1
    assert mesh.all_sum(x) is x
    assert mesh.global_weighted_average([1.5], 0) == ([1.5], 0)
    mesh.barrier()
    lr, hr = torch.zeros(4, 1, 2), torch.ones(4, 1, 3)
    assert mesh.regroup_for_accum(lr, hr, 2) == (lr, hr)
    g = [torch.ones(2)]
    mesh.all_reduce_grads(g)
    assert torch.equal(g[0], torch.ones(2))
    mesh.coordination_barrier()


def test_dryrun_multichip(runs):
    """The entry point itself: 2 ranks, one step each, the same metrics
    and weights on both."""
    res = runs["dryrun"]
    assert res[0]["metrics"] == res[1]["metrics"]
    assert res[0]["checksum"] == res[1]["checksum"]
    assert np.isfinite(res[0]["metrics"]["total"])


def test_spawn_returns_tensors_by_value(runs):
    """A rank's tensor reaches the parent whole although the rank has
    exited: a tensor passed through the result queue as a shared file
    descriptor cannot be read once its process is gone."""
    for rank, t in enumerate(runs["tensors"]):
        torch.testing.assert_close(
            t, torch.arange(TENSOR_BACK, dtype=torch.float32) + rank,
            rtol=0, atol=0)
