"""The port's FLOP count (``aero_tpu_torch/utils/flops.py``) against the JAX
walker (``aero_tpu/utils/flops.py``), on the CPU: closed forms and single
operators, the canonical generator forward, the tiny config's train step,
and the count's independence of the route that computes the work.

As a script (from the repository root) it prints the reconciliation of the
two counts, term by term, for the serving forward and the train step of a
config:

    python -m tests.test_torch_port_flops [experiment=aero_4-16_512_64]
        [dset=4-16] [batch=2] [precision=float32] [port=1]

``port=0`` leaves out the port's train step on the CPU (at the canonical
width it is one real step) and prints the count it should have.

The JAX side is traced (``make_jaxpr``), never compiled.
"""

import collections
import math
import os
import re
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax import lax

from aero_tpu.utils import flops as jflops
from aero_tpu_torch.ops import _build
from aero_tpu_torch.ops import attention as pattn
from aero_tpu_torch.ops import ftb as pftb
from aero_tpu_torch.ops import group_norm as pgn
from aero_tpu_torch.ops import lstm as plstm
from aero_tpu_torch.utils import flops as pflops

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

CONF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "conf")
PARITY_RTOL = 0.01  # the port's count against the JAX walker's


def _t(*shape):
    return torch.ones(*shape)


def _j(*shape):
    return jnp.ones(shape)


def _grad_count(fn, *xs):
    """The port's count of fn's forward and its backward to every x."""
    xs = [x.clone().requires_grad_() for x in xs]
    return pflops.count_flops(lambda: fn(*xs).sum().backward()).total


def _jax_grad_count(fn, *xs):
    return jflops.count_flops(
        jax.grad(lambda *a: jnp.sum(fn(*a)), argnums=tuple(range(len(xs)))),
        *xs).total


def _jax_conv(x, w, stride=1, padding=0, groups=1):
    return lax.conv_general_dilated(
        x, w, (stride,), [(padding, padding)], feature_group_count=groups,
        dimension_numbers=("NCH", "OIH", "NCH"))


def _jax_conv_transpose(x, w, stride):
    """The JAX package's transposed convolution (torch layout [in, out, k],
    no padding) on NCH input."""
    from aero_tpu.models.modules import _conv_transpose

    y = _conv_transpose(jnp.swapaxes(x, 1, 2), jnp.transpose(w, (2, 0, 1)),
                        stride, 0, axis=1)
    return jnp.swapaxes(y, 1, 2)


# (port function, port inputs, closed-form count)
CLOSED_FORMS = {
    "dot": (lambda a, b: a @ b, (_t(64, 128), _t(128, 32)),
            2 * 64 * 32 * 128),
    "batched_dot": (lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                    (_t(4, 8, 16), _t(4, 16, 8)), 2 * 4 * 8 * 8 * 16),
    "conv1d_same": (lambda a, b: F.conv1d(a, b, padding=1),
                    (_t(2, 4, 16), _t(8, 4, 3)), 2 * (2 * 8 * 16) * 4 * 3),
    "grouped_conv": (lambda a, b: F.conv1d(a, b, padding=1, groups=2),
                     (_t(2, 4, 16), _t(8, 2, 3)), 2 * (2 * 8 * 16) * 2 * 3),
    # stride 4, kernel 8: A = 2 phases of 2 taps over (16 + 1) * 4
    # positions, JAX's polyphase form; PyTorch's own formula counts the
    # 16 input positions x 8 taps
    "transposed_conv": (lambda a, b: F.conv_transpose1d(a, b, stride=4),
                        (_t(2, 4, 16), _t(4, 8, 8)),
                        2 * 2 * 4 * 8 * (16 + 1) * 4 * 2),
    "grad_of_dot": (None, (_t(32, 64), _t(64, 16)), 3 * 2 * 32 * 16 * 64),
}


@pytest.mark.parametrize("case", sorted(CLOSED_FORMS))
def test_closed_form(case):
    fn, args, want = CLOSED_FORMS[case]
    if case == "grad_of_dot":  # forward, dx = g w^T, dw = x^T g
        assert _grad_count(lambda a, b: a @ b, *args) == want
    else:
        assert pflops.count_flops(fn, *args).total == want


# the gradient rules against the JAX walker's transposes: (port fn, JAX fn,
# input shapes); a strided input gradient is JAX's lhs-dilated convolution
GRADS = {
    "conv1d_strided": (lambda x, w: F.conv1d(x, w, stride=4, padding=2),
                       lambda x, w: _jax_conv(x, w, 4, 2),
                       ((2, 4, 34), (8, 4, 5))),
    "conv1d_grouped_strided": (
        lambda x, w: F.conv1d(x, w, stride=4, padding=20, groups=4),
        lambda x, w: _jax_conv(x, w, 4, 20, 4), ((2, 16, 160), (32, 4, 41))),
    "conv_transpose_stride2": (
        lambda x, w: F.conv_transpose1d(x, w, stride=2),
        lambda x, w: _jax_conv_transpose(x, w, 2), ((2, 4, 4), (4, 6, 8))),
    "conv_transpose_stride4": (
        lambda x, w: F.conv_transpose1d(x, w, stride=4),
        lambda x, w: _jax_conv_transpose(x, w, 4), ((3, 4, 16), (4, 8, 8))),
    "bmm": (lambda a, b: a @ b, lambda a, b: a @ b, ((3, 5, 7), (3, 7, 2))),
}


@pytest.mark.parametrize("case", sorted(GRADS))
def test_forward_and_gradient_match_jax_walker(case):
    port_fn, jax_fn, shapes = GRADS[case]
    assert (pflops.count_flops(port_fn, *(_t(*s) for s in shapes)).total
            == jflops.count_flops(jax_fn, *(_j(*s) for s in shapes)).total)
    assert (_grad_count(port_fn, *(_t(*s) for s in shapes))
            == _jax_grad_count(jax_fn, *(_j(*s) for s in shapes)))


@pytest.mark.parametrize("band", [0, 5])
def test_attention_counts_its_formula_not_its_plain_ops(band):
    """The plain version's blocked einsums would count every key of a
    block's window; the entry point counts the pairs |t - s| <= band, and
    twice that for the backward."""
    b, t, h, c = 2, 37, 2, 4
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, t, h, c, generator=g) for _ in range(3))
    w = torch.rand(b, t, h, generator=g)
    fwd = pflops.attention_flops(b, t, h, c, band)
    pairs = sum(min(t - 1, s + band) - max(0, s - band) + 1
                for s in range(t)) if band else t * t
    assert fwd == 4 * b * h * pairs * c
    assert pflops.count_flops(pattn.local_attention, q, k, v, w,
                              band).total == fwd
    assert _grad_count(lambda *a: pattn.local_attention(*a, band=band),
                       q, k, v, w) == 3 * fwd


def test_lstm_counts_the_scan_whatever_runs_it():
    """nn.LSTM is one oneDNN operator on this CPU, which no formula
    reads: the BLSTM counts the JAX scan's products, forward and
    backward."""
    from aero_tpu_torch.models.modules import BLSTM

    m = BLSTM(8)
    x = torch.randn(3, 8, 50)
    fwd = pflops.lstm_flops(3, 50, [8, 16], 8)
    linear = 2 * 3 * 50 * 16 * 8
    assert pflops.count_flops(m, x).total == fwd + linear
    assert _grad_count(m, x) == 3 * (fwd + linear)


# --- the whole model against the JAX walker -----------------------------

def _configs(overrides):
    from aero_tpu.utils.config import load_config as jload
    from aero_tpu_torch.utils.config import load_config

    return (jload(CONF, "main_config", overrides),
            load_config(CONF, "main_config", overrides))


def _jax_forward(jargs, batch, samples):
    """The traced eval forward of the JAX generator."""
    from aero_tpu.train import build

    gen = build.build_models(jargs)["generator"]
    x = jnp.zeros((batch, 1, samples), jnp.float32)
    v = jax.eval_shape(lambda: gen.init(jax.random.PRNGKey(0), x,
                                        train=False))
    v = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), v)
    return jax.make_jaxpr(lambda vv, a: gen.apply(vv, a, train=False))(v, x)


def _decay_flops(gen, fn):
    """The JAX LocalState's einsum of its decay queries with the decay
    rates (2 N T H ndecay), which the port forms elementwise, over the
    LocalStates ``fn`` runs."""
    from aero_tpu_torch.models.modules import LocalState

    total = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: total.append(2 * a[0].shape[0] * a[0].shape[2]
                                  * m.heads * m.ndecay))
        for m in gen.modules() if isinstance(m, LocalState)]
    try:
        fn()
    finally:
        for hook in hooks:
            hook.remove()
    return sum(total)


def test_canonical_forward_matches_jax_walker():
    """aero_4-16_512_64 at B = 1 x 1 s (T = 251 <= 512: JAX's dense
    attention, no query padding): the counts differ by the decay
    einsums alone."""
    from aero_tpu_torch.train import build

    jargs, args = _configs(["experiment=aero_4-16_512_64", "dset=4-16",
                            "precision=float32"])
    want = _jaxpr_total(_jax_forward(jargs, 1, 4000))
    gen = build.build_models(args, "cpu")["generator"].eval()
    x = torch.zeros(1, 1, 4000)
    with torch.no_grad():
        got = pflops.count_flops(gen, x).total
        decay = _decay_flops(gen, lambda: gen(x))
    assert abs(got - want) <= PARITY_RTOL * want
    assert got + decay == want


def _jax_step_count(jargs, batch, grouped, monkeypatch=None):
    """The JAX walker's count of ``make_train_step`` at ``batch`` rows, with
    the discriminators' grouped convolutions as grouped convolutions
    (``grouped``) or as the package's default lowering chooses."""
    from aero_tpu.models import discriminators
    from aero_tpu.parallel import mesh as pmesh
    from aero_tpu.train import build
    from aero_tpu.train.train_step import init_state, make_train_step

    kept = discriminators._DISC_CONV_MODE
    discriminators._DISC_CONV_MODE = "grouped" if grouped else kept
    try:
        models = build.build_models(jargs)
        lr_shape, hr_shape = build.segment_shapes(jargs)
        lr_shape, hr_shape = ((batch,) + lr_shape[1:],
                              (batch,) + hr_shape[1:])

        def init():
            k1, k2 = jax.random.split(jax.random.PRNGKey(0))
            return init_state(jargs, models, build.init_variables(
                jargs, models, k1, lr_shape, hr_shape), k2)

        state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                             jax.eval_shape(init))
        # one device: the walker counts the global program either way
        step = make_train_step(jargs, models,
                               pmesh.make_mesh(jax.devices()[:1]),
                               donate=False)
        return jax.make_jaxpr(step)(state, jnp.zeros(lr_shape),
                                    jnp.zeros(hr_shape))
    finally:
        discriminators._DISC_CONV_MODE = kept


def _port_step(args, batch):
    from aero_tpu_torch.train import build
    from aero_tpu_torch.train.train_step import TrainStep

    lr_shape, hr_shape = build.segment_shapes(args.experiment)
    rng = np.random.default_rng(0)
    lr = (0.1 * rng.standard_normal((batch,) + lr_shape[1:])).astype(
        np.float32)
    hr = (0.1 * rng.standard_normal((batch,) + hr_shape[1:])).astype(
        np.float32)
    models = build.build_models(args, "cpu")
    return TrainStep(args, models, "cpu"), models, lr, hr


def _jaxpr_total(closed) -> int:
    acc = jflops.FlopCount()
    jflops._count_jaxpr(closed.jaxpr, 1, acc)
    return acc.total


def test_tiny_train_step_matches_jax_walker():
    """The tiny config's step (B = 2 x 0.5 s) within 1% of JAX's
    ``make_train_step``, its MelGAN's grouped convolutions counted as
    grouped: the JAX package's default runs the small ones as dense
    block-diagonal convolutions, whose zero blocks its walker counts
    (PERF.md names this and the other differences)."""
    jargs, args = _configs(["experiment=tiny", "dset=debug",
                            "precision=float32"])
    want = _jaxpr_total(_jax_step_count(jargs, 2, grouped=True))
    step, _, lr, hr = _port_step(args, 2)
    got = pflops.count_flops(step.grads, lr, hr).total
    assert abs(got - want) <= PARITY_RTOL * want, (got, want)


# --- route independence --------------------------------------------------

def _fake_kernels(monkeypatch, calls):
    """Every kernel launch of the four wrappers replaced by its plain
    version on the CPU, and the wrappers' device checks by shape checks,
    so CPU tensors take the kernel route."""
    monkeypatch.setattr(_build, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(pattn, "_check", lambda q, k, v, w: tuple(q.shape))

    def kernel_fwd(qf, kf, vf, wf, with_lse, band=0):
        calls.append("attention_fwd")
        q, k, v, w = (a[:, :, None] for a in (qf, kf, vf, wf))
        out = (pattn.banded_reference_attention(q, k, v, w, band) if band
               else pattn.reference_attention(q, k, v, w))
        return out[:, :, 0], torch.zeros(qf.shape[:2])

    def kernel_bwd(qf, kf, vf, wf, of, lse, gf, band=0):
        calls.append("attention_bwd")
        grads = pattn.reference_attention_bwd(
            *(a[:, :, None] for a in (qf, kf, vf, wf, of, gf)), band=band)
        return tuple(d[:, :, 0] for d in grads[:3]) + (
            grads[3][:, :, 0].float(),)

    def lstm_launch(xp, w_hh, bias, w_packed=None):
        calls.append("lstm")
        return plstm.reference_lstm_recurrence(xp, w_hh, bias)

    def ftb_launch(x, y, h, ka, kb, b2):
        calls.append("ftb")
        return pftb.reference_fused_tail(x, y, h, ka, kb, b2)

    monkeypatch.setattr(pattn, "_kernel_fwd", kernel_fwd)
    monkeypatch.setattr(pattn, "_kernel_bwd", kernel_bwd)
    monkeypatch.setattr(plstm, "_launch", lstm_launch)
    def group_norm_launch(x, groups, weight, bias, eps, act, a):
        calls.append("group_norm")
        return pgn.reference_group_norm(x, groups, weight, bias, eps, act, a)

    monkeypatch.setattr(pftb, "_launch", ftb_launch)
    monkeypatch.setattr(pgn, "_launch", group_norm_launch)


def test_eval_count_is_route_independent(monkeypatch):
    """The canonical structure at 16 channels, 1 s, eval: the plain
    versions, the kernel route with AERO_LSTM_KERNEL=1 AERO_FTB_KERNEL=1
    (the BLSTM's input projections and the recurrence, the BatchNorm fold
    and the fused tail) on the plain route and with the launches faked,
    all count the same."""
    from aero_tpu_torch.models.aero import Aero
    from tests.test_torch_port_aero import NARROW

    torch.manual_seed(0)
    gen = Aero(**NARROW).eval()
    x = 0.1 * torch.randn(1, 1, 4000)

    def count():
        with torch.no_grad():
            return pflops.count_flops(gen, x)

    default = count()
    monkeypatch.setenv("AERO_LSTM_KERNEL", "1")
    monkeypatch.setenv("AERO_FTB_KERNEL", "1")
    switched = count()
    calls = []
    _fake_kernels(monkeypatch, calls)
    faked = count()
    assert default.total == switched.total == faked.total
    assert collections.Counter(calls) == {"attention_fwd": 4, "lstm": 8,
                                          "ftb": 4, "group_norm": 24}
    assert switched["lstm"] < default["lstm"]  # its projection: a matmul


def test_train_count_is_route_independent(monkeypatch):
    """The tiny config's step (forward and backward attention kernels)
    counts the same on the plain route and with the launches faked."""
    _, args = _configs(["experiment=tiny", "dset=debug",
                        "precision=float32"])
    step, _, lr, hr = _port_step(args, 2)
    plain = pflops.count_flops(step.grads, lr, hr).total
    calls = []
    _fake_kernels(monkeypatch, calls)
    faked = pflops.count_flops(step.grads, lr, hr).total
    assert plain == faked
    # the tiny config's one LocalState
    assert collections.Counter(calls) == {"attention_fwd": 1,
                                          "attention_bwd": 1}


# --- the reconciliation (run as a script) -------------------------------

def _jax_terms(closed, depth=1):
    """{(scope, 'fwd' | 'bwd'): FLOPs} of a traced step by the name stack
    of each product and convolution, scans multiplied out."""
    terms = collections.Counter()

    def walk(jaxpr, mult, scope):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            stack = scope + "/" + str(eqn.source_info.name_stack)
            if name in ("dot_general", "conv_general_dilated"):
                n = (jflops._dot_general_flops(eqn) if name == "dot_general"
                     else jflops._conv_flops(eqn))
                parts = [re.sub(r"\w+\(", "", p).rstrip(")")
                         for p in stack.split("/") if p]
                key = "/".join(parts[:depth + 1])
                if "bshf,f->bsh" in stack:
                    key = "decay einsum"
                terms[(key, "bwd" if "transpose(" in stack
                       else "fwd")] += mult * n
            elif name == "scan":
                walk(eqn.params["jaxpr"].jaxpr,
                     mult * int(eqn.params["length"]), stack)
            else:
                for value in eqn.params.values():
                    for sub in jflops._sub_jaxprs(value):
                        walk(sub, mult, stack)

    walk(closed.jaxpr, 1, "")
    return terms


def reconcile(overrides, batch, precision, port=True):
    """Print the JAX walker's and the port's counts of the serving forward
    (B = batch x 10 s; the port's at B = 1 times batch, every count being
    linear in B) and of the train step (B = batch), and the terms that
    part them."""
    overrides = [o for o in overrides if not o.startswith("precision=")]
    jargs, args = _configs(overrides + [f"precision={precision}"])
    from aero_tpu_torch.train import build

    print(f"{' '.join(overrides)} precision={precision} batch={batch}")
    closed = _jax_forward(jargs, batch, 40000)
    want = _jaxpr_total(closed)
    gen = build.build_models(args, "cpu")["generator"].eval()
    x = torch.zeros(1, 1, 40000)
    modules = collections.Counter()

    def around(name):  # the running count across each layer's call
        def pre(m, a):
            m._flops_before = pflops._ACTIVE[-1].count.total

        def post(m, a, out):
            modules[name] += (pflops._ACTIVE[-1].count.total
                              - m._flops_before) * batch
        return pre, post

    layers = [(f"encoder_{i}", m) for i, m in enumerate(gen.encoder)] + [
        (f"decoder_{j}", m) for j, m in enumerate(gen.decoder)]
    hooks = []
    for name, m in layers:
        pre, post = around(name)
        hooks += [m.register_forward_pre_hook(pre),
                  m.register_forward_hook(post)]
    with torch.no_grad():
        got = pflops.count_flops(gen, x).total * batch
        for h in hooks:
            h.remove()
        decay = _decay_flops(gen, lambda: gen(x)) * batch
    modules["STFT, iSTFT"] = got - sum(modules.values())
    print(f"serving forward, {batch} x 10 s: JAX walker {want}, port {got} "
          f"({got / want - 1:+.4%}); the JAX decay einsums {decay}; "
          f"the rest, JAX's query padding of the blockwise attention to a "
          f"multiple of 256: {want - got - decay}")
    jax_by = collections.Counter()
    for (k, _), v in _jax_terms(closed, depth=1).items():
        layer = k.split("/")[1] if k.count("/") and "_" in k.split("/")[1] \
            and not k.split("/")[1].startswith("Aero.") else "STFT, iSTFT"
        jax_by["decay einsums" if k == "decay einsum" else layer] += v
    print(f"    {'module':16s} {'JAX walker':>16s} {'port':>16s}")
    for name in [n for n, _ in layers] + ["STFT, iSTFT", "decay einsums"]:
        print(f"    {name:16s} {jax_by[name]:>16d} {modules[name]:>16d}")

    closed = _jax_step_count(jargs, batch, grouped=False)
    closed_grouped = _jax_step_count(jargs, batch, grouped=True)
    default, grouped = _jaxpr_total(closed), _jaxpr_total(closed_grouped)
    terms = _jax_terms(closed_grouped)
    # the discriminators' layers, and their average pools (convolutions
    # with a ones kernel in JAX, which the port does not count) at the
    # scope's root
    disc_fwd = sum(v for (k, d), v in terms.items()
                   if "Discriminator/" in k and d == "fwd")
    pools = sum(v for (k, _), v in terms.items()
                if k.endswith("Discriminator"))
    n_disc = 4  # JAX: real and fake audio in each of the two losses
    # the first decoder's rewrite, on one row (its count is linear in B)
    cap = {}
    hook = gen.decoder[0].rewrite.register_forward_pre_hook(
        lambda m, a: cap.setdefault("x", a[0][:1].detach()))
    with torch.no_grad():
        gen(torch.zeros((1,) + build.segment_shapes(args.experiment)[0][1:]))
    hook.remove()
    zero_half = batch * pflops.count_flops(gen.decoder[0].rewrite,
                                           cap["x"]).total // 2
    decay = sum(v for (k, _), v in terms.items() if k == "decay einsum")
    expect = grouped - disc_fwd // n_disc + zero_half - decay - pools
    print(f"train step, {batch} rows: JAX walker {default} (default "
          f"lowering), {grouped} (grouped convolutions as grouped; the "
          f"default's dense block-diagonal zero blocks: "
          f"{default - grouped})")
    print(f"  - JAX's fourth MelGAN forward (real audio, again in the "
          f"discriminator loss): {disc_fwd // n_disc}")
    print(f"  + the port's input gradient of the first decoder's rewrite "
          f"over the zero half of cat(0, skip): {zero_half}")
    print(f"  - JAX's decay einsums: {decay}; - JAX's average-pool "
          f"convolutions: {pools}")
    print(f"  = {expect}, the port's count of the same step")
    if port:
        step, _, lr, hr = _port_step(args, batch)
        got = pflops.count_flops(step.grads, lr, hr).total
        print(f"  the port's count: {got} ({got / grouped - 1:+.4%} of the "
              f"grouped JAX count); less the sum: {got - expect}")
    for (k, d), v in sorted(terms.items()):
        print(f"    JAX {d} {v:>16d} {k}")


if __name__ == "__main__":
    argv = [a for a in sys.argv[1:] if "=" in a]
    opts = dict(a.split("=", 1) for a in argv
                if a.split("=", 1)[0] in ("batch", "precision", "port"))
    rest = [a for a in argv if a.split("=", 1)[0] not in opts]
    reconcile(rest or ["experiment=aero_4-16_512_64", "dset=4-16"],
              int(opts.get("batch", 2)), opts.get("precision", "float32"),
              opts.get("port", "1") == "1")
