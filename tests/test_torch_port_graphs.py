"""``EvalForward``'s CUDA graphs on the CPU, where there are none: a stub
generator and a fake capture backend that behaves as a graph does (its
capture runs the forward's Python once; a replay runs none of it and
overwrites one static output). The shape rule, the order eager, capture,
replay, the pool's first graph at the largest shape, the keys and
``update_state``, the counters (a replay launches nothing through the
wrappers), a returned tensor that outlives the next call, and the eager
forwards under ``attention.recording`` and a FLOP count."""

import os

import numpy as np
import pytest
import torch

from aero_tpu_torch.eval import forward as pfwd
from aero_tpu_torch.eval.forward import EvalForward
from aero_tpu_torch.models.factory import build_generator
from aero_tpu_torch.ops import attention
from aero_tpu_torch.utils import profiling
from aero_tpu_torch.utils.config import load_config
from aero_tpu_torch.utils.flops import count_flops

pytestmark = pytest.mark.torch_port

CONF = os.path.join(os.path.dirname(__file__), "..", "conf")
SR, SCALE = 4000, 4.0
# the forwards (rows, padded samples) of the speech files cell: one row of
# 1-10 s, and two or three full 10 s chunks; and of the two bulk cells
FILES_SHAPES = [(1, n) for n in range(SR, 10 * SR + 1, SR)] + [
    (2, 10 * SR), (3, 10 * SR)]
BULK_SHAPES = [(16, 10 * SR), (16, 110250)]


class Stub(torch.nn.Module):
    """A generator with Aero's interface: ``spectra`` calls a counted
    wrapper (``periodic_attention``) and reads a weight; ``synthesis``
    makes a new tensor of ``length * 4`` samples. In eval mode."""

    compute_dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(2.0))
        self.eval()

    def forward(self, mix, return_spec=False):
        spec, z = self.spectra(mix)
        out = self.synthesis(spec, mix.shape[-1])
        return (out, spec, z) if return_spec else out

    def spectra(self, mix):
        q = torch.ones(1, 3, 1, 2)
        attention.periodic_attention(q, q, q, q[..., 0], q[..., :1])
        return torch.complex(mix * self.w, mix), mix

    def synthesis(self, spec, length):
        return torch.repeat_interleave(spec.real, 4, dim=-1)[
            ..., :int(length * SCALE)]


def _expected(stub, lr):
    """What the eager forward gives for host ``lr``, padded as
    ``EvalForward`` pads it."""
    with torch.no_grad():
        return stub(torch.from_numpy(pfwd._pad_reflect_tail(
            lr, pfwd.bucket_target(lr.shape[-1], SR))))[
            ..., :int(lr.shape[-1] * SCALE)].numpy()


class FakeGraph:
    def __init__(self, fn, x):
        self.fn = fn
        self.input = x.clone()
        self.output = fn(self.input)

    def replay(self, x):
        """The captured work without its Python: the wrappers' counters
        stay where they were."""
        self.input.copy_(x)
        calls = attention.periodic_attention.calls
        self.output.copy_(self.fn(self.input))
        attention.periodic_attention.calls = calls
        return self.output


class FakeGraphs:
    def __init__(self):
        self.captured, self.cleared = [], 0

    def clear(self):
        self.cleared += 1

    def capture(self, fn, x):
        self.captured.append(FakeGraph(fn, x))
        return self.captured[-1]


def _forward(gen=None):
    fwd = EvalForward(gen or Stub(), SCALE, SR, "cpu")
    assert fwd.graphs is None  # the CPU: every forward eager
    fwd.graphs = FakeGraphs()
    return fwd


def _kinds():
    return (EvalForward.eager_forwards, EvalForward.graph_captures,
            EvalForward.graph_replays)


def _moved(before):
    return tuple(a - b for a, b in zip(_kinds(), before))


def _signal(n, seed=0, rows=1):
    return np.random.default_rng(seed).standard_normal(
        (rows, 1, n)).astype(np.float32)


@pytest.mark.parametrize("rows, n, graphed", [
    *[(r, n, True) for r, n in FILES_SHAPES],
    *[(r, n, False) for r, n in BULK_SHAPES]])
def test_small_forwards_replay_and_bulk_ones_stay_eager(rows, n, graphed):
    fwd = _forward()
    key = fwd._graph_key(torch.empty(rows, 1, n), False)
    assert (key is not None) == graphed
    assert (rows * n <= pfwd.GRAPH_MAX_SAMPLES) == graphed
    # a [B, T] input stays eager: ``spectra`` takes [B, C, T] alone
    assert fwd._graph_key(torch.empty(rows, n), False) is None


def test_eager_then_capture_then_replay():
    stub = Stub()
    fwd = _forward(stub)
    cpu = EvalForward(stub, SCALE, SR, "cpu")
    # the first capture of a pool also warms up and captures its floor
    for i, kind in enumerate([(1, 0, 0), (1, 2, 0), (0, 0, 1), (0, 0, 1)]):
        lr = _signal(2 * SR + 17, seed=i)
        before = _kinds()
        np.testing.assert_array_equal(fwd(lr), _expected(stub, lr))
        assert _moved(before) == kind
        before = _kinds()
        cpu(lr)
        assert _moved(before) == (1, 0, 0)
    assert len(fwd.graphs.captured) == 2
    # calls for the spectra stay eager
    spec_fwd = _forward(stub)
    spec_fwd.return_spec = True
    before = _kinds()
    for _ in range(3):
        spec_fwd(_signal(SR))
    assert _moved(before) == (3, 0, 0) and not spec_fwd.graphs.captured


@pytest.mark.parametrize("channels", [1, 2])
def test_a_pool_starts_with_the_largest_forward(channels):
    """Each pool's first graph is one row of ``GRAPH_MAX_SAMPLES`` samples
    over the input's channels, zeros: at least as many samples as any
    forward the rule graphs, so the later captures fit in its memory."""
    fwd = _forward()
    shapes = [(1, channels, SR), (3, channels, 3 * SR), (1, channels, SR)]
    for shape in shapes:
        for _ in range(2):
            fwd.forward_tensor(np.zeros(shape, np.float32))
    floor, *graphs = fwd.graphs.captured
    assert floor is fwd._floor
    assert tuple(floor.input.shape) == (
        1, channels, pfwd.GRAPH_MAX_SAMPLES // channels)
    assert not floor.input.any()
    assert [tuple(g.input.shape) for g in graphs] == shapes[:2]
    assert all(g.input.numel() <= floor.input.numel() for g in graphs)
    assert floor.input.numel() > pfwd.GRAPH_MAX_SAMPLES - channels
    fwd.update_state(fwd.gen)
    assert fwd._floor is None
    for _ in range(2):
        fwd.forward_tensor(np.zeros(shapes[0], np.float32))
    assert fwd.graphs.captured[-2] is fwd._floor is not floor


def test_keys_and_update_state(monkeypatch):
    stub = Stub()
    fwd = _forward(stub)

    def call(n, rows=1):
        before = _kinds()
        fwd.forward_tensor(_signal(n, rows=rows))
        return _moved(before)

    assert [call(SR), call(SR), call(2 * SR), call(SR)] == [
        (1, 0, 0), (1, 2, 0), (1, 0, 0), (0, 0, 1)]
    assert [call(SR, rows=2), call(SR, rows=2)] == [(1, 0, 0), (0, 1, 0)]
    for name, value in (("AERO_LSTM_KERNEL", "1"), ("AERO_FTB_KERNEL", "1"),
                        ("AERO_ATTN_BAND", "64")):
        monkeypatch.setenv(name, value)
        assert [call(SR), call(SR), call(SR)] == [
            (1, 0, 0), (0, 1, 0), (0, 0, 1)]
    monkeypatch.delenv("AERO_LSTM_KERNEL")
    monkeypatch.delenv("AERO_FTB_KERNEL")
    monkeypatch.delenv("AERO_ATTN_BAND")
    assert call(SR) == (0, 0, 1)
    stub.train()
    assert [call(SR), call(SR)] == [(1, 0, 0), (1, 0, 0)]
    stub.eval()
    stub.compute_dtype = torch.bfloat16
    assert call(SR) == (1, 0, 0)
    del stub.compute_dtype
    assert call(SR) == (0, 0, 1)
    # another generator, or the same one again: every graph goes, and the
    # next capture starts a new pool with its floor
    cleared = fwd.graphs.cleared
    fwd.update_state(stub)
    assert fwd.graphs.cleared == cleared + 1
    assert [call(SR), call(SR), call(SR)] == [(1, 0, 0), (1, 2, 0), (0, 0, 1)]
    other = Stub()
    fwd.update_state(other)
    assert [call(SR), call(SR)] == [(1, 0, 0), (1, 2, 0)]
    # weights changed in place are read by the replays
    with torch.no_grad():
        other.w.mul_(3)
    lr = _signal(SR, seed=5)
    before = _kinds()
    np.testing.assert_array_equal(fwd(lr), _expected(other, lr))
    assert _moved(before) == (0, 0, 1)


@pytest.mark.parametrize("calls", [1, 7])
def test_replays_launch_nothing_through_the_wrappers(calls):
    """The wrappers count where Python launches: each eager forward and
    each capture, the floor's too, and never a replay, which
    ``graph_replays`` counts apart."""
    stub = Stub()
    fwd = _forward(stub)
    cpu = EvalForward(stub, SCALE, SR, "cpu")
    counted = {}
    before = profiling.counters()
    for _ in range(2):  # warm-up and capture
        fwd(_signal(SR))
    counted["set-up"] = _changes(before)
    for name, f in (("replays", fwd), ("eager", cpu)):
        before = profiling.counters()
        for i in range(calls):
            f(_signal(SR, seed=i))
        counted[name] = _changes(before)
    setup = counted["set-up"]
    assert setup["periodic_attention.calls"] == 4 == (
        setup["EvalForward.eager_forwards"]
        + setup["EvalForward.graph_captures"])
    assert counted["replays"] == {"EvalForward.graph_replays": calls,
                                  "EvalForward.samples": calls * SR}
    assert counted["eager"] == {"EvalForward.eager_forwards": calls,
                                "EvalForward.samples": calls * SR,
                                "periodic_attention.calls": calls}


def _changes(before):
    return {k: n - before[k] for k, n in profiling.counters().items()
            if n != before[k]}


def test_returned_tensor_outlives_the_next_replay():
    stub = Stub()
    fwd = _forward(stub)
    for _ in range(2):
        fwd.forward_tensor(_signal(SR))
    a, b = _signal(SR, seed=1), _signal(SR, seed=2)
    got_a = fwd.forward_tensor(a)
    got_b = fwd.forward_tensor(b)
    # the static output holds b's spectra now; a's prediction is its own
    np.testing.assert_array_equal(
        fwd.graphs.captured[-1].output.imag.numpy(), b)
    np.testing.assert_array_equal(got_a.numpy(), _expected(stub, a))
    np.testing.assert_array_equal(got_b.numpy(), _expected(stub, b))


def test_aero_synthesis_is_a_new_tensor():
    """The graph holds Aero's ``spectra``; what ``_run`` returns is the
    eager synthesis of its static output, in memory of its own."""
    args = load_config(CONF, "main_config",
                       ["experiment=tiny", "dset=debug", "device=cpu"])
    gen = build_generator(dict(args.experiment.aero), "float32", "cpu")
    x = torch.from_numpy(_signal(SR))
    with torch.inference_mode():
        spec, _ = gen.spectra(x)
        out = gen.synthesis(spec, SR)
        whole = gen(x)
    assert out.untyped_storage().data_ptr() != \
        spec.untyped_storage().data_ptr()
    assert torch.equal(out, whole) and out.shape == (1, 1, 4 * SR)


@pytest.mark.parametrize("watch", ["recording", "count_flops"])
def test_eager_while_python_watches(watch):
    stub = Stub()
    fwd = _forward(stub)
    for _ in range(3):
        fwd.forward_tensor(_signal(SR))
    lr = _signal(SR, seed=3)
    before = _kinds()
    if watch == "recording":
        with attention.recording():
            got = fwd(lr)
    else:
        with torch.inference_mode():
            count_flops(fwd, lr)
        got = _expected(stub, lr)
    assert _moved(before) == (1, 0, 0)
    np.testing.assert_array_equal(got, _expected(stub, lr))
    before = _kinds()
    fwd(lr)
    assert _moved(before) == (0, 0, 1)
