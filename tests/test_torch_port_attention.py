"""The port's LocalState attention against aero_tpu's: the plain PyTorch
forward and backward against the dense JAX reference (and its VJP) and
against the Pallas kernels in interpret mode, and the wrapper's CPU
dispatch. The CUDA kernels themselves are held against the plain versions
on the card by chip_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aero_tpu.ops import attention as jattn
from aero_tpu_torch.ops import attention as pattn

pytestmark = pytest.mark.torch_port

ATOL = 2e-5  # float32 on the CPU; softmax sums in different orders

CASES = [(c, t) for c in (12, 24) for t in (137, 300)]  # ragged T


@pytest.fixture
def interpret_mode():
    old = jattn._INTERPRET
    jattn._INTERPRET = True
    yield
    jattn._INTERPRET = old


def _inputs(t, c, b=2, h=3, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, t, h, c)) / np.sqrt(c)).astype(np.float32)
    k = rng.standard_normal((b, t, h, c)).astype(np.float32)
    v = rng.standard_normal((b, t, h, c)).astype(np.float32)
    w = (0.1 * rng.random((b, t, h))).astype(np.float32)
    return q, k, v, w


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("c,t", CASES)
def test_plain_matches_jax_reference(c, t):
    xs = _inputs(t, c)
    want = np.asarray(jattn.reference_attention(*map(jnp.asarray, xs)))
    got = pattn.reference_attention(*_torch(*xs), block_q=64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("c,t", CASES)
def test_plain_matches_pallas_interpret(c, t, interpret_mode):
    xs = _inputs(t, c, seed=1)
    want = np.asarray(jattn.pallas_attention(*map(jnp.asarray, xs)))
    got = pattn.reference_attention(*_torch(*xs))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_cpu_wrapper_takes_plain_version_without_launching():
    xs = _torch(*_inputs(300, 12, seed=2))
    before = pattn.local_attention.launches
    got = pattn.local_attention(*xs)
    np.testing.assert_array_equal(got.numpy(),
                                  pattn.reference_attention(*xs).numpy())
    assert pattn.local_attention.launches == before


def test_wrapper_raises_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither all-CPU nor CUDA raises."""
    q, k, v, w = _torch(*_inputs(16, 12))
    with pytest.raises(ValueError):
        pattn.local_attention(q.to("meta"), k, v, w)


def test_plain_bfloat16_close_to_float32():
    xs = _torch(*_inputs(300, 24, seed=3))
    want = pattn.reference_attention(*xs)
    got = pattn.reference_attention(*(x.bfloat16() for x in xs))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2)


def _grad_inputs(t, c, seed):
    q, k, v, w = _inputs(t, c, seed=seed)
    g = np.random.default_rng(seed + 100).standard_normal(q.shape).astype(
        np.float32)
    return (q, k, v, w), g


def _jax_vjp(xs, g):
    out, vjp = jax.vjp(jattn.reference_attention, *map(jnp.asarray, xs))
    return np.array(out), [np.array(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("c,t", CASES)
def test_plain_backward_matches_jax_vjp(c, t):
    xs, g = _grad_inputs(t, c, seed=10)
    out, want = _jax_vjp(xs, g)
    got = pattn.reference_attention_bwd(*_torch(*xs), torch.from_numpy(out),
                                        torch.from_numpy(g), block_q=64)
    for name, a, e in zip(("dq", "dk", "dv", "dw"), got, want):
        assert a.shape == e.shape, name
        # dw sums ds * |t - s| over up to T keys, so its scale grows with T
        np.testing.assert_allclose(a.numpy(), e, err_msg=name,
                                   atol=ATOL * max(1.0, np.abs(e).max()))


@pytest.mark.parametrize("c,t", CASES)
def test_autograd_through_plain_matches_jax_vjp(c, t):
    xs, g = _grad_inputs(t, c, seed=20)
    _, want = _jax_vjp(xs, g)
    ts = [x.requires_grad_() for x in _torch(*xs)]
    out = pattn.local_attention(*ts)  # CPU: the plain version, autograd
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, e in zip(("dq", "dk", "dv", "dw"), got, want):
        np.testing.assert_allclose(a.numpy(), e, err_msg=name,
                                   atol=ATOL * max(1.0, np.abs(e).max()))


@pytest.mark.parametrize("c,t", CASES)
def test_plain_backward_matches_pallas_bwd_interpret(c, t, interpret_mode):
    xs, g = _grad_inputs(t, c, seed=30)
    jxs = list(map(jnp.asarray, xs))
    out = jattn.pallas_attention(*jxs)
    want = [np.asarray(x) for x in jattn.pallas_attention_bwd(
        *jxs, out, jnp.asarray(g))]
    got = pattn.reference_attention_bwd(*_torch(*xs),
                                        torch.from_numpy(np.asarray(out)),
                                        torch.from_numpy(g))
    for name, a, e in zip(("dq", "dk", "dv", "dw"), got, want):
        np.testing.assert_allclose(a.numpy(), e, err_msg=name,
                                   atol=ATOL * max(1.0, np.abs(e).max()))
