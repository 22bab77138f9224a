"""The port's banded LocalState attention (``AERO_ATTN_BAND``) against
aero_tpu's, float32 on the CPU: the plain banded forward against the dense
JAX reference and the banded Pallas kernel in interpret mode, its values
and autograd gradients and the plain banded backward against ``jax.vjp``
of ``banded_local_attention``, a band covering every key against exact
attention, and LocalState's dispatch with its warning. The CUDA kernels
with a band are held against the plain versions on the card by
chip_smoke.py."""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aero_tpu.models import modules as jm
from aero_tpu.ops import attention as jattn
from aero_tpu_torch.models import modules as pm
from aero_tpu_torch.ops import attention as pattn
from tests.test_torch_port_attention import _grad_inputs, _inputs, _torch
from tests.test_torch_port_modules import _jax_vars, _load

pytestmark = pytest.mark.torch_port

ATOL = 2e-5  # float32 on the CPU; softmax sums in different orders
# (C', T, W): ragged T, bands narrower and wider than a 64-query block
CASES = [(12, 137, 16), (24, 300, 64), (12, 300, 130)]


@pytest.fixture
def interpret_mode():
    old = jattn._INTERPRET
    jattn._INTERPRET = True
    yield
    jattn._INTERPRET = old


@pytest.mark.parametrize("c,t,band", CASES)
def test_banded_plain_matches_jax_reference(c, t, band):
    xs = _inputs(t, c, seed=band)
    want = np.asarray(jattn.banded_reference_attention(
        *map(jnp.asarray, xs), band))
    got = pattn.banded_reference_attention(*_torch(*xs), band, block_q=64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("c,t,band", CASES)
def test_banded_plain_matches_pallas_interpret(c, t, band, interpret_mode):
    xs = _inputs(t, c, seed=band + 1)
    want = np.asarray(jattn.banded_pallas_attention(*map(jnp.asarray, xs),
                                                    band))
    got = pattn.local_attention(*_torch(*xs), band=band)  # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("t", [137, 300])
def test_band_covering_every_key_is_exact(t):
    xs = _torch(*_inputs(t, 24, seed=5))
    exact = pattn.reference_attention(*xs)
    for band in (t - 1, t, 4 * t):
        np.testing.assert_allclose(
            pattn.banded_reference_attention(*xs, band).numpy(),
            exact.numpy(), atol=1e-6)


def _jax_banded_vjp(xs, g, band):
    out, vjp = jax.vjp(lambda *a: jattn.banded_local_attention(*a, band),
                       *map(jnp.asarray, xs))
    return np.array(out), [np.array(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("c,t,band", CASES)
def test_banded_autograd_matches_jax_vjp(c, t, band):
    xs, g = _grad_inputs(t, c, seed=40 + band)
    want_out, want = _jax_banded_vjp(xs, g, band)
    ts = [x.requires_grad_() for x in _torch(*xs)]
    out = pattn.local_attention(*ts, band=band)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=ATOL)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for name, a, e in zip(("dq", "dk", "dv", "dw"), got, want):
        # dw sums ds * |t - s| over up to 2W + 1 keys
        np.testing.assert_allclose(a.numpy(), e, err_msg=name,
                                   atol=ATOL * max(1.0, np.abs(e).max()))


@pytest.mark.parametrize("c,t,band", CASES)
def test_banded_plain_backward_matches_jax_vjp(c, t, band):
    xs, g = _grad_inputs(t, c, seed=50 + band)
    out, want = _jax_banded_vjp(xs, g, band)
    got = pattn.reference_attention_bwd(*_torch(*xs), torch.from_numpy(out),
                                        torch.from_numpy(g), block_q=64,
                                        band=band)
    for name, a, e in zip(("dq", "dk", "dv", "dw"), got, want):
        np.testing.assert_allclose(a.numpy(), e, err_msg=name,
                                   atol=ATOL * max(1.0, np.abs(e).max()))


def _local_state(t, seed):
    """Port and JAX LocalState outputs, the decay slopes near 0 (global
    attention, as training leaves them) so that a band changes the
    answer."""
    x = np.random.default_rng(seed).standard_normal((2, t, 16)).astype(
        np.float32)
    jmod = jm.LocalState(16, heads=4, ndecay=4)
    v = _jax_vars(jmod, jnp.asarray(x), seed=seed)
    decay = v["params"]["query_decay"]["conv"]
    decay["bias"] = np.full_like(decay["bias"], -12.0)
    port = _load(pm.LocalState(16, heads=4, ndecay=4), v,
                 ("encoder_0", "dconv", "layers_0_time_attn"),
                 "encoder.0.dconv.layers.0.time_attn.")
    with torch.no_grad():
        got = port(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    return got.numpy(), np.asarray(jmod.apply(v, jnp.asarray(x)))


def test_local_state_with_band_matches_jax(monkeypatch, interpret_mode):
    """t = 300 > 2W with W = 64: both take the banded operator (JAX's
    banded Pallas kernel in interpret mode)."""
    monkeypatch.setenv("AERO_ATTN_BAND", "64")
    banded, want = _local_state(300, seed=6)
    np.testing.assert_allclose(banded, want, atol=ATOL)
    monkeypatch.delenv("AERO_ATTN_BAND")
    exact, _ = _local_state(300, seed=6)
    assert np.abs(banded - exact).max() > 1e-3  # the band changed the answer


def test_local_state_band_too_wide_warns_and_runs_exact(monkeypatch, caplog):
    """t = 100 <= 2W: the same warning as the JAX package, exact result."""
    monkeypatch.setenv("AERO_ATTN_BAND", "64")
    with caplog.at_level(logging.WARNING):
        got, want = _local_state(100, seed=7)
    assert any("AERO_ATTN_BAND=64 requested but attention site t=100" in
               r.getMessage() and r.name == pm.__name__
               for r in caplog.records)
    np.testing.assert_allclose(got, want, atol=ATOL)
    monkeypatch.delenv("AERO_ATTN_BAND")
    exact, _ = _local_state(100, seed=7)
    np.testing.assert_array_equal(got, exact)
