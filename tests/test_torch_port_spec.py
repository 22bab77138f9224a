"""The port's STFT/iSTFT (torch.stft/istft) against aero_tpu.ops.spec at the
canonical 4->16 kHz settings (analysis hop 16 / window 128, synthesis hop
64 / window 512, n_fft 512), the 8->24 kHz ones, and the round trip."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from aero_tpu.ops import spec as jspec
from aero_tpu_torch.ops import spec as pspec

pytestmark = pytest.mark.torch_port

# (hop, win) pairs: 4->16 analysis and synthesis, 8->24 analysis and synthesis
SETTINGS = [(16, 128), (64, 512), (21, 170), (63, 510)]


def _signal(n=4000, seed=0):
    return np.random.default_rng(seed).standard_normal((2, 1, n)).astype(
        np.float32)


@pytest.mark.parametrize("hop,win", SETTINGS)
def test_spectro_matches_jax(hop, win):
    x = _signal()
    want = np.asarray(jspec.spectro(jnp.asarray(x), 512, hop, win_length=win))
    got = pspec.spectro(torch.from_numpy(x), 512, hop, win_length=win)
    assert got.shape == want.shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("hop,win", SETTINGS)
def test_ispectro_matches_jax(hop, win):
    rng = np.random.default_rng(1)
    z = (rng.standard_normal((2, 1, 257, 60))
         + 1j * rng.standard_normal((2, 1, 257, 60))).astype(np.complex64)
    want = np.asarray(jspec.ispectro(jnp.asarray(z), hop, win_length=win))
    got = pspec.ispectro(torch.from_numpy(z), hop, win_length=win)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_round_trip_synthesis_settings():
    x = _signal(16000, seed=2)
    z = pspec.spectro(torch.from_numpy(x), 512, 64, win_length=512)
    y = pspec.ispectro(z, 64, length=x.shape[-1], win_length=512)
    np.testing.assert_allclose(y.numpy(), x, atol=1e-5)
