"""The whole Aero forward with all three opt-in switches (AERO_LSTM_KERNEL=1,
AERO_FTB_KERNEL=1, AERO_ATTN_BAND=64) against aero_tpu's with the same
switches and weights, float32 on the CPU, at the canonical structure cut to
16 channels and 3 s (T = 751 frames). There the port takes the plain
versions of its three kernels through the switches' wiring (the BLSTM's
input projections and packing, the BatchNorm fold, the band dispatch), and
JAX its plain references (the scan, the composed tail, the banded blockwise
attention), which compute the same functions as its kernels; the module
tests hold those kernels in interpret mode."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aero_tpu.models.aero import Aero as JaxAero
from aero_tpu.models.init import rescale_tree
from aero_tpu_torch.models.aero import Aero
from aero_tpu_torch.ops import attention as pattn
from aero_tpu_torch.ops import ftb as pftb
from aero_tpu_torch.ops import lstm as plstm
from aero_tpu_torch.train.from_jax import state_dict_from_jax
from tests.test_torch_port_aero import NARROW, _jax_kwargs, _perturbed

pytestmark = pytest.mark.torch_port

BAND = 64
SWITCHES = {"AERO_LSTM_KERNEL": "1", "AERO_FTB_KERNEL": "1",
            "AERO_ATTN_BAND": str(BAND)}


def _count(monkeypatch, module, name, seen):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        seen.append((name, kwargs.get("band", 0)))
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)


def test_narrow_forward_with_all_switches_matches_jax(monkeypatch):
    for key, value in SWITCHES.items():
        monkeypatch.setenv(key, value)
    jm = JaxAero(**_jax_kwargs(NARROW))
    rng = np.random.default_rng(0)
    x = (0.1 * rng.standard_normal((2, 1, 12000))).astype(np.float32)
    v = jax.jit(lambda k, y: jm.init(k, y, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": rescale_tree(v["params"], NARROW["rescale"]),
         "batch_stats": v["batch_stats"]}
    v = _perturbed(jax.tree.map(np.asarray, v), rng)
    want = np.asarray(jax.jit(lambda vv, y: jm.apply(vv, y, train=False))(
        v, jnp.asarray(x)))

    seen = []
    _count(monkeypatch, plstm, "lstm_recurrence", seen)
    _count(monkeypatch, pftb, "ftb_tail", seen)
    _count(monkeypatch, pattn, "local_attention", seen)
    port = Aero(**NARROW).eval()
    port.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    # enc2/enc3: 2 DConv layers x 2 LSTM layers each (H = 16, 32); FTB on
    # every encoder; LocalState at T = 751 > 2 * 64, so banded
    assert sorted(seen) == sorted([("lstm_recurrence", 0)] * 8
                                  + [("ftb_tail", 0)] * 4
                                  + [("local_attention", BAND)] * 4)
    assert got.shape == want.shape == (2, 1, 4 * x.shape[-1])
    # float32 on the CPU; relative to the output's scale, as the default
    # path's test_forward_matches_jax
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
