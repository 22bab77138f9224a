"""The port's fused FTB tail (``aero_tpu_torch/ops/ftb.py``) and its FTB with
``AERO_FTB_KERNEL=1`` against aero_tpu's, float32 on the CPU: the plain
tail against the Pallas kernel in interpret mode (``ftb_tail``), the FTB in
eval mode with perturbed BatchNorm statistics against JAX's FTB on its
kernel path, BatchNorm's fold, and training left on the composed form. The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aero_tpu.models import modules as jm
from aero_tpu.ops import ftb as jftb
from aero_tpu_torch.models import modules as pm
from aero_tpu_torch.ops import ftb as pftb
from tests.test_torch_port_modules import _load

pytestmark = pytest.mark.torch_port

# float32 on the CPU, as tests/test_ftb_kernel.py holds the JAX kernel to
# its composed form: 2C-term channel sums and an F-term frequency mix in
# different orders
ATOL, RTOL = 2e-5, 1e-5
# (F, C, T), the cases of tests/test_ftb_kernel.py
CASES = [(32, 8, 50), (16, 24, 129), (96, 8, 70)]


@pytest.fixture
def interpret_mode():
    old = jftb._INTERPRET
    jftb._INTERPRET = True
    yield
    jftb._INTERPRET = old


@pytest.fixture
def calls(monkeypatch):
    """Counts the FTB's calls of ``ftb_tail``."""
    seen = []
    real = pftb.ftb_tail

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(pftb, "ftb_tail", spy)
    return seen


@pytest.mark.parametrize("f,c,t", CASES)
def test_ftb_tail_matches_pallas_interpret(f, c, t, interpret_mode):
    rng = np.random.default_rng(f + c + t)
    x = (0.3 * rng.standard_normal((2, f, t, c))).astype(np.float32)
    h = rng.standard_normal((2, t, c)).astype(np.float32)
    ka, kb = (rng.standard_normal((2, c, c)) / np.sqrt(c)).astype(np.float32)
    w_freq = (rng.standard_normal((f, f)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    want = np.asarray(jftb.ftb_tail(*map(jnp.asarray,
                                         (x, h, ka, kb, w_freq, b2))))
    got = pftb.ftb_tail(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(h).permute(0, 2, 1),
                        *map(torch.from_numpy, (ka, kb, w_freq, b2)))
    assert got.shape == (2, c, f, t)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=ATOL, rtol=RTOL)


def _ftb(f, c, t, seed):
    """JAX FTB and the port's with the same weights; BatchNorm statistics
    moved off their init as tests/test_ftb_kernel.py moves them, so the
    fold is not trivial."""
    x = (0.3 * np.random.default_rng(seed).standard_normal((2, f, t, c))
         ).astype(np.float32)
    jmod = jm.FTB(input_dim=f, in_channel=c)
    v = jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x), False)
    v = {k: jax.tree.map(np.asarray, v[k]) for k in ("params", "batch_stats")}
    v["batch_stats"] = jax.tree.map(
        lambda a: a + 0.1 * np.arange(a.shape[-1], dtype=a.dtype),
        v["batch_stats"])
    port = _load(pm.FTB(f, c), v, ("encoder_0", "freq_attn_block"),
                 "encoder.0.freq_attn_block.")
    return x, jmod, v, port


def _port(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()


@pytest.mark.parametrize("f,c,t", CASES[:2])
def test_ftb_eval_with_switch_matches_jax_kernel_path(f, c, t, monkeypatch,
                                                      calls, interpret_mode):
    x, jmod, v, port = _ftb(f, c, t, seed=1)
    want = np.asarray(jmod.apply(v, jnp.asarray(x), False))  # the kernel
    monkeypatch.setenv("AERO_FTB_KERNEL", "1")
    got = _port(port, x)
    assert calls == [(2, c, f, t)]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    monkeypatch.delenv("AERO_FTB_KERNEL")
    np.testing.assert_allclose(_port(port, x), want, atol=ATOL, rtol=RTOL)
    assert len(calls) == 1


def test_ftb_training_keeps_composed_form(monkeypatch, calls):
    x = np.random.default_rng(2).standard_normal((2, 16, 40, 8)).astype(
        np.float32)
    port = pm.FTB(16, 8).train()
    want = _port(port, x)
    monkeypatch.setenv("AERO_FTB_KERNEL", "1")
    got = _port(port, x)
    assert calls == []
    np.testing.assert_array_equal(got, want)


def test_batchnorm_fold_matches_jax_fold_only():
    rng = np.random.default_rng(3)
    stats = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    params = {"scale": (1 + 0.1 * rng.standard_normal(6)).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    want = jm._RawBatchNorm().apply(
        {"params": params, "batch_stats": stats}, 6, False, fold_only=True)
    bn = pm.BatchNorm(6)
    bn.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"])})
    for a, e in zip(bn.fold(), want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(e),
                                   rtol=1e-6)


def test_wrapper_raises_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither CPU nor CUDA raises."""
    x = torch.zeros(1, 4, 8, 5, device="meta")
    with pytest.raises(ValueError):
        pftb.ftb_tail(x, torch.zeros(1, 4, 5), torch.zeros(4, 4),
                      torch.zeros(4, 4), torch.zeros(8, 8), torch.zeros(4))


def test_output_channel_tiles():
    """One tile up to 64 output channels, else even tiles of at most 64."""
    assert [pftb._tile(c) for c in (8, 16, 24, 48, 64, 96, 100, 192)] == [
        16, 16, 32, 48, 64, 48, 64, 64]
