"""The port's LSTM recurrence (``aero_tpu_torch/ops/lstm.py``) and its BLSTM
with ``AERO_LSTM_KERNEL=1`` against aero_tpu's, float32 on the CPU: the
plain recurrence against the Pallas kernel in interpret mode
(``lstm_time_scan``), the BLSTM in eval mode against JAX's BLSTM on its
kernel path through the 200/100 chunking, and the switch's gates. The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aero_tpu.models import modules as jm
from aero_tpu.ops import lstm as jlstm
from aero_tpu_torch.models import modules as pm
from aero_tpu_torch.ops import lstm as plstm
from tests.test_torch_port_modules import _jax_vars, _load

pytestmark = pytest.mark.torch_port

ATOL = 1e-5  # float32, both on the CPU; 2H-term sums in different orders


@pytest.fixture
def interpret_mode():
    old = jlstm._INTERPRET
    jlstm._INTERPRET = True
    yield
    jlstm._INTERPRET = old


@pytest.fixture
def calls(monkeypatch):
    """Counts the BLSTM's calls of ``lstm_recurrence``."""
    seen = []
    real = plstm.lstm_recurrence

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(plstm, "lstm_recurrence", spy)
    return seen


def _port_to_jax_xp(xp, bias, hd):
    """The port's [T, 8H, N] (direction-major rows, both at input time t)
    plus bias -> JAX's [T, 8H, N] (gate-major, direction-minor rows, the
    reverse direction at flipped time)."""
    t, _, n = xp.shape
    x4 = (xp + bias[None, :, None]).reshape(t, 2, 4, hd, n)
    return np.stack([x4[:, 0], x4[::-1, 1]], axis=2).reshape(t, 8 * hd, n)


@pytest.mark.parametrize("hd,n", [(8, 37), (72, 5)],
                         ids=["blockdiag_h8", "per_direction_h72"])
def test_recurrence_matches_pallas_interpret(hd, n, interpret_mode):
    """H = 8 takes the JAX kernel's block-diagonal W_hh, H = 72 (2H > 128)
    its per-direction one; N is ragged against the kernels' tiles."""
    t = 23
    rng = np.random.default_rng(hd)
    xp = (0.5 * rng.standard_normal((t, 8 * hd, n))).astype(np.float32)
    w_hh = (0.3 * rng.standard_normal((2, 4 * hd, hd))).astype(np.float32)
    bias = (0.2 * rng.standard_normal(8 * hd)).astype(np.float32)
    w_pk = jlstm.pack_weights(jnp.asarray(w_hh[0].T), jnp.asarray(w_hh[1].T),
                              hd)
    ys = np.asarray(jlstm.lstm_time_scan(
        jnp.asarray(_port_to_jax_xp(xp, bias, hd)), w_pk, hd))
    want = np.concatenate([ys[:, :hd], ys[::-1, hd:]], axis=1)  # input time
    got = plstm.lstm_recurrence(torch.from_numpy(xp),
                                torch.from_numpy(w_hh),
                                torch.from_numpy(bias))
    assert got.shape == (t, 2 * hd, n)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def _blstm(c, t, seed):
    x = (0.5 * np.random.default_rng(seed).standard_normal((3, t, c))).astype(
        np.float32)
    jmod = jm.BLSTM(c, layers=2, max_steps=200, skip=True)
    v = _jax_vars(jmod, jnp.asarray(x), False, seed=seed)
    port = _load(pm.BLSTM(c), v, ("encoder_0", "dconv", "layers_0_lstm"),
                 "encoder.0.dconv.layers.0.lstm.")
    return x, jmod, v, port


def _port(port, x):
    with torch.no_grad():
        y = port(torch.from_numpy(x).transpose(1, 2))
    return y.transpose(1, 2).numpy()


def test_blstm_eval_with_switch_matches_jax_kernel_path(monkeypatch, calls,
                                                        interpret_mode):
    """T = 450: three sequences of 5 overlapped 200-step chunks each, two
    layers, against JAX's BLSTM with its Pallas recurrence (interpret)."""
    x, jmod, v, port = _blstm(16, 450, seed=1)
    want = np.asarray(jax.jit(lambda vv, xx: jmod.apply(vv, xx, False))(
        v, jnp.asarray(x)))
    monkeypatch.setenv("AERO_LSTM_KERNEL", "1")
    got = _port(port, x)
    assert [s[1:] for s in calls] == [(128, 15), (128, 15)]  # [T, 8H, N]
    np.testing.assert_allclose(got, want, atol=ATOL)
    monkeypatch.delenv("AERO_LSTM_KERNEL")
    np.testing.assert_allclose(_port(port, x), got, atol=ATOL)  # nn.LSTM
    assert len(calls) == 2


def test_blstm_training_keeps_nn_lstm(monkeypatch, calls):
    x, jmod, v, port = _blstm(8, 230, seed=2)
    monkeypatch.setenv("AERO_LSTM_KERNEL", "1")
    port.train()
    got = _port(port, x)
    assert calls == []
    want = np.asarray(jmod.apply(v, jnp.asarray(x), True))  # the scan
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("c", [12, 136])
def test_blstm_switch_skips_widths_the_kernel_does_not_take(c, monkeypatch,
                                                             calls):
    """The gate of modules.py:681-683: H % 8 == 0 and H <= 128."""
    assert not plstm.takes_kernel(c)
    monkeypatch.setenv("AERO_LSTM_KERNEL", "1")
    _port(pm.BLSTM(c).eval(), np.zeros((1, 40, c), np.float32))
    assert calls == []


def test_wrapper_raises_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither CPU nor CUDA raises."""
    xp = torch.zeros(3, 64, 4, device="meta")
    with pytest.raises(ValueError):
        plstm.lstm_recurrence(xp, torch.zeros(2, 32, 8))


def test_packed_w_hh_layout():
    """pack_w_hh puts W_hh[d, g*H + r*U + u, k] at [d, k, r, g, u]."""
    hd, u = 16, 2
    w = torch.arange(2 * 4 * hd * hd, dtype=torch.float32).view(2, 4 * hd, hd)
    packed = plstm.pack_w_hh(w, torch.float32)
    assert packed.shape == (2, hd, 8, 4, u)
    for d, k, r, g, uu in [(0, 3, 1, 2, 1), (1, 15, 7, 3, 0)]:
        assert packed[d, k, r, g, uu] == w[d, g * hd + r * u + uu, k]


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("device,dtype,training,hidden,switch,want", [
    ("cuda", BF16, False, 48, "0", True), ("cuda", BF16, False, 96, "0", True),
    ("cuda", F32, False, 48, "0", False), ("cuda", BF16, True, 48, "0", False),
    ("cuda", BF16, False, 192, "0", False),
    ("cpu", BF16, False, 48, "0", False),
    ("cpu", F32, False, 48, "0", False), ("cpu", F32, False, 48, "1", True),
    ("cuda", F32, False, 96, "1", True), ("cuda", BF16, True, 48, "1", False),
    ("cuda", BF16, False, 192, "1", False)],
    ids=["cuda_bf16_h48", "cuda_bf16_h96", "cuda_f32", "cuda_bf16_train",
         "cuda_bf16_h192", "cpu_bf16", "cpu_f32", "cpu_f32_switch",
         "cuda_f32_switch", "train_switch", "h192_switch"])
def test_kernel_route(device, dtype, training, hidden, switch, want,
                      monkeypatch):
    """bf16 on CUDA in eval without autograd takes the kernel; the
    switch decides elsewhere, never in training or past the gate."""
    monkeypatch.setenv("AERO_LSTM_KERNEL", switch)
    with torch.no_grad():
        assert plstm.kernel_route(torch.device(device), dtype, training,
                                  hidden) == want
    assert plstm.kernel_route(torch.device(device), dtype, training,
                              hidden) == (want and switch == "1")


def test_blstm_operands_repack_after_an_inplace_change(monkeypatch):
    """The recurrence's operands are kept while no parameter changes and
    rebuilt after an in-place change (an optimizer step), so a forward
    then equals a fresh module's; nothing is kept while autograd records."""
    monkeypatch.setenv("AERO_LSTM_KERNEL", "1")
    torch.manual_seed(0)
    port = pm.BLSTM(8).eval()
    x = torch.randn(2, 8, 230)
    port(x)
    assert port._operands is None
    with torch.no_grad():
        first = port._layer_operands(torch.float32)
        assert port._layer_operands(torch.float32) is first
        port.lstm.weight_hh_l1_reverse.add_(0.5)
        second = port._layer_operands(torch.float32)
        assert second is not first
        assert torch.equal(second[1][1][1], port.lstm.weight_hh_l1_reverse)
        fresh = pm.BLSTM(8).eval()
        fresh.load_state_dict(port.state_dict())
        assert torch.equal(port(x), fresh(x))


def test_blstm_capture_builds_operands_from_the_parameters(monkeypatch):
    """Under a CUDA graph capture (stubbed here) the operands come from
    the parameters, not from those kept: the kept ones spoilt, a forward
    under the capture still equals the eager one, and leaves them as they
    were. So a replay reads weights changed in place (an optimizer step
    between the Solver's valid passes), and no graph holds memory that a
    later rebuild frees."""
    monkeypatch.setenv("AERO_LSTM_KERNEL", "1")
    torch.manual_seed(0)
    port = pm.BLSTM(8).eval()
    x = torch.randn(2, 8, 230)
    with torch.no_grad():
        want = port(x)
        kept = port._operands
        for w_ih, w_hh, bias, _ in kept[1][:-1]:  # copies, not parameters
            for operand in (w_ih, w_hh, bias):
                operand.zero_()
        monkeypatch.setattr(pm, "_capturing", lambda tensor: True)
        assert torch.equal(port(x), want)
        assert port._operands is kept
        port.lstm.weight_ih_l0.mul_(-1)
        fresh = pm.BLSTM(8).eval()
        fresh.load_state_dict(port.state_dict())
        assert torch.equal(port(x), fresh(x))
        assert port._operands is kept


def test_blstm_counts_forwards_by_route(monkeypatch, calls):
    port = pm.BLSTM(8).eval()
    x = torch.zeros(1, 8, 40)
    before = (pm.BLSTM.kernel_forwards, pm.BLSTM.library_forwards)
    with torch.no_grad():
        port(x)
        monkeypatch.setenv("AERO_LSTM_KERNEL", "1")
        port(x)
        port(x)
    assert (pm.BLSTM.kernel_forwards - before[0],
            pm.BLSTM.library_forwards - before[1]) == (2, 1)
    assert len(calls) == 4


@pytest.mark.parametrize("n,hidden,tile", [
    (3328, 48, 32), (1664, 96, 32), (8832, 48, 16), (4416, 96, 16),
    (208, 48, 8), (104, 96, 8), (88, 48, 8), (44, 96, 8), (24, 48, 8),
    (12, 96, 8), (1001, 128, 8)],
    ids=["speech_b16_h48", "speech_b16_h96", "music_b16_h48",
         "music_b16_h96", "chunk_b1_h48", "chunk_b1_h96", "file4s_b1_h48",
         "file4s_b1_h96", "tail1s_b1_h48", "tail1s_b1_h96", "h128"])
def test_seq_tile_picks_the_tile_measured_fastest(n, hidden, tile):
    """At the serving shapes on an H100 (132 SMs): the fastest tile of
    each (PERF.md section 6; 32 and 16 within 3% at speech's H 48), 8 at
    every batch-1 shape, 8 alone past H 96."""
    assert plstm.seq_tile(n, hidden, 132) == tile
