"""The bf16 LSTM recurrence kernel (``aero_tpu_torch/ops/lstm.py``,
``csrc/lstm_mma.cu``) against its plain version on a CUDA card at every
sequence tile it has, at the serving shapes' N (enc2 at H 48, enc3 at
H 96: speech and music at batch 16, a 10 s chunk, a 4 s file and a 1 s
tail at batch 1) and at an N that is not a multiple of 8; and a bf16
BLSTM forward in eval, which takes the kernel route, eagerly and replayed
from a CUDA graph across an in-place weight change. Skips without CUDA;
``chip_smoke.py`` phase 17 times the tiles. On the card:
``python -m pytest tests/test_torch_port_lstm_card.py --noconftest``.
"""

import pytest
import torch

from aero_tpu_torch.models.modules import BLSTM
from aero_tpu_torch.ops import lstm as plstm

pytestmark = [pytest.mark.torch_port, pytest.mark.card]

STEPS = 200
# max|kernel - plain| of h in [-1, 1] (chip_smoke.LSTM_ATOL): h is rounded
# to bf16 every step, and one rounding that falls the other way (2^-8 near
# 1) travels on through the recurrence
ATOL = 3e-2
SHAPES = [(3328, 48), (1664, 96), (8832, 48), (4416, 96), (208, 48),
          (104, 96), (88, 48), (44, 96), (24, 48), (12, 96), (1001, 48),
          (1001, 128)]
CASES = [(n, hd, tile) for n, hd in SHAPES for tile in plstm.tiles(hd)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


def _inputs(n, hd, device, seed):
    """xp ~ 0.5 N(0, 1) in bf16; W_hh and the bias uniform in
    +-1/sqrt(H), nn.LSTM's init."""
    g = torch.Generator(device=device).manual_seed(seed)
    xp = 0.5 * torch.randn(STEPS, 8 * hd, n, device=device, generator=g)
    w = 2 * torch.rand(2, 4 * hd, hd, device=device, generator=g) - 1
    b = 2 * torch.rand(8 * hd, device=device, generator=g) - 1
    return xp.to(torch.bfloat16), w / hd ** 0.5, b / hd ** 0.5


@pytest.mark.parametrize("n,hd,tile", CASES)
def test_every_tile_matches_plain(cuda, n, hd, tile, monkeypatch):
    monkeypatch.setattr(plstm, "seq_tile", lambda n, hidden, sms: tile)
    xp, w, b = _inputs(n, hd, cuda, seed=n + hd)
    launches = plstm.lstm_recurrence.mma_launches
    got = plstm.lstm_recurrence(xp, w, b)
    torch.cuda.synchronize()
    assert plstm.lstm_recurrence.mma_launches == launches + 1
    want = plstm.reference_lstm_recurrence(xp, w, b)
    assert got.shape == want.shape == (STEPS, 2 * hd, n)
    assert (got.float() - want.float()).abs().max().item() <= ATOL


def test_blstm_eval_forward_takes_the_kernel(cuda):
    """Two recurrences, one kernel forward and no library one; the output
    within bf16 rounding of the nn.LSTM route (train mode: float32 cuDNN);
    an in-place weight change repacks W_hh."""
    torch.manual_seed(0)
    blstm = BLSTM(48).to(cuda).eval()
    x = torch.randn(8, 48, 1001, device=cuda, dtype=torch.bfloat16)
    launches = plstm.lstm_recurrence.mma_launches
    forwards = (BLSTM.kernel_forwards, BLSTM.library_forwards)
    with torch.inference_mode():
        y = blstm(x)
    assert plstm.lstm_recurrence.mma_launches == launches + 2
    assert (BLSTM.kernel_forwards, BLSTM.library_forwards) == (
        forwards[0] + 1, forwards[1])
    with torch.inference_mode():
        blstm.train()
        want = blstm(x)
        blstm.eval()
    gap = ((y.float() - want.float()).norm() / want.float().norm()).item()
    assert gap < 5e-3  # 6.3e-4 to 6.9e-4 at the serving shapes (phase 17)
    with torch.no_grad():
        blstm.lstm.weight_hh_l1.mul_(-1)
        fresh = BLSTM(48).to(cuda).eval()
        fresh.load_state_dict(blstm.state_dict())
    with torch.inference_mode():
        assert torch.equal(blstm(x), fresh(x))
        assert not torch.equal(blstm(x), y)


def test_blstm_graph_replay_reads_weights_changed_in_place(cuda):
    """A CUDA graph of a bf16 eval forward, captured after an eager one
    (as ``EvalForward`` captures), replays what an eager forward gives,
    also after an in-place weight change (an optimizer step) and an eager
    forward that rebuilt the kept operands: the capture built its own
    from the parameters, inside the graph."""
    torch.manual_seed(0)
    blstm = BLSTM(48).to(cuda).eval()
    x = torch.randn(2, 48, 1001, device=cuda, dtype=torch.bfloat16)
    graph = torch.cuda.CUDAGraph()
    with torch.inference_mode():
        blstm(x)
        with torch.cuda.graph(graph):
            out = blstm(x)
        graph.replay()
        before = out.clone()
        torch.testing.assert_close(before, blstm(x), rtol=0, atol=0)
    with torch.no_grad():
        blstm.lstm.weight_hh_l0.mul_(-1)
        blstm.linear.weight.mul_(-1)
        blstm.linear.bias.mul_(-1)
    with torch.inference_mode():
        want = blstm(x)
        graph.replay()
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        # the change moves the branch (the output less the skip) by more
        # than its own size: stale operands could not pass for fresh ones
        assert (want - before).float().norm() > (before - x).float().norm()
