"""The dispatch rules of the tensor-core kernels and the LSTM's fragment
layout, on the CPU.

bfloat16 calls on the card take the tensor-core kernels
(``csrc/local_attention_mma.cu``, ``csrc/lstm_mma.cu``), float32 calls the
float32 kernels; the rule is the dtype alone, and what no kernel takes
raises. ``pack_w_hh_mma`` lays W_hh out as the mma.sync A fragments the
LSTM kernel holds in registers: pinned here index by index, and by an
emulation of the kernel's product on those fragments against the plain
recurrence. The kernels themselves run on the card only (chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from aero_tpu_torch.ops import attention as pattn
from aero_tpu_torch.ops import lstm as plstm

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("c", pattn.KERNEL_WIDTHS)
def test_attention_route_by_dtype(c):
    assert pattn.forward_route(torch.bfloat16, c) == "mma"
    assert pattn.forward_route(torch.float32, c) == "simt"


@pytest.mark.parametrize("dtype,c,error", [
    (torch.bfloat16, 6, ValueError), (torch.float32, 64, ValueError),
    (torch.float16, 12, TypeError), (torch.float64, 24, TypeError)])
def test_attention_route_raises_on_what_no_kernel_takes(dtype, c, error):
    with pytest.raises(error):
        pattn.forward_route(dtype, c)


@pytest.mark.parametrize("hidden", [8, 48, 72, 96, 128])
def test_lstm_route_by_dtype(hidden):
    """Every H the gate takes has both routes: the tensor-core kernel pads
    K to a multiple of 16 (8 -> 16, 72 -> 80)."""
    assert plstm.route(torch.bfloat16, hidden) == "mma"
    assert plstm.route(torch.float32, hidden) == "simt"


@pytest.mark.parametrize("dtype,hidden,error", [
    (torch.bfloat16, 12, ValueError), (torch.bfloat16, 136, ValueError),
    (torch.float32, 100, ValueError), (torch.float16, 48, TypeError)])
def test_lstm_route_raises_on_what_no_kernel_takes(dtype, hidden, error):
    with pytest.raises(error):
        plstm.route(dtype, hidden)


@pytest.mark.parametrize("hidden", [24, 48])
def test_packed_w_hh_mma_layout(hidden):
    """pack_w_hh_mma puts W_hh[d, (2m + j % 2) H + 8r + g, 16k + 2q +
    8 (j // 2) + e] at [d, r, lane = 4g + q, m, k, j, e], 0 where the
    column is >= H (H = 24 pads K to 32)."""
    ks = (hidden + 15) // 16
    w = torch.arange(2 * 4 * hidden * hidden, dtype=torch.float32).view(
        2, 4 * hidden, hidden) % 251  # exact in bfloat16
    packed = plstm.pack_w_hh_mma(w)
    assert packed.shape == (2, hidden // 8, 32, 2, ks, 4, 2)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    for d, r, lane, m, k, j, e in [(0, 0, 0, 0, 0, 0, 0), (1, 2, 31, 1, 1, 3, 1),
                                   (0, 1, 13, 1, 0, 1, 0), (1, 0, 6, 0, 1, 2, 1)]:
        g, q = lane // 4, lane % 4
        col = 16 * k + 2 * q + 8 * (j // 2) + e
        want = (w[d, (2 * m + j % 2) * hidden + 8 * r + g, col]
                if col < hidden else 0.0)
        assert packed[d, r, lane, m, k, j, e].item() == want


def _tiles_from_fragments(packed):
    """[2, W, 32, 2, KS, 4, 2] fragments -> the A tiles [2, W, 2, KS, 16,
    16] they hold, by mma.m16n8k16's A layout: register j of lane (g, q)
    holds row g + 8 (j % 2), columns 2q + 8 (j // 2) + e."""
    d, n_w, _, _, ks, _, _ = packed.shape
    tiles = torch.zeros(d, n_w, 2, ks, 16, 16)
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for j in range(4):
            for e in range(2):
                tiles[:, :, :, :, g + 8 * (j % 2), 2 * q + 8 * (j // 2) + e] = (
                    packed[:, :, lane, :, :, j, e].float())
    return tiles


@pytest.mark.parametrize("hidden,n", [(8, 5), (24, 13)])
def test_mma_fragment_product_reproduces_the_recurrence(hidden, n):
    """The kernel's step on the packed fragments: accumulator rows g and
    g + 8 of m-tile m of warp r are gates 2m and 2m + 1 of unit 8r + g;
    c and h follow. float32, with W_hh exact in bfloat16, against
    ``reference_lstm_recurrence``."""
    rng = np.random.default_rng(hidden)
    t = 6
    w_hh = torch.from_numpy(0.3 * rng.standard_normal((2, 4 * hidden, hidden))
                            ).float().to(torch.bfloat16).float()
    xp = torch.from_numpy(0.5 * rng.standard_normal((t, 8 * hidden, n))).float()
    bias = torch.from_numpy(0.2 * rng.standard_normal(8 * hidden)).float()
    want = plstm.reference_lstm_recurrence(xp, w_hh, bias)

    tiles = _tiles_from_fragments(plstm.pack_w_hh_mma(w_hh))
    ks = tiles.shape[3]
    n_w = hidden // 8
    h = torch.zeros(2, n, 16 * ks)                    # [dir, seq, K] as in smem
    c = torch.zeros(2, hidden, n)
    got = torch.empty(t, 2, hidden, n)
    x4 = (xp + bias[None, :, None]).view(t, 2, 4, hidden, n)
    for step in range(t):
        x_t = torch.stack([x4[step, 0], x4[t - 1 - step, 1]])  # [2, 4, H, N]
        acc = torch.einsum("dwmkab,dnkb->dwman", tiles,
                           h.view(2, n, ks, 16))      # [2, W, 2, 16, N]
        gates = acc.view(2, n_w, 2, 2, 8, n).permute(0, 2, 3, 1, 4, 5)
        gates = gates.reshape(2, 4, hidden, n) + x_t  # gate 2m + row half
        gi, gf, gg, go = gates.unbind(1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h_new = torch.sigmoid(go) * torch.tanh(c)
        h[:, :, :hidden] = h_new.transpose(1, 2)
        got[step, 0] = h_new[0]
        got[t - 1 - step, 1] = h_new[1]
    np.testing.assert_allclose(got.reshape(t, 2 * hidden, n).numpy(),
                               want.numpy(), atol=1e-5)
