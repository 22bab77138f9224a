"""The GroupNorm kernel pair (``aero_tpu_torch/ops/group_norm.py``,
``csrc/group_norm.cu``) against its plain version on a CUDA card, eagerly
and as two replays of a CUDA graph, which must give the eager launch's
bits. Skips without CUDA; ``chip_smoke.py`` phase 16 runs the same checks
at every GroupNorm site of both configurations. On the card:
``python -m pytest tests/test_torch_port_group_norm_card.py --noconftest``.
"""

import pytest
import torch

from aero_tpu_torch.ops import group_norm as gn

pytestmark = [pytest.mark.torch_port, pytest.mark.card]

# max|kernel - plain| <= tol * max|plain| (chip_smoke.GN_TOL): float32
# statistics in another order; bfloat16 rounds once, so one ulp at most
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# (x's shape, groups, act, rows of Snake's a): enc3's and the deepest
# decoder's sites at batch 1 and T 2501, then ragged ones (a GLU half-plane
# of 2331 elements, T 777 and 1001)
CASES = [((1, 384, 4, 2501), 4, "gelu", 0), ((4, 96, 2501), 1, "snake", 4),
         ((4, 768, 2501), 1, "glu", 0), ((1, 768, 4, 2501), 4, "glu", 0),
         ((1, 1536, 4, 2501), 4, "glu", 0), ((1, 192, 14, 2501), 4, "gelu", 0),
         ((2, 6, 777), 2, "glu", 0), ((3, 24, 5, 777), 4, "none", 0),
         ((10, 18, 1001), 1, "snake", 5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel pair has no CPU form")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,act,rows", CASES)
def test_kernel_pair_matches_plain_and_replays(cuda, shape, groups, act,
                                               rows, dtype):
    g = torch.Generator(device=cuda).manual_seed(19)
    x = (2 + 3 * torch.randn(shape, device=cuda, generator=g)).to(dtype)
    w = 1 + 0.3 * torch.randn(shape[1], device=cuda, generator=g)
    b = 0.3 * torch.randn(shape[1], device=cuda, generator=g)
    a = (torch.empty(rows, device=cuda).exponential_(0.1, generator=g)
         if act == "snake" else None)
    args = (x, groups, w, b, 1e-5, act, a)
    calls = gn.group_norm.calls
    got = gn.group_norm(*args)
    want = gn.reference_group_norm(*args)
    assert gn.group_norm.calls == calls + 1
    assert got.shape == want.shape and got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item()

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = gn.group_norm(*args)
    calls = gn.group_norm.calls
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(static.clone())
    torch.cuda.synchronize()
    assert gn.group_norm.calls == calls
    assert torch.equal(replays[0], replays[1])
    assert torch.equal(replays[0], got)
