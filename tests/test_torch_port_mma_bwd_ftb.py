"""The dispatch rules and fragment layout of the tensor-core FTB tail and
attention backward, on the CPU.

bfloat16 calls on the card take ``csrc/ftb_mma.cu`` and
``csrc/local_attention_bwd_mma.cu``, float32 calls the SIMT kernels; the
rule is the dtype alone, and what no kernel takes raises. ``pack_ftb_mma``
lays [Ka; Kb]^T out as the mma.sync A fragments the FTB kernel holds in
registers: pinned here index by index, and by an emulation of the kernel's
product on those fragments (h * y rounded to bfloat16 once, float32 sums)
against the plain tail and against the JAX kernel in interpret mode. The
backward's one new rounding (p and ds to bfloat16 before their products)
is sized against the float32 formulas. The kernels themselves run on the
card only (chip_smoke.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from aero_tpu.ops import ftb as jftb
from aero_tpu_torch.ops import attention as pattn
from aero_tpu_torch.ops import ftb as pftb

pytestmark = pytest.mark.torch_port

BF16 = torch.bfloat16
FTB_TOL = 2.0 ** -6      # chip_smoke's bfloat16 tolerance, of max|plain|
BWD_TOL_BF16 = 2e-2      # chip_smoke's bfloat16 backward tolerance, of max


@pytest.fixture
def interpret_mode():
    old = jftb._INTERPRET
    jftb._INTERPRET = True
    yield
    jftb._INTERPRET = old


@pytest.mark.parametrize("c,c_out", [(48, 48), (96, 96), (192, 192),
                                     (24, 24), (100, 100), (24, 40)])
def test_ftb_route_by_dtype(c, c_out):
    assert pftb.route(BF16, c, c_out) == "mma"
    assert pftb.route(torch.float32, c, c_out) == "simt"


@pytest.mark.parametrize("dtype,c,c_out,error", [
    (BF16, 200, 48, ValueError), (BF16, 48, 208, ValueError),
    (torch.float32, 512, 64, ValueError), (torch.float16, 48, 48, TypeError)])
def test_ftb_route_raises_on_what_no_kernel_takes(dtype, c, c_out, error):
    with pytest.raises(error):
        pftb.route(dtype, c, c_out)


@pytest.mark.parametrize("c", pattn.KERNEL_WIDTHS)
def test_attention_backward_route_by_dtype(c):
    assert pattn.backward_route(BF16, c) == "mma"
    assert pattn.backward_route(torch.float32, c) == "simt"


@pytest.mark.parametrize("dtype,c,error", [
    (BF16, 6, ValueError), (torch.float32, 64, ValueError),
    (torch.float16, 12, TypeError)])
def test_attention_backward_route_raises(dtype, c, error):
    with pytest.raises(error):
        pattn.backward_route(dtype, c)


@pytest.mark.parametrize("c,c_out", [(24, 24), (100, 100), (24, 40)])
def test_packed_ftb_mma_layout(c, c_out):
    """pack_ftb_mma puts A[16 m + g + 8 (j % 2), 16 k + 2 q + 8 (j // 2) +
    e] at [m, lane = 4 g + q, k, j, e], with A[o, c] = Ka[c, o] and
    A[o, 16 KS + c] = Kb[c, o], zeros in the padding of C and C'."""
    ks, mt = -(-c // 16), -(-c_out // 16)
    ka = torch.arange(c * c_out, dtype=torch.float32).view(c, c_out) % 251
    kb = -(torch.arange(c * c_out, dtype=torch.float32).view(c, c_out) % 241)
    packed = pftb.pack_ftb_mma(ka, kb)          # exact in bfloat16
    assert packed.shape == (mt, 32, 2 * ks, 4, 2)
    assert packed.dtype == BF16 and packed.is_contiguous()

    def want(o, col):
        half, ch = divmod(col, 16 * ks)
        if o >= c_out or ch >= c:
            return 0.0
        return (kb if half else ka)[ch, o].item()
    for m, lane, k, j, e in [(0, 0, 0, 0, 0), (mt - 1, 31, 2 * ks - 1, 3, 1),
                             (0, 13, ks - 1, 1, 0), (mt - 1, 6, ks, 2, 1),
                             (1, 27, ks + 1, 3, 0)]:
        g, q = divmod(lane, 4)
        o = 16 * m + g + 8 * (j % 2)
        col = 16 * k + 2 * q + 8 * (j // 2) + e
        assert packed[m, lane, k, j, e].item() == want(o, col)


def _a_from_fragments(packed):
    """[MT, 32, 2 KS, 4, 2] fragments -> the A matrix [16 MT, 32 KS] they
    hold, by mma.m16n8k16's A layout: register j of lane (g, q) holds row
    g + 8 (j % 2), columns 2q + 8 (j // 2) + e of its k-step."""
    mt, _, k2, _, _ = packed.shape
    a = torch.full((16 * mt, 16 * k2), float("nan"))
    for lane in range(32):
        g, q = divmod(lane, 4)
        for j in range(4):
            for e in range(2):
                rows = 16 * torch.arange(mt)[:, None] + g + 8 * (j % 2)
                cols = (16 * torch.arange(k2)[None, :] + 2 * q + 8 * (j // 2)
                        + e)
                a[rows, cols] = packed[:, lane, :, j, e].float()
    assert not a.isnan().any()  # every entry of A comes from one register
    return a


def _emulated_ftb_mma(x, y, h, ka, kb, b2):
    """The kernel's product per (b, f) on the packed fragments: B's k-steps
    0..KS-1 hold bf16(h * y), KS..2KS-1 x, channels zero-padded; float32
    sums, b2, ReLU, bfloat16 out."""
    b, c, f, t = x.shape
    c_out = ka.shape[1]
    a = _a_from_fragments(pftb.pack_ftb_mma(ka, kb))    # [16 MT, 32 KS]
    kp = a.shape[1] // 2
    rhs = torch.zeros(b, 2 * kp, f, t)
    rhs[:, :c] = (y * h[:, :, None, :]).float()           # one rounding
    rhs[:, kp:kp + c] = x.float()
    acc = torch.einsum("ok,bkft->boft", a, rhs)
    assert not acc[:, c_out:].any()  # the padded rows of A are zero
    return torch.relu(acc[:, :c_out] + b2.float()[None, :, None, None]).to(
        BF16)


def _ftb_inputs(b, c, c_out, f, t, seed):
    rng = np.random.default_rng(seed)

    def bf(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape)).float() \
            .to(BF16)
    x, y = bf(b, c, f, t, scale=0.3), bf(b, c, f, t, scale=0.3)
    h = torch.relu(bf(b, c, t))
    ka, kb = bf(c, c_out, scale=c ** -0.5), bf(c, c_out, scale=c ** -0.5)
    b2 = torch.from_numpy(0.1 * rng.standard_normal(c_out)).float()
    return x, y, h, ka, kb, b2


@pytest.mark.parametrize("c,c_out,f,t", [(24, 24, 5, 37), (100, 100, 3, 29),
                                         (24, 40, 4, 33)])
def test_ftb_fragment_product_reproduces_the_tail(c, c_out, f, t):
    """The emulated kernel against ``reference_fused_tail`` in bfloat16 on
    the CPU: C = 24 and 100 pad K (to 32 and 112 a half) and M; the two
    differ only in the order of float32 sums, so by at most one rounding
    of the output (2^-7 relative), half the card's tolerance."""
    args = _ftb_inputs(2, c, c_out, f, t, seed=c + f)
    got = _emulated_ftb_mma(*args)
    want = pftb.reference_fused_tail(*args)
    assert got.shape == want.shape == (2, c_out, f, t)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -7 * want.float().abs().max().item()


def test_ftb_fragment_product_matches_jax_kernel(interpret_mode):
    """One small case against ``aero_tpu.ops.ftb.ftb_tail`` (its Pallas
    kernel in interpret mode), in bfloat16: the emulation takes the y of
    the JAX package's own frequency-mix einsum, and holds to the card's
    tolerance."""
    b, c, f, t = 2, 24, 16, 50
    x, _, h, ka, kb, b2 = _ftb_inputs(b, c, c, f, t, seed=7)
    w_freq = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (f, f)) / np.sqrt(f)).float().to(BF16)

    def j(a):  # torch bf16 -> jnp bf16 through float32 (exact)
        return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    xj = j(x.permute(0, 2, 3, 1))                    # [B, F, T, C]
    want = jftb.ftb_tail(xj, j(h.permute(0, 2, 1)), j(ka), j(kb), j(w_freq),
                         jnp.asarray(b2.numpy()))
    y = jnp.einsum("gf,bftc->bgtc", j(w_freq), xj)
    y = torch.from_numpy(np.array(y.astype(jnp.float32))).to(BF16)
    got = _emulated_ftb_mma(x, y.permute(0, 3, 1, 2).contiguous(), h, ka, kb,
                            b2)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    err = (got.permute(0, 2, 3, 1).float() - want).abs().max().item()
    assert err <= FTB_TOL * want.abs().max().item()


def _bwd(q, k, v, w, out, g, band, rounded):
    """``reference_attention_bwd``'s formulas in float32 in one block; with
    ``rounded``, p and ds go to bfloat16 before the products dv = p^T g,
    dq = ds k and dk = ds^T q, as mma.sync takes them (dw keeps the
    float32 ds)."""
    t = q.shape[1]
    wf = w.permute(0, 2, 1)
    t_idx = torch.arange(t, dtype=torch.float32)
    scores, delta, diag = pattn._scores(q, k, wf, t_idx, 0, t, band)
    p = torch.softmax(scores, dim=2)                           # [B, H, T, S]
    d_s = (out * g).sum(-1).permute(0, 2, 1)                   # [B, H, S]
    ds = (p * (torch.einsum("bthc,bshc->bhts", v, g) - d_s[:, :, None, :])
          ).masked_fill(diag, 0.0)
    dw = -(ds * delta).sum(2).permute(0, 2, 1)

    def r(a):
        return a.to(BF16).float() if rounded else a
    return (torch.einsum("bhts,bthc->bshc", r(ds), k),
            torch.einsum("bhts,bshc->bthc", r(ds), q),
            torch.einsum("bhts,bshc->bthc", r(p), g), dw)


@pytest.mark.parametrize("c,band", [(12, 0), (24, 0), (12, 16)])
def test_backward_bf16_rounding_is_well_inside_tolerance(c, band):
    """The new rounding alone, on bfloat16-valued inputs: the emulation
    matches ``reference_attention_bwd`` unrounded, and rounding p and ds
    moves each gradient by under a quarter of the card's 2e-2 of its max
    (up to 3.5e-3 at these shapes and at T 501)."""
    rng = np.random.default_rng(c + band)
    b, t, h = 2, 97, 2

    def bf(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape)).float() \
            .to(BF16).float()
    q, k, v, g = bf(b, t, h, c, scale=c ** -0.5), bf(b, t, h, c), \
        bf(b, t, h, c), bf(b, t, h, c)
    w = 10.0 ** (-4.0 + 3.0 * torch.from_numpy(rng.random((b, t, h)))).float()
    if band:
        out = pattn.banded_reference_attention(q, k, v, w, band)
    else:
        out = pattn.reference_attention(q, k, v, w)
    exact = _bwd(q, k, v, w, out, g, band, rounded=False)
    want = pattn.reference_attention_bwd(q, k, v, w, out, g, band=band)
    rounded = _bwd(q, k, v, w, out, g, band, rounded=True)
    for e, ref, r in zip(exact, want, rounded):
        scale = ref.abs().max().item()
        assert (e - ref).abs().max().item() <= 1e-5 * scale
        assert (r - ref).abs().max().item() <= 0.25 * BWD_TOL_BF16 * scale
