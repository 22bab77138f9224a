"""Measure how LOCAL a checkpoint's LocalState attention is (the twin of
``tools/attn_band_probe.py``).

Decides whether the banded attention kernel (``AERO_ATTN_BAND=W``: scores
only for |t - s| <= W) can replace the exact one on this checkpoint
without changing results beyond rounding.

Method: load a checkpoint, run the generator forward on an eval-length
input under ``ops.attention.recording`` (each LocalState call's
(queries, keys, content, decay_w)), then for every attention site compute
the DENSE exact softmax (float32, numpy) and report, per band half-width
W:

  - tail_mass: max over (batch, head, query) of the softmax probability
    mass OUTSIDE the band, the quantity a banded kernel drops;
  - out_rel:   max relative L2 error of the banded output vs exact, per
    query row (the effect on the attention result).

Also prints the per-head decay-slope stats (the smallest slope bounds the
worst-case tail: mass beyond W scales like exp(-w_min * W) relative).

Usage:
  python -m aero_tpu_torch.tools.attn_band_probe checkpoint=<.atpu or .th> \\
      [duration=10] [widths=32,64,128,256,512] [device=cpu]

The forward runs in float32 on the GPU unless ``device=cpu`` is given (no
GPU and no ``device=cpu``: it raises); the report runs on the host (dense
T^2 in float32: about 0.8 GB an array at T 2501 for enc2's 8 rows).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from aero_tpu_torch.models.modules import LocalState
from aero_tpu_torch.ops import attention
from aero_tpu_torch.predict import CONF_DIR, resolve_device
from aero_tpu_torch.train.build import load_generator_state
from aero_tpu_torch.utils.config import load_config


def _kv(argv):
    out = {}
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            out[k] = v
    return out


def band_report(q, k, v, w, widths, tag):
    """q/k/v: [B, T, H, C] f32; w: [B, T, H] (per-query decay slope)."""
    b, t, h, c = q.shape
    scores = np.einsum("bthc,bshc->bhts", k, q,
                       optimize=True).astype(np.float32)
    idx = np.arange(t)
    delta = np.abs(idx[:, None] - idx[None, :]).astype(np.float32)  # [t, s]
    scores -= delta[None, None] * w.transpose(0, 2, 1)[:, :, None, :].astype(
        np.float32)
    np.einsum("bhtt->bht", scores)[...] = -100.0  # self mask (diag view)
    scores -= scores.max(axis=2, keepdims=True)
    p = np.exp(scores)
    p /= p.sum(axis=2, keepdims=True)  # softmax over keys t
    out_exact = np.einsum("bhts,bthc->bshc", p, v, optimize=True)
    norm = np.linalg.norm(out_exact, axis=-1)  # [b, s, h]
    print(f"\n{tag}: B={b} T={t} H={h} C'={c}")
    wmin = w.min(axis=(0, 1))
    wmed = np.median(w, axis=(0, 1))
    print("  decay slope per head: min", np.array2string(wmin, precision=4),
          " median", np.array2string(wmed, precision=4))
    rows = []
    for W in widths:
        inband = (delta <= W)[None, None]  # [1,1,t,s]
        pb = np.where(inband, p, 0.0)
        pb_sum = pb.sum(axis=2, keepdims=True)
        tail = 1.0 - pb_sum[:, :, 0]  # [b,h,s]
        pb = pb / np.maximum(pb_sum, 1e-30)
        out_band = np.einsum("bhts,bthc->bshc", pb, v, optimize=True)
        rel = (np.linalg.norm(out_band - out_exact, axis=-1)
               / np.maximum(norm, 1e-12))
        rows.append((W, tail.max(), float(np.quantile(tail, 0.999)),
                     rel.max(), float(np.quantile(rel, 0.999))))
    print("     W   tail_max   tail_p999   out_rel_max  out_rel_p999")
    for W, tm, tq, rm, rq in rows:
        print(f"  {W:>4}   {tm:.3e}  {tq:.3e}   {rm:.3e}    {rq:.3e}")
    return rows


def probe_input(sr: int, duration: float) -> np.ndarray:
    """[1, 1, n] float32: the JAX probe's eval-length input, the synthetic
    family its checkpoints train on (harmonics plus noise), same draws."""
    rng = np.random.default_rng(0)
    n = int(duration * sr)
    tt = np.arange(n) / sr
    f0 = 110 * 2 ** rng.uniform(0, 1)
    x = np.zeros(n)
    for hnum in range(1, 12):
        x += rng.uniform(0.05, 1.0) / hnum * np.sin(
            2 * np.pi * f0 * hnum * tt + rng.uniform(0, 2 * np.pi))
    x += 0.01 * rng.standard_normal(n)
    return (0.2 * x / np.abs(x).max()).astype(np.float32)[None, None]


def capture(gen: torch.nn.Module, x: np.ndarray):
    """(output, sites) of one inference forward of ``gen`` on ``x``: sites
    [(name, (q, k, v, w))] in call order, the tensors on ``gen``'s device,
    each named by its LocalState module (each runs once a forward, in the
    order the modules are declared)."""
    device = next(gen.parameters()).device
    with torch.no_grad(), attention.recording() as calls:
        out = gen(torch.from_numpy(x).to(device))
    names = [n for n, m in gen.named_modules()
             if isinstance(m, LocalState) and not m.nfreqs]
    if len(names) != len(calls):
        raise RuntimeError(f"{len(calls)} attention calls from "
                           f"{len(names)} LocalState modules")
    return out, list(zip(names, calls))


def numpy_site(site):
    """(q, k, v, w) tensors -> float32 numpy arrays on the host."""
    return tuple(a.detach().float().cpu().numpy() for a in site)


def report(sites, widths):
    """``band_report`` of every (name, (q, k, v, w)) site, then the worst
    over all sites per W, printed; returns ({name: rows}, {W: (tail_max,
    out_rel_max)})."""
    per_site, worst = {}, {}
    for name, site in sites:
        q, k, v, w = numpy_site(site)
        rows = band_report(q, k, v, w, widths, name)
        per_site[name] = rows
        for W, tm, _, rm, _ in rows:
            a, b_ = worst.get(W, (0.0, 0.0))
            worst[W] = (max(a, tm), max(b_, rm))

    print("\n== overall worst over all attention sites ==")
    print("     W   tail_max   out_rel_max")
    for W in widths:
        tm, rm = worst[W]
        print(f"  {W:>4}   {tm:.3e}   {rm:.3e}")
    return per_site, worst


def probe(checkpoint: str, duration: float = 10.0,
          widths=(32, 64, 128, 256, 512), device="cuda"):
    """The canonical generator of ``checkpoint`` in float32 on ``device``,
    its forward on ``probe_input`` and the printed report; returns (sites,
    per_site rows, worst)."""
    args = load_config(str(CONF_DIR), "main_config", [
        "experiment=aero_4-16_512_64", "dset=debug",
        f"checkpoint_file={checkpoint}", "precision=float32",
    ])
    gen = load_generator_state(args, device)
    x = probe_input(int(args.experiment.lr_sr), duration)
    out, sites = capture(gen, x)
    print(f"forward ok: in {x.shape} -> out {tuple(out.shape)} on {device}")
    return (sites, *report(sites, list(widths)))


def main(argv=None):
    kv = _kv(sys.argv[1:] if argv is None else argv)
    ckpt = kv.get("checkpoint")
    if not ckpt or not os.path.exists(ckpt):
        raise FileNotFoundError(f"checkpoint not found: {ckpt}")
    widths = [int(x) for x in kv.get("widths", "32,64,128,256,512").split(",")]
    probe(ckpt, float(kv.get("duration", "10")), widths,
          resolve_device(kv.get("device")))


if __name__ == "__main__":
    main()
