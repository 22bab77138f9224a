"""Measure the first-party ViSQOL scorer across a degradation x shift
matrix and print the JSON table recorded in native/VISQOL_DIVERGENCE.md
(the twin of ``tools/visqol_divergence_matrix.py``).

Usage: python -m aero_tpu_torch.tools.visqol_divergence_matrix
       [out=<tmp>/visqol_matrix.json]
Runs on the host: the scorer is ``native/bazel-bin/visqol``, called as
the port's ``eval/metrics.py`` calls it; the signals are synthesized.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

from aero_tpu_torch.data.prep import make_speech_like
from aero_tpu_torch.data.resample import resample_np
from aero_tpu_torch.eval import metrics

NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")


def run_visqol(ref, deg, sr=16000, speech=True):
    """The scorer's MOS of ``deg`` against ``ref`` ([1, n] at ``sr``):
    ``metrics.get_visqol`` on 16-bit wavs in a temporary directory. Raises
    where the scorer fails (the metric scores such a file 0)."""
    with tempfile.TemporaryDirectory() as td:
        mos = metrics.get_visqol(ref, deg, os.path.join(td, "m"), sr, speech,
                                 NATIVE)
    if mos == 0.0:
        raise RuntimeError(f"the ViSQOL scorer under {NATIVE} failed")
    return mos


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out = kv.get("out", os.path.join(tempfile.gettempdir(),
                                     "visqol_matrix.json"))
    sr = 16000
    rng = np.random.default_rng(7)
    sig = make_speech_like(sr, 3.0, seed=0)[None]

    def bandlimit(x, mid_sr):
        y = resample_np(x, sr, mid_sr)
        return resample_np(y, mid_sr, sr)[:, :x.shape[-1]]

    def noisy(x, snr_db):
        n = rng.standard_normal(x.shape).astype(np.float32)
        n *= np.sqrt((x ** 2).mean() / (n ** 2).mean() / 10 ** (snr_db / 10))
        return (x + n).astype(np.float32)

    def quantize(x, bits):
        q = 2.0 ** (bits - 1)
        return (np.round(np.clip(x, -1, 1) * q) / q).astype(np.float32)

    def shift(x, sec):
        if sec == 0:
            return x
        return np.concatenate(
            [np.zeros((1, int(sec * sr)), np.float32), x], axis=-1)

    degradations = {
        "identity": lambda x: x,
        "noise_snr20": lambda x: noisy(x, 20),
        "noise_snr10": lambda x: noisy(x, 10),
        "noise_snr0": lambda x: noisy(x, 0),
        "lowpass_8k": lambda x: bandlimit(x, 8000),
        "lowpass_4k": lambda x: bandlimit(x, 4000),
        "lowpass_2k": lambda x: bandlimit(x, 2000),
        "quant_6bit": lambda x: quantize(x, 6),
        "quant_4bit": lambda x: quantize(x, 4),
        "unrelated": lambda x: make_speech_like(sr, 3.0, seed=99)[None],
    }
    shifts = [0.0, 0.05, 0.13]

    matrix = {}
    for name, fn in degradations.items():
        row = {}
        deg = fn(sig)
        for sh in shifts:
            row[f"shift_{sh:g}s"] = round(run_visqol(sig, shift(deg, sh)), 3)
        matrix[name] = row
        print(f"{name:14s} " + "  ".join(
            f"{k}={v:.3f}" for k, v in row.items()), flush=True)

    with open(out, "w") as f:
        json.dump(matrix, f, indent=1)
    print(f"written: {out}")


if __name__ == "__main__":
    main()
