"""Inference and artifact saving (port of ``aero_tpu/eval/enhance.py``):
clip-safe wav writes, the ``_lr/_hr/_pr.wav`` triple, log-power heatmap
PNGs, and a sweep that enhances a whole loader."""

from __future__ import annotations

import logging
import os

import numpy as np

from aero_tpu_torch.data import audio_io
from aero_tpu_torch.utils.log import LogProgress
from aero_tpu_torch.utils.viz import save_heatmap_png

logger = logging.getLogger(__name__)


def write(wav: np.ndarray, filename: str, sr: int) -> None:
    """Peak-normalise only when the peak exceeds 1, then save 16-bit PCM."""
    wav = np.asarray(wav)
    audio_io.save(filename, wav / max(float(np.abs(wav).max()), 1.0), sr)


def save_wavs(processed_sigs, lr_sigs, hr_sigs, filenames, lr_sr, hr_sr):
    for lr, hr, pr, filename in zip(lr_sigs, hr_sigs, processed_sigs,
                                    filenames):
        write(lr, filename + "_lr.wav", sr=lr_sr)
        write(hr, filename + "_hr.wav", sr=hr_sr)
        write(pr, filename + "_pr.wav", sr=hr_sr)


def _log_power(spec: np.ndarray) -> np.ndarray:
    return np.log2(np.maximum(np.abs(spec) ** 2, 1e-12))


def save_specs(lr_spec, pr_spec, hr_spec, filename):
    """``_lr/_pr/_hr_spec.png`` heatmaps of complex spectra [C, F, T]; the lr
    and hr ones only where they do not exist yet."""
    for spec, kind in ((lr_spec, "lr"), (hr_spec, "hr")):
        path = f"{filename}_{kind}_spec.png"
        if spec is not None and not os.path.isfile(path):
            save_heatmap_png(_log_power(np.asarray(spec))[0], path)
    save_heatmap_png(_log_power(np.asarray(pr_spec))[0],
                     filename + "_pr_spec.png")


def enhance(dataloader, forward_fn, args):
    """Sweep a loader of ((lr, lr_paths), (hr, hr_paths)) and save each
    file's triple; ``forward_fn(lr)`` maps [B, 1, T] to [B, 1, T*scale].
    Returns the stems written."""
    os.makedirs(args.samples_dir, exist_ok=True)
    exp = args.experiment
    lr_sr = exp.hr_sr if exp.get("upsample") else exp.lr_sr
    total_filenames = []
    limit = int(args.get("enhance_samples_limit", -1))
    iterator = LogProgress(logger, dataloader, name="Generate enhanced files")
    for i, ((lr_sigs, lr_paths), (hr_sigs, _hr_paths)) in enumerate(iterator):
        names = [os.path.basename(p).rsplit(".", 1)[0] for p in lr_paths]
        total_filenames += names
        estimates = np.asarray(forward_fn(lr_sigs))
        save_wavs(estimates, lr_sigs, hr_sigs,
                  [os.path.join(args.samples_dir, n) for n in names],
                  lr_sr, exp.hr_sr)
        if i == limit:
            break
    return total_filenames
