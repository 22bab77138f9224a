"""Quality metrics: LSD and ViSQOL (port of ``aero_tpu/eval/metrics.py``).

- LSD: log-spectral distance on STFT(2048, hop 512, Hann) log10 power,
  RMS over frequency, then the mean, in numpy on the host.
- ViSQOL: the repository's scorer CLI ``native/bazel-bin/visqol`` (or the
  one under ``visqol_path``) as a subprocess, on 16-bit wavs resampled to
  16 kHz (speech) or 48 kHz (audio); the last tab-separated field of its
  output is the MOS. Any failure scores 0, which the averages exclude.
"""

from __future__ import annotations

import logging
import os
import subprocess

import numpy as np

from aero_tpu_torch.data import audio_io
from aero_tpu_torch.data.resample import resample_np
from aero_tpu_torch.utils.hoststft import stft_frames_np

logger = logging.getLogger(__name__)

VISQOL_MIN_DURATION = 0.48

# Version stamp of the scorer's last successful run in this process. MOS
# values are comparable only within one stamp; the Solver writes it beside
# every history entry that carries a ViSQOL value.
_scorer_version: str | None = None


def visqol_scorer_version(visqol_path: str | None = None) -> str | None:
    """The stamp of the last successful run; before any run, the scorer's
    answer to ``--version`` when ``visqol_path`` is given."""
    global _scorer_version
    if _scorer_version is None and visqol_path:
        _scorer_version = probe_scorer_version(visqol_path)
    return _scorer_version


def probe_scorer_version(visqol_path: str) -> str:
    """``VISQOL-COMPAT:`` stamp of ``--version``; ``external`` for a scorer
    that runs and prints none; ``unknown`` for one that cannot run."""
    try:
        proc = subprocess.run(
            [os.path.join(visqol_path, "bazel-bin", "visqol"), "--version"],
            cwd=visqol_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            timeout=30)
        return _parse_scorer_version(proc.stdout.decode("utf-8"))
    except Exception:  # noqa: BLE001 - probing never breaks an evaluation
        return "unknown"


def _parse_scorer_version(stdout: str) -> str:
    for line in stdout.splitlines():
        if line.startswith("VISQOL-COMPAT:"):
            return line.split(":", 1)[1].strip()
    return "external"


def stft_mag_np(x: np.ndarray, nfft: int = 2048, hop: int = 512) -> np.ndarray:
    """|STFT| [B, F, frames]: Hann(nfft), center-reflect, not normalised."""
    z = stft_frames_np(np.atleast_2d(np.asarray(x, np.float32)), nfft, hop)
    return np.abs(z).swapaxes(-1, -2)


def get_lsd(ref_sig: np.ndarray, out_sig: np.ndarray) -> float:
    """ref/out: [B, T]."""
    sp = np.log10(np.maximum(stft_mag_np(ref_sig) ** 2, 1e-8))
    st = np.log10(np.maximum(stft_mag_np(out_sig) ** 2, 1e-8))
    return float(np.mean(np.sqrt(np.mean((sp - st) ** 2, axis=1))))


def get_visqol(ref_sig: np.ndarray, out_sig: np.ndarray, filename: str,
               sr: int, speech_mode: bool, visqol_path: str) -> float:
    """Writes ``<filename>_ref.wav`` and ``_est.wav`` (16-bit) in the
    working directory, runs the scorer from ``visqol_path`` and parses the
    trailing float of its output; 0 on any failure. The temporary wavs
    are removed in every case."""
    global _scorer_version
    tmp_reference = os.path.abspath(f"{filename}_ref.wav")
    tmp_estimation = os.path.abspath(f"{filename}_est.wav")
    target_sr = 16000 if speech_mode else 48000
    try:
        ref = np.atleast_2d(ref_sig)
        out = np.atleast_2d(out_sig)
        if sr != target_sr:
            ref = resample_np(ref, sr, target_sr)
            out = resample_np(out, sr, target_sr)
        audio_io.save(tmp_reference, ref, target_sr, bits_per_sample=16)
        audio_io.save(tmp_estimation, out, target_sr, bits_per_sample=16)
        if min(ref.shape[-1], out.shape[-1]) / target_sr < VISQOL_MIN_DURATION:
            raise ValueError("File duration is too small.")
        argv = [os.path.join(visqol_path, "bazel-bin", "visqol"),
                "--reference_file", tmp_reference,
                "--degraded_file", tmp_estimation]
        if speech_mode:
            argv.append("--use_speech_mode")
        proc = subprocess.run(argv, cwd=visqol_path, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
        stdout = proc.stdout.decode("utf-8")
        visqol = float(stdout.split("\t")[-1].replace("\n", ""))
        _scorer_version = _parse_scorer_version(stdout)
    except Exception as e:  # noqa: BLE001 - any failure scores 0
        logger.info(f"failed to get visqol of {filename}: {e}")
        return 0.0
    finally:
        for tmp in (tmp_reference, tmp_estimation):
            if os.path.exists(tmp):
                os.remove(tmp)
    return visqol


def run_metrics(clean: np.ndarray, estimate: np.ndarray, args, filename: str):
    """clean/estimate: [B, 1, T] or [B, T]. Returns (lsd, visqol); visqol is
    0 unless ``args.visqol`` is set and a scorer is found."""
    hr_sr = args.experiment.hr_sr if "experiment" in args else args.hr_sr
    exp = args.get("experiment", args)
    speech_mode = bool(exp.get("speech_mode", True))
    clean = np.asarray(clean)
    estimate = np.asarray(estimate)
    if clean.ndim == 3:
        clean = clean[:, 0, :]
    if estimate.ndim == 3:
        estimate = estimate[:, 0, :]
    lsd = get_lsd(clean, estimate)
    visqol_path = args.get("visqol_path") or default_visqol_path()
    visqol = 0.0
    if bool(args.get("visqol")) and visqol_path:
        visqol = get_visqol(clean, estimate, filename, int(hr_sr),
                            speech_mode, str(visqol_path))
    return lsd, visqol


def default_visqol_path() -> str | None:
    """``native/`` of this repository when it holds ``bazel-bin/visqol``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    native = os.path.join(root, "native")
    if os.path.exists(os.path.join(native, "bazel-bin", "visqol")):
        return native
    return None
