"""Offline dataset preparation: egs-json builders, resampling and synthetic
datasets (port of ``aero_tpu/data/prep.py``)."""

from __future__ import annotations

import json
import os
import typing as tp
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from aero_tpu_torch.data import audio_io
from aero_tpu_torch.data.resample import resample_np

# Fixed VCTK speaker split: of 108 speakers, the last 8 (sorted) are test.
N_TEST_SPEAKERS = 8


def scan_files(data_dir: str, pattern: str = "_mic1.wav") -> tp.List[str]:
    out = []
    for root, _dirs, files in os.walk(data_dir):
        for f in sorted(files):
            if f.endswith(pattern) or (pattern == "*" and f.endswith(".wav")):
                out.append(os.path.join(root, f))
    return sorted(out)


def build_meta(files: tp.Sequence[str], n_samples_limit: int = -1):
    """[(path, n_frames)] sorted by path."""
    if n_samples_limit > 0:
        files = list(files)[:n_samples_limit]
    with ThreadPoolExecutor(max_workers=8) as ex:
        metas = list(ex.map(
            lambda path: [path, audio_io.info(path).num_frames], files))
    return sorted(metas)


def create_meta_files(data_dir: str, out_dir: str, json_name: str,
                      pattern: str = "_mic1.wav", n_samples_limit: int = -1,
                      split_speakers: bool = True) -> None:
    """Scan ``data_dir`` and write tr/ and val/ ``{json_name}.json``."""
    files = scan_files(data_dir, pattern)
    if split_speakers:
        def speaker(f):
            return os.path.basename(os.path.dirname(f))

        speakers = sorted({speaker(f) for f in files})
        test = (set(speakers[-N_TEST_SPEAKERS:])
                if len(speakers) > N_TEST_SPEAKERS else set())
        tr = [f for f in files if speaker(f) not in test]
        val = [f for f in files if speaker(f) in test]
    else:
        n_val = max(1, len(files) // 10)
        tr, val = files[:-n_val], files[-n_val:]
    for split, split_files in (("tr", tr), ("val", val)):
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        meta = build_meta(split_files, n_samples_limit)
        with open(os.path.join(out_dir, split, f"{json_name}.json"), "w") as f:
            json.dump(meta, f, indent=2)


def resample_tree(in_dir: str, out_dir: str, target_sr: int,
                  pattern: str = ".wav") -> None:
    """Resample every ``pattern`` file of a directory tree into ``out_dir``."""
    for root, _dirs, files in os.walk(in_dir):
        dst_root = os.path.join(out_dir, os.path.relpath(root, in_dir))
        wavs = [f for f in files if f.endswith(pattern)]
        if wavs:
            os.makedirs(dst_root, exist_ok=True)
        for f in wavs:
            audio, sr = audio_io.load(os.path.join(root, f))
            audio_io.save(os.path.join(dst_root, f),
                          resample_np(audio, sr, target_sr), target_sr)


def make_speech_like(sr: int = 16000, duration: float = 3.0,
                     seed: int = 0) -> np.ndarray:
    """A broadband speech-like test signal, float32 [n]: voiced harmonics
    shaped by six random formants, a syllabic envelope with pauses, and
    fricative noise bursts. Every structure (pitch contour, formants,
    rhythm) comes from ``seed``, so two seeds give unrelated utterances.
    The ViSQOL calibration's signal (``tools/visqol_divergence_matrix.py``
    of this package); the same draws in the same order as
    ``aero_tpu.data.prep``'s, so the samples are equal bit for bit."""
    rng = np.random.default_rng(seed)
    n = int(sr * duration)
    t = np.arange(n) / sr
    f0_base = rng.uniform(90, 220)
    f0 = f0_base * (1 + 0.2 * np.sin(2 * np.pi * rng.uniform(0.4, 1.2) * t
                                     + rng.uniform(0, 6))
                    + 0.08 * np.sin(2 * np.pi * rng.uniform(1.8, 3.2) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    formants = [(rng.uniform(300, 800), 80), (rng.uniform(1000, 1900), 120),
                (rng.uniform(2200, 3000), 180), (rng.uniform(3200, 4200), 250),
                (rng.uniform(4800, 6000), 400), (rng.uniform(6500, 7600), 600)]
    voiced = np.zeros(n)
    for h in range(1, 90):
        fh = f0_base * h
        if fh > sr / 2 * 0.98:
            break
        w = sum(1.0 / ((fh - fc) ** 2 / bw ** 2 + 1) for fc, bw in formants)
        voiced += w * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    syl = rng.uniform(0.9, 1.6)
    env = np.clip(np.sin(2 * np.pi * syl * t + rng.uniform(0, 6)) + 0.55,
                  0, None) ** 1.5
    voiced *= env
    fric = np.diff(rng.standard_normal(n), prepend=0.0)
    fric_env = np.clip(np.sin(2 * np.pi * syl * t + np.pi) + 0.2, 0, None) ** 2
    sig = voiced / np.abs(voiced).max() \
        + 0.35 * fric * fric_env / np.abs(fric).max()
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def make_dummy_dataset(out_dir: str, lr_sr: int = 4000, hr_sr: int = 16000,
                       n_files: int = 8, duration: float = 2.5,
                       seed: int = 0) -> str:
    """A small synthetic LR/HR dataset (harmonics plus noise, each file
    ``duration`` s plus up to 0.25 s) and its egs jsons: the same files
    listed under ``tr/`` and ``val/``."""
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(os.path.join(wav_dir, "hr"), exist_ok=True)
    os.makedirs(os.path.join(wav_dir, "lr"), exist_ok=True)
    lr_meta, hr_meta = [], []
    for i in range(n_files):
        n = int(duration * hr_sr) + int(rng.integers(0, hr_sr // 4))
        t = np.arange(n) / hr_sr
        f0 = float(rng.uniform(100, 400))
        sig = np.zeros(n, dtype=np.float32)
        for h in range(1, 12):
            if f0 * h < hr_sr / 2:
                sig += (rng.uniform(0.05, 0.3) / h) * np.sin(
                    2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
        sig += 0.01 * rng.standard_normal(n).astype(np.float32)
        sig = (0.7 * sig / max(1e-9, np.abs(sig).max())).astype(np.float32)

        lr = resample_np(sig[None], hr_sr, lr_sr)[0]
        hr_path = os.path.join(wav_dir, "hr", f"p{i:03d}.wav")
        lr_path = os.path.join(wav_dir, "lr", f"p{i:03d}.wav")
        audio_io.save(hr_path, sig[None], hr_sr)
        audio_io.save(lr_path, lr[None], lr_sr)
        hr_meta.append([hr_path, n])
        lr_meta.append([lr_path, lr.shape[-1]])

    for split in ("tr", "val"):
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "hr.json"), "w") as f:
            json.dump(sorted(hr_meta), f)
        with open(os.path.join(d, "lr.json"), "w") as f:
            json.dump(sorted(lr_meta), f)
    return out_dir
