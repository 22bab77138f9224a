"""Single-file inference on the GPU (port of the repository's ``predict.py``).

Usage::

    python -m aero_tpu_torch.predict experiment=aero_4-16_512_64 dset=4-16 \\
        +filename=<in.wav> +output=<dir> checkpoint_file=<checkpoint.th> \\
        [precision=bfloat16] [device=cuda|cpu]

Loads the generator from a reference-format ``.th``, splits the input into
10 s chunks (all full chunks as one batch), times the prediction and writes
``<stem>_pr.wav``. The device is CUDA unless ``device=cpu`` is given; with
no GPU present it raises rather than running on the CPU.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from aero_tpu_torch.data import audio_io
from aero_tpu_torch.eval.forward import ChunkedInference, EvalForward
from aero_tpu_torch.models.factory import build_generator
from aero_tpu_torch.train.from_jax import load_reference_checkpoint

logger = logging.getLogger(__name__)

CONF_DIR = Path(__file__).resolve().parents[1] / "conf"
SEGMENT_DURATION_SEC = 10


def resolve_device(name) -> torch.device:
    """``cpu`` or ``cuda[:i]``; anything else (the shared config's ``tpu``
    default included) means CUDA. CUDA without a GPU raises."""
    name = str(name or "cuda")
    device = torch.device(name if name == "cpu" or name.startswith("cuda")
                          else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=cpu to run on the CPU")
    return device


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_wav(wav: np.ndarray, filename: str, sr: int) -> None:
    """Peak-normalise only when the peak exceeds 1, then save 16-bit PCM."""
    wav = np.asarray(wav)
    audio_io.save(filename, wav / max(float(np.abs(wav).max()), 1.0), sr)


def predict_file(gen: torch.nn.Module, filename: str, output_dir: str,
                 lr_sr: int, hr_sr: int, device) -> dict:
    """Upsample one WAV file with ``gen``; returns the output path, sample
    counts, the timed seconds and the realtime factor. One untimed run
    first warms both shapes (the batched chunks and the ragged tail)."""
    device = torch.device(device)
    lr_sig, sr = audio_io.load(filename)
    if sr != lr_sr:
        raise ValueError(f"{filename}: sample rate {sr}, expected {lr_sr}")
    scale = hr_sr / lr_sr
    fwd = EvalForward(gen, scale=scale, lr_sr=sr, device=device)
    chunked = ChunkedInference(fwd, sr, segment_s=SEGMENT_DURATION_SEC,
                               batch_chunks=True)
    x = lr_sig[None]  # [1, C, T]
    chunked(x)
    _sync(device)
    start = time.perf_counter()
    pr = chunked(x)[0]
    _sync(device)
    seconds = time.perf_counter() - start
    audio_sec = lr_sig.shape[-1] / sr
    out = os.path.join(output_dir, Path(filename).stem + "_pr.wav")
    os.makedirs(output_dir, exist_ok=True)
    write_wav(pr, out, hr_sr)
    logger.info("prediction %.3f s, realtime factor %.2fx, wrote %s",
                seconds, audio_sec / seconds, out)
    return {"path": out, "in_samples": int(lr_sig.shape[-1]),
            "out_samples": int(pr.shape[-1]), "seconds": seconds,
            "realtime_factor": audio_sec / seconds}


def main(argv=None) -> dict:
    from aero_tpu_torch.utils.config import load_config  # needs PyYAML

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = load_config(str(CONF_DIR), "main_config",
                       list(sys.argv[1:] if argv is None else argv))
    exp = args.experiment
    if exp.model != "aero":
        raise NotImplementedError(f"model {exp.model!r} is not ported")
    if exp.get("upsample", False):
        raise NotImplementedError("upsample=true datasets are not ported")
    device = resolve_device(args.get("device"))
    precision = str(args.get("precision", "float32") or "float32")
    gen = build_generator(exp.aero, precision, device)
    state, _ = load_reference_checkpoint(str(args.checkpoint_file))
    gen.load_state_dict(state, strict=True)
    return predict_file(gen, os.path.abspath(str(args.filename)),
                        os.path.abspath(str(args.output)), int(exp.lr_sr),
                        int(exp.hr_sr), device)


if __name__ == "__main__":
    main()
