"""Single-file inference on the GPU (port of the repository's ``predict.py``).

Usage::

    python -m aero_tpu_torch.predict experiment=aero_4-16_512_64 dset=4-16 \\
        +filename=<in.wav> +output=<dir> [checkpoint_file=<.atpu or .th>] \\
        [continue_best=true] [precision=bfloat16] [device=cuda|cpu] \\
        [batch_chunks=false] [+pad_tail_to_chunk=1] [+devices=[cuda:0,cuda:1]] \\
        [experiment.upsample=true experiment.aero.spec_upsample=false]

(``experiment=seanet_4-16`` serves Seanet the same way.)

Changes into the run directory ``outputs/<dset>/<experiment>/`` (as the
train CLI does) and loads the generator from ``checkpoint_file`` there
(default ``checkpoint.atpu``; an ``.atpu`` or a reference-format ``.th``;
its best state with ``continue_best``). Splits the input into 10 s chunks
(all full chunks as one batch unless ``batch_chunks=false``; the ragged
tail padded to a whole chunk with ``+pad_tail_to_chunk=1``), times the
prediction and writes ``<stem>_pr.wav``. The device is CUDA unless
``device=cpu`` is given; with no GPU present it raises rather than running
on the CPU. With several local GPUs, or a device list ``+devices=[...]``,
the batch of full chunks is split over one generator replica a device.
"""

from __future__ import annotations

import copy
import logging
import os
import sys
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from aero_tpu_torch.data import audio_io
from aero_tpu_torch.data.resample import resample_np
from aero_tpu_torch.eval.forward import ChunkedInference, EvalForward
from aero_tpu_torch.train.build import load_generator_state

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


def serving_devices(args, device: torch.device) -> tp.List[torch.device]:
    """The devices that serve the batch of full chunks: ``+devices`` when
    the config names them, every local GPU for a CUDA ``device`` without an
    index, else ``device`` alone."""
    if args.get("devices"):
        return [resolve_device(d) for d in args.devices]
    if device.type == "cuda" and device.index is None \
            and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _sync(devices):
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def write_wav(wav: np.ndarray, filename: str, sr: int) -> None:
    """Peak-normalise only when the peak exceeds 1, then save 16-bit PCM."""
    wav = np.asarray(wav)
    audio_io.save(filename, wav / max(float(np.abs(wav).max()), 1.0), sr)


def predict_file(gen: torch.nn.Module, filename: str, output_dir: str,
                 lr_sr: int, hr_sr: int, device, bucket_s: float = 1.0,
                 batch_chunks: bool = True, pad_tail: bool = False,
                 devices: tp.Sequence = (), upsample: bool = False) -> dict:
    """Upsample one WAV file with ``gen`` (on ``device``); returns the
    output path, sample counts, the timed seconds and the realtime factor.
    With ``upsample`` the file is first resampled to ``hr_sr`` on the host
    and ``gen`` runs at scale 1 (the repository's ``predict.py:70-76``; a
    generator with ``spec_upsample`` false keeps that length). With two or
    more ``devices`` (``device`` among them or not) a replica of ``gen`` on
    each serves its part of the batch of full chunks. One untimed run first
    warms both shapes (the batched chunks and the ragged tail); the timed
    run captures the CUDA graph of a shape that replays from one
    (``EvalForward``), and so times the capture."""
    device = torch.device(device)
    lr_sig, sr = audio_io.load(filename)
    if sr != lr_sr:
        raise ValueError(f"{filename}: sample rate {sr}, expected {lr_sr}")
    scale = hr_sr / lr_sr
    if upsample:
        lr_sig, sr, scale = resample_np(lr_sig, sr, hr_sr), hr_sr, 1.0

    def forward(model, on):
        return EvalForward(model, scale=scale, lr_sr=sr, device=on,
                           bucket_s=bucket_s)

    devices = [torch.device(d) for d in devices]
    replicas = [forward(gen if d == device else copy.deepcopy(gen).to(d), d)
                for d in devices] if len(devices) > 1 else []
    chunked = ChunkedInference(forward(gen, device), sr,
                               segment_s=SEGMENT_DURATION_SEC,
                               batch_chunks=batch_chunks, pad_tail=pad_tail,
                               scale=scale, replicas=replicas)
    used = [device, *devices]
    x = lr_sig[None]  # [1, C, T]
    chunked(x)
    _sync(used)
    start = time.perf_counter()
    pr = chunked(x)[0]
    _sync(used)
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
    """Returns ``predict_file``'s record; the working directory is restored
    on return."""
    from aero_tpu_torch.utils.config import (  # needs PyYAML
        load_config, run_dir_for)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = load_config(str(CONF_DIR), "main_config",
                       list(sys.argv[1:] if argv is None else argv))
    exp = args.experiment
    device = resolve_device(args.get("device"))
    devices = serving_devices(args, device)
    filename = os.path.abspath(str(args.filename))
    output_dir = os.path.abspath(str(args.output))
    cwd = os.getcwd()
    run_dir = run_dir_for(args)
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)
    try:
        gen = load_generator_state(args, devices[0])
        return predict_file(gen, filename, output_dir, int(exp.lr_sr),
                            int(exp.hr_sr), devices[0],
                            float(args.get("eval_bucket_s", 1.0)),
                            bool(args.get("batch_chunks", True)),
                            bool(args.get("pad_tail_to_chunk", False)),
                            devices, bool(exp.get("upsample", False)))
    finally:
        os.chdir(cwd)


if __name__ == "__main__":
    main()
