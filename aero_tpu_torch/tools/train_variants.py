"""Trained trajectories for the non-4->16 ratios (the twin of
``tools/train_variants.py``).

Runs the canonical synthetic quality protocol (48-file dummy set of 3 s,
seed 2036, bf16, B=16) through ``python -m aero_tpu_torch.train`` at:

- ``8-24``  — scale 3, the fractional-analysis-hop case (lr STFT hop
  64//3, window 512//3);
- ``11-44`` — music mode (11.025 -> 44.1 kHz, speech_mode=false,
  audio-mode ViSQOL), with the HiFi MPD+MSD discriminator pair so a
  trained trajectory also covers the HiFi loss family.

Usage: python -m aero_tpu_torch.tools.train_variants [which=8-24,11-44]
       [epochs=125] [out=<tmp>/variants]
Runs the variants one after the other on the GPU; each run's history.json
holds its results, and the trailing table summarizes them. Exits 1 if a
run failed.
"""

from __future__ import annotations

import os
import sys
import tempfile

from aero_tpu_torch.data.prep import make_dummy_dataset
from aero_tpu_torch.tools import _runs

VARIANTS = {
    "8-24": dict(
        experiment="aero_8-24_512_64", lr_sr=8000, hr_sr=24000, extra=[]),
    "11-44": dict(
        experiment="aero_11-44_512_64", lr_sr=11025, hr_sr=44100,
        # The JAX package chose accum_steps=4 for a 15.75 GB chip, where
        # B=16 at 44.1 kHz with MPD+MSD needed 30.0 GB. The port keeps it:
        # 4 microbatches of 4 take the same global-batch step as one of 16
        # (train_step.TrainStep), so both packages' trajectories compare.
        extra=["experiment.discriminator_models=[mpd,msd_hifi]",
               "accum_steps=4"]),
}


def train_argv(name: str, epochs: int, egs: str) -> list:
    """The train CLI's command line of variant ``name`` on the egs in
    ``egs``."""
    spec = VARIANTS[name]
    return _runs.TRAIN + [
        f"experiment={spec['experiment']}", "dset=debug",
        f"dset.train={egs}/tr", f"dset.valid={egs}/val",
        f"dset.test={egs}/val",
        f"epochs={epochs}", "eval_every=25", "cross_valid=true",
        "cross_valid_every=5", "experiment.batch_size=16",
        "precision=bfloat16", "seed=2036", "visqol=true",
    ] + spec["extra"]


def run_variant(name: str, epochs: int, out: str) -> dict:
    """Train variant ``name`` in ``out/<name>/run`` (its dataset in
    ``out/<name>/egs``, made once); {"history", "path"}, or {} if the run
    failed."""
    spec = VARIANTS[name]
    egs = os.path.join(out, name, "egs")
    if not os.path.exists(os.path.join(egs, "tr")):
        make_dummy_dataset(egs, lr_sr=spec["lr_sr"], hr_sr=spec["hr_sr"],
                           n_files=48, duration=3.0, seed=7)

    run_dir = os.path.join(out, name, "run")
    os.makedirs(run_dir, exist_ok=True)
    cmd = train_argv(name, epochs, egs)
    print(f"=== {name}: {' '.join(cmd)}", flush=True)
    r = _runs.run_train(cmd, run_dir)
    if r.returncode != 0:
        print(f"{name} FAILED rc={r.returncode}", flush=True)
        return {}
    path, history = _runs.load_history(run_dir)
    return {"history": history, "path": path}


def summary(results: dict) -> None:
    print("\n=== trajectories (epoch: valid | LSD | ViSQOL) ===")
    for name, res in results.items():
        if not res:
            continue
        print(f"--- {name} ({res['path']})")
        for ep, h in enumerate(res["history"]):
            lsd = h.get("Average lsd")
            if lsd is None and "evaluation_loss" not in h and ep % 5:
                continue
            print(f"  ep{ep + 1:3d}: "
                  f"v={h.get('evaluation_loss', float('nan')):.4f} "
                  f"lsd={h.get('Average lsd', float('nan')):.3f} "
                  f"vq={h.get('Average visqol', float('nan')):.3f}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    which = kv.get("which", "8-24,11-44").split(",")
    epochs = int(kv.get("epochs", 125))
    out = kv.get("out", os.path.join(tempfile.gettempdir(), "variants"))

    results = {}
    for name in which:
        results[name] = run_variant(name, epochs, out)
    summary(results)
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
