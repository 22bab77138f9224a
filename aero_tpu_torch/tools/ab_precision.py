"""bf16-vs-f32 convergence A/B on the canonical config (the twin of
``tools/ab_precision.py``).

Trains the canonical aero_4-16_512_64 twice from the same seed on the
same synthetic dataset through ``python -m aero_tpu_torch.train``, once
precision=float32, once bfloat16, and compares the LSD/ViSQOL
trajectories from history.json. The port trains in bf16 by default
(bench, phase 7 of chip_smoke.py); this run is the evidence that bf16
training quality matches f32 (the reference trains f32 throughout).

Usage: python -m aero_tpu_torch.tools.ab_precision [epochs=40]
       [n_files=48] [out=<tmp>/ab_precision]
Runs both precisions one after the other on the GPU.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

from aero_tpu_torch.data.prep import make_dummy_dataset
from aero_tpu_torch.tools import _runs

PRECISIONS = ("float32", "bfloat16")


def train_argv(precision: str, epochs: int, egs: str) -> list:
    """The train CLI's command line of one arm of the A/B."""
    return _runs.TRAIN + [
        "experiment=aero_4-16_512_64", "dset=debug",
        f"dset.train={egs}/tr", f"dset.valid={egs}/val",
        f"dset.test={egs}/val",
        f"epochs={epochs}", "eval_every=10", "cross_valid=true",
        "cross_valid_every=2", "experiment.batch_size=8",
        f"precision={precision}", "seed=2036",
    ]


def summary(results: dict, epochs: int) -> None:
    print("\n=== A/B summary (valid loss | test LSD | test ViSQOL) ===")
    for ep in range(epochs):
        row = [f"epoch {ep:3d}"]
        for precision in PRECISIONS:
            h = results[precision][ep]
            row.append(
                f"{precision[:5]}:"
                f" v={h.get('evaluation_loss', float('nan')):.4f}"
                f" lsd={h.get('Average lsd', float('nan')):.3f}"
                f" vq={h.get('Average visqol', float('nan')):.3f}")
        print("  ".join(row), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    epochs = int(kv.get("epochs", 40))
    n_files = int(kv.get("n_files", 48))
    out = kv.get("out", os.path.join(tempfile.gettempdir(), "ab_precision"))

    egs = os.path.join(out, "egs")
    if not os.path.exists(os.path.join(egs, "tr")):
        make_dummy_dataset(egs, n_files=n_files, duration=3.0, seed=7)

    results = {}
    for precision in PRECISIONS:
        run_dir = os.path.join(out, precision)
        os.makedirs(run_dir, exist_ok=True)
        cmd = train_argv(precision, epochs, egs)
        print(f"=== {precision}: {' '.join(cmd)}", flush=True)
        r = _runs.run_train(cmd, run_dir, capture=True)
        sys.stdout.write(r.stdout[-3000:])
        sys.stderr.write(r.stderr[-3000:])
        if r.returncode != 0:
            print(f"{precision} FAILED rc={r.returncode}")
            return 1
        results[precision] = _runs.load_history(run_dir)[1]

    summary(results, epochs)
    with open(os.path.join(out, "ab_summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"\nwritten: {out}/ab_summary.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
