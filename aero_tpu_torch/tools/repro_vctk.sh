#!/usr/bin/env bash
# One-command reproduction of the paper protocol on VCTK with the
# PyTorch/CUDA port (the twin of tools/repro_vctk.sh).
#
# Usage:
#   aero_tpu_torch/tools/repro_vctk.sh /path/to/VCTK/wav48 [OUT_DIR]  # real run
#   aero_tpu_torch/tools/repro_vctk.sh --dry-run [OUT_DIR]            # CI-testable
#
# Real run: resample wav48 -> 16 kHz (HR) and 4 kHz (LR); build egs
# jsons with the reference's 100-train/8-test speaker split; train the
# canonical aero_4-16_512_64 for 125 epochs on the GPU (python -m
# aero_tpu_torch.train; without a GPU it raises); run python -m
# aero_tpu_torch.test for the final LSD/ViSQOL.
#
# Dry run: synthesizes a VCTK-shaped tree (108 speakers, *_mic1.wav at
# 48 kHz), executes the resample + egs stages FOR REAL, asserts the
# 100/8 speaker split counts, then prints the train/test commands
# instead of running them. Covered by tests/test_torch_port_prep.py.
#
# PYTHON names the interpreter (default: python).
set -euo pipefail

REPO="$(cd "$(dirname "$0")/../.." && pwd)"
cd "$REPO"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
PY="${PYTHON:-python}"

DRY=0
if [[ "${1:-}" == "--dry-run" ]]; then
    DRY=1
    shift
    OUT="${1:-$(mktemp -d -t repro_vctk.XXXXXX)}"
    VCTK="$OUT/wav48_synth"
    echo "[repro] dry-run: synthesizing a VCTK-shaped tree at $VCTK"
    "$PY" - "$VCTK" <<'EOF'
import os
import sys

import numpy as np

from aero_tpu_torch.data import audio_io

root = sys.argv[1]
rng = np.random.default_rng(0)
sr = 48000
for s in range(108):
    d = os.path.join(root, f"p{225 + s}")
    os.makedirs(d, exist_ok=True)
    for u in range(2):
        n = int(0.25 * sr)
        sig = 0.1 * np.sin(2 * np.pi * rng.uniform(100, 300)
                           * np.arange(n) / sr).astype(np.float32)
        audio_io.save(os.path.join(d, f"p{225 + s}_{u:03d}_mic1.wav"),
                      sig[None, :], sr)
print("synthesized 108 speakers x 2 utterances")
EOF
else
    VCTK="${1:?usage: aero_tpu_torch/tools/repro_vctk.sh /path/to/VCTK/wav48 [OUT_DIR]}"
    OUT="${2:-outputs/repro_vctk}"
fi

HR_DIR="$OUT/wav/16000"
LR_DIR="$OUT/wav/4000"
EGS="$OUT/egs/vctk/4-16"

echo "[repro] 1/4 resample -> 16 kHz (HR) and 4 kHz (LR)"
"$PY" -m aero_tpu_torch.data_prep.resample_data "$VCTK" "$HR_DIR" 16000
"$PY" -m aero_tpu_torch.data_prep.resample_data "$VCTK" "$LR_DIR" 4000

echo "[repro] 2/4 egs metadata (100/8 speaker split)"
"$PY" -m aero_tpu_torch.data_prep.create_meta_files "$LR_DIR" "$EGS" lr
"$PY" -m aero_tpu_torch.data_prep.create_meta_files "$HR_DIR" "$EGS" hr

echo "[repro] 3/4 verify the reference split semantics"
"$PY" - "$EGS" <<'EOF'
import json
import os
import sys

egs = sys.argv[1]


def speakers(path):
    with open(path) as f:
        files = json.load(f)
    return {os.path.basename(os.path.dirname(p)) for p, _n in files}


def load(path):
    with open(path) as f:
        return json.load(f)


tr = speakers(os.path.join(egs, "tr", "lr.json"))
val = speakers(os.path.join(egs, "val", "lr.json"))
assert len(tr) == 100, f"train speakers {len(tr)} != 100"
assert len(val) == 8, f"test speakers {len(val)} != 8"
assert not tr & val, "speaker leakage between splits"
for name in ("lr", "hr"):
    a = load(os.path.join(egs, "tr", f"{name}.json"))
    b = load(os.path.join(egs, "val", f"{name}.json"))
    assert a == sorted(a) and b == sorted(b), "egs jsons must be sorted"
hr_tr = speakers(os.path.join(egs, "tr", "hr.json"))
assert hr_tr == tr, "lr/hr split mismatch"
print(f"split OK: {len(tr)} train / {len(val)} test speakers")
EOF

TRAIN_CMD=("$PY" -m aero_tpu_torch.train dset=4-16 experiment=aero_4-16_512_64
           "dset.train=$EGS/tr" "dset.test=$EGS/val"
           epochs=125 precision=bfloat16)
TEST_CMD=("$PY" -m aero_tpu_torch.test dset=4-16 experiment=aero_4-16_512_64
          "dset.train=$EGS/tr" "dset.test=$EGS/val")

echo "[repro] 4/4 canonical 125-epoch train + test"
if [[ "$DRY" == 1 ]]; then
    echo "[repro] dry-run: would execute:"
    echo "  ${TRAIN_CMD[*]}"
    echo "  ${TEST_CMD[*]}"
    echo "[repro] dry-run PASSED"
else
    "${TRAIN_CMD[@]}"
    "${TEST_CMD[@]}"
fi
