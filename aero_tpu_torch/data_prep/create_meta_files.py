"""Build egs metadata jsons (the twin of ``data_prep/create_meta_files.py``).

Scans a dataset tree for ``*_mic1.wav`` (VCTK convention), splits 100
train / 8 test speakers, writes sorted [(path, n_frames)] jsons to
``<out>/tr/<name>.json`` and ``<out>/val/<name>.json``. Runs on the host.

Usage:
    python -m aero_tpu_torch.data_prep.create_meta_files <data_dir> \\
        <out_dir> <json_name> [--pattern _mic1.wav] [--n_samples_limit N] \\
        [--no-speaker-split]
"""

import argparse

from aero_tpu_torch.data.prep import create_meta_files


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("data_dir")
    p.add_argument("target_dir")
    p.add_argument("json_name", help="lr or hr")
    p.add_argument("--pattern", default="_mic1.wav")
    p.add_argument("--n_samples_limit", type=int, default=-1)
    p.add_argument("--no-speaker-split", action="store_true")
    args = p.parse_args(argv)
    create_meta_files(args.data_dir, args.target_dir, args.json_name,
                      pattern=args.pattern,
                      n_samples_limit=args.n_samples_limit,
                      split_speakers=not args.no_speaker_split)


if __name__ == "__main__":
    main()
