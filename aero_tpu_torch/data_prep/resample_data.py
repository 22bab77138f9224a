"""Offline dataset resampling (the twin of ``data_prep/resample_data.py``).

Resamples every wav under ``data_dir`` into ``target_dir`` (tree
preserved) at ``target_sr`` with the port's polyphase resampler
(``data/resample.py``, numpy on the host); no sox.

Usage:
    python -m aero_tpu_torch.data_prep.resample_data <data_dir> \\
        <target_dir> <target_sr>
"""

import argparse

from aero_tpu_torch.data.prep import resample_tree


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("data_dir")
    p.add_argument("target_dir")
    p.add_argument("target_sr", type=int)
    args = p.parse_args(argv)
    resample_tree(args.data_dir, args.target_dir, args.target_sr)


if __name__ == "__main__":
    main()
