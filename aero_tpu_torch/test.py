"""Test-set evaluation CLI of the port, the twin of the repository's
``test.py``.

Usage::

    python -m aero_tpu_torch.test experiment=aero_4-16_512_64 dset=4-16 \\
        dset.test=<egs dir> [checkpoint_file=<.atpu or .th>] \\
        [continue_best=true] [precision=bfloat16] [device=cuda|cpu]

Changes into the run directory ``outputs/<dset>/<experiment>/``, loads the
generator from ``checkpoint_file`` there (its best state with
``continue_best``), enhances and scores every test file (LSD, and ViSQOL
unless ``visqol=false``), writes the ``_lr/_hr/_pr`` samples and the
averages to ``test_results_file``. CUDA unless ``device=cpu``.

Under torchrun's variables each rank joins their group, scores its strided
shard of the test files, and the averages span every rank's scores; rank
0 alone logs them and writes ``test_results_file``.
"""

from __future__ import annotations

import json
import logging
import os
import sys

from aero_tpu_torch.eval import metrics as eval_metrics
from aero_tpu_torch.eval.evaluate import evaluate
from aero_tpu_torch.eval.forward import EvalForward, make_spec_fns
from aero_tpu_torch.parallel import mesh
from aero_tpu_torch.predict import CONF_DIR, resolve_device
from aero_tpu_torch.train.__main__ import (
    absolute_dset_paths, eval_loader, join_group)
from aero_tpu_torch.train.build import load_generator_state
from aero_tpu_torch.utils.log import bold, setup_logging

logger = logging.getLogger(__name__)


def run(args, device) -> dict:
    exp = args.experiment
    upsample = bool(exp.get("upsample", False))
    gen = load_generator_state(args, device)
    fwd = EvalForward(gen, scale=1.0 if upsample else exp.hr_sr / exp.lr_sr,
                      lr_sr=int(exp.hr_sr if upsample else exp.lr_sr),
                      device=device,
                      bucket_s=float(args.get("eval_bucket_s", 1.0)),
                      return_spec=exp.model == "aero")
    lsd, visqol, files = evaluate(args, eval_loader(args, args.dset.test, True),
                                  0, fwd, spec_fns=make_spec_fns(args, gen))
    _, n_files = mesh.global_weighted_average([], len(files))
    results = {"lsd": lsd, "visqol": visqol, "n_files": n_files,
               "checkpoint_file": str(args.checkpoint_file)}
    if visqol:
        results["visqol_scorer"] = eval_metrics.visqol_scorer_version(
            args.get("visqol_path") or eval_metrics.default_visqol_path()
        ) or "unknown"
    if mesh.rank() == 0:
        logger.info("Done evaluation.")
        logger.info(bold(f"LSD={lsd} , VISQOL={visqol}"))
        if visqol:
            logger.info(f"ViSQOL scorer: {results['visqol_scorer']} (MOS "
                        "comparable only within one scorer stamp)")
        with open(str(args.test_results_file), "w") as f:
            json.dump(results, f, indent=2)
    return results


def main(argv=None) -> dict:
    """Returns the results; the working directory is restored on return."""
    from aero_tpu_torch.utils.config import load_config, run_dir_for

    args = load_config(str(CONF_DIR), "main_config",
                       list(sys.argv[1:] if argv is None else argv))
    absolute_dset_paths(args)
    device = resolve_device(args.get("device"))
    cwd = os.getcwd()
    run_dir = run_dir_for(args)
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)
    try:
        setup_logging(bool(args.verbose))
        return run(args, join_group(args, device))
    finally:
        mesh.destroy()
        os.chdir(cwd)


if __name__ == "__main__":
    main()
