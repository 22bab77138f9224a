"""Joint evaluate + enhance over a test loader (port of
``aero_tpu/eval/evaluate.py``).

Per file: the generator forward (with its spectra for Aero), LSD and
ViSQOL, the wandb media, and the ``_lr/_hr/_pr`` wav and PNG artifacts.
Zero scores are left out of the averages. Under a ``torch.distributed``
group each rank scores its shard of the files and the averages are taken
over every rank's scores (``parallel.mesh.global_weighted_average``; a
rank with no files joins with count 0), so every rank returns the same.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor

from aero_tpu_torch.data.datasets import match_signal
from aero_tpu_torch.eval.enhance import save_specs, save_wavs
from aero_tpu_torch.eval.metrics import run_metrics
from aero_tpu_torch.parallel.mesh import global_weighted_average
from aero_tpu_torch.utils import wandb_logger
from aero_tpu_torch.utils.log import LogProgress, bold

logger = logging.getLogger(__name__)


class _Scores:
    """Running LSD and ViSQOL sums; a zero score counts in no average."""

    def __init__(self):
        self.lsd = self.visqol = 0.0
        self.lsd_count = self.visqol_count = self.total = 0

    def add(self, lsd, visqol):
        self.lsd += lsd
        self.visqol += visqol
        self.lsd_count += lsd != 0
        self.visqol_count += visqol != 0
        self.total += 1

    def averages(self):
        return (self.lsd / self.lsd_count if self.lsd_count else 0.0,
                self.visqol / self.visqol_count if self.visqol_count else 0.0)

    def global_averages(self):
        """``averages`` over every rank's nonzero scores."""
        lsd, visqol = self.averages()
        (lsd,), _ = global_weighted_average([lsd], self.lsd_count)
        (visqol,), _ = global_weighted_average([visqol], self.visqol_count)
        return lsd, visqol

    def summary(self):
        lsd, visqol = self.averages()
        return (f"LSD={lsd} ({self.lsd_count}/{self.total}), "
                f"VISQOL={visqol} ({self.visqol_count}/{self.total}).")


def _n_files_to_log(args) -> int:
    return int(args.wandb.get("n_files_to_log", 10)) if "wandb" in args \
        else -1


def _lr_sr(args) -> int:
    exp = args.experiment
    return exp.hr_sr if exp.get("upsample") else exp.lr_sr


def evaluate(args, data_loader, epoch, eval_forward, spec_fns=None):
    """Returns (avg_lsd, avg_visqol, filenames).

    ``eval_forward`` is an ``EvalForward``; with ``return_spec`` (Aero) the
    pr and lr spectra come from the generator itself and the hr spectrum
    from ``spec_fns["hr_spec"]``, else every spectrum from
    ``spec_fns["spec"]``. The host work of a file (metrics, media, files)
    runs on a worker thread while the next file's forward runs.
    """
    scores = _Scores()
    total_filenames = []
    n_log = _n_files_to_log(args)
    lr_sr, hr_sr = _lr_sr(args), args.experiment.hr_sr
    os.makedirs(args.samples_dir, exist_ok=True)

    def host_work(pr, hr, lr, pr_spec, lr_spec, hr_spec, filename,
                  log_media):
        lsd_i, visqol_i = run_metrics(hr, pr, args, filename)
        if log_media:
            wandb_logger.log_data_to_wandb(
                pr, hr, lr, lsd_i, visqol_i, filename, epoch, lr_sr, hr_sr,
                lr_spec=lr_spec, pr_spec=pr_spec, hr_spec=hr_spec)
        path = os.path.join(args.samples_dir, filename)
        save_wavs(pr, lr, hr, [path], lr_sr, hr_sr)
        if pr_spec is not None:
            save_specs(None if lr_spec is None else lr_spec[0], pr_spec[0],
                       None if hr_spec is None else hr_spec[0], path)
        return lsd_i, visqol_i

    futures = []
    iterator = LogProgress(logger, data_loader, name="Eval estimates")
    with ThreadPoolExecutor(max_workers=2) as pool:
        for (lr, _lr_paths), (hr, hr_paths) in iterator:
            filename = os.path.splitext(os.path.basename(hr_paths[0]))[0]
            total_filenames.append(filename)
            if eval_forward.return_spec:
                pr, pr_spec, lr_spec = eval_forward(lr)
                hr_spec = spec_fns["hr_spec"](hr) if spec_fns else None
            else:
                pr = eval_forward(lr)
                spec = (spec_fns or {}).get("spec")
                pr_spec, lr_spec, hr_spec = (
                    (spec(pr), spec(lr), spec(hr)) if spec else (None,) * 3)
            pr = match_signal(pr, hr.shape[-1])
            log_media = n_log == -1 or len(futures) < n_log
            if len(futures) >= 4:  # bound the files in flight
                futures[-4].result()
            futures.append(pool.submit(
                host_work, pr, hr, lr, pr_spec, lr_spec, hr_spec, filename,
                log_media))
        for fut in futures:
            scores.add(*fut.result())

    exp = args.experiment
    logger.info(bold(f"{exp.name}, {exp.lr_sr}->{exp.hr_sr}. Test set "
                     f"performance:{scores.summary()}"))
    return (*scores.global_averages(), total_filenames)


def evaluate_on_saved_data(args, dataset, epoch):
    """(avg_lsd, avg_visqol) over saved ``_lr/_hr/_pr`` triples (a
    ``PrHrSet``), with wandb media for the first ``n_files_to_log`` files,
    their spectra re-read from the saved PNGs."""
    scores = _Scores()
    n_log = _n_files_to_log(args)
    lr_sr, hr_sr = _lr_sr(args), args.experiment.hr_sr

    def saved_spec(filename, kind):
        path = os.path.join(args.samples_dir, f"{filename}_{kind}_spec.png")
        if not os.path.exists(path):
            return None
        import numpy as np
        from PIL import Image  # wandb media only

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))

    def one(data, log_media):
        lr_i, hr_i, pr_i, filename = data
        lsd_i, visqol_i = run_metrics(hr_i[None], pr_i[None], args, filename)
        if log_media and wandb_logger.active():
            wandb_logger.log_data_to_wandb(
                pr_i[None], hr_i[None], lr_i[None], lsd_i, visqol_i,
                filename, epoch, lr_sr, hr_sr,
                lr_spec=saved_spec(filename, "lr"),
                pr_spec=saved_spec(filename, "pr"),
                hr_spec=saved_spec(filename, "hr"), specs_rendered=True)
        return lsd_i, visqol_i

    futures = []
    iterator = LogProgress(logger, dataset, name="Eval estimates")
    with ThreadPoolExecutor(max_workers=4) as pool:
        for i, data in enumerate(iterator):
            if len(futures) >= 8:
                futures[-8].result()
            futures.append(pool.submit(one, data, n_log == -1 or i < n_log))
        for fut in futures:
            scores.add(*fut.result())
    logger.info(bold(f"{args.experiment.name}. Saved-data performance: "
                     f"{scores.summary()}"))
    return scores.global_averages()
