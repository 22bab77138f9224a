"""Offline-safe wandb logging (port of ``aero_tpu/utils/wandb_logger.py``).

The same surface as the JAX package's: a no-op unless ``wandb`` imports and
``wandb.mode`` is not ``disabled``. ``wandb`` is imported at first use,
never at import.
"""

from __future__ import annotations

import logging
import os
import uuid

logger = logging.getLogger(__name__)

_WANDB = None
_TRIED = False
_active = False


def _wandb():
    global _WANDB, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            import wandb

            _WANDB = wandb
        except Exception:  # noqa: BLE001 - absent or broken: logging is off
            _WANDB = None
    return _WANDB


def _enabled(args) -> bool:
    mode = str(args.get("wandb", {}).get("mode", "disabled"))
    return mode != "disabled" and _wandb() is not None


def _get_group_id(path="group_id.dat") -> str:
    """A group id kept in ``path``, so the runs of several processes group
    together."""
    if os.path.exists(path):
        with open(path) as f:
            return f.read().strip()
    gid = uuid.uuid4().hex
    with open(path, "w") as f:
        f.write(gid)
    return gid


def init_wandb_run(args, rank: int = 0, world_size: int = 1):
    global _active
    if not _enabled(args):
        return None
    kw = dict(
        project=args.wandb.project_name, entity=args.wandb.get("entity"),
        mode=args.wandb.mode, tags=list(args.wandb.get("tags", [])),
        resume=args.wandb.get("resume", False), name=str(args.experiment.name))
    if world_size > 1:
        kw["group"] = _get_group_id()
        kw["name"] = f"{kw['name']}-rank{rank}"
    run = _wandb().init(**kw)
    _active = True
    return run


def active() -> bool:
    return _active


def log_metrics(metrics: dict, step: int):
    if _active:
        _wandb().log(metrics, step=step)


def _wave_heatmap(signal):
    """Waveform -> heatmap of its log2 power spectrogram."""
    import numpy as np

    from aero_tpu_torch.utils.viz import (
        convert_spectrogram_to_heatmap, power_spectrogram_np)

    with np.errstate(divide="ignore"):
        return convert_spectrogram_to_heatmap(
            np.log2(power_spectrogram_np(signal)))


def _spec_heatmap(spec):
    """Complex spectrogram [C, F, T] -> heatmap of log2 |.|^2."""
    import numpy as np

    from aero_tpu_torch.utils.viz import convert_spectrogram_to_heatmap

    spec = np.asarray(spec)
    while spec.ndim > 2:
        spec = spec[0]
    with np.errstate(divide="ignore"):
        return convert_spectrogram_to_heatmap(np.log2(np.abs(spec) ** 2))


def log_data_to_wandb(pr, hr, lr, lsd, visqol, filename, epoch,
                      lr_sr, hr_sr, lr_spec=None, pr_spec=None, hr_spec=None,
                      specs_rendered=False):
    """Per-file media: the prediction's spectrogram and audio always; the
    model's spectra (pr always, hr and lr up to epoch 10) and the hr and lr
    spectrograms and audio up to epoch 10. ``specs_rendered``: the spec
    arguments are RGB images already, not complex spectrograms."""
    if not _active:
        return
    import numpy as np

    wandb = _wandb()
    pr, hr, lr = (np.asarray(x) for x in (pr, hr, lr))
    heat = (lambda s: s) if specs_rendered else _spec_heatmap
    key = f"test samples/{filename}"
    data = {
        f"{key}/lsd": lsd, f"{key}/visqol": visqol,
        f"{key}/spectrogram": wandb.Image(_wave_heatmap(pr), caption="PR"),
        f"{key}/audio": wandb.Audio(pr.squeeze(), sample_rate=hr_sr,
                                    caption="PR"),
    }
    if pr_spec is not None and hr_spec is not None and lr_spec is not None:
        data[f"{key}/pr_spec"] = wandb.Image(heat(pr_spec), caption="PR spec")
        if epoch <= 10:
            data[f"{key}/hr_spec"] = wandb.Image(heat(hr_spec),
                                                 caption="HR spec")
            data[f"{key}/lr_spec"] = wandb.Image(heat(lr_spec),
                                                 caption="LR spec")
    if epoch <= 10:
        for name, sig, sr in (("hr", hr, hr_sr), ("lr", lr, lr_sr)):
            data[f"{key}/{filename}_{name}_spectrogram"] = wandb.Image(
                _wave_heatmap(sig), caption=name.upper())
            data[f"{key}/{filename}_{name}_audio"] = wandb.Audio(
                sig.squeeze(), sample_rate=sr, caption=name.upper())
    wandb.log(data, step=epoch)


def create_wandb_table(args, dataset, epoch):
    """Final results table over saved _lr/_hr/_pr triples."""
    if not _active:
        return
    import numpy as np

    from aero_tpu_torch.data.resample import resample_np
    from aero_tpu_torch.eval.metrics import run_metrics

    wandb = _wandb()
    columns = ["filename", "hr audio", "hr spectogram", "lr audio",
               "lr spectogram", "pr audio", "pr spectogram", "lsd", "visqol"]
    table = wandb.Table(columns=columns)
    hr_sr = int(args.experiment.hr_sr)
    lr_sr = int(args.experiment.lr_sr)
    n_limit = int(args.wandb.get("n_files_to_log_to_table", 10) or 0)
    for i, (lr_i, hr_i, pr_i, fname) in enumerate(dataset):
        if n_limit and i >= n_limit:
            break
        lsd, visqol = run_metrics(hr_i[None], pr_i[None], args, fname)
        lr_up = resample_np(np.atleast_2d(lr_i), lr_sr, hr_sr)
        table.add_data(
            fname,
            wandb.Audio(hr_i.squeeze(), sample_rate=hr_sr,
                        caption=f"{fname}_hr"),
            wandb.Image(_wave_heatmap(hr_i)),
            wandb.Audio(lr_i.squeeze(), sample_rate=lr_sr,
                        caption=f"{fname}_lr"),
            wandb.Image(_wave_heatmap(lr_up)),
            wandb.Audio(pr_i.squeeze(), sample_rate=hr_sr,
                        caption=f"{fname}_pr"),
            wandb.Image(_wave_heatmap(pr_i)), lsd, visqol)
    wandb.log({"Results": table}, step=epoch)


def finish():
    global _active
    if _active:
        _wandb().finish()
        _active = False
