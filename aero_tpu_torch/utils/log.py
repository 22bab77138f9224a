"""Logging helpers: LogProgress, ANSI bold, history queries (copy of
``aero_tpu/utils/log.py``)."""

from __future__ import annotations

import logging
import time


class LogProgress:
    """Log-line progress reporter (tqdm-like but log-friendly)."""

    def __init__(self, logger, iterable, updates=5, total=None,
                 name="LogProgress", level=logging.INFO):
        self.iterable = iterable
        self.total = total or len(iterable)
        self.updates = updates
        self.name = name
        self.logger = logger
        self.level = level

    def update(self, **infos):
        self._infos = infos

    def __iter__(self):
        self._iterator = iter(self.iterable)
        self._index = -1
        self._infos = {}
        self._begin = time.time()
        return self

    def __next__(self):
        self._index += 1
        try:
            return next(self._iterator)
        finally:
            log_every = max(1, self.total // self.updates)
            if self._index >= 1 and self._index % log_every == 0:
                self._log()

    def _log(self):
        speed = (1 + self._index) / (time.time() - self._begin)
        infos = " | ".join(f"{k.capitalize()} {v}"
                           for k, v in self._infos.items())
        if speed < 1e-4:
            rate = "oo sec/it"
        elif speed < 0.1:
            rate = f"{1 / speed:.1f} sec/it"
        else:
            rate = f"{speed:.1f} it/sec"
        out = f"{self.name} | {self._index}/{self.total} | {rate}"
        if infos:
            out += " | " + infos
        self.logger.log(self.level, out)


def colorize(text, color):
    return f"\033[{color}m{text}\033[0m"


def bold(text):
    return colorize(text, "1")


def pull_metric(history, name):
    return [metrics[name] for metrics in history if name in metrics]


def setup_logging(verbose: bool = False, log_file: str | None = None):
    handlers = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(log_file, mode="a"))
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="[%(asctime)s][%(name)s][%(levelname)s] - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S", handlers=handlers, force=True)
