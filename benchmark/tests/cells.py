"""Shared by the benchmark's tests: a cell's files as ``run.py`` loads them,
shrunk to a CPU's size where asked, and one run of the cell's driver."""

from __future__ import annotations

import contextlib
import io
import json
import types

import torch

from benchmark import harness, run
from benchmark.reference import models as R


def files(cell: str, tiny: bool = False) -> dict:
    """The cell's files; ``tiny``: 8 channels, float32, 1 s chunks and
    short files, 0.5 s training segments in batches of 2."""
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    out = harness.cell_files(manifest, cell)
    out["units"] = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
    if tiny:
        cfg, traffic = out["config"], out["traffic"]
        cfg["precision"] = "float32"
        cfg["experiment"]["aero"]["channels"] = 8
        cfg["experiment"]["segment"] = 0.5
        if traffic["driver"] == "serve":
            traffic.update(chunk_s=1.0, signal_s=20.0, profile_units=2)
            d = traffic["durations"]
            if d["kind"] == "fixed":
                d["seconds"] = 2.5
            else:
                d.update(median_s=1.5, block=10)
        else:
            traffic.update(batch=2, pool_batches=4, profile_units=2)
    return out


def measure(cell_files: dict, seed: int, seconds: float, trace: int = 0,
            device=None, make_program=None) -> dict:
    """One run of the cell (run.measure), on the CPU unless ``device``."""
    args = types.SimpleNamespace(workload=cell_files["cell"]["name"],
                                 seed=seed, seconds=seconds, trace=trace)
    return run.measure(args, cell_files, torch.device(device or "cpu"),
                       make_program)


def measure_readings(cell_files: dict, seed: int, seconds: float, **kw):
    """``measure``, and the readings that the driver prints beside the
    compared numbers (the train cell's ``readings`` line), or None."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        result = measure(cell_files, seed, seconds, **kw)
    lines = [x for x in err.getvalue().splitlines()
             if x.startswith("readings ")]
    return result, json.loads(lines[-1][len("readings "):]) if lines else None


def rounded_program(quant):
    """The reference computed with the rounding ``quant`` in the program's
    place: the operands of every product and the inputs of every leaf
    module (norms, activations, the LSTM) rounded, as the program rounds
    them to bfloat16. ``R.fp8`` is the cells' lower-precision control."""
    def inputs(module, args):
        return tuple(quant(a) if isinstance(a, torch.Tensor)
                     and a.is_floating_point() else a for a in args)

    def make(cfg, reference, device, with_disc):
        for model in reference.values():
            R.set_precision(model, quant)
            for m in model.modules():
                if not any(True for _ in m.children()):
                    m.register_forward_pre_hook(inputs)
        reference["generator"].eval()
        return {k: v for k, v in reference.items()
                if with_disc or k == "generator"}

    return make


fp8_program = rounded_program(R.fp8)
