"""The benchmark of ``aero_tpu_torch`` on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Reads ``BENCHMARK.json`` at the repository root; the cell names its
configuration (``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``driver`` names the loop in
``benchmark/drivers``), its limits (``benchmark/limits/<cell>.json``) and,
through the manifest, its per-layer metrics
(``benchmark/layer_metrics/<metric>.py``). With ``--trace 0`` the last
line of standard output is the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics; each run checks its outputs against the plain
reference and prints every compared number beside its limit, last on
standard error and under ``checks`` in the result. Exits non-zero, with no
result, without the GPUs the cell asks for, or if the process holds JAX or
the JAX package after the window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def context(args, files, device, make_program=None):
    readers = {name: harness.load_reader(name)
               for name in files["per_layer"]} if args.trace else {}
    return types.SimpleNamespace(
        cfg=files["config"], traffic=files["traffic"],
        limits=files["limits"], seed=args.seed % 2 ** 63,
        seconds=args.seconds, trace=bool(args.trace), device=device,
        readers=readers,
        make_program=make_program or harness.program_models)


def measure(args, files, device, make_program=None) -> dict:
    """Run the cell's driver; returns the result object (without
    ``device``'s name and count) and the compared numbers."""
    import importlib

    ctx = context(args, files, device, make_program)
    driver = importlib.import_module(
        f"benchmark.drivers.{files['traffic']['driver']}")
    out = driver.run(ctx)
    checks = out["checks"]
    correct = out["failed"] == 0 and all(ok for _, _, ok in checks.values())
    if args.trace:
        trace = out["trace"]
        metrics = {}
        for name, reader in ctx.readers.items():
            value = reader.read(trace)
            if value is not None:
                metrics[name] = {"value": value, "unit": reader.UNIT}
    else:
        trace = None
        metrics = {name: {"value": out["setup_s"] if name == "setup_s"
                          else out["metrics"][name],
                          "unit": files["units"][name]}
                   for name in files["end_to_end"]}
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"memory_peak_bytes": out["memory_peak_bytes"]}}
    if trace is not None:
        result["device"].update(busy_s=trace["busy_s"],
                                window_s=trace["window_s"])
        result["breakdown"] = trace["breakdown"]
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim, _) in checks.items()}
    return result


def main(argv=None) -> int:
    os.environ.setdefault("USE_FLAX", "0")
    args = parse(sys.argv[1:] if argv is None else argv)
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    files = harness.cell_files(manifest, args.workload)
    files["units"] = {m["name"]: m["unit"] for m in manifest["end_to_end"]}
    chips = int(files["cell"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    result = measure(args, files, device)
    held = harness.forbidden_modules()
    if held:
        print(f"the process holds {held} after the window", file=sys.stderr)
        return 4
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": chips, **result["device"]}
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks  # last key of the line
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
