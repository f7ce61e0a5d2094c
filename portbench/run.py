"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Everything is found by name:
``BENCHMARK.json`` names the cell's configuration and its metrics; the
configuration is ``portbench/configs/<config>.json`` (sizes, the
program's knobs, the driver that runs it, the limits of its checks); the
traffic mix is ``portbench/traffic/<cell>.json`` (the generator it takes
and its parameters); each per-layer metric is read by
``portbench/metrics/<metric>.py``.  Adding a configuration, a mix or a
metric adds files and entries; no file here changes.

A run: the data made on the device from ``--seed``; set-up (the kernels
built into ``build/kernels/`` in the checkout on the first run there, and
a warm-up at the cell's own shapes); the measured window of ``--seconds``
of requests or rounds; with ``--trace 1`` a traced stretch of it for the
per-layer metrics; then the plain reference's checks of what the window
produced, each number printed beside its limit.  The last line of
standard output is the result.  Exits 2 without the cards the cell asks
for, 3 when the JAX package or JAX itself was loaded, and prints no result
then.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse                                               # noqa: E402
import importlib                                              # noqa: E402
import importlib.util                                         # noqa: E402
import json                                                   # noqa: E402
import math                                                   # noqa: E402
import os                                                     # noqa: E402
import subprocess                                             # noqa: E402
import sys                                                    # noqa: E402
from pathlib import Path                                      # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_processes_tpu")


class Spec:
    """The cell, its configuration and traffic, and its metrics, as
    ``BENCHMARK.json`` and the files it names give them."""

    def __init__(self, workload: str, root: Path = ROOT):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; "
                             f"known: {sorted(cells)}")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = json.loads(
            (root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (root / BENCH_DIR.name / "traffic" / f"{workload}.json")
            .read_text())

        def mine(metric):
            return workload in metric.get("workloads", [workload])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def load_module(path: Path):
    """A module from a file (metric files are named after their metric,
    dots and all)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_for(config: dict):
    return importlib.import_module(f"portbench.drivers.{config['driver']}")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that belong to JAX or the JAX
    package, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info(torch) -> dict:
    info = {"name": torch.cuda.get_device_name(0), "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
        info["power_limit"] = out.rpartition(",")[2].strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return info


def read_per_layer(spec: Spec, ctx: dict,
                   metrics_dir: Path = BENCH_DIR / "metrics") -> dict:
    """Each per-layer metric its reader finds something to read for."""
    out = {}
    for m in spec.per_layer:
        reader = load_module(metrics_dir / f"{m['name']}.py")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judged(values: dict, limits: dict) -> dict:
    """Each number compared with its limit, in the limits' order."""
    return {name: {"value": values[name], "limit": limits[name]}
            for name in limits}


def is_correct(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def cache_dirs():
    """Every build and kernel cache in fixed directories of the checkout
    (the program's own CUDA builds go to ``build/kernels/`` there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)


def measure(spec: Spec, seed: int, seconds: float, trace: bool,
            device) -> dict:
    """One run of the cell on ``device`` after the look for the card:
    set-up, the window, the checks; returns the result's line (None when
    the JAX package or JAX itself was loaded)."""
    import torch
    device = torch.device(device)
    on_card = device.type == "cuda"
    driver = driver_for(spec.config)
    session = driver.setup(spec.config, spec.traffic, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    win = driver.window(session, seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: loaded in the measuring process: {leaked}",
              file=sys.stderr)
        return None

    checks = judged(driver.check(session, win), spec.config["limits"])
    checks["failed"] = {"value": win["failed"], "limit": 0}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": spec.cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": is_correct(checks), "attempted": win["attempted"],
              "failed": win["failed"]}
    if trace:
        reduced = win["trace"]
        result["metrics"] = read_per_layer(spec, dict(win["ctx"],
                                                      trace=reduced))
        dev.update(busy_s=reduced.busy_seconds(), window_s=reduced.window_s)
        result["breakdown"] = reduced.breakdown()
    else:
        values = dict(win["e2e"], setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]),
                                         "unit": m["unit"]}
                             for m in spec.end_to_end}
    result["device"] = dev
    if on_card:
        result["card"] = card_info(torch)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = Spec(args.workload)
    cache_dirs()
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < spec.cell["chips"]:
        print(f"portbench: the cell asks for {spec.cell['chips']} CUDA "
              f"card(s); this machine has {have}", file=sys.stderr)
        return 2
    result = measure(spec, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    if result is None:
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
