"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this package and
the port.  The cell's entry in `BENCHMARK.json` names its configuration
(`portbench/configs/<config>.json`) and its traffic mix
(`portbench/traffic/<traffic>.json`); the mix's `kind` names the driver in
`portbench/kinds/`.  The run builds the cell from the seed, warms up every
shape it will use (set-up, `setup_s`), measures for `--seconds`, reads the
device's memory peak, frees the port's state, then holds what the window
produced against the plain reference (`correct`).  With `--trace 1` a
bounded slice at the start of the window runs under the profiler and the
result carries the cell's per-layer metrics instead of its end-to-end ones.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared beside its limit (also printed as
the last lines of standard error).  Without a CUDA card, with fewer cards
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level module names the run may not hold (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "collaborative_nonstationary_multivariate_gaussian_process_tpu")
PORT = "collaborative_nonstationary_multivariate_gaussian_process_tpu_torch"
CACHE = ROOT / "build" / "portbench-cache"


class CellError(RuntimeError):
    """A run that cannot give a result: exit code 2, no result line."""


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise CellError(f"no {path}")
    return json.loads(path.read_text())


def load_json(path: Path) -> dict:
    if not path.exists():
        raise CellError(f"no {path}")
    return json.loads(path.read_text())


def cell_spec(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell `workload` of `bench`, with its configuration, its traffic mix
    (`portbench/traffic/<traffic>.json`), the limits of its check
    (`portbench/limits/<workload>.json`) and the metrics it reports, all
    found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / HERE.name / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / HERE.name / "limits" / f"{workload}.json")
    return dict(workload=w, config=cfg, traffic=traffic, limits=limits, root=root,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, w, bench)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, w, bench)])


def _reports(metric: dict, w: dict, bench: dict) -> bool:
    """A metric with `workloads` is reported in the cells it lists; one
    without, in every cell (an end-to-end one), or in every cell that
    reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return w["name"] in metric["workloads"]
    if "moves" not in metric:
        return True
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    return _reports(e2e[metric["moves"]], w, bench)


def kind_module(traffic: dict):
    name = traffic["kind"]
    if not (HERE / "kinds" / f"{name}.py").exists():
        raise CellError(f"no driver portbench/kinds/{name}.py for traffic kind {name!r}")
    return importlib.import_module(f"portbench.kinds.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """The `read(ctx)` of `portbench/metrics/<name>.py`."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    if not path.exists():
        raise CellError(f"no reader {path} for per-layer metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None):
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & set(FORBIDDEN))


def set_caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def device_info(torch, chips: int) -> dict:
    if not torch.cuda.is_available():
        raise CellError("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise CellError(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def run_window(cell, seconds: float, trace: bool):
    """Units of work back to back until `seconds` have passed (the last one
    finishing); with `trace`, the cell's first `slice_units` under the
    profiler.  Returns (wall seconds, the units' records, the traced slice)."""
    from portbench import trace as tr

    records, out = [], {}
    t0 = time.perf_counter()
    if trace:
        with tr.traced(out):
            for _ in range(cell.slice_units):
                records.append(cell.unit())
            out["units"] = list(records)
    while time.perf_counter() - t0 < seconds:
        records.append(cell.unit())
    return time.perf_counter() - t0, records, out


def execute(args, root: Path = ROOT, device=None, log=sys.stderr) -> dict:
    """One run; returns the result object (the last line).  `device` other
    than None skips the card check (the tests drive a run on the CPU)."""
    spec = cell_spec(benchmark(root), args.workload, root)
    kind = kind_module(spec["traffic"])
    import torch

    # float32 as the configurations state it: no TF32 products in the port
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    if device is None:
        dev_info = device_info(torch, spec["workload"]["chips"])
        device = torch.device("cuda")
    else:
        device = torch.device(device)
        dev_info = {"platform": device.type, "kind": device.type, "count": 1}
    cell = kind.Cell(spec["config"], spec["traffic"], spec["limits"], args.seed, device, root=root)
    cell.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    wall, records, traced = run_window(cell, args.seconds, bool(args.trace))
    if device.type == "cuda":
        dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    else:
        dev_info["memory_peak_bytes"] = 0
    summary = cell.summarize(records, wall)
    cell.release()
    checks = cell.check()
    found = forbidden_modules()
    if found:
        raise CellError(f"the run holds JAX or the JAX package: {found}")
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": summary["attempted"], "failed": summary["failed"]}
    metrics = {}
    if args.trace:
        sl = traced["slice"]
        ctx = dict(config=spec["config"], traffic=spec["traffic"], slice=sl,
                   units=traced["units"])
        for m in spec["per_layer"]:
            value = metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        dev_info["busy_s"], dev_info["window_s"] = sl.busy_s, sl.window_s
        result["breakdown"] = {"device_ops": sl.device_ops, "idle_gaps": sl.idle_gaps}
        for line in cell.describe_work():
            print(line, file=log)
    else:
        for m in spec["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else summary["metrics"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result["metrics"], result["device"] = metrics, dev_info
    result["checks"] = checks
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=log)
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    set_caches()
    try:
        result = execute(args)
    except CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"portbench: cannot import the port ({PORT}) or torch: {e}", file=sys.stderr)
        return 2
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
