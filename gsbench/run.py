"""The benchmark of gaustudio_torch on NVIDIA GPUs.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``gsbench/configs/``),
a traffic mix (``gsbench/traffic/<name>.json``, whose ``driver`` names the
loop in ``gsbench/drivers/``) and its limits (``gsbench/limits/<cell>.json``).
Per-layer metrics are readers in ``gsbench/metrics/<name>.py``. Everything
is found by the names in ``BENCHMARK.json``.

A reader's ``read(ctx)`` returns its number, or None where the run has
nothing for it to read. Every driver's traced window gives ``ctx`` the same
keys: ``kind`` (the driver), ``model`` ("3dgs" or "2dgs"), ``profile``
(``gsbench/trace.py``'s reduction of the window: device time by kernel,
busy and window seconds, and every device and host span), ``steps``
(steps, frames or extractions in the window), ``params`` (a callable
giving the raw attributes the window rendered, on the device), ``views``
((cameras.json entry, scale) of each view rendered, in order) and ``run``
(the driver's ``Run``, its program state released); a driver may add its
own readings.

A run makes its scene, cameras and images from ``--seed``, warms up, then
measures for ``--seconds`` (``--trace 0``: the cell's end-to-end metrics)
or profiles a steady window (``--trace 1``: its per-layer metrics). Then,
with the program's state freed, the plain reference (``gsbench/reference``)
recomputes what the timed path produced and the comparison decides
``correct``. The last line of standard output is the result's JSON.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "gsbench")
# the JAX reference package and JAX itself must never load in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "gaustudio_tpu")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str) -> dict:
    """Everything a run of ``workload`` needs, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"gsbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def listed(metric):
        return workload in metric["workloads"] if "workloads" in metric else None

    end_to_end = [m for m in bench["end_to_end"] if listed(m) is not False]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if listed(m) or (listed(m) is None and m["moves"] in reported)]
    return {
        "cell": cell,
        "config": _json(os.path.join(ROOT, config["file"])),
        "traffic": _json(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")),
        "limits": _json(os.path.join(BENCH, "limits", workload + ".json")),
        "end_to_end": end_to_end,
        "per_layer": per_layer,
    }


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def compared_lines(numbers: dict, limits: dict) -> list:
    return [f"compared {k}: {numbers[k]!r} (limit {limits[k]!r})" for k in sorted(numbers)]


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches stay inside the checkout, at fixed paths; no library loads JAX
    cache = os.path.join(ROOT, ".gsbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, ROOT)

    spec = cell_spec(_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gsbench: {args.workload} needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    from gaustudio_torch.utils import kernels

    kernels.load()  # built once per checkout into gaustudio_torch/build/
    driver = _load(os.path.join(BENCH, "drivers", spec["traffic"]["driver"] + ".py"),
                   "gsbench_driver")
    run = driver.Run(spec["config"], spec["traffic"], args.seed, device)
    info = run.setup()
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START
    print(f"gsbench: {args.workload} seed {args.seed}: set-up {setup_s:.3f} s, "
          + ", ".join(f"{k} {v}" for k, v in info.items()), flush=True)

    if args.trace:
        ctx = run.traced()
    else:
        measured = run.window(args.seconds)
    torch.cuda.synchronize(device)
    peak = int(torch.cuda.max_memory_allocated(device))
    found = forbidden_modules()
    if found:
        print(f"gsbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    attempted = int(run.attempted)

    run.release()
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    numbers = run.compare(run.reference())
    print(f"gsbench: reference {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    limits = {k: spec["limits"][k] for k in numbers}
    correct = judge(numbers, limits)

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": 0}
    if args.trace:
        ctx["run"] = run
        prof = ctx["profile"]
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        metrics = {}
        for m in spec["per_layer"]:
            value = _load(os.path.join(BENCH, "metrics", m["name"] + ".py"),
                          "gsbench_metric").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    else:
        measured["setup_s"] = setup_s
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    result.update(metrics=metrics, device=device_info,
                  compared={k: {"value": numbers[k], "limit": limits[k]} for k in numbers})
    for line in compared_lines(numbers, limits):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
