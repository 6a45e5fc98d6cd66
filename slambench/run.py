"""The benchmark of mvil_fusion_torch: one run of one cell.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` beside this folder:
the cell's configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, which names its feed under ``feeds/``),
the limits of its comparison (``limits/<cell>.json``) and one reader per
metric (``metrics/<metric>.py``).  With ``--trace 0`` the last line of
standard output holds the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics, the device's busy time and a breakdown; the
numbers compared with the reference, each with its limit, are the last
lines of standard error and the last key of that line.

A run needs a CUDA card: without one it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse                                         # noqa: E402
import importlib                                        # noqa: E402
import importlib.util                                   # noqa: E402
import json                                             # noqa: E402
import math                                             # noqa: E402
import os                                               # noqa: E402
import sys                                              # noqa: E402
from dataclasses import dataclass                       # noqa: E402
from pathlib import Path                                # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mvil_fusion_tpu")


@dataclass
class Cell:
    """What a feed is given: the cell, its configuration (the file and
    the program's ``SystemConfig``), its traffic and limits, the run's
    seed and length, the recorder and the device."""

    name: str
    conf: dict
    cfg: object
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    rec: object
    device: object
    t_process: float
    read_faults: bool = False


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: dict, name: str):
    """(workload entry, configuration file, traffic file, limits)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                         f"{sorted(cells)}")
    w = cells[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    conf = load_json(ROOT / conf_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return w, conf, traffic, limits


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports in a run of this kind."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read`` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"slambench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(bench, name, seed, seconds, trace, device, t_process,
             overrides=None, read_faults=False):
    """One run of cell `name` on `device`: (the result line as a dict,
    the feed's record of the run).  `overrides` edits the loaded
    configuration, traffic and limits (the tests shrink a cell with
    it); `read_faults` has the feed also judge answers as faults of the
    program would give them, into the report lines."""
    from mvil_fusion_torch.config import SystemConfig

    from slambench.harness import Context, Recorder
    w, conf, traffic, limits = load_cell(bench, name)
    if overrides is not None:
        overrides(conf, traffic, limits)
    rec = Recorder(bool(trace))
    ctx = Cell(name, conf, SystemConfig.from_dict(conf["system"]), traffic,
               limits, seed, seconds, rec, device, t_process, read_faults)
    feed = importlib.import_module(f"slambench.feeds.{traffic['feed']}")
    out = feed.run(ctx)
    compared = out["compared"]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in compared)
    tr = rec.read_trace()
    c = Context(name, rec.spans, rec.counters, tr, out)
    metrics = {}
    for m in metrics_of(bench, name, trace):
        v = reader(m["name"])(c)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device_info(device, w["chips"], out["memory_peak"])}
    if trace and tr is not None:
        line["device"]["busy_s"] = tr.busy_us() * 1e-6
        line["device"]["window_s"] = tr.span_us() * 1e-6
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["compared"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in compared}
    return line, out


def device_info(device, count, memory_peak):
    import torch
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": count, "memory_peak_bytes": int(memory_peak)}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--read-faults", type=int, choices=(0, 1), default=0,
                    help="also judge the answers that faults of the program "
                    "would give (report lines only; for setting limits)")
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    w, _, _, _ = load_cell(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"slambench: the cell needs {w['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    # one host thread for the program's CPU work: the card's host is
    # shared, and a pool of threads per process spreads the runs
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    line, out = run_cell(bench, args.workload, args.seed, args.seconds,
                         args.trace, device, T_PROCESS,
                         read_faults=bool(args.read_faults))
    for k, v in out["info"].items():
        print(f"slambench: {k} {v}", file=sys.stderr)
    if out["info"].get("stream_end"):
        print("slambench: the window reached the end of the stream",
              file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"slambench: modules loaded that the port must not load: "
              f"{found}", file=sys.stderr)
        return 3
    for n, c in line["compared"].items():
        print(f"compare {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
