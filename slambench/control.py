"""The control of a cell's comparison: the reference put in the program's
place, in bfloat16, judged by the float64 reference as a run's answers
are.  Its readings must fail the cell's limits; they set the limits'
upper ends.  The benchmark's runs do not run it.

    python3 slambench/control.py --workload <cell> --span <sweeps> \
        --seed <n> [--seed ...]

Prints one JSON line a seed: the compared numbers of the control and the
limits.  Needs a CUDA card (``--device cpu`` for a rehearsal).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from slambench import run as R                          # noqa: E402


def control_readings(bench, name, seed, device, span, overrides=None,
                     info=None):
    """The control's compared numbers for one seed: (name, value,
    limit) each.  `span` is the number of sweeps after the set-up's
    that the control's sample is drawn from, as a run's window would
    cover them."""
    from mvil_fusion_torch.config import SystemConfig
    _, conf, traffic, limits = R.load_cell(bench, name)
    if overrides is not None:
        overrides(conf, traffic, limits)
    ctx = R.Cell(name, conf, SystemConfig.from_dict(conf["system"]),
                 traffic, limits, seed, 0.0, None, device,
                 time.perf_counter())
    feed = importlib.import_module(f"slambench.feeds.{traffic['feed']}")
    return feed.control(ctx, span, info=info)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--span", type=int, required=True,
                    help="sweeps of the window that the sample is drawn "
                    "from")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    bench = R.load_json(ROOT / "BENCHMARK.json")
    device = torch.device(args.device)
    for seed in args.seed:
        t = time.perf_counter()
        info = {}
        out = control_readings(bench, args.workload, seed, device, args.span,
                               info=info)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "info": info,
                          "compared": {n: {"value": v, "limit": lim}
                                       for n, v, lim in out}}), flush=True)


if __name__ == "__main__":
    main()
