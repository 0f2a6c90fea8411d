"""Readings behind the limits of `correct`: one cell's timed path on many
seeds, and its control, in one process.

    python3 gpubench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--first-seed N] [--seconds S]

For each seed it runs the cell as run.py does (inputs from the seed, set-up,
a window of S seconds, the check against the plain reference) and prints
the checked numbers. The control is the program run with some of the
configuration's keys overridden, at the cell's own sizes and load; it has
to come out not correct. It is the configuration file's own `"control"`
object where the file has one; else the program's own lower-precision path
switched on, the configuration's dtype stepped down (float32 -> bfloat16,
bfloat16 -> int8). A configuration with neither is refused by name. The
benchmark's own runs never run it. Prints one JSON line a run and a
summary: the largest reading of the sound runs (the lower reading) and the
smallest of the control's (the upper).

A new configuration gets its control with no edit here: a change that
adds it (with its cell, its reference module where its tier needs one, its
own CPU test file and its entries in BENCHMARK.json) writes a `"control"`
object into its file where its dtype has no lower tier above, as an int8
configuration has none. gpubench/tests/test_gpubench_layout.py checks that
every configuration in use resolves to a control, and
test_gpubench_control.py runs the control of every cell on the card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOWER_TIER = {"float32": "bfloat16", "bfloat16": "int8"}


def control_overrides(cfg: dict) -> dict:
    """The program's keys that the control of configuration `cfg` overrides."""
    if "control" in cfg:
        return dict(cfg["control"])
    if cfg["dtype"] not in LOWER_TIER:
        raise ValueError(f"configuration {cfg.get('name')!r}: the program has no tier below "
                         f"{cfg['dtype']}; its file states no \"control\"")
    return {"dtype": LOWER_TIER[cfg["dtype"]]}


def readings(cell, seeds, seconds: float, device, overrides=None) -> list[dict]:
    from gpubench import harness

    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = harness.run(cell, seed, seconds, False, device, t0, overrides)
        row = {"seed": seed, "correct": res.line["correct"],
               "attempted": res.line["attempted"],
               **{k: v["value"] for k, v in res.checks.items()}}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_100_000_001)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench import spec

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.Bench(ROOT).cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    sound = readings(cell, seeds, args.seconds, device)
    ctrl_seeds = [s + 1 for s in seeds[:args.control_seeds]]
    control = readings(cell, ctrl_seeds, args.seconds, device,
                       control_overrides(cell.config))
    summary = {"workload": cell.name,
               "lower": {k: max(r[k] for r in sound) for k in ("differing", "max_abs_diff")},
               "upper": {k: min(r[k] for r in control) for k in ("differing", "max_abs_diff")},
               "sound_correct": sum(r["correct"] for r in sound),
               "control_correct": sum(r["correct"] for r in control)}
    print("summary " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
