"""Run one cell of the benchmark once, on one process, and print the result.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, gpubench/ and
raisr_tpu_torch/. The cell (BENCHMARK.json `workloads`) names a
configuration file and a traffic file; the run makes its banks and frames
from the seed on the card, warms up the cell's shapes, measures the window,
with --trace 1 traces a bounded slice after it, checks the kept outputs
against the plain reference in gpubench/reference/, and prints the result
as the last line of standard output: the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1. The checks, each number
beside its limit, are the last lines of standard error.

It exits with 2, and prints no result, without a CUDA card (or with fewer
cards than the cell asks for), and with 3 if JAX or the JAX package was
loaded by the time the result is ready. Kernel builds stay inside the
checkout (build/); traces and bank folders go under TMPDIR and are deleted.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "raisr_tpu")


def loaded_forbidden() -> list[str]:
    """Modules of JAX or the JAX package in this process, by whole
    top-level name (raisr_tpu_torch is not raisr_tpu)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    # caches of anything that compiles stay at fixed paths in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / "gpubench" / sub))
    os.environ.setdefault("USE_FLAX", "0")
    # load from one process with few threads: the host's cores are shared,
    # and idle intra-op workers only take them from the thread that drives
    # the card
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")

    from gpubench import spec

    try:
        cell = spec.Bench(ROOT).cell(args.workload)
    except spec.SpecError as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2

    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gpubench: the cell {cell.name} needs {cell.chips} CUDA card(s); this "
              f"machine has {have}. No result.", file=sys.stderr)
        return 2
    try:
        import raisr_tpu_torch
    except ImportError as e:
        print(f"gpubench: the program raisr_tpu_torch is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    if ROOT not in pathlib.Path(raisr_tpu_torch.__file__).resolve().parents:
        print(f"gpubench: raisr_tpu_torch comes from {raisr_tpu_torch.__file__}, not from "
              f"this checkout {ROOT}. No result.", file=sys.stderr)
        return 2

    from gpubench import harness

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)  # the card's context
    t_cuda = time.perf_counter()
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    out.notes.insert(0, f"set-up from the start: torch imported at {t_torch - T_START} s, "
                        f"the card's context at {t_cuda - T_START} s")

    bad = loaded_forbidden()
    if bad:
        print(f"gpubench: JAX or the JAX package was loaded: {', '.join(bad)}. No result.",
              file=sys.stderr)
        return 3
    for note in out.notes:
        print(f"gpubench: {note}")
    print(f"gpubench: card {card_line()}", file=sys.stderr)
    for name, c in out.checks.items():
        rule = (f"<= {c['limit']}" if "limit" in c else f">= {c['least']}")
        print(f"check {name} {c['value']} {rule}", file=sys.stderr)
    print(f"check correct {out.line['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out.line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
