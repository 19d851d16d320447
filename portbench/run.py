"""Benchmark of tpupt_torch, the PyTorch and CUDA path tracer, on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up the cell named in BENCHMARK.json
(scene files, parse, flatten, upload, warm-up), runs its timed path for
`--seconds`, checks what that path produced against the plain reference
(portbench/reference), and prints one JSON line: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` a `breakdown`, and last
`checks`, each compared number beside its limit (also the last lines on
standard error). It exits with another code than 0, and prints no result,
without a card, or when a module of JAX or of the JAX package (`tpupt`)
was loaded."""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpupt")


def forbidden_modules(modules=None):
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared whole (tpupt_torch is not tpupt)."""
    names = {m.split(".")[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness import drive, manifest

    cell = manifest.cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = drive.run(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded, and not allowed in a run: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
