"""Readings that a cell's limits are set from, beside the benchmark's own
runs (which give the program's readings): the control, and for a training
cell the faults, each at the cell's own size. The cell's kind
(`portbench/kinds/<kind>.py`) gives them through its `calibrate`.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--samples N]

- The control is the reference put in the program's place and computed a
  precision lower than the configuration's float32: its shading chain in
  bfloat16 (portbench/reference/path.py). It is held against the float32
  reference by the cell's own comparison.
- For a training (`inverse`) cell also the fault "half of the batch left
  out, the mean taken over the rest": the reference step with the second
  half of the wavefront's lanes dropped and the loss taken over the pixels
  left. A step that returns its state unchanged reads 1 on `change_gap`
  by its definition and needs no run.

`--samples` is the number of samples a render cell's window renders (the
`attempted` of its runs). Prints one JSON line a seed and reading. Not run
by the benchmark's runs; from the command line it needs a card
(portbench/tests/test_portbench_faults.py runs it on the CPU at a small
size)."""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import torch  # noqa: E402

from harness import manifest  # noqa: E402
from harness.program import log  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--samples", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = manifest.cell(args.workload)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = manifest.kind(cell["mix"]["kind"]).calibrate(
            cell, seed, dev, args.samples)
        for reading, numbers in out.items():
            print(json.dumps(dict(seed=seed, reading=reading, **numbers)),
                  flush=True)
        log(f"seed {seed}: {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
