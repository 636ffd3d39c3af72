"""Readings for the limit of a cell's correctness check, on the card.

    python3 -m port_bench.control --workload <name> --seeds 1 2 3 \
        [--seconds 1]

For each seed, in one process: the cell's set-up, a short window (one
call at the cell's own chunk size, or as many as --seconds lets start),
the program freed, then the check's number (port_bench/compare.py,
`block_ratio`) for the program (the lower reading) and, on the same
sample and from the same states, for the control: the reference one
precision step below the configuration's (fp8 e4m3 for bf16, one scale a
tensor) put in the program's place (the upper reading). One JSON line
per seed; the benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from port_bench import compare
from port_bench.run import load_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    spec = load_cell(args.workload)
    control = compare.CONTROL[spec["config"]["dtype"]]
    kind = importlib.import_module(
        f"port_bench.traffic.{spec['traffic']['kind']}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        traffic = kind.Traffic(dict(spec, seed=seed,
                                    device=torch.device("cuda")))
        window = traffic.window(args.seconds)
        traffic.release()
        t1 = time.perf_counter()
        program = dict((name, v) for name, v, _ in traffic.check())
        judged = traffic.judged
        t2 = time.perf_counter()
        ctrl = traffic.check(control)[-1][1]
        t3 = time.perf_counter()
        print(json.dumps(dict(
            workload=args.workload, seed=seed, precision=control,
            calls=window["calls"], window_s=window["window_s"],
            captures=window["captures"], program=program["block_ratio"],
            control=ctrl, output_off_last_block=program[
                "output_off_last_block"],
            program_ratios=judged["ratios"], program_gaps=judged["gaps"],
            base_gaps=judged["base_gaps"],
            control_ratios=traffic.judged["ratios"],
            control_gaps=traffic.judged["gaps"],
            setup_parts=traffic.setup_parts,
            setup_and_window_s=t1 - t0, check_s=t2 - t1,
            control_s=t3 - t2)), flush=True)
        del traffic
    return 0


if __name__ == "__main__":
    sys.exit(main())
