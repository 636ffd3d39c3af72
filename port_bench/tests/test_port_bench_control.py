"""The correctness check's control: the reference one precision step
below the configuration's (fp8 for bf16), put in the program's place.
Marked `cuda`, at each cell's own size on the card: the control reads
above the cell's limit and the program below it (one seed here; PERF.md
has the readings of `python3 -m port_bench.control` over many). On the
CPU, at the small size of test_port_bench_faults.py: the control reads at
least three times what the program reads."""

import pytest
import torch

from port_bench.run import load_cell
from test_port_bench_faults import CELLS, small


def readings(spec, device, seed=2 ** 31 + 21):
    import importlib

    kind = importlib.import_module(
        f"port_bench.traffic.{spec['traffic']['kind']}")
    traffic = kind.Traffic(dict(spec, seed=seed, device=device))
    traffic.window(0.0)
    traffic.release()
    program = traffic.check()[-1]
    control = traffic.check("fp8")[-1]
    return program, control


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program_cpu(cell):
    (_, prog, limit), (_, ctrl, _) = readings(small(cell),
                                              torch.device("cpu"))
    assert prog <= limit and ctrl >= 3 * prog, (prog, limit, ctrl)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes_card(cell, card):
    (_, prog, limit), (_, ctrl, _) = readings(load_cell(cell), card)
    assert prog <= limit < ctrl, (prog, limit, ctrl)
