"""The readers of the program's spans and counters
(agdiff_torch/utils/profiling.py): runner.host_ms.gen,
ladder.nodes_per_step.gen and forward.nodes_per_step.gen on synthetic
records, and the cell that lists them."""

import os
import sys

import pytest

from conftest import ROOT

if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from agdiff_torch.utils import profiling  # noqa: E402
from agdiff_torch.utils.profiling import Span  # noqa: E402
from port_bench.run import load_cell, reader  # noqa: E402

MS = 1_000_000   # ns


def _calls(n):
    return dict(calls=[{}] * n)


def _program(monkeypatch, spans=(), counters=None):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "counters", lambda: dict(counters or {}))


def _call(first, start):
    """One run call's spans from `start` ms, ids from `first`: 100 ms in
    all, 60 of them in the ladder (with a forward and a nested wait that
    counts once) and 30 in the wait."""
    r = first
    s = [Span(r, None, "runner.run", start * MS, (start + 100) * MS, r),
         Span(r + 1, r, "runner.pad", (start + 1) * MS, (start + 3) * MS, r),
         Span(r + 2, r, "ladder.run", (start + 5) * MS, (start + 65) * MS,
              r),
         Span(r + 3, r + 2, "forward", (start + 6) * MS, (start + 7) * MS,
              r),
         Span(r + 4, r + 2, "runner.wait", (start + 8) * MS,
              (start + 9) * MS, r),
         Span(r + 5, r, "runner.wait", (start + 65) * MS, (start + 95) * MS,
              r),
         Span(r + 6, r, "runner.copy_back", (start + 95) * MS,
              (start + 99) * MS, r)]
    return s


def test_runner_host_ms(monkeypatch):
    read = reader("runner.host_ms.gen")
    spans = _call(1, 0) + _call(10, 200)
    # the second call's ladder 20 ms longer: 10 and 10 - 20 = -10 -> mean 0
    spans[9] = spans[9]._replace(end_ns=spans[9].end_ns + 20 * MS)
    _program(monkeypatch, spans)
    assert read(_calls(2)) == pytest.approx(0.0)
    _program(monkeypatch, _call(1, 0) + _call(10, 200))
    assert read(_calls(2)) == pytest.approx(10.0)
    # a root of another name is no call
    _program(monkeypatch, _call(1, 0) + [Span(20, None, "ladder.run", 0,
                                              5 * MS, 20)])
    assert read(_calls(1)) == pytest.approx(10.0)


def test_runner_host_ms_none(monkeypatch):
    read = reader("runner.host_ms.gen")
    _program(monkeypatch)
    assert read(_calls(1)) is None
    _program(monkeypatch, _call(1, 0))
    assert read(_calls(2)) is None       # fewer roots than calls
    monkeypatch.delattr(profiling, "spans")   # a program without spans
    assert read(_calls(1)) is None


COUNTS = {"ladder.replayed_nodes": 3000, "forward.replayed_nodes": 1800,
          "ladder.replayed_steps": 20}


@pytest.mark.parametrize("metric,want", [("ladder.nodes_per_step.gen", 60.0),
                                         ("forward.nodes_per_step.gen", 90.0)])
def test_nodes_per_step(monkeypatch, metric, want):
    read = reader(metric)
    _program(monkeypatch, counters=COUNTS)
    assert read(_calls(1)) == want
    _program(monkeypatch, counters={k: 2 * v for k, v in COUNTS.items()})
    assert read(_calls(1)) == want
    _program(monkeypatch)
    assert read(_calls(1)) is None
    _program(monkeypatch, counters={"other": 3})
    assert read(_calls(1)) is None
    monkeypatch.delattr(profiling, "counters")
    assert read(_calls(1)) is None


def test_the_cell_lists_every_metric_with_a_reader():
    names = [m["name"] for m in load_cell("qm9.testset")["per_layer"]]
    assert names == ["runner.off_device_ms.gen", "ladder.captures.gen",
                     "forward.mfu.gen", "k1_roofline.gen",
                     "k1.device_share.gen", "device.idle_share.gen",
                     "runner.host_ms.gen", "ladder.nodes_per_step.gen",
                     "forward.nodes_per_step.gen"]
    for name in names:
        assert callable(reader(name))
        assert os.path.exists(os.path.join(ROOT, "port_bench", "metrics",
                                           name + ".py"))
