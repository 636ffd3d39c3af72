"""The port's profiling hooks (agdiff_torch/utils/profiling.py) against
the JAX package's (agdiff_tpu/utils/profiling.py) on the CPU, and the
synthetic end-to-end example (agdiff_torch/examples/
synthetic_end_to_end.py) against the construction of
examples/synthetic_end_to_end.py through the JAX package: the same
training conformers and test molecules, array by array, and its `main`
end to end at a tiny size. Whether training beats the untrained model is
the example's own assertion, which needs the full run: the card's
chip_smoke.py phase 16 (c) holds it; here either outcome of it is
accepted, its message checked."""

import dataclasses
import glob
import json
import os
import re

import numpy as np
import pytest
import torch

from agdiff_tpu.data.synthetic import synthetic_dataset as jax_synthetic
from agdiff_tpu.utils import profiling as jax_profiling

from agdiff_torch.data.bucketing import pad_molecules
from agdiff_torch.examples import synthetic_end_to_end as example
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.utils import profiling

from test_torch_port_common import configs, molecules


def test_trace_writes_a_trace(tmp_path):
    """A small CPU forward under trace(): one Chrome trace under log_dir
    that names the forward's operators."""
    torch.set_num_threads(2)
    _, cfg = configs()
    model = DualEncoderEpsNetwork(cfg).eval()
    batch = pad_molecules(molecules(2), 16)
    with profiling.trace(str(tmp_path)) as prof, torch.no_grad():
        model(batch)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1 and prof is not None
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)


@dataclasses.dataclass
class _Leaf:
    a: torch.Tensor
    b: object


def test_timer_and_block_on():
    """elapsed is None inside the block, positive after; block_on takes
    nested dicts, lists, tuples, dataclasses and non-tensors, as JAX's
    takes a pytree, and returns what JAX's does (None)."""
    tree = {"x": torch.ones(3), "y": [1, (torch.zeros(2), "s")],
            "z": _Leaf(torch.ones(1), None), "w": 2.5}
    for module in (profiling, jax_profiling):
        with module.Timer() as t:
            assert t.elapsed is None
            assert t.block_on(tree if module is profiling
                              else {"w": 2.5, "x": np.ones(3)}) is None
        assert t.elapsed > 0
    assert profiling._cuda_devices(tree, set()) == set()


def test_device_memory_stats():
    """On the CPU: None, as JAX's CPU device gives; with no argument, the
    first card, which is missing here, so it raises."""
    assert profiling.device_memory_stats("cpu") is None
    assert jax_profiling.device_memory_stats() is None
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profiling.device_memory_stats()


def _jax_example_sets(num_train, num_test):
    """examples/synthetic_end_to_end.py's construction, through the JAX
    package."""
    base = jax_synthetic(num_train, seed=0, min_heavy=4, max_heavy=6,
                         num_conformers=3)
    train = [dataclasses.replace(m, pos=r, pos_ref=None, meta=dict(m.meta))
             for m in base for r in m.pos_ref.reshape(-1, m.num_nodes, 3)]
    test = jax_synthetic(1000 + num_test, seed=1, min_heavy=4, max_heavy=6,
                         num_conformers=3)[-num_test:]
    return train, test


def test_example_datasets_match_jax():
    """At the example's defaults (192 training molecules, 12 test)."""
    got = example.datasets(192, 12)
    want = _jax_example_sets(192, 12)
    for g_set, w_set in zip(got, want, strict=True):
        assert len(g_set) == len(w_set)
        for a, b in zip(g_set, w_set):
            for f in ("atom_type", "pos", "bond_index", "bond_type",
                      "pos_ref"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), f
                if x is not None:
                    assert x.dtype == y.dtype, f
                    np.testing.assert_array_equal(x, y, err_msg=f)
            assert a.smiles == b.smiles and a.meta == b.meta


def test_example_main_runs(tmp_path, capsys):
    torch.set_num_threads(2)
    out = tmp_path / "e2e"
    argv = ["--iters", "2", "--timesteps", "20", "--num_train", "8",
            "--num_test", "2", "--hidden", "32", "--device", "cpu",
            "--out", str(out)]
    try:
        res = example.main(argv)
    except AssertionError as err:
        assert "training did not improve" in str(err)
        res = None
    text = capsys.readouterr().out
    m = re.search(r"RESULT: MAT-R untrained ([\d.]+) -> trained ([\d.]+) A "
                  r"\| COV-R@1A ([\d.]+) -> ([\d.]+)", text)
    assert m, text
    mats = [float(m.group(1)), float(m.group(2))]
    assert all(np.isfinite(mats)) and all(v > 0 for v in mats)
    if res is not None:
        assert "LEARNING DEMONSTRATED" in text
        assert res["mat_trained"] < res["mat_untrained"]
    for tag in ("untrained", "trained"):
        with np.load(out / tag / "samples_all.npz") as data:
            assert int(data["__num__"]) == 2
            gens = [data[f"m{k}/pos_gen"] for k in range(2)]
        assert all(g.shape[0] == 6 and np.isfinite(g).all() for g in gens)
    assert os.path.exists(out / "trained" / "samples_1.npz")


# ---- spans and counters ------------------------------------------------------

def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_span_off_records_nothing(monkeypatch):
    """With no profiler recording a span records nothing and opens no
    profiler range."""
    def no_range(name):
        raise AssertionError(f"a range {name!r} opened")

    profiling.clear()
    monkeypatch.setattr(profiling, "_host_range", no_range)
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    assert profiling.spans() == []


def test_span_records_under_the_profiler():
    """Under torch.profiler: one record a span, nested spans linked to
    their parent and sharing its request, each a host event of the
    profiler; a second root starts a request of its own."""
    profiling.clear()
    with _cpu_profile() as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(4).sum()
        with profiling.span("second"):
            pass
    got = {s.name: s for s in profiling.spans()}
    assert sorted(got) == ["inner", "outer", "second"]
    outer, inner, second = got["outer"], got["inner"], got["second"]
    assert outer.parent_id is None and second.parent_id is None
    assert inner.parent_id == outer.id
    assert inner.request == outer.request == outer.id
    assert second.request == second.id != outer.id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.end_ns <= second.start_ns <= second.end_ns
    names = {e.name for e in prof.events()}
    assert {"outer", "inner", "second"} <= names
    # host ops, not user annotations, which the profiler would also draw
    # on a card's timeline over the kernels launched inside them
    kinds = {e.activity_type() for e in prof.profiler.kineto_results.events()
             if e.name() in ("outer", "inner", "second")}
    assert kinds == {"cpu_op"}
    # a span decorating a function opens one span a call
    profiling.clear()
    fn = profiling.span("decorated")(lambda x: x + 1)
    with _cpu_profile():
        assert fn(1) == 2 and fn(2) == 3
    assert [s.name for s in profiling.spans()] == ["decorated"] * 2


def test_spans_of_two_threads_do_not_nest():
    """A span opened in one thread while another thread's span is open is
    a root of its own."""
    import threading

    profiling.clear()
    opened, done = threading.Event(), threading.Event()

    def other():
        with profiling.span("a"):
            opened.set()
            assert done.wait(30)

    with _cpu_profile():
        t = threading.Thread(target=other)
        t.start()
        assert opened.wait(30)
        with profiling.span("b"):
            with profiling.span("b.child"):
                pass
        done.set()
        t.join(30)
    assert not t.is_alive()
    got = {s.name: s for s in profiling.spans()}
    assert got["a"].parent_id is None and got["b"].parent_id is None
    assert got["b.child"].parent_id == got["b"].id
    assert got["a"].request != got["b"].request


def test_count_and_clear():
    profiling.clear()
    profiling.count("x")
    profiling.count("x", 4)
    profiling.count("y", 2)
    assert profiling.counters() == {"x": 5, "y": 2}
    with _cpu_profile():
        with profiling.span("s"):
            pass
    assert len(profiling.spans()) == 1
    profiling.clear()
    assert profiling.counters() == {} and profiling.spans() == []


def test_runner_spans_under_the_profiler():
    """An eager PackedGenerationRunner.run at hidden 32 under the
    profiler: one `runner.run` root a call, with the runner's phases and
    `ladder.run` under it and `forward` under `ladder.run`; the same run
    with the profiler off records none."""
    from agdiff_torch.eval.generate import PackedGenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.models.weights import init_random
    from agdiff_torch.sampling.langevin import SamplerConfig

    from test_torch_port_common import port_molecule

    torch.set_num_threads(2)
    _, cfg = configs()
    model = init_random(DualEncoderEpsNetwork(cfg), 3).eval()
    runner = PackedGenerationRunner(
        model, cfg, make_diffusion(cfg), SamplerConfig(n_steps=3),
        buckets=(16,), chunk_size=8, device="cpu")
    mols = [port_molecule(m) for m in molecules(2)]
    profiling.clear()
    with _cpu_profile():
        for seed in (0, 1):
            runner.run(mols, None, seed=seed, num_confs=[2, 3])
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent_id is None]
    assert [s.name for s in roots] == ["runner.run"] * 2
    for root in roots:
        children = [s for s in spans if s.parent_id == root.id]
        names = [s.name for s in children]
        assert names == ["runner.plan", "runner.pad", "runner.starts",
                         "ladder.run", "runner.wait", "runner.copy_back",
                         "runner.collect"], names
        ladder = children[3]
        forwards = [s for s in spans if s.name == "forward"
                    and s.request == root.id]
        assert len(forwards) == 3
        assert all(by_id[s.parent_id] is ladder for s in forwards)
        assert all(s.request == root.id for s in spans
                   if s.parent_id == root.id)
    assert profiling.counters() == {}    # nothing replays on the CPU
    profiling.clear()
    runner.run(mols, None, seed=0, num_confs=[2, 3])
    assert profiling.spans() == []
