"""The harness finds cells, configurations, traffic kinds and per-layer
metrics by name: adding their files and entries is enough, with no edit
to a file the benchmark has."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT


def _copy(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "port_bench"),
                    tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_cell_metric_and_kind_added_by_files(tmp_path):
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    before = {p: (root / p).read_bytes() for p in (
        "port_bench/run.py", "port_bench/traffic/testset.py")}
    (root / "port_bench/configs/tiny.json").write_text(json.dumps(
        {"hidden_dim": 8, "buckets": [16], "dtype": "float32"}))
    (root / "port_bench/workloads/tiny_mix.json").write_text(json.dumps(
        {"kind": "echo", "rate": 3}))
    (root / "port_bench/traffic/echo.py").write_text(
        "KIND = 'echo'\n")
    (root / "port_bench/metrics/echo.rate.py").write_text(
        "def read(reading):\n    return reading['traffic']['rate'] * 2\n")
    bench["configs"].append({"name": "tiny", "source": "https://x.test",
                             "file": "port_bench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.echo", "config": "tiny",
                               "traffic": "tiny_mix", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "echo_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny.echo"]})
    bench["per_layer"].append({"name": "echo.rate", "unit": "1/s",
                               "better": "higher", "source":
                               "program_counter", "layer": "Echo",
                               "moves": "echo_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import importlib, json\n"
        "from port_bench.run import load_cell, reader\n"
        "spec = load_cell('tiny.echo')\n"
        "kind = importlib.import_module("
        "'port_bench.traffic.' + spec['traffic']['kind'])\n"
        "print(json.dumps(dict(config=spec['config']['hidden_dim'],"
        " kind=kind.KIND,"
        " e2e=[m['name'] for m in spec['end_to_end']],"
        " layer=[m['name'] for m in spec['per_layer']],"
        " value=reader('echo.rate')(spec),"
        " qm9=[m['name'] for m in load_cell('qm9.testset')['per_layer']])))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == 8 and got["kind"] == "echo"
    assert sorted(got["e2e"]) == ["echo_per_s", "setup_s"]
    assert got["layer"] == ["echo.rate"] and got["value"] == 6
    assert "echo.rate" not in got["qm9"]      # another cell's metric
    for p, data in before.items():
        assert (root / p).read_bytes() == data


def test_every_cell_metric_has_its_reader():
    sys.path.insert(0, ROOT)
    from port_bench.run import load_cell, reader

    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    for cell in bench["workloads"]:
        spec = load_cell(cell["name"])
        assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
        for m in spec["per_layer"]:
            assert callable(reader(m["name"]))


def test_no_card_no_result(tmp_path):
    """Without a CUDA card a run fails and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "qm9.testset",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr
