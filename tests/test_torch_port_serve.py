"""The port's generation server (agdiff_torch/serve/server.py) beside the
JAX service (agdiff_tpu/serve/server.py): the same requests over real
sockets on 127.0.0.1 give the same reply keys, `ok` values and reject
marker; the port's inline positions are its packed runner's, bit for
bit; concurrent requests merge into one packed run and each gives its
solo samples. Positions are not compared with JAX's: jax.random and
torch.Generator draw different starts (ROADMAP.md constraints).

A small model (hidden 32, 2 + 2 convs) and a 4-step strided DDIM ladder
at eta 0, bucket 16, chunks of 8, as tests/test_serve_batching.py runs
the JAX service; both services merge within 0.8 s and reject molecules
above 24 atoms. Every client call and thread join carries a timeout, and
the server threads are daemons."""

import json
import socket
import threading

import numpy as np
import pytest

from agdiff_tpu.eval.generate import (
    GenerationRunner as JaxRunner,
    PackedGenerationRunner as JaxPackedRunner,
)
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.sampling.langevin import SamplerConfig as JaxSamplerConfig
from agdiff_tpu.serve import server as jax_server

from agdiff_torch.data.synthetic import synthetic_dataset
from agdiff_torch.eval.generate import GenerationRunner, PackedGenerationRunner
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.sampling.langevin import SamplerConfig
from agdiff_torch.serve import server
from agdiff_torch.serve.server import GenerationService, submit

from test_torch_port_common import (
    batches,
    configs,
    jax_variables,
    molecules,
    port_model,
)

LADDER = dict(n_steps=4, ladder="strided", sampling_type="generalized",
              eta=0.0)
RUNNER = dict(buckets=(16,), chunk_size=8)
WINDOW, MAX_NODES = 0.8, 24
TIMEOUT = 300     # seconds, each client call
JOIN = 30         # seconds, each thread join


def _start(svc):
    """svc.serve on a daemon thread; returns (service, port, thread)."""
    box, ready = [], threading.Event()

    def on_ready(p):
        box.append(p)
        ready.set()

    t = threading.Thread(target=svc.serve,
                         kwargs=dict(port=0, ready_callback=on_ready),
                         daemon=True)
    t.start()
    assert ready.wait(30)
    return svc, box[0], t


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = configs()
    jb, _ = batches(molecules(1, seed=9), max_nodes=16, batch_size=1)
    jmodel, variables = jax_variables(jcfg, jb)
    return jcfg, cfg, jmodel, variables, port_model(cfg, variables)


@pytest.fixture(scope="module")
def services(model):
    """Both services, packed runners, merging within WINDOW."""
    jcfg, cfg, jmodel, variables, tmodel = model
    port = PackedGenerationRunner(tmodel, cfg, make_diffusion(cfg),
                                  SamplerConfig(**LADDER), device="cpu",
                                  **RUNNER)
    jax = JaxPackedRunner(jmodel, variables, jax_diffusion(jcfg),
                          JaxSamplerConfig(**LADDER), use_fast=True,
                          model_config=jcfg, **RUNNER)
    started = {
        "port": _start(GenerationService(port, batch_window_s=WINDOW,
                                         max_nodes=MAX_NODES)),
        "jax": _start(jax_server.GenerationService(
            jax, batch_window_s=WINDOW, max_nodes=MAX_NODES)),
    }
    yield started
    for _, p, t in started.values():
        try:
            submit({"cmd": "shutdown"}, port=p, timeout=5)
        except OSError:
            pass
        t.join(timeout=JOIN)


def _gen(seed, n_mols=2, **kw):
    return {"cmd": "generate", "synthetic": n_mols, "synthetic_seed": 7,
            "num_conformers": 2, "num_confs": 2, "seed": seed,
            "save": False, "return_pos": True, "resume": False, **kw}


def _raw(port, payload: bytes) -> dict:
    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as c:
        c.sendall(payload)
        data = b""
        while not data.endswith(b"\n"):
            chunk = c.recv(1 << 16)
            if not chunk:
                break
            data += chunk
    return json.loads(data.decode())


def _concurrent(port, requests: dict) -> dict:
    """Each request from its own client thread at once; name -> reply."""
    replies = {}

    def client(name, req):
        replies[name] = submit(req, port=port, timeout=TIMEOUT)

    threads = [threading.Thread(target=client, args=kv, daemon=True)
               for kv in requests.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert set(replies) == set(requests)
    return replies


def test_probe_molecule_matches_jax():
    for n in (1, 2, 5, 24):
        got, want = server.probe_molecule(n), jax_server.probe_molecule(n)
        for name in ("atom_type", "pos", "bond_index", "bond_type"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert got.smiles == want.smiles and got.num_nodes == want.num_nodes


def test_warm_classes_key_tight_classes_by_atom_count(model):
    """Bucket 32 is a triu class whatever the size; at bucket 64 (tight)
    the port keys each atom count of a capacity apart, where JAX keys the
    capacity; each JAX class's molecule is the largest of the port's."""
    jcfg, cfg, _, _, tmodel = model
    port = GenerationRunner(tmodel, cfg, make_diffusion(cfg),
                            SamplerConfig(), buckets=(32, 64), device="cpu")
    jax = JaxRunner(None, None, None, JaxSamplerConfig(), buckets=(32, 64),
                    use_fast=True, model_config=jcfg)
    sizes = (10, 20, 40, 47, 48, 48, 60)
    got = server.warm_classes(port, [server.probe_molecule(n)
                                     for n in sizes])
    want = jax_server.warm_classes(jax, [jax_server.probe_molecule(n)
                                         for n in sizes])
    assert set(got) == {(32, None, None), (64, 1024, 40), (64, 1280, 47),
                        (64, 1280, 48), (64, 1792, 60)}
    assert set(want) == {(32, None), (64, 1024), (64, 1280), (64, 1792)}
    for (b, cap), mol in want.items():
        ours = [m for key, m in got.items() if key[:2] == (b, cap)]
        assert max(m.num_nodes for m in ours) == mol.num_nodes
        if cap is not None:
            assert all(m.num_nodes * (m.num_nodes - 1) // 2 <= cap
                       for m in ours)


def test_replies_match_jax(services, tmp_path):
    """ping, warm, generate inline and saved, evaluate, an unknown
    command, bad JSON and a generate without a dataset: the same keys and
    `ok` on both services, and the same message where it is one line."""
    ports = {k: p for k, (_, p, _) in services.items()}
    replies = {k: {} for k in ports}
    for side, port in ports.items():
        out = tmp_path / side
        r = replies[side]
        r["ping"] = submit({"cmd": "ping"}, port=port, timeout=TIMEOUT)
        r["warm"] = submit({"cmd": "warm", "nodes": [12], "num_samples": 8},
                           port=port, timeout=TIMEOUT)
        r["inline"] = submit(_gen(4, batch=False), port=port,
                             timeout=TIMEOUT)
        r["saved"] = submit(_gen(5, batch=False, num_confs="2x", save=True,
                                 return_pos=False, out_dir=str(out)),
                            port=port, timeout=TIMEOUT)
        r["evaluate"] = submit({"cmd": "evaluate", "num_workers": 0,
                                "samples": r["saved"].get("out")},
                               port=port, timeout=TIMEOUT)
        r["unknown"] = submit({"cmd": "frobnicate"}, port=port,
                              timeout=TIMEOUT)
        r["bad_json"] = _raw(port, b"{not json\n")
        r["no_dataset"] = submit({"cmd": "generate", "out_dir": str(out),
                                  "batch": False}, port=port,
                                 timeout=TIMEOUT)
    for name, jax_reply in replies["jax"].items():
        ours = replies["port"][name]
        assert set(ours) == set(jax_reply), name
        assert ours["ok"] == jax_reply["ok"], (name, ours)
    ok = {k for k, v in replies["port"].items() if v["ok"]}
    assert ok == {"ping", "warm", "inline", "saved", "evaluate"}
    for name in ("unknown", "bad_json"):
        assert replies["port"][name]["error"] == replies["jax"][name]["error"]
    assert replies["port"]["no_dataset"]["error"].rstrip().endswith(
        "generate needs 'test_set' or 'synthetic'")
    assert replies["port"]["saved"]["samples"] == \
        replies["jax"]["saved"]["samples"] == 8
    assert replies["port"]["evaluate"]["molecules"] == 2
    assert np.isfinite(replies["port"]["evaluate"]["MAT-R_mean"])


def test_inline_positions_are_the_runners(services):
    """A request's inline positions equal PackedGenerationRunner.run called
    directly on its molecules with the same item seeds, bit for bit."""
    svc, port, _ = services["port"]
    reply = submit(_gen(4, batch=False), port=port, timeout=TIMEOUT)
    mols = synthetic_dataset(2, seed=7, num_conformers=2)
    with svc.device_lock:
        direct = svc.runner.run(mols, None, seed=4, num_confs=2,
                                item_seeds=[(4, 0), (4, 1)], save=False,
                                resume=False)
    for got, mol in zip(reply["pos"], direct):
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      mol.meta["pos_gen"])


def test_concurrent_requests_merge_and_keep_their_samples(services):
    """Three requests at once ride one packed run (batched_with >= 1 for
    at least two) and each gives its solo ("batch": false) samples: the
    same chunk batch size (8), the starts keyed by its own seed, and a
    noise-free ladder."""
    _, port, _ = services["port"]
    solo = {s: submit(_gen(s, batch=False), port=port, timeout=TIMEOUT)
            for s in (1, 2, 3)}
    assert all(r["ok"] and "batched_with" not in r for r in solo.values())
    merged = _concurrent(port, {s: _gen(s) for s in (1, 2, 3)})
    for s, r in merged.items():
        assert r["ok"] and r["molecules"] == 2 and r["samples"] == 4
        for got, want in zip(r["pos"], solo[s]["pos"]):
            np.testing.assert_array_equal(np.asarray(got, np.float32),
                                          np.asarray(want, np.float32))
    assert max(r["batched_with"] for r in merged.values()) >= 1


def test_over_capacity_reject_matches_jax(services):
    """A molecule above max_nodes is rejected with JAX's one-line message
    and marker, merged or alone, while a request merged with it is
    answered."""
    over = _gen(11, n_mols=1, synthetic_heavy=20)
    for batch in (True, False):
        got = {}
        for side, (_, port, _) in services.items():
            if batch:
                got[side] = _concurrent(port, {"over": over, "ok": _gen(12)})
            else:
                got[side] = {"over": submit({**over, "batch": False},
                                            port=port, timeout=TIMEOUT)}
        for side in got:
            assert got[side]["over"]["ok"] is False
            assert got[side]["over"]["rejected"] == "over_capacity"
            assert "Traceback" not in got[side]["over"]["error"]
        assert got["port"]["over"] == got["jax"]["over"]
        assert f"server capacity {MAX_NODES}" in got["port"]["over"]["error"]
        if batch:
            assert got["port"]["ok"]["ok"] and got["port"]["ok"]["samples"] \
                == 4


def test_batch_window_needs_a_packed_runner(model):
    _, cfg, _, _, tmodel = model
    runner = GenerationRunner(tmodel, cfg, make_diffusion(cfg),
                              SamplerConfig(**LADDER), device="cpu",
                              **RUNNER)
    with pytest.raises(ValueError, match="PackedGenerationRunner"):
        GenerationService(runner, batch_window_s=0.5)


def test_cli_refuses_what_it_cannot_serve():
    """`--num_devices` beyond the machine's cards raises before any
    checkpoint is read (data-parallel serving itself runs in
    tests/test_torch_port_parallel_cli.py); `--batch_window` needs
    `--packed`, as in the JAX CLI."""
    import torch

    from agdiff_torch.cli import serve

    too_many = (torch.cuda.device_count() if torch.cuda.is_available()
                else 0) + 1
    with pytest.raises(ValueError, match=f"requested {too_many} devices"):
        serve.main(["missing.pt", "--num_devices", str(too_many)])
    with pytest.raises(SystemExit):
        serve.main(["missing.pt", "--batch_window", "0.2"])
    with pytest.raises(SystemExit):
        serve.main([])


def test_shutdown_replies_match_jax(services):
    replies = {}
    for side, (_, port, thread) in services.items():
        replies[side] = submit({"cmd": "shutdown"}, port=port,
                               timeout=TIMEOUT)
        thread.join(timeout=JOIN)
        assert not thread.is_alive()
    assert replies["port"] == replies["jax"] == {"ok": True,
                                                 "shutdown": True}
