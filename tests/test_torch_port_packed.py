"""PackedGenerationRunner in the port against the JAX package's: the
chunks it pads (which molecule and sample in which slot, the bucket, the
batch size, the pair capacity) on a mixed QM9-size set and a Drugs-size
set with repeated atom counts (grouped by atom count at the tight
engines' buckets); a request's samples packed against the same request
alone (DDIM at eta 0, item seeds); resume; `--packed` through the CLI."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from agdiff_tpu.eval import generate as jax_generate
from agdiff_tpu.sampling.langevin import SamplerConfig as JaxSamplerConfig

from agdiff_torch.cli import generate as cli
from agdiff_torch.eval import generate
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.reference_checkpoint import (
    export_reference_state_dict,
)
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.models.weights import init_random
from agdiff_torch.sampling.langevin import SamplerConfig

from agdiff_tpu.data.synthetic import synthetic_dataset

from test_torch_port_common import SMALL, configs, port_molecule

BUCKETS = (16, 48)
CHUNK = 8
SETS = {   # molecules, per-item sample counts
    # QM9 size (7-14 atoms, bucket 16, triu engines)
    "qm9": (dict(n=8, seed=21, min_heavy=3, max_heavy=6),
            [3, 5, 2, 7, 4, 1, 9, 2]),
    # Drugs size (31-41 atoms, bucket 48, tight engines): 35, 36, 37 and
    # 40 atoms twice each
    "drugs": (dict(n=10, seed=0, min_heavy=13, max_heavy=15),
              [2, 3, 5, 1, 4, 2, 6, 3, 2, 5])}
# a request alone against the same request packed, DDIM at eta 0 (no
# noise): the same bits at one batch size; across batch sizes the CPU's
# batched products may sum in another order (measured 0 here), held to
# 1e-5 of the largest coordinate
ACROSS_BATCH_TOL = 1e-5


def _mols(name):
    kw, counts = SETS[name]
    kw = dict(kw)
    return synthetic_dataset(kw.pop("n"), **kw), counts


def _jax_chunks(mols, counts, monkeypatch):
    """The JAX packed runner's chunks: (slot molecules by index, bucket,
    batch size, capacity), its ladder stubbed out (no program runs)."""
    jcfg, _ = configs(dtype="bfloat16")
    runner = jax_generate.PackedGenerationRunner(
        None, None, None, JaxSamplerConfig(n_steps=2), buckets=BUCKETS,
        chunk_size=CHUNK, use_fast=True, model_config=jcfg)
    index = {id(m): i for i, m in enumerate(mols)}
    chunks, real_pad = [], jax_generate.pad_molecules

    def pad(ms, bucket, batch_size=None, **kw):
        chunks.append([[index[id(m)] for m in ms], bucket, batch_size])
        return real_pad(ms, bucket, batch_size=batch_size, **kw)

    class Stub:
        fused = False

        def __call__(self, variables, batch, pos_init, key):
            b = batch.pos.shape[0]
            return SimpleNamespace(pos=np.zeros(batch.pos.shape, np.float32),
                                   nan_flags=np.zeros(b, bool))

    monkeypatch.setattr(jax_generate, "pad_molecules", pad)

    def get(bucket, retry, capacity=None, engine=None):
        chunks[-1].append(capacity)
        return Stub()

    runner._sampler = get
    runner.run(mols, "unused", num_confs=counts, save=False)
    return chunks


def _port_chunks(mols, counts, monkeypatch):
    _, cfg = configs(dtype="bfloat16")
    model = DualEncoderEpsNetwork(cfg)
    runner = generate.PackedGenerationRunner(
        model, cfg, make_diffusion(cfg), SamplerConfig(n_steps=2),
        buckets=BUCKETS, chunk_size=CHUNK, device="cpu")
    index = {id(m): i for i, m in enumerate(mols)}
    chunks, real_pad = [], generate.pad_molecules

    def pad(ms, bucket, batch_size=None, **kw):
        chunks.append([[index[id(m)] for m in ms], bucket, batch_size])
        return real_pad(ms, bucket, batch_size=batch_size, **kw)

    def stub(batch, pos_init, generator=None):
        return SimpleNamespace(pos=torch.zeros_like(pos_init),
                               nan_flags=torch.zeros(len(pos_init),
                                                     dtype=torch.bool))

    def get(engine, retry, capacity=None):
        chunks[-1].append(capacity)
        return stub

    monkeypatch.setattr(generate, "pad_molecules", pad)
    runner._sampler = get
    out = runner.run(mols, None, num_confs=counts)
    return chunks, out, runner


@pytest.mark.parametrize("name", list(SETS))
def test_chunks_match_jax(name, monkeypatch):
    """Slot by slot the same chunks as the JAX runner, the tight groups
    of one atom count each; every molecule gets its samples back."""
    jmols, counts = _mols(name)
    want = _jax_chunks(jmols, counts, monkeypatch)
    mols = [port_molecule(m) for m in jmols]
    got, out, runner = _port_chunks(mols, counts, monkeypatch)
    assert got == want
    assert sum(len(c[0]) for c in got) >= sum(counts)
    assert [len(m.meta["pos_gen"]) for m in out] == counts
    for slots, bucket, bsz, capacity in got:
        sizes = {mols[i].num_nodes for i in slots}
        tight = runner._engine_for(bucket) in generate._TIGHT_ENGINES
        assert tight == (name == "drugs") and bsz == len(slots)
        assert len(sizes) == 1 if tight else capacity is None
    if name == "drugs":   # different molecules share a chunk
        assert any(len({i for i in c[0]}) > 1 for c in got)


@pytest.fixture(scope="module")
def small_model():
    _, cfg = configs()
    return cfg, init_random(DualEncoderEpsNetwork(cfg), 3).eval()


def _ddim_runner(cfg, model, chunk=CHUNK):
    return generate.PackedGenerationRunner(
        model, cfg, make_diffusion(cfg),
        SamplerConfig(n_steps=4, ladder="strided",
                      sampling_type="generalized", eta=0.0, w_global=0.3),
        buckets=BUCKETS, chunk_size=chunk, device="cpu")


@pytest.mark.parametrize("name", list(SETS))
def test_a_request_packed_gives_its_samples_alone(name, small_model):
    """Request 0 (item seeds) co-batched with others against request 0
    alone: bit for bit at one batch size (3 + 3 + 2 slots and 3 slots
    both pad to 8), within ACROSS_BATCH_TOL at another (16)."""
    cfg, model = small_model
    jmols, _ = _mols(name)
    mols = [port_molecule(m) for m in jmols]
    if name == "drugs":   # one atom count (36): one tight group
        sizes = [m.num_nodes for m in mols]
        same = [k for k, m in enumerate(mols) if sizes[k] == sizes[0]]
        mols = [mols[k] for k in same] + [mols[0]]
    mols = mols[:3]
    seeds = [(7, 100), (8, 5), (9, 6)]
    alone = _ddim_runner(cfg, model).run(mols[:1], None, num_confs=[3],
                                         item_seeds=seeds[:1])
    packed8 = _ddim_runner(cfg, model).run(mols, None, num_confs=[3, 3, 2],
                                           item_seeds=seeds)
    packed16 = _ddim_runner(cfg, model, 16).run(
        mols, None, num_confs=[3, 6, 5], item_seeds=seeds)
    want = alone[0].meta["pos_gen"]
    assert want.shape == (3, mols[0].num_nodes, 3) and np.isfinite(want).all()
    np.testing.assert_array_equal(packed8[0].meta["pos_gen"], want)
    np.testing.assert_allclose(packed16[0].meta["pos_gen"], want, rtol=0,
                               atol=ACROSS_BATCH_TOL * np.abs(want).max())
    # each sample index has a start of its own
    assert not np.allclose(want[0], want[1])


def test_resume_and_the_cli_flag(small_model, tmp_path):
    """run() writes each molecule's file and samples_all.npz; a rerun
    loads the written molecules and generates only the missing one; the
    CLI's --packed runs this runner."""
    cfg, model = small_model
    mols = [port_molecule(m) for m in _mols("qm9")[0][:3]]
    out = tmp_path / "run"
    first = _ddim_runner(cfg, model).run(mols, str(out), num_confs=2)
    stamps = {i: os.path.getmtime(out / f"samples_{i}.npz") for i in (0, 2)}
    os.remove(out / "samples_1.npz")
    made = []
    runner = _ddim_runner(cfg, model)
    real = runner._sampler

    def spy(engine, retry, capacity=None):
        made.append(retry)
        return real(engine, retry, capacity)

    runner._sampler = spy
    again = runner.run(mols, str(out), num_confs=2)
    assert made == [False]
    assert {i: os.path.getmtime(out / f"samples_{i}.npz")
            for i in (0, 2)} == stamps
    for a, b in zip(first, again):
        assert b.meta["pos_gen"].shape == a.meta["pos_gen"].shape
    assert len(generate.load_samples(str(out / "samples_all.npz"))) == 3
    # the CLI with --packed, on a reference .pt of the model
    ckpt = tmp_path / "ckpt" / "model.pt"
    ckpt.parent.mkdir()
    torch.save({"model": export_reference_state_dict(model),
                "config": {"model": dict(SMALL)}}, ckpt)
    runs = []
    real_run = generate.PackedGenerationRunner.run

    def spy_run(self, *a, **kw):
        runs.append(type(self).__name__)
        return real_run(self, *a, **kw)

    generate.PackedGenerationRunner.run = spy_run
    try:
        cli.main([str(ckpt), "--synthetic", "3", "--synthetic_heavy", "4",
                  "--out_dir", str(tmp_path / "cli"), "--n_steps", "3",
                  "--num_confs", "2", "--chunk_size", "8", "--fast",
                  "--packed", "--device", "cpu"])
    finally:
        generate.PackedGenerationRunner.run = real_run
    assert runs == ["PackedGenerationRunner"]
    got = generate.load_samples(str(tmp_path / "cli" / "samples_all.npz"))
    assert [m.meta["pos_gen"].shape[0] for m in got] == [2, 2, 2]
    assert all(np.isfinite(m.meta["pos_gen"]).all() for m in got)
