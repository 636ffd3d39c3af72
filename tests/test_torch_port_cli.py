"""The port's generation entry point against the JAX package: the .npz
molecule format both ways, the test-set packing, reference .pt
checkpoints (import and export), and `python -m agdiff_torch.cli.generate`
on the CPU, whose files JAX's `load_samples` reads, with resume, partial
ranges and the module path."""

import os
import pickle

import numpy as np
import pytest
import torch

from agdiff_tpu.chem.mol import (
    Molecule as JaxMolecule,
    load_molecules as jax_load,
    save_molecules as jax_save,
)
from agdiff_tpu.data.dataset import (
    PackedConformationDataset as JaxPacked,
)
from agdiff_tpu.eval.generate import load_samples as jax_load_samples
from agdiff_tpu.train.import_torch import (
    export_reference_state_dict as jax_export,
    load_reference_checkpoint as jax_load_checkpoint,
)

from agdiff_torch.chem.mol import load_molecules, save_molecules
from agdiff_torch.cli import generate as cli
from agdiff_torch.data.dataset import PackedConformationDataset
from agdiff_torch.data.synthetic import synthetic_dataset
from agdiff_torch.eval import generate
from agdiff_torch.models.reference_checkpoint import (
    export_reference_state_dict,
    load_reference_checkpoint,
)

from test_torch_port_common import (
    SMALL,
    batches,
    configs,
    jax_variables,
    molecules,
    port_model,
    port_molecule,
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A reference checkpoint of a small model (JAX's exporter, saved as
    the reference saves) and a two-molecule test set."""
    jcfg, cfg = configs()
    mols = molecules(2, seed=13)
    jb, _ = batches(mols, 16)
    _, variables = jax_variables(jcfg, jb)
    root = tmp_path_factory.mktemp("cli")
    ckpt = str(root / "ckpt" / "model.pt")
    os.makedirs(os.path.dirname(ckpt))
    torch.save({"model": jax_export(variables, jcfg),
                "config": {"model": dict(SMALL)}}, ckpt)
    test_set = str(root / "test.npz")
    jax_save(test_set, mols)
    return jcfg, cfg, variables, mols, ckpt, test_set, root


def _fields(m):
    return (m.atom_type, m.pos, m.bond_index, m.bond_type, m.pos_ref)


def test_molecule_files_read_across_packages(setup, tmp_path):
    mols = [JaxMolecule(*_fields(m)[:4], pos_ref=m.pos_ref, smiles=m.smiles,
                        meta={"idx": 3, "smiles_ok": True})
            for m in setup[3]]
    jax_path, port_path = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jax_save(jax_path, mols)
    save_molecules(port_path, [port_molecule(m) for m in mols])
    for a, b in ((load_molecules(jax_path), mols),
                 (jax_load(port_path), mols)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            for fx, fy in zip(_fields(x), _fields(y)):
                np.testing.assert_array_equal(fx, fy)
            assert x.smiles == y.smiles
    assert load_molecules(jax_path)[0].meta == {"idx": 3, "smiles_ok": True}


def test_packing_gives_jax_pos_ref_and_order(tmp_path):
    """Per-conformer molecules (two SMILES, interleaved) pack into one
    molecule each, in first-seen order, conformers stacked in pos_ref;
    the same conformers as the reference's .pkl pack alike."""
    base = molecules(2, seed=4)
    rng = np.random.default_rng(0)
    confs = []
    for k in range(5):
        m = base[k % 2]
        confs.append(JaxMolecule(
            atom_type=m.atom_type, pos=m.pos + rng.normal(size=m.pos.shape),
            bond_index=m.bond_index, bond_type=m.bond_type,
            smiles=f"S{k % 2}"))
    want = JaxPacked(confs).molecules
    got = PackedConformationDataset([port_molecule(m) for m in confs])
    assert [m.smiles for m in got.molecules] == [m.smiles for m in want]
    for x, y in zip(got.molecules, want):
        np.testing.assert_array_equal(x.pos_ref, y.pos_ref)
        np.testing.assert_array_equal(x.pos, y.pos)
    assert got.num_refs(0) == 3 and got.num_refs(1) == 2
    from test_torch_port_geom import legacy_of

    path = str(tmp_path / "confs.pkl")
    with open(path, "wb") as f:
        pickle.dump([legacy_of(m) for m in confs], f)
    from_pkl = PackedConformationDataset(path)
    assert [m.smiles for m in from_pkl.molecules] == [m.smiles for m in want]
    for x, y in zip(from_pkl.molecules, want):
        np.testing.assert_array_equal(x.pos_ref, y.pos_ref)


def test_reference_checkpoint_loads_bitwise(setup, tmp_path):
    """The port's loader gives the weights of JAX's importer followed by
    load_jax_variables, bit for bit; an unknown key raises; the port's
    export equals JAX's key for key."""
    jcfg, cfg, variables, _, ckpt, _, _ = setup
    model, config = load_reference_checkpoint(ckpt)
    assert config == cfg
    jvars, jconfig = jax_load_checkpoint(ckpt)
    want = port_model(cfg, jvars).state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    exported, ref = export_reference_state_dict(model), jax_export(
        variables, jcfg)
    assert set(exported) == set(ref)
    for key in ref:
        assert exported[key].dtype == ref[key].dtype, key
        assert torch.equal(exported[key], ref[key]), key
    bad = str(tmp_path / "bad.pt")
    sd = dict(ref, **{"encoder_global.extra.weight": torch.zeros(1)})
    torch.save({"model": sd, "config": {"model": dict(SMALL)}}, bad)
    with pytest.raises(KeyError, match="extra"):
        load_reference_checkpoint(bad)
    del sd["encoder_global.extra.weight"], sd["encoder_local.node_emb.weight"]
    torch.save({"model": sd, "config": {"model": dict(SMALL)}}, bad)
    with pytest.raises(KeyError, match="node_emb"):
        load_reference_checkpoint(bad)


def _argv(setup, out_dir, *extra):
    ckpt, test_set = setup[4], setup[5]
    return [ckpt, "--test_set", test_set, "--out_dir", str(out_dir),
            "--n_steps", "3", "--num_confs", "2", "--chunk_size", "4",
            "--w_global", "0.3", "--device", "cpu", *extra]


@pytest.fixture
def counted(monkeypatch):
    """Counts the molecules the runner generates (not loads)."""
    made = []
    real = generate.GenerationRunner.generate_molecule

    def spy(self, mol, num_samples, gen):
        made.append(mol.num_nodes)
        return real(self, mol, num_samples, gen)

    monkeypatch.setattr(generate.GenerationRunner, "generate_molecule", spy)
    return made


def test_cli_generates_on_mono_and_resumes(setup, counted):
    """--fast --engine mono writes samples JAX's load_samples reads; a
    second run resumes without generating; --no_resume regenerates the
    same conformers (the generator is seeded from the dataset index)."""
    mols, root = setup[3], setup[6]
    out = root / "mono"
    cli.main(_argv(setup, out, "--fast", "--engine", "mono"))
    assert len(counted) == 2
    first = jax_load_samples(str(out / "samples_all.npz"))
    assert len(first) == 2
    for mol, got in zip(mols, first):
        pg = got.meta["pos_gen"]
        assert pg.shape == (2, mol.num_nodes, 3) and np.isfinite(pg).all()
        np.testing.assert_array_equal(got.atom_type, mol.atom_type)
    single = jax_load_samples(str(out / "samples_1.npz"))[0]
    np.testing.assert_array_equal(single.meta["pos_gen"],
                                  first[1].meta["pos_gen"])
    assert os.path.exists(out / "log.txt")
    stamp = os.path.getmtime(out / "samples_0.npz")
    cli.main(_argv(setup, out, "--fast", "--engine", "mono"))
    assert len(counted) == 2 and os.path.getmtime(
        out / "samples_0.npz") == stamp
    cli.main(_argv(setup, out, "--fast", "--engine", "mono", "--no_resume"))
    assert len(counted) == 4
    again = generate.load_samples(str(out / "samples_all.npz"))
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.meta["pos_gen"], b.meta["pos_gen"])


def test_cli_partial_range_gives_the_whole_runs_conformers(setup):
    root = setup[6]
    whole, part = root / "whole", root / "part"
    cli.main(_argv(setup, whole, "--fast", "--engine", "mono"))
    cli.main(_argv(setup, part, "--fast", "--engine", "mono",
                   "--start_idx", "1"))
    got = jax_load_samples(str(part / "samples_all.npz"))
    assert len(got) == 1 and not os.path.exists(part / "samples_0.npz")
    want = jax_load_samples(str(whole / "samples_1.npz"))[0]
    np.testing.assert_array_equal(got[0].meta["pos_gen"],
                                  want.meta["pos_gen"])


def test_cli_without_fast_takes_the_module_path(setup, monkeypatch):
    """Without --fast the ladder runs on the dense module (JAX's
    build_sampler path) and --engine has no effect."""
    root = setup[6]
    built = []
    real = generate.build_sampler

    def spy(model, diffusion, config, **kw):
        built.append(type(model).__name__)
        return real(model, diffusion, config, **kw)

    monkeypatch.setattr(generate, "build_sampler", spy)
    monkeypatch.setattr(generate, "build_monolithic_forward", None)
    out = root / "module"
    cli.main(_argv(setup, out, "--engine", "mono"))
    assert built == ["DualEncoderEpsNetwork"]
    got = jax_load_samples(str(out / "samples_all.npz"))
    assert all(np.isfinite(m.meta["pos_gen"]).all() for m in got)


def test_cli_synthetic_molecules_with_every_sampler_flag(setup, counted):
    """--synthetic takes the molecules from data/synthetic.py (seed 7,
    three reference conformers each) in place of --test_set, and the
    sampler flags reach the runner: a strided Heun ladder with a denoise
    tail writes every molecule's samples."""
    ckpt, root = setup[4], setup[6]
    out = root / "synthetic"
    cli.main([ckpt, "--synthetic", "2", "--synthetic_heavy", "4",
              "--ladder", "strided", "--sampling_type", "generalized",
              "--eta", "0", "--solver", "heun", "--denoise_tail", "2",
              "--n_steps", "4", "--chunk_size", "4", "--w_global", "0.3",
              "--out_dir", str(out), "--device", "cpu"])
    assert len(counted) == 2
    got = jax_load_samples(str(out / "samples_all.npz"))
    want = synthetic_dataset(2, seed=7, num_conformers=3, min_heavy=4,
                             max_heavy=4)
    assert len(got) == 2
    for k, (mol, res) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(res.atom_type, mol.atom_type)
        pg = res.meta["pos_gen"]
        assert pg.shape == (6, mol.num_nodes, 3) and np.isfinite(pg).all()
        assert os.path.exists(out / f"samples_{k}.npz")
    with pytest.raises(SystemExit):
        cli.main([ckpt, "--n_steps", "4", "--device", "cpu"])
