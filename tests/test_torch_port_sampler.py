"""The port's Langevin ladder against the JAX package's with the same
noise, the generation runner end to end on the CPU, and the port's
independence from JAX."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.models.fast_forward import build_fast_forward as jax_fast
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.sampling.langevin import (
    SamplerConfig as JaxSamplerConfig,
    langevin_dynamics_sample,
)

from agdiff_torch.data.fixture import load_fixture
from agdiff_torch.eval.generate import GenerationRunner
from agdiff_torch.models.dualenc import ModelOutput
from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.sampling.langevin import (
    SamplerConfig,
    langevin_dynamics_sample as port_ld,
)

from test_torch_port_common import (
    batches,
    configs,
    jax_variables,
    molecules,
    port_model,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 10
# a step size large enough that the drift moves atoms visibly, and the
# global branch switched on, so the comparison covers both branches
LADDER = dict(n_steps=STEPS, step_lr=2e-4, w_global=0.3,
              global_start_sigma=10.0, clip=5.0, clip_local=4.0)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = configs()
    jb, tb = batches(molecules(3, seed=8), batch_size=4)
    _, variables = jax_variables(jcfg, jb)
    return jcfg, cfg, jb, tb, variables


def test_ld_ladder_matches_jax_with_replayed_noise(setup):
    jcfg, cfg, jb, tb, variables = setup
    rng = np.random.default_rng(2)
    pos_init = rng.normal(size=tb.pos.shape).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = langevin_dynamics_sample(
        None, None, jb, jnp.asarray(pos_init), key, jax_diffusion(jcfg),
        JaxSamplerConfig(**LADDER),
        forward_fn=jax_fast(jcfg, variables, use_pallas=False))
    # the JAX ladder draws normal(noise_key) after key, noise_key = split(key)
    noise = []
    for _ in range(STEPS):
        key, noise_key = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(
            noise_key, tb.pos.shape, jnp.float32)))
    fwd = build_fast_forward(cfg, port_model(cfg, variables), None)
    got = port_ld(fwd, tb, torch.from_numpy(pos_init), make_diffusion(cfg),
                  SamplerConfig(**LADDER),
                  noise=torch.from_numpy(np.stack(noise)))
    assert fwd.calls == STEPS
    moved = np.abs(np.asarray(ref.pos) - pos_init * make_diffusion(
        cfg).sigmas[-1] * tb.node_mask.numpy()[..., None]).max()
    assert moved > 1e-2
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               atol=1e-4)
    np.testing.assert_array_equal(got.nan_flags.numpy(),
                                  np.asarray(ref.nan_flags))


def test_ld_ladder_flags_and_zeroes_non_finite_graphs(setup):
    _, cfg, _, tb, variables = setup
    fwd = build_fast_forward(cfg, port_model(cfg, variables), None)

    def poisoned(batch, **kw):
        out = fwd(batch, **kw)
        s = out.edge_inv_local.clone()
        s[1] = float("nan")
        return ModelOutput(s, *out[1:])

    res = port_ld(poisoned, tb, torch.randn(tb.pos.shape),
                  make_diffusion(cfg), SamplerConfig(n_steps=3),
                  generator=torch.Generator().manual_seed(0))
    assert res.nan_flags.tolist() == [False, True, False, False]
    assert torch.isfinite(res.pos).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generation_runner_on_cpu(setup, dtype):
    _, cfg, _, _, variables = setup
    import dataclasses

    cfg = dataclasses.replace(cfg, dtype=dtype)
    mols = load_fixture()[:2]
    runner = GenerationRunner(
        port_model(cfg, variables), cfg, make_diffusion(cfg),
        SamplerConfig(n_steps=3, w_global=0.3), buckets=(32,), chunk_size=4,
        device="cpu")
    out = runner.run(mols, seed=1, num_confs="2x")
    assert runner._engine_for(32) == ("pksf" if dtype == "bfloat16"
                                      else None)
    for mol, res in zip(mols, out):
        pg = res.meta["pos_gen"]
        assert pg.shape == (2 * mol.num_ref, mol.num_nodes, 3)
        assert np.isfinite(pg).all()
        assert np.abs(pg).max() > 0
    # same seed, same conformers
    again = runner.run(mols[:1], seed=1, num_confs="2x")
    np.testing.assert_array_equal(again[0].meta["pos_gen"],
                                  out[0].meta["pos_gen"])


def test_generation_runner_retries_non_finite_chunks(setup):
    _, cfg, _, _, variables = setup
    runner = GenerationRunner(
        port_model(cfg, variables), cfg, make_diffusion(cfg),
        SamplerConfig(n_steps=4, step_lr=1e6), buckets=(32,), chunk_size=8,
        device="cpu")
    pg = runner.run(load_fixture()[:1], num_confs=5)[0].meta["pos_gen"]
    assert pg.shape[0] == 5 and np.isfinite(pg).all()
    assert (None, True, None) in runner._samplers  # the retry ran
    assert runner._batch_size_for(5) == 8
    assert runner.num_samples_for(load_fixture()[0], "3x") == 6


def test_entry_points_need_a_device_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from agdiff_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def test_port_imports_no_jax():
    """Importing every module of agdiff_torch, the CLIs under cli/ and
    the COV/MAT, training, serving and parallel (mesh, data-parallel,
    sharded, pipeline) modules, the .pkl reader (data/geom.py) and the
    protein path (chem/pdb.py, data/protein.py, the alanine dipeptide
    example), the host modules (data/native_relax.py, utils/profiling.py,
    the synthetic end-to-end example) and the RDKit and psi4 ones
    (chem/rdkit_bridge.py, the GEOM CLI, SMILES generation, properties)
    among them, loads neither jax nor agdiff_tpu, nor RDKit or psikit, nor
    tensorboard (utils/logging.py imports it in TensorBoardWriter), and no
    source names jax or agdiff_tpu in an import, or RDKit or psikit in
    an import at module level. The reader of converted JAX checkpoints
    (train/checkpoint.py) is among the listed modules; no module of the
    port and no chip_*.py script imports the converter
    (convert_jax_checkpoint.py, the one file of the port that imports
    jax)."""
    code = (
        "import importlib, pkgutil, sys, agdiff_torch\n"
        "for m in pkgutil.walk_packages(agdiff_torch.__path__, "
        "'agdiff_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'agdiff_tpu', 'rdkit', 'psikit', "
        "'psi4', 'tensorboard', 'tensorflow')]\n"
        "bad += [m for m in ('agdiff_torch.cli.generate', "
        "'agdiff_torch.cli._common', 'agdiff_torch.cli.eval_covmat', "
        "'agdiff_torch.chem.rmsd', 'agdiff_torch.chem.native_rmsd', "
        "'agdiff_torch.eval.covmat', 'agdiff_torch.eval.covmat_linear', "
        "'agdiff_torch.cli.train', 'agdiff_torch.train.trainer', "
        "'agdiff_torch.train.train_step', 'agdiff_torch.train.optimizer', "
        "'agdiff_torch.train.checkpoint', 'agdiff_torch.models.loss', "
        "'agdiff_torch.ops.masked', 'agdiff_torch.utils.logging', "
        "'agdiff_torch.utils.misc', 'agdiff_torch.serve.server', "
        "'agdiff_torch.cli.serve', 'agdiff_torch.parallel', "
        "'agdiff_torch.parallel.mesh', 'agdiff_torch.parallel.data_parallel', "
        "'agdiff_torch.parallel.sharded', 'agdiff_torch.parallel.pipeline', "
        "'agdiff_torch.data.geom', 'agdiff_torch.nn.edge_encoders', "
        "'agdiff_torch.chem.pdb', 'agdiff_torch.data.protein', "
        "'agdiff_torch.examples.alanine_dipeptide', "
        "'agdiff_torch.data.native_relax', 'agdiff_torch.utils.profiling', "
        "'agdiff_torch.examples.synthetic_end_to_end', "
        "'agdiff_torch.chem.rdkit_bridge', 'agdiff_torch.cli.preprocess', "
        "'agdiff_torch.cli.smiles_generation', "
        "'agdiff_torch.eval.properties', 'agdiff_torch.cli.eval_prop') "
        "if m not in sys.modules]\n"
        "print(len(list(pkgutil.walk_packages(agdiff_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|agdiff_tpu)\b",
                         re.M)
    sources = [os.path.join(d, f)
               for d, _, fs in os.walk(os.path.join(ROOT, "agdiff_torch"))
               for f in fs if f.endswith(".py")]
    sources += [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                                "chip_stamps.py",
                                                "chip_profile.py")]
    assert len(sources) > 20
    top_level = re.compile(r"^(import|from)\s+(rdkit|psikit|psi4)\b", re.M)
    converter = re.compile(r"^\s*(import|from)\s+convert_jax_checkpoint\b|"
                           r"import_module\([\"']convert_jax_checkpoint",
                           re.M)
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not pattern.search(text), path
        assert not top_level.search(text), path
        assert not converter.search(text), path
