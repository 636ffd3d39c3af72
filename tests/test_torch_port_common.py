"""Shared inputs of the tests/test_torch_port_* files (no tests here): a
small model config in both packages, JAX variables with non-trivial
BatchNorm statistics and learnable betas, the same weights in the port,
and one padded batch in both layouts."""

import jax
import numpy as np
import torch

from agdiff_tpu.config import ModelConfig as JaxModelConfig
from agdiff_tpu.data.bucketing import pad_molecules as jax_pad
from agdiff_tpu.data.synthetic import synthetic_dataset
from agdiff_tpu.models.dualenc import get_model

from agdiff_torch.chem.mol import Molecule
from agdiff_torch.config import ModelConfig
from agdiff_torch.data.bucketing import pad_molecules
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.weights import load_jax_variables

torch.set_num_threads(2)

SMALL = dict(hidden_dim=32, num_convs=2, num_convs_local=2,
             num_diffusion_timesteps=100)
# XLA's CPU backend without its optimisation passes: a JAX reference here
# is a small program run once, and at level 0 it compiles about 4x faster,
# to the same values within f32 rounding (7e-8 of a score plane of ~1)
FAST_XLA = {"xla_backend_optimization_level": 0}


def jax_run(fn, *args):
    """fn(*args), traced into one program compiled with FAST_XLA (a
    Pallas kernel in interpret mode included)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(*args)


def configs(**overrides):
    """(JAX config, port config) with the same fields."""
    kw = {**SMALL, **overrides}
    return JaxModelConfig(**kw), ModelConfig(**kw)


def molecules(n=3, seed=21):
    return synthetic_dataset(n, seed=seed, min_heavy=3, max_heavy=5)


def port_molecule(m):
    return Molecule(atom_type=m.atom_type, pos=m.pos, bond_index=m.bond_index,
                    bond_type=m.bond_type, pos_ref=m.pos_ref, smiles=m.smiles)


def batches(mols, max_nodes=16, batch_size=None):
    """The same padded batch as a JAX GraphBatch and a port GraphBatch."""
    jb = jax_pad(mols, max_nodes, batch_size=batch_size)
    tb = pad_molecules([port_molecule(m) for m in mols], max_nodes,
                       batch_size=batch_size)
    return jb, tb


# variable shapes by config: they depend on neither the values nor the
# shape of the batch the init is traced with
_SHAPES = {}


def _initial_variables(model, jcfg, jbatch, rng):
    """The JAX model's variables as numpy: flax's tree and shapes (from
    tracing its init, which compiles nothing), filled from `rng` as the
    model's initializers fill them: dense kernels and their biases uniform
    in +-1/sqrt(fan_in), embeddings standard normal, BatchNorm statistics
    and affines and learnable betas at their initial values."""
    key = repr(jcfg)
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(
            lambda k, b: model.init(k, b, train=False),
            jax.random.PRNGKey(0), jbatch)

    def fill(tree):
        out = {}
        bound = (1.0 / np.sqrt(tree["kernel"].shape[0]) if "kernel" in tree
                 else None)
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = fill(v)
                continue
            if k in ("kernel", "bias") and bound is not None:
                out[k] = rng.uniform(-bound, bound, v.shape)
            elif k == "embedding":
                out[k] = rng.normal(0.0, 1.0, v.shape)
            elif k in ("var", "beta", "scale"):
                out[k] = np.ones(v.shape)
            elif k in ("mean", "bias"):    # a BatchNorm's
                out[k] = np.zeros(v.shape)
            else:
                raise ValueError(f"no initializer for variable {k!r}")
            out[k] = np.asarray(out[k], dtype=v.dtype)
        return out

    return fill(_SHAPES[key])


def jax_variables(jcfg, jbatch, seed=9):
    """Initialised JAX variables as numpy, with BatchNorm statistics,
    BatchNorm affines and learnable betas moved off their initial values
    (so BN folding and the betas are really exercised)."""
    model = get_model(jcfg)
    variables = _initial_variables(model, jcfg, jbatch,
                                   np.random.default_rng((seed, 1)))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k == "mean":
                out[k] = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("beta", "scale"):
                out[k] = rng.uniform(0.6, 1.4, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return model, perturb(variables)


def row_product(x, w):
    """x @ w as a sum over k in increasing order: each row's bits depend
    on that row alone, as in the kernels' products. (A CPU BLAS handles a
    matrix's last rows with other kernels, so there a row's bits can
    depend on how many rows the matrix has.)"""
    acc = x[..., :1] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + x[..., k:k + 1] * w[k]
    return acc


def port_model(cfg, variables):
    model = DualEncoderEpsNetwork(cfg)
    load_jax_variables(model, variables)
    return model.eval()
