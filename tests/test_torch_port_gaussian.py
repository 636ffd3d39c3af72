"""The 'gaussian' edge encoder (agdiff_tpu/nn/edge_encoders.py:81-94,
:132-176) against the JAX package on the CPU, on numpy-made inputs and
transplanted weights:

  * the module forward with edge_encoder 'gaussian', dense and
    packed_pairs, at f32 within 2e-4 on the masked score planes (the
    module path's class, PARITY.md section 2.1), and at bf16 within
    SCORE_REL = 2^-6 of each plane's largest value (two bf16 ulps there,
    tests/test_torch_port_bf16.py's limit; read 7.3e-3 dense and 3.7e-3
    packed on the global plane, 0 on the local one; f32 reads 3e-6);
  * one f32 train step: the losses, every gradient leaf and the running
    statistics against JAX's value_and_grad with injected timesteps and
    noise, under tests/test_torch_port_train.py's limits;
  * the weight bridge both ways and the optimizer's partition (the
    encoder's embedding takes the global Adam, as
    agdiff_tpu/train/optimizer.py:40-47 labels it);
  * every fast engine and 'mono' refusing the encoder with the JAX
    package's message, and the runner's module path generating with it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from agdiff_tpu.train import optimizer as jax_opt

from agdiff_torch.eval.generate import MODULE, GenerationRunner
from agdiff_torch.models.fast_forward import ENGINES, build_fast_forward
from agdiff_torch.models.mono_forward import build_monolithic_forward
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.models.tight_forward import ENGINES as TIGHT_ENGINES
from agdiff_torch.models.tight_forward import build_tight_forward
from agdiff_torch.models.weights import export_jax_variables, flax_leaf
from agdiff_torch.nn.edge_encoders import (
    GaussianSmearingEdgeEncoder,
    get_edge_encoder,
)
from agdiff_torch.sampling.langevin import SamplerConfig
from agdiff_torch.train import optimizer as port_opt

from test_torch_port_bf16 import SCORE_REL, jax_narrow
from test_torch_port_common import (
    batches,
    configs,
    jax_variables,
    molecules,
    port_model,
)
from test_torch_port_train import (
    GRAD_FLOOR,
    GRAD_RTOL,
    LOSS_RTOL,
    STATS_ATOL,
    _jax_step,
    port_step,
)

GAUSSIAN = dict(edge_encoder="gaussian")
F32_ATOL = 2e-4
B, N = 4, 16


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module", params=[
    ("float32", False), ("float32", True), ("bfloat16", False),
    ("bfloat16", True)],
    ids=["f32-dense", "f32-packed", "bf16-dense", "bf16-packed"])
def forward_case(request):
    dtype, packed = request.param
    jcfg, cfg = configs(dtype=dtype, packed_pairs=packed, **GAUSSIAN)
    jb, tb = batches(molecules(3, seed=5), N, batch_size=B)
    model, variables = jax_variables(jcfg, jb)
    want = jax_narrow(lambda v, b: model.apply(v, b, train=False),
                      variables, jb)
    with torch.no_grad():
        got = port_model(cfg, variables)(tb)
    return dtype, want, got


def test_gaussian_module_matches_jax(forward_case):
    dtype, want, got = forward_case
    for name, mask in (("edge_inv_global", "edge_mask"),
                       ("edge_inv_local", "local_mask")):
        m = np.asarray(getattr(want, mask))
        np.testing.assert_array_equal(getattr(got, mask).numpy(), m)
        w = np.asarray(getattr(want, name))
        g = getattr(got, name)
        assert g.dtype == torch.float32
        scale = float(np.abs(w[m]).max())
        assert scale > 1e-2, name
        err = float(np.abs(g.numpy() - w)[m].max())
        limit = F32_ATOL if dtype == "float32" else SCORE_REL * scale
        assert err <= limit, f"{name}: {err:.3e} > {limit:.3e}"


def test_gaussian_encoder_matches_jax_module():
    """The encoder alone against the flax module: out_channels =
    2 (hidden // 2), the RBF over [0, 2 cutoff], the embedding rows; at
    bf16 the output is f32 (JAX's promotion of the f32 RBF beside the
    bf16 embedding)."""
    import jax.numpy as jnp

    from agdiff_tpu.config import ModelConfig as JaxModelConfig
    from agdiff_tpu.nn.edge_encoders import get_edge_encoder as jax_encoder

    rng = np.random.default_rng(4)
    length = rng.uniform(0, 25, (3, 7, 1)).astype(np.float32)
    types = rng.integers(0, 8, (3, 7))
    for dtype, jd in ((torch.float32, jnp.float32),
                      (torch.bfloat16, jnp.bfloat16)):
        jcfg = JaxModelConfig(hidden_dim=32, **GAUSSIAN)
        jmod = jax_encoder(jcfg, jd)
        variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(length),
                              jnp.asarray(types))
        want = np.asarray(jmod.apply(variables, jnp.asarray(length),
                                     jnp.asarray(types)))
        enc = get_edge_encoder(configs(**GAUSSIAN)[1], dtype)
        assert isinstance(enc, GaussianSmearingEdgeEncoder)
        with torch.no_grad():
            enc.bond_emb.weight.copy_(torch.from_numpy(np.array(
                variables["params"]["bond_emb"]["embedding"])))
            got = enc(torch.from_numpy(length), torch.from_numpy(types))
        assert got.dtype == torch.float32 and got.shape == (3, 7, 32)
        assert want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def step_case():
    jcfg, cfg = configs(**GAUSSIAN)
    jb, tb = batches(molecules(3, seed=5), N, batch_size=B)
    rng = np.random.default_rng(17)
    t = rng.integers(0, jcfg.num_diffusion_timesteps, B)
    noise = rng.normal(size=(B, N, 3)).astype(np.float32)
    _, variables = jax_variables(jcfg, jb)
    return (variables, _jax_step(jcfg, variables, jb, t, noise),
            port_step(cfg, variables, tb, t, noise))


def test_gaussian_train_step_matches_jax(step_case):
    variables, (lo_j, stats, _, grads), (model, lo, _) = step_case
    for name in ("loss", "loss_global", "loss_local"):
        want = float(getattr(lo_j, name))
        assert want > 0.0, name
        assert abs(float(getattr(lo, name).detach()) - want) <= \
            LOSS_RTOL * want, name
    top = max(float(np.abs(g).max())
              for g in jax.tree_util.tree_leaves(grads))
    seen = 0
    for name, p in model.named_parameters():
        _, path = flax_leaf(model, name)
        want = _leaf(grads, path)
        got = p.grad.numpy()
        if path[-1] == "kernel":
            got = got.T
        tol = GRAD_RTOL * float(np.abs(want).max()) + GRAD_FLOOR * top
        err = float(np.abs(got - want).max())
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"
        seen += 1
    assert seen == len(jax.tree_util.tree_leaves(grads))
    emb = model.edge_encoder_global.bond_emb.weight.grad
    assert float(emb.abs().max()) > 0.0   # the encoder's embedding learns
    for name, buf in model.named_buffers():
        _, path = flax_leaf(model, name)
        np.testing.assert_allclose(buf.numpy(), _leaf(stats, path),
                                   atol=STATS_ATOL, err_msg=name)


def test_gaussian_weights_and_partition(step_case):
    """export_jax_variables gives back the tree the module was loaded
    from; param_partition labels every leaf as JAX's does."""
    variables = step_case[0]
    model = port_model(configs(**GAUSSIAN)[1], variables)
    out = export_jax_variables(model)
    flat_in = dict(jax.tree_util.tree_leaves_with_path(variables))
    flat_out = dict(jax.tree_util.tree_leaves_with_path(out))
    assert flat_in.keys() == flat_out.keys()
    for k in flat_in:
        np.testing.assert_array_equal(np.asarray(flat_out[k]),
                                      np.asarray(flat_in[k]))
    assert "edge_encoder_global" in variables["params"]
    assert set(variables["params"]["edge_encoder_global"]) == {"bond_emb"}
    labels = jax_opt.param_partition(variables["params"])
    for name, label in port_opt.param_partition(model).items():
        _, path = flax_leaf(model, name)
        assert label == _leaf(labels, path).item(), name


def test_fast_engines_refuse_gaussian(step_case):
    """Every fast forward refuses the encoder with the JAX package's
    message (fast_forward.py:292-295, tight_forward.py:212-215,
    monolithic.py:396-397), so the module path is the one to take."""
    _, cfg = configs(**GAUSSIAN)
    model = port_model(cfg, step_case[0])
    for engine in ENGINES:
        with pytest.raises(NotImplementedError,
                           match="fast_forward supports the 'mlp' edge "
                                 "encoder"):
            build_fast_forward(cfg, model, engine)
    with pytest.raises(NotImplementedError, match="fast_forward"):
        build_fast_forward(cfg, model, "pallas", pack_pairs=False)
    for engine in TIGHT_ENGINES:
        with pytest.raises(NotImplementedError,
                           match="tight_forward supports the 'mlp' edge "
                                 "encoder"):
            build_tight_forward(cfg, model, engine)
    with pytest.raises(NotImplementedError, match="mlp edge encoder only"):
        build_monolithic_forward(cfg, model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_runner_generates_with_gaussian(step_case, dtype):
    """GenerationRunner without use_fast (the module path) on a gaussian
    model: finite samples of the molecule's shape."""
    _, cfg = configs(**GAUSSIAN)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = port_model(cfg, step_case[0])
    mol = molecules(1, seed=11)[0]
    runner = GenerationRunner(model, cfg, make_diffusion(cfg),
                              SamplerConfig(n_steps=3, w_global=0.3),
                              buckets=(N,), chunk_size=4, device="cpu",
                              use_fast=False)
    assert runner._engine_for(N) == MODULE
    from test_torch_port_common import port_molecule

    out = runner.run([port_molecule(mol)], num_confs=3)[0].meta["pos_gen"]
    assert out.shape == (3, mol.num_nodes, 3) and np.isfinite(out).all()
