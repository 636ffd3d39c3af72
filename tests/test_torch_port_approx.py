"""The '-approx' variants: ops/approx.py against agdiff_tpu.ops.approx
(1e-6 at f32), K1's plain version with the approximations against the
JAX kernel given the same ones (interpret mode, 2e-4 at f32), and the
approx engines against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.models.fast_forward import (
    build_fast_forward as jax_fast,
    fold_eval_params as jax_fold,
)
from agdiff_tpu.models.tight_forward import build_tight_forward as jax_tight
from agdiff_tpu.ops import approx as jax_approx
from agdiff_tpu.ops.pallas import stack_packed as jax_stack

from agdiff_torch.kernels import stack_packed as k1
from agdiff_torch.models.fast_forward import FastForward, build_fast_forward
from agdiff_torch.models.tight_forward import build_tight_forward
from agdiff_torch.ops import approx
from agdiff_torch.ops.pairs import pair_capacity_for, prepare_pairs_shared

from test_torch_port_common import (
    batches,
    configs,
    jax_variables,
    molecules,
    port_model,
)

NAMES = ("softplus", "tanh", "sigmoid", "gelu", "relu")
# bf16 engines against JAX's: as in tests/test_torch_port_tight.py
BF16_TOL = 1e-2


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = configs(num_convs=3, smooth_conv=True)
    mol = molecules(1, seed=11)[0]
    jb, tb = batches([mol] * 2, max_nodes=16)
    _, variables = jax_variables(jcfg, jb)
    cap = pair_capacity_for(mol.num_nodes, 16)
    return jcfg, cfg, jb, tb, variables, cap, port_model(cfg, variables)


@pytest.mark.parametrize("name", NAMES)
def test_approx_functions_match_jax(name):
    x = np.concatenate([np.linspace(-30, 30, 4001),
                        np.random.default_rng(0).normal(0, 4, 2000)]
                       ).astype(np.float32)
    got = getattr(approx, name)(torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jax_approx, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    # bf16 inputs are evaluated in f32 and rounded back: one bf16 ulp
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got16 = getattr(approx, name)(xb)
    assert got16.dtype == torch.bfloat16
    ref16 = np.asarray(getattr(jax_approx, name)(
        jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    np.testing.assert_allclose(got16.float().numpy(), ref16,
                               rtol=2 ** -7, atol=1e-6)


def test_approx_error_bounds():
    """The documented max errors over the real line."""
    x = torch.linspace(-40, 40, 80001, dtype=torch.float64)
    assert (approx.softplus(x) - torch.nn.functional.softplus(x)
            ).abs().max() < 2e-4
    assert (approx.sigmoid(x) - torch.sigmoid(x)).abs().max() < 7e-4
    assert (approx.tanh(x) - torch.tanh(x)).abs().max() < 1.5e-3


@pytest.mark.parametrize("mode", ["schnet", "gin", "full"])
def test_plain_approx_matches_jax_kernel(setup, mode, monkeypatch):
    """K1's plain version with approx=True against the interpret-mode
    Pallas kernel given ops/approx.py's softplus and sigmoid, on the
    inputs of a tight forward (pad slots included), at f32."""
    monkeypatch.setattr(jax_stack, "_INTERPRET", True)
    jcfg, cfg, _, tb, variables, cap, model = setup
    fwd = FastForward(cfg, model, mode=mode, approx=True)
    pairs = prepare_pairs_shared(tb.node_mask, cap)
    kw, _ = fwd.stack_inputs(tb, pairs)
    got = k1.packed_stack_forward(**kw, mode=mode, approx=True)
    folded = jax_fold(jcfg, variables)
    j = {k: jnp.asarray(v.numpy()) for k, v in kw.items()
         if isinstance(v, torch.Tensor)}
    oh_i = jax.nn.one_hot(pairs.iu.numpy(), tb.pos.shape[1]) \
        * pairs.valid.numpy()[:, None]
    oh_j = jax.nn.one_hot(pairs.ju.numpy(), tb.pos.shape[1]) \
        * pairs.valid.numpy()[:, None]
    ext = dict(e_packed_local=j["e_packed_local"],
               local_mask_p=j["local_mask_p"], hl0=j["hl0"],
               gin_layers=folded["gin_layers"])
    if mode == "full":
        ext.update(grad_global=folded["grad_global"],
                   grad_local=folded["grad_local"], act_fn=jax.nn.relu)
    ref = jax_stack.packed_stack_forward(
        j["e_packed"], j["we"], j["h0"], folded["blocks"], mode=mode,
        selectors=(jnp.concatenate([oh_j, oh_i], 0),
                   jnp.concatenate([oh_i, oh_j], 0).T),
        softplus_fn=jax_approx.softplus, sigmoid_fn=jax_approx.sigmoid,
        **({} if mode == "schnet" else ext))
    got = [got] if mode == "schnet" else list(got)
    ref = [ref] if mode == "schnet" else list(ref)
    n = int(tb.node_mask[0].sum())
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r)
        if mode != "full":   # node states: real rows only
            g, r = g[:, :n], r[:, :n]
        else:                # planes: valid slots only
            g, r = g[:, :pairs.num_valid], r[:, :pairs.num_valid]
        assert np.abs(r).max() > 1e-3
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=2e-4)
    exact = k1.packed_stack_forward(**kw, mode=mode)
    exact = [exact] if mode == "schnet" else list(exact)
    assert any(not torch.equal(a, b) for a, b in zip(exact, got))


@pytest.mark.parametrize("engine", ["pksf-approx", "tight-pksf-approx"])
def test_approx_engines_match_jax(setup, engine, monkeypatch):
    """The bf16 '-approx' engines against JAX's approx=True forwards with
    slim storage (eager; interpret-mode Pallas)."""
    monkeypatch.setattr(jax_stack, "_INTERPRET", True)
    jcfg, cfg, jb, tb, variables, cap, model = setup
    slim = dict(compute_dtype=jnp.bfloat16, store_dtype=jnp.bfloat16,
                packed_stack="full", approx=True)
    if engine.startswith("tight"):
        ref = jax_tight(jcfg, variables, capacity=cap, shared=True,
                        **slim)(jb)
        fwd = build_tight_forward(cfg, model, engine, capacity=cap)
    else:
        ref = jax_fast(jcfg, variables, use_pallas=False, **slim)(jb)
        fwd = build_fast_forward(cfg, model, engine)
    assert fwd.approx and fwd.mode == "full"
    out = fwd(tb)
    for name, mask in (("edge_inv_global", ref.edge_mask),
                       ("edge_inv_local", ref.local_mask)):
        m = np.asarray(mask)
        want = np.where(m, np.asarray(getattr(ref, name), np.float32), 0)
        got = np.where(m, getattr(out, name).numpy(), 0)
        scale = np.abs(want).max()
        assert scale > 1e-3
        np.testing.assert_allclose(got, want, atol=BF16_TOL * scale)
