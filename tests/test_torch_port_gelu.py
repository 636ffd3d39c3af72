"""Gelu score heads (ModelConfig.mlp_act 'gelu') against the JAX package
on the CPU, on numpy-made inputs and transplanted weights:

  * the heads' activation each engine takes: jax.nn.gelu's tanh form, and
    under '-approx' the gelu of ops/approx.py, as JAX's engines choose it
    (agdiff_tpu/models/fast_forward.py:325-345, tight_forward.py:
    218-238), for the forwards and for K1's plain version;
  * the f32 '-approx' forwards ('approx', 'tight-approx', and K1's plain
    version in mode 'full' at f32 over the triu set and over a tight
    list) against JAX's 'approx' and 'tight-approx' engines within 2e-4,
    and the same forwards with the exact gelu in the heads must miss
    that limit (the heads' form shows at f32);
  * the bf16 K1 engines ('pksf', 'tight-pksf', K1's plain version)
    against JAX's engines of the same names
    (interpret-mode Pallas), under the narrow limits of
    tests/test_torch_port_engines.py;
  * K4's plain twin with gelu against the interpret-mode Pallas kernel
    (f32, bf16), and engine 'pallas' with pack_pairs=False (both heads
    through K4) against JAX's use_pallas=True forward.

The CUDA kernels' gelu forms are held against these plain versions on the
card (tests/test_torch_port_cuda.py, chip_smoke.py phase 13)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.models.fast_forward import (
    build_fast_forward as jax_fast,
    fold_eval_params as jax_fold,
)
from agdiff_tpu.ops import approx as jax_approx
from agdiff_tpu.ops.pallas import block_packed as jax_bp
from agdiff_tpu.ops.pallas import fused as jax_fused

from agdiff_torch.kernels import fused
from agdiff_torch.kernels import stack_packed as k1
from agdiff_torch.models.fast_forward import FastForward, build_fast_forward
from agdiff_torch.models.tight_forward import TightForward, build_tight_forward
from agdiff_torch.nn.common import activation_by_name
from agdiff_torch.ops.pairs import pair_capacity_for

from test_torch_port_common import (
    batches,
    configs,
    jax_run,
    jax_variables,
    molecules,
    port_model,
)
from test_torch_port_engines import NARROW_LIMITS, jax_reference, plane_errors

N = 16
F32_TOL = 2e-4
# bf16 engines against JAX's (tests/test_torch_port_fused.py)
BF16_ENGINE_TOL = 1e-2
BF16_TWIN_TOL = 5e-4


@pytest.fixture(scope="module")
def setup():
    """A small gelu model with the smooth envelope and a batch of one
    molecule repeated with noised positions (as
    tests/test_torch_port_engines.py)."""
    jcfg, cfg = configs(num_convs=3, smooth_conv=True, mlp_act="gelu")
    mol = molecules(1, seed=11)[0]
    jb, tb = batches([mol] * 3, max_nodes=N)
    rng = np.random.default_rng(0)
    pos = ((np.asarray(jb.pos) + 0.3 * rng.normal(size=jb.pos.shape))
           * np.asarray(jb.node_mask)[..., None]).astype(np.float32)
    jb = jb.replace(pos=jnp.asarray(pos))
    tb = tb.replace(pos=torch.from_numpy(pos))
    _, variables = jax_variables(jcfg, jb)
    cap = pair_capacity_for(mol.num_nodes, 16)
    return jcfg, cfg, jb, tb, variables, cap, port_model(cfg, variables)


@pytest.fixture(scope="module")
def references(setup):
    """JAX's forwards by engine name, shared between the cases."""
    return {}


def reference(setup, references, engine):
    if engine not in references:
        references[engine] = jax_reference(setup, dict(engine=engine))
    return references[engine]


# port forward -> (how it is built, the JAX engine it is held against)
F32_APPROX = {
    "approx": "approx",
    "tight-approx": "tight-approx",
    "pksf-approx@f32": "approx",
    "tight-pksf-approx@f32": "tight-approx",
}


def f32_forward(setup, name):
    """The port's f32 '-approx' forward `name`: the engines 'approx' and
    'tight-approx', or K1's plain version in mode 'full' at f32 (the
    'pksf-approx' arithmetic without bf16 rounding), triu or tight."""
    _, cfg, _, _, _, cap, model = setup
    if name == "approx":
        return build_fast_forward(cfg, model, "approx")
    if name == "tight-approx":
        return build_tight_forward(cfg, model, "tight-approx", capacity=cap)
    if name.startswith("tight-"):
        return TightForward(cfg, model, capacity=cap, mode="full",
                            compute_dtype=torch.float32, approx=True)
    return FastForward(cfg, model, mode="full", compute_dtype=torch.float32,
                       approx=True)


def _jax_gelu(approx):
    return jax_approx.gelu if approx else jax.nn.gelu


@pytest.mark.parametrize("approx", [False, True])
def test_head_activation_matches_jax(setup, approx):
    """K1's head act and each forward's `act` against the gelu JAX's
    engine of the same name gives its heads, on f32 inputs."""
    _, cfg, _, _, _, cap, model = setup
    x = np.concatenate([np.linspace(-12, 12, 4801),
                        np.random.default_rng(3).normal(0, 3, 2000)]
                       ).astype(np.float32)
    want = np.asarray(_jax_gelu(approx)(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = k1.head_activation("gelu", approx)(xt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert k1.head_activation("relu", approx) is activation_by_name("relu")
    suffix = "-approx" if approx else ""
    fwds = [build_fast_forward(cfg, model, f"pksf{suffix}"),
            build_fast_forward(cfg, model, f"pks{suffix}"),
            build_fast_forward(cfg, model, "approx" if approx else None),
            build_tight_forward(cfg, model, f"tight-pksf{suffix}",
                                capacity=cap),
            build_tight_forward(cfg, model, f"tight{suffix}", capacity=cap)]
    for fwd in fwds:
        assert fwd.approx == approx
        np.testing.assert_allclose(fwd.act(xt).numpy(), want, atol=1e-6,
                                   rtol=0)
    # the two forms differ by more than the f32 forwards' limit
    assert np.abs(np.asarray(jax_approx.gelu(jnp.asarray(x)))
                  - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() > 1e-4


@pytest.mark.parametrize("name", list(F32_APPROX))
def test_f32_approx_forwards_match_jax(setup, references, name,
                                       monkeypatch):
    """The f32 '-approx' forwards of a gelu model against JAX's f32
    '-approx' engine within 2e-4 (rtol = atol, as
    tests/test_torch_port_engines.py); with the exact gelu in the heads
    (the form the port took before) the same forward misses it."""
    ref = reference(setup, references, F32_APPROX[name])
    out = f32_forward(setup, name)(setup[3])
    for plane in ("edge_inv_global", "edge_inv_local"):
        np.testing.assert_allclose(
            getattr(out, plane).numpy(), np.asarray(getattr(ref, plane)),
            rtol=F32_TOL, atol=F32_TOL, err_msg=plane)
    monkeypatch.setattr(
        k1, "head_activation", lambda act, approx=False:
        activation_by_name(act))
    import agdiff_torch.models.fast_forward as ff
    monkeypatch.setattr(ff, "head_activation", k1.head_activation)
    exact = f32_forward(setup, name)(setup[3])
    worst = max(
        float(np.max(np.abs(getattr(exact, p).numpy()
                            - np.asarray(getattr(ref, p)))
                     - F32_TOL * (1 + np.abs(np.asarray(getattr(ref, p))))))
        for p in ("edge_inv_global", "edge_inv_local"))
    assert worst > 0.0, "exact gelu heads stay within the limit"


@pytest.mark.parametrize("engine", ["pksf", "tight-pksf"])
def test_gelu_k1_engines_match_jax(setup, references, engine):
    """The bf16 K1 engines of a gelu model (K1's plain version on the
    CPU, no launch) against JAX's engines of the same name, with the
    interpret-mode Pallas K1 given the same head act."""
    _, cfg, _, tb, _, cap, model = setup
    ref = reference(setup, references, engine)
    fwd = (build_tight_forward(cfg, model, engine, capacity=cap)
           if engine.startswith("tight") else
           build_fast_forward(cfg, model, engine))
    assert fwd.mode == "full" and fwd.stack.act == "gelu"
    before = dict(k1.launches)
    out = fwd(tb)
    assert dict(k1.launches) == before
    for plane, readings in plane_errors(out, ref).items():
        for got, limit in zip(readings, NARROW_LIMITS):
            assert got <= limit, (plane, readings)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got, ref, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_gelu_plain_matches_jax_kernel(setup, dtype, monkeypatch):
    """K4's plain twin with gelu against the interpret-mode Pallas kernel
    with activation='gelu', on seeded inputs at N = 8 (the fused tests'
    tolerances); 0 off the mask; relu gives other values."""
    jcfg, cfg, _, _, variables, _, model = setup
    monkeypatch.setattr(jax_fused, "_INTERPRET", True)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp6 = jax_fold(jcfg, variables)["grad_global"]
    p6 = build_fast_forward(cfg, model, None).stack.grad_global
    rng = np.random.default_rng(2)
    b, n, h = 2, 8, cfg.hidden_dim
    e = rng.normal(0, 0.5, (b, n, n, h)).astype(np.float32)
    x = rng.normal(0, 1, (b, n, h)).astype(np.float32)
    mask = rng.random((b, n, n)) < 0.5
    jargs = [p.astype(jd) if k % 2 == 0 else p for k, p in enumerate(jp6)]
    ref = jax_run(lambda: jax_fused.pair_score_mlp(
        jnp.asarray(x).astype(jd), jnp.asarray(e).astype(jd),
        jnp.asarray(mask), *jargs, activation="gelu"))
    args = (torch.from_numpy(x).to(dtype), torch.from_numpy(e).to(dtype),
            torch.from_numpy(mask), *p6)
    before = dict(fused.launches)
    got = fused.pair_score_mlp(*args, activation="gelu")
    assert dict(fused.launches) == before
    assert float(got[~torch.from_numpy(mask)].abs().max()) == 0.0
    _close(got.numpy(), ref,
           F32_TOL if dtype == torch.float32 else BF16_TWIN_TOL)
    relu = fused.pair_score_mlp(*args, activation="relu")
    assert (relu - got).abs().max() > 10 * F32_TOL * float(
        np.abs(np.asarray(ref)).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_dense_pairs_gelu_matches_jax(setup, dtype, monkeypatch):
    """Engine 'pallas' with pack_pairs=False on a gelu model (both heads
    through K4's plain twin with gelu) against JAX's use_pallas=True,
    pack_pairs=False forward (K3, K4, K5 in interpret mode): 2e-4 of the
    largest score at f32, 1e-2 at bf16."""
    import dataclasses

    jcfg, cfg, jb, tb, variables, _, _ = setup
    monkeypatch.setattr(jax_fused, "_INTERPRET", True)
    monkeypatch.setattr(jax_bp, "_INTERPRET", True)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jax_run(jax_fast(jcfg, variables, compute_dtype=jd,
                           use_pallas=True, pack_pairs=False), jb)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    fwd = build_fast_forward(cfg, port_model(cfg, variables), "pallas",
                             pack_pairs=False)
    got = fwd(tb)
    tol = F32_TOL if dtype == "float32" else BF16_ENGINE_TOL
    for plane, mask in (("edge_inv_global", ref.edge_mask),
                        ("edge_inv_local", ref.local_mask)):
        m = np.asarray(mask)
        _close(np.where(m, getattr(got, plane).numpy(), 0),
               np.where(m, np.asarray(getattr(ref, plane), np.float32), 0),
               tol)


def test_gelu_variant_names():
    """The launch counters name the gelu forms apart from relu's."""
    from agdiff_torch.kernels import monolithic as k6

    assert k1.variant("full", False, False, gelu=True) == \
        "stack_full_gelu:triu"
    assert k1.variant("full", True, True, gelu=True) == \
        "stack_full_gelu_approx:tight"
    assert k1.variant("full", True, True) == "stack_full_approx:tight"
    assert k6.variant(torch.bfloat16, "gelu") == "mono_gelu:bf16"
    assert k6.variant(torch.float32) == "mono:f32"
