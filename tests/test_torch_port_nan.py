"""NaN through the port's plain twins as through the JAX reference: a
NaN edge feature (a non-finite distance) must come out where the
reference puts it, since the sampler's guard flags a graph by its
non-finite positions and the runner reruns flagged graphs with
clip_local. The hand kernels are held to the plain twins' pattern on the
card (tests/test_torch_port_cuda.py, chip_smoke.py phase 7).

* K1 (whole-stack), mode 'full' over the triu set at f32 and with
  '-approx', K2 '-approx', K4 and K5: numpy inputs with one real pair's
  edge features NaN in graph 1 (for K4 and K5 also one pair off the
  mask), through the interpret-mode Pallas kernel (N = 8) and the plain
  twin: the same non-finite elements, the finite ones at each test
  file's tolerance (PERF.md section 2).
* K1 over a tight list (modes 'full', with and without '-approx') and K6
  (engine 'mono'): one atom's position NaN in graph 1, through JAX's
  forward (interpret-mode Pallas, N = 16) and the port's: the same
  non-finite cells on the masks.
* A 3-step ladder with one atom of graph 1 at 1e30 A (its distances
  overflow to inf, as a diverging ladder's do) flags graph 1 alone on
  'pksf', 'tight-pksf' and 'mono', as JAX's ladder does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.models.fast_forward import (
    build_fast_forward as jax_fast,
    fold_eval_params as jax_fold,
)
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.models.tight_forward import build_tight_forward as jax_tight
from agdiff_tpu.ops import approx as jax_approx
from agdiff_tpu.ops.pallas import block_packed as jax_bp
from agdiff_tpu.ops.pallas import fused as jax_fused
from agdiff_tpu.ops.pallas import monolithic as jax_mono
from agdiff_tpu.ops.pallas import stack_packed as jax_stack
from agdiff_tpu.sampling.langevin import (
    SamplerConfig as JaxSamplerConfig,
    langevin_dynamics_sample as jax_ld,
)

from agdiff_torch.kernels import block_packed as k2
from agdiff_torch.kernels import fused
from agdiff_torch.kernels import stack_packed as k1
from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.models.mono_forward import build_monolithic_forward
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.models.tight_forward import TightForward
from agdiff_torch.ops.pairs import pair_capacity_for, triu_pairs
from agdiff_torch.sampling.langevin import SamplerConfig, build_fast_sampler

from test_torch_port_common import (
    batches,
    configs,
    jax_run,
    jax_variables,
    molecules,
    port_model,
)

B, N = 2, 8
P = N * (N - 1) // 2
F32_TOL = 2e-4          # of the largest finite value: f32 summation order
BF16_TWIN_TOL = 5e-4    # tests/test_torch_port_fused.py's twin tolerance
NAN = float("nan")


def _same_pattern(got, ref, tol, mask=None, some_bad=True):
    """The same non-finite elements (within `mask`), the finite ones
    within tol of the largest finite reference value; some of each
    (some_bad=False: all finite)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if mask is not None:
        got, ref = got[mask], ref[mask]
    bad = ~np.isfinite(ref)
    np.testing.assert_array_equal(~np.isfinite(got), bad)
    assert bad.any() == some_bad and (~bad).any()
    scale = np.abs(ref[~bad]).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got[~bad], ref[~bad], rtol=0,
                               atol=tol * scale)


@pytest.fixture(scope="module")
def setup():
    """The small config in both packages, a batch of one molecule three
    times at N = 16 (a shared tight list), JAX variables, the port's
    model, and the batch with atom 0 of graph 1 at NaN."""
    jcfg, cfg = configs()
    mol = molecules(1, seed=11)[0]
    jb, tb = batches([mol] * 3, 16)
    _, variables = jax_variables(jcfg, jb)
    pos = np.asarray(jb.pos).copy()
    pos[1, 0] = np.nan
    planted = (jb.replace(pos=jnp.asarray(pos)),
               tb.replace(pos=torch.from_numpy(pos)))
    return (jcfg, cfg, mol, variables, port_model(cfg, variables),
            (jb, tb), planted)


def _rng_inputs(seed, h, dense=True):
    rng = np.random.default_rng(seed)
    lead = (B, N, N) if dense else (B, P)
    e = rng.normal(0, 0.5, lead + (h,)).astype(np.float32)
    w = rng.uniform(0, 1, (2,) + lead).astype(np.float32)
    w[rng.random((2,) + lead) < 0.3] = 0.0
    x = rng.normal(0, 1, (B, N, h)).astype(np.float32)
    mask = rng.random(lead) < 0.5
    return e, w, x, mask


# ---- kernels on numpy inputs ----------------------------------------------------

@pytest.mark.parametrize("approx", [False, True])
def test_k1_triu_keeps_nan(setup, approx, monkeypatch):
    """K1 mode 'full' at f32 (with '-approx': the polynomial softplus and
    rational sigmoid on both sides), pair 0 of graph 1 NaN in both planes'
    edge features: NaN everywhere in graph 1, as in the reference."""
    jcfg, cfg, _, variables, model, _, _ = setup
    monkeypatch.setattr(jax_stack, "_INTERPRET", True)
    folded = jax_fold(jcfg, variables)
    stack = build_fast_forward(cfg, model, None).stack
    rng = np.random.default_rng(5)
    h = cfg.hidden_dim
    e = rng.normal(0, 0.5, (B, P, h)).astype(np.float32)
    e[1, 0] = NAN
    we = rng.uniform(0, 1, (2 * cfg.num_convs, B, P)).astype(np.float32)
    we[:, :, rng.random(P) < 0.3] = 0.0
    h0, hl0 = (rng.normal(0, 1, (B, N, h)).astype(np.float32)
               for _ in range(2))
    lm = rng.random((B, P)) < 0.4
    fns = (dict(softplus_fn=jax_approx.softplus,
                sigmoid_fn=jax_approx.sigmoid) if approx else {})
    ref = jax.jit(lambda: jax_stack.packed_stack_forward(
        jnp.asarray(e), jnp.asarray(we), jnp.asarray(h0), folded["blocks"],
        mode="full", e_packed_local=jnp.asarray(e),
        local_mask_p=jnp.asarray(lm), hl0=jnp.asarray(hl0),
        gin_layers=folded["gin_layers"], grad_global=folded["grad_global"],
        grad_local=folded["grad_local"], act_fn=jax.nn.relu, **fns))()
    et = torch.from_numpy(e)
    got = k1.packed_stack_forward(
        et, torch.from_numpy(we), torch.from_numpy(h0), stack, et,
        torch.from_numpy(lm), torch.from_numpy(hl0), triu_pairs(N),
        approx=approx)
    for g, r in zip(got, ref):
        _same_pattern(g.numpy(), r, F32_TOL)
        assert np.isnan(np.asarray(r)[1]).all()


def test_k2_approx_keeps_nan(setup, monkeypatch):
    """K2 '-approx' at bf16, one real pair of graph 1 NaN."""
    jcfg, cfg, _, variables, model, _, _ = setup
    monkeypatch.setattr(jax_bp, "_INTERPRET", True)
    jconvs = jax_fold(jcfg, variables)["blocks"][1]["convs"]
    convs = build_fast_forward(cfg, model, None).blocks[1]["convs"]
    f1, f2 = (c["fb"][0].shape[1] for c in convs)
    e, w, _, _ = _rng_inputs(4, cfg.hidden_dim, dense=False)
    e[1, 3] = NAN
    rng = np.random.default_rng(6)
    x1 = rng.normal(0, 1, (B, N, f1)).astype(np.float32)
    x2 = rng.normal(0, 1, (B, N, f2)).astype(np.float32)
    bf = jnp.bfloat16
    ref = jax_run(lambda: jax_bp.packed_block_aggregate(
        jnp.asarray(e).astype(bf), jnp.asarray(w[0]), jnp.asarray(w[1]),
        jnp.asarray(x1).astype(bf), jnp.asarray(x2).astype(bf), *jconvs,
        softplus_fn=jax_approx.softplus))
    got = k2.packed_block_aggregate(
        torch.from_numpy(e).bfloat16(), torch.from_numpy(w[0]),
        torch.from_numpy(w[1]), torch.from_numpy(x1).bfloat16(),
        torch.from_numpy(x2).bfloat16(), *convs, triu_pairs(N), approx=True)
    i, j = (int(t[3]) for t in (triu_pairs(N).iu, triu_pairs(N).ju))
    for g, r in zip(got, ref):
        g, r = g.numpy(), np.asarray(r, np.float32)
        # the Pallas kernel sums each node's messages as a one-hot
        # selector product over all pairs, so NaN x 0 reaches every node
        # of graph 1; the twin (and the CUDA kernel) add each message to
        # its two endpoints only. Graph 1 is non-finite in both.
        assert np.isnan(r[1]).all()
        bad = ~np.isfinite(g)
        assert bad[1, [i, j]].all() and bad.sum() == 2 * g.shape[-1]
        _same_pattern(g[0], r[0], BF16_TWIN_TOL, some_bad=False)


def _on_off(mask, g=1):
    """A cell of graph g on the mask and one off it."""
    on = np.argwhere(mask[g])[0]
    off = np.argwhere(~mask[g])[0]
    return tuple(on), tuple(off)


def test_k4_keeps_nan_on_its_mask(setup, monkeypatch):
    """K4 (f32): a NaN edge feature on the mask gives a NaN score there,
    one off the mask a 0 (the reference's where(mask != 0, score, 0))."""
    jcfg, cfg, _, variables, model, _, _ = setup
    monkeypatch.setattr(jax_fused, "_INTERPRET", True)
    jp6 = jax_fold(jcfg, variables)["grad_global"]
    p6 = build_fast_forward(cfg, model, None).stack.grad_global
    e, _, h, mask = _rng_inputs(2, cfg.hidden_dim)
    on, off = _on_off(mask)
    e[(1,) + on] = e[(1,) + off] = NAN
    ref = jax_run(lambda: jax_fused.pair_score_mlp(
        jnp.asarray(h), jnp.asarray(e), jnp.asarray(mask), *jp6,
        activation="relu"))
    got = fused.pair_score_mlp(torch.from_numpy(h), torch.from_numpy(e),
                               torch.from_numpy(mask), *p6).numpy()
    _same_pattern(got, ref, F32_TOL)
    assert np.isnan(got[(1,) + on]) and got[(1,) + off] == 0.0


def test_k5_keeps_nan_off_its_mask(setup, monkeypatch):
    """K5: the reference applies the mask after the relu, so a NaN edge
    feature off the mask reaches the sum (NaN x 0), as one on it does."""
    cfg = setup[1]
    monkeypatch.setattr(jax_fused, "_INTERPRET", True)
    e, _, x, mask = _rng_inputs(3, cfg.hidden_dim)
    on, off = _on_off(mask)
    e[(1,) + on] = e[(1,) + off] = NAN
    ref = jax_run(lambda: jax_fused.gine_aggregate(
        jnp.asarray(x), jnp.asarray(e), jnp.asarray(mask)))
    got = fused.gine_aggregate(torch.from_numpy(x), torch.from_numpy(e),
                               torch.from_numpy(mask)).numpy()
    _same_pattern(got, ref, F32_TOL)
    assert np.isnan(got[1, on[0]]).all() and np.isnan(got[1, off[0]]).all()


# ---- forwards with a NaN position --------------------------------------------

def _planes_pattern(out, ref, tol):
    for name in ("edge_mask", "local_mask"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name, mask in (("edge_inv_global", ref.edge_mask),
                       ("edge_inv_local", ref.local_mask)):
        _same_pattern(getattr(out, name).float().numpy(),
                      np.asarray(getattr(ref, name), np.float32), tol,
                      np.asarray(mask))
        assert not np.isfinite(np.asarray(getattr(ref, name))[1]).all()


@pytest.mark.parametrize("approx", [False, True])
def test_tight_full_keeps_nan(setup, approx, monkeypatch):
    """K1 mode 'full' over the molecule's tight list (pad slots included)
    at f32, with and without '-approx'."""
    jcfg, cfg, mol, variables, model, _, (jb, tb) = setup
    monkeypatch.setattr(jax_stack, "_INTERPRET", True)
    cap = pair_capacity_for(mol.num_nodes, 16)
    ref = jax_tight(jcfg, variables, capacity=cap, shared=True,
                    packed_stack="full", approx=approx)(jb)
    out = TightForward(cfg, model, capacity=cap, mode="full",
                       approx=approx)(tb)
    _planes_pattern(out, ref, F32_TOL)


def test_mono_keeps_nan(setup, monkeypatch):
    """K6's plain twin (engine 'mono', f32) against JAX's mono forward:
    graph 1's NaN cells as JAX's. JAX's kernel aggregates a tile of
    graphs (here the whole batch) through block-diagonal one-hot
    selector products, so NaN x 0 carries graph 1's NaN into every graph
    of its tile (ROADMAP.md, reference-side defects); the port's other
    graphs are finite, as JAX's are on the batch without the NaN."""
    jcfg, cfg, _, variables, model, (jb0, _), (jb, tb) = setup
    monkeypatch.setattr(jax_mono, "_INTERPRET", True)
    jfwd = jax_mono.build_monolithic_forward(
        jcfg, variables, compute_dtype=jnp.float32, tile=2)
    ref, clean = jfwd(jb), jfwd(jb0)
    out = build_monolithic_forward(cfg, model)(tb)
    for name, mask in (("edge_inv_global", ref.edge_mask),
                       ("edge_inv_local", ref.local_mask)):
        g = getattr(out, name).numpy()
        r, c = (np.asarray(getattr(x, name), np.float32)
                for x in (ref, clean))
        m = np.asarray(mask)
        assert (~np.isfinite(r[m])).all()   # every graph of the tile
        np.testing.assert_array_equal(~np.isfinite(g[1][m[1]]),
                                      ~np.isfinite(r[1][m[1]]))
        keep = m.copy()
        keep[1] = False
        _same_pattern(g, c, F32_TOL, keep, some_bad=False)


# ---- the ladder's guard -------------------------------------------------------

def test_ladder_flags_a_diverged_graph_as_jax_does(setup):
    """Atom 0 of graph 1 at 1e30 A: JAX's ladder (its f32 forward) and
    the port's on 'pksf', 'tight-pksf' and 'mono' (the plain twins, on
    the CPU) flag graph 1 alone."""
    jcfg, cfg, mol, variables, model, (jb, tb), _ = setup
    ladder = dict(n_steps=3, w_global=0.3)
    pos = np.asarray(jb.pos).copy()
    pos[1, 0] = 1e30
    ref = jax_run(functools.partial(
        jax_ld, None, None, diffusion=jax_diffusion(jcfg),
        config=JaxSamplerConfig(**ladder),
        forward_fn=jax_fast(jcfg, variables, use_pallas=False)),
        jb, jnp.asarray(pos), jax.random.PRNGKey(0))
    want = np.asarray(ref.nan_flags).tolist()
    assert want == [False, True, False]
    from agdiff_torch.models.tight_forward import build_tight_forward

    bf16 = cfg.__class__(**{**cfg.__dict__, "dtype": "bfloat16"})
    for fwd, capacity in (
            (build_fast_forward(bf16, model, "pksf"), None),
            (build_tight_forward(bf16, model, "tight-pksf"),
             pair_capacity_for(mol.num_nodes, 16)),
            (build_monolithic_forward(bf16, model), None)):
        got = build_fast_sampler(fwd, make_diffusion(cfg),
                                 SamplerConfig(**ladder),
                                 pair_capacity=capacity)(
            tb, torch.from_numpy(pos),
            generator=torch.Generator().manual_seed(0))
        assert got.nan_flags.tolist() == want
