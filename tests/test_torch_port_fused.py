"""K2-K5 and the engines around them: the plain twins of
kernels/fused.py (K3, K4, K5) and kernels/block_packed.py (K2) against the
JAX Pallas kernels in interpret mode on the same seeded inputs and folded
weights; the engines 'pallas' (packed and pack_pairs=False), 'pk' and
'pk-approx' against JAX's build_fast_forward with the same transplanted
weights; the traps of those engines; a few-step 'pallas' ladder against
JAX's with replayed noise; the runner's engine rule. The CUDA kernels
themselves are held against the twins on the card
(tests/test_torch_port_cuda.py, chip_smoke.py)."""

import dataclasses
import functools
import os
import shutil

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
from agdiff_tpu.ops import approx as jax_approx
from agdiff_tpu.ops.pallas import block_packed as jax_bp
from agdiff_tpu.ops.pallas import fused as jax_fused
from agdiff_tpu.sampling.langevin import (
    SamplerConfig as JaxSamplerConfig,
    langevin_dynamics_sample,
)

from agdiff_torch.data.fixture import load_fixture
from agdiff_torch.eval.generate import GenerationRunner
from agdiff_torch.kernels import block_packed as k2
from agdiff_torch.kernels import build
from agdiff_torch.kernels import fused
from agdiff_torch.models.fast_forward import (
    build_fast_forward,
    edge_encode,
    pair_scores,
)
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.ops.pairs import mirror_features, mirror_plane, triu_pairs
from agdiff_torch.sampling.langevin import (
    SamplerConfig,
    build_fast_sampler,
)

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
F32_TOL = 2e-4      # of the output's largest value: f32 summation order
# bf16, twin against the JAX kernel: both round at the same places (the
# operands, the filter's hidden layer, K4's hidden layer), so they differ
# by f32 summation order, and by the last bits of each framework's
# softplus, unless that flips the bf16 rounding of a hidden value: one
# such flip moved 2 of 512 outputs of K3 by 1.4e-4 of the largest; held
# to 5e-4 of it
BF16_TWIN_TOL = 5e-4
# bf16 engines against JAX's on the same folded weights: the encoder,
# distance weights and node tails are f32 in another summation order and
# feed bf16 roundings, so a few roundings flip and later layers carry them
# (tests/test_torch_port_tight.py holds its bf16 engines to the same 1e-2)
BF16_ENGINE_TOL = 1e-2


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got, ref, atol=tol * scale, rtol=0)


@pytest.fixture(scope="module")
def engine_setup():
    """The small config in both packages, one padded batch of three
    molecules (N = 16) in both layouts, and JAX variables."""
    jcfg, cfg = configs()
    jb, tb = batches(molecules(3, seed=4))
    _, variables = jax_variables(jcfg, jb)
    return jcfg, cfg, jb, tb, variables


@pytest.fixture(scope="module")
def weights(engine_setup):
    jcfg, cfg, _, _, variables = engine_setup
    model = port_model(cfg, variables)
    convs = build_fast_forward(cfg, model, None).blocks[0]["convs"]
    return jcfg, cfg, variables, model, convs


def _jax_dtype(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _rng_inputs(seed, h, f1, f2, dense=True):
    """Seeded edge features, distance-weight planes with zeroed entries,
    node inputs and a 0/1 mask, dense (B, N, N, ...) or packed (B, P,
    ...)."""
    rng = np.random.default_rng(seed)
    lead = (B, N, N) if dense else (B, P)
    e = rng.normal(0, 0.5, lead + (h,)).astype(np.float32)
    w = rng.uniform(0, 1, (2,) + lead).astype(np.float32)
    w[rng.random((2,) + lead) < 0.3] = 0.0
    x1 = rng.normal(0, 1, (B, N, f1)).astype(np.float32)
    x2 = rng.normal(0, 1, (B, N, f2)).astype(np.float32)
    mask = rng.random(lead) < 0.5
    return e, w, x1, x2, mask


# ---- the plain twins against the Pallas kernels --------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_plain_matches_jax_kernel(weights, dtype, monkeypatch):
    jcfg, cfg, variables, _, convs = weights
    monkeypatch.setattr(jax_fused, "_INTERPRET", True)
    jconvs = jax_fold(jcfg, variables)["blocks"][0]["convs"]
    f1, f2 = (c["fb"][0].shape[1] for c in convs)
    e, w, h1, h2, _ = _rng_inputs(1, cfg.hidden_dim, f1, f2)
    ref = jax_run(lambda: jax_fused.interaction_block_aggregate(
        jnp.asarray(e).astype(_jax_dtype(dtype)), jnp.asarray(w[0]),
        jnp.asarray(w[1]), jnp.asarray(h1), jnp.asarray(h2), *jconvs))
    before = dict(fused.launches)
    got = fused.interaction_block_aggregate(
        torch.from_numpy(e).to(dtype), torch.from_numpy(w[0]),
        torch.from_numpy(w[1]), torch.from_numpy(h1), torch.from_numpy(h2),
        *convs)
    assert dict(fused.launches) == before   # CPU tensors: the plain twin
    tol = F32_TOL if dtype == torch.float32 else BF16_TWIN_TOL
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        _close(g.numpy(), r, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_plain_matches_jax_kernel(weights, dtype, monkeypatch):
    jcfg, cfg, variables, _, _ = weights
    monkeypatch.setattr(jax_fused, "_INTERPRET", True)
    jd = _jax_dtype(dtype)
    jp6 = jax_fold(jcfg, variables)["grad_global"]
    p6 = build_fast_forward(cfg, port_model(cfg, variables),
                            None).stack.grad_global
    e, _, h, _, mask = _rng_inputs(2, cfg.hidden_dim, cfg.hidden_dim, 4)
    jargs = [p.astype(jd) if k % 2 == 0 else p for k, p in enumerate(jp6)]
    ref = jax_run(lambda: jax_fused.pair_score_mlp(
        jnp.asarray(h).astype(jd), jnp.asarray(e).astype(jd),
        jnp.asarray(mask), *jargs, activation="relu"))
    got = fused.pair_score_mlp(
        torch.from_numpy(h).to(dtype), torch.from_numpy(e).to(dtype),
        torch.from_numpy(mask), *p6)
    assert float(got[~torch.from_numpy(mask)].abs().max()) == 0.0
    _close(got.numpy(), ref,
           F32_TOL if dtype == torch.float32 else BF16_TWIN_TOL)


def test_k5_plain_matches_jax_kernel(weights, monkeypatch):
    cfg = weights[1]
    monkeypatch.setattr(jax_fused, "_INTERPRET", True)
    e, _, x, _, mask = _rng_inputs(3, cfg.hidden_dim, cfg.hidden_dim, 4)
    ref = jax_run(lambda: jax_fused.gine_aggregate(
        jnp.asarray(x), jnp.asarray(e), jnp.asarray(mask)))
    got = fused.gine_aggregate(torch.from_numpy(x), torch.from_numpy(e),
                               torch.from_numpy(mask))
    _close(got.numpy(), ref, F32_TOL)


@pytest.mark.parametrize("dtype,approx", [
    (torch.float32, False), (torch.bfloat16, False), (torch.bfloat16, True)])
def test_k2_plain_matches_jax_kernel(weights, dtype, approx, monkeypatch):
    jcfg, cfg, variables, _, convs = weights
    monkeypatch.setattr(jax_bp, "_INTERPRET", True)
    jd = _jax_dtype(dtype)
    jconvs = jax_fold(jcfg, variables)["blocks"][1]["convs"]
    convs = build_fast_forward(cfg, port_model(cfg, variables),
                               None).blocks[1]["convs"]
    f1, f2 = (c["fb"][0].shape[1] for c in convs)
    e, w, x1, x2, _ = _rng_inputs(4, cfg.hidden_dim, f1, f2, dense=False)
    ref = jax_run(lambda: jax_bp.packed_block_aggregate(
        jnp.asarray(e).astype(jd), jnp.asarray(w[0]), jnp.asarray(w[1]),
        jnp.asarray(x1).astype(jd), jnp.asarray(x2).astype(jd), *jconvs,
        softplus_fn=jax_approx.softplus if approx else jax.nn.softplus))
    got = k2.packed_block_aggregate(
        torch.from_numpy(e).to(dtype), torch.from_numpy(w[0]),
        torch.from_numpy(w[1]), torch.from_numpy(x1).to(dtype),
        torch.from_numpy(x2).to(dtype), *convs, triu_pairs(N),
        approx=approx)
    tol = F32_TOL if dtype == torch.float32 else BF16_TWIN_TOL
    for g, r in zip(got, ref):
        _close(g.numpy(), r, tol)


def test_plain_twins_count_no_launch(weights):
    _, cfg, _, _, convs = weights
    f1, f2 = (c["fb"][0].shape[1] for c in convs)
    e, w, x1, x2, _ = _rng_inputs(5, cfg.hidden_dim, f1, f2, dense=False)
    before = dict(k2.launches)
    k2.packed_block_aggregate(torch.from_numpy(e), torch.from_numpy(w[0]),
                              torch.from_numpy(w[1]), torch.from_numpy(x1),
                              torch.from_numpy(x2), *convs, triu_pairs(N))
    assert dict(k2.launches) == before
    assert k2.variant(torch.bfloat16, True) == "packed_block_approx:bf16"
    assert fused.variant("gine", torch.float32) == "gine:f32"


# ---- the engines against JAX's --------------------------------------------------

def _planes(out):
    return [np.asarray(out.edge_inv_global), np.asarray(out.edge_inv_local)]


_JAX_OUTPUTS = {}   # JAX forwards already run, by (dtype, options)


def _engine_pair(engine_setup, dtype, monkeypatch, **jax_kw):
    """(port config at dtype, port model, port batch, JAX's output of
    build_fast_forward(**jax_kw) at dtype, Pallas kernels in interpret
    mode)."""
    jcfg, cfg, jb, tb, variables = engine_setup
    monkeypatch.setattr(jax_fused, "_INTERPRET", True)
    monkeypatch.setattr(jax_bp, "_INTERPRET", True)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # JAX's defaults written out, so that equal forwards share one entry
    jax_kw = {"use_pallas": True, "pack_pairs": True, **jax_kw}
    key = (dtype, tuple(sorted((k, str(v)) for k, v in jax_kw.items())))
    if key not in _JAX_OUTPUTS:
        _JAX_OUTPUTS[key] = jax_run(jax_fast(jcfg, variables,
                                             compute_dtype=jd, **jax_kw), jb)
    return cfg, port_model(cfg, variables), tb, _JAX_OUTPUTS[key]


@pytest.mark.parametrize("dtype,pack_pairs", [
    ("float32", True), ("bfloat16", True), ("float32", False)])
def test_pallas_engine_matches_jax(engine_setup, dtype, pack_pairs,
                                   monkeypatch):
    """Engine 'pallas' against JAX's use_pallas=True forward (K3, K4, K5
    in interpret mode): 2e-4 of the largest score at f32, packed or with
    pack_pairs=False; BF16_ENGINE_TOL at bf16."""
    cfg, model, tb, ref = _engine_pair(engine_setup, dtype, monkeypatch,
                                       use_pallas=True,
                                       pack_pairs=pack_pairs)
    fwd = build_fast_forward(cfg, model, "pallas", pack_pairs=pack_pairs)
    got = fwd(tb)
    tol = F32_TOL if dtype == "float32" else BF16_ENGINE_TOL
    for g, r in zip(_planes(got), _planes(ref)):
        _close(g, r, tol)
    assert fwd.calls == 1


@pytest.mark.parametrize("engine", ["pk", "pk-approx"])
def test_pk_engine_matches_jax(engine_setup, engine, monkeypatch):
    """Engine 'pk' (and its '-approx' form) against JAX's packed_kernel
    forward with slim storage, K2 in interpret mode."""
    approx = engine.endswith("approx")
    cfg, model, tb, ref = _engine_pair(
        engine_setup, "bfloat16", monkeypatch, use_pallas=False,
        packed_kernel=True, store_dtype=jnp.bfloat16, approx=approx)
    got = build_fast_forward(cfg, model, engine)(tb)
    for g, r in zip(_planes(got), _planes(ref)):
        _close(g, r, BF16_ENGINE_TOL)


def test_pallas_refuses_approx_and_dense_pairs_elsewhere(engine_setup):
    _, cfg, _, _, variables = engine_setup
    model = port_model(cfg, variables)
    with pytest.raises(ValueError, match="approx"):
        build_fast_forward(cfg, model, "pallas-approx")
    with pytest.raises(ValueError, match="pallas"):
        build_fast_forward(cfg, model, "pk", pack_pairs=False)


# ---- the traps -------------------------------------------------------------------

def test_trap_pallas_bf16_heads_keep_f32_weights(engine_setup, monkeypatch):
    """At bf16 the 'pallas' score heads take bf16-rounded inputs but keep
    f32 weights and arithmetic (fast_forward.py:499-519): casting the
    weights to bf16, as 'pks' and 'pk' do, moves the global plane away
    from JAX's by more than the engine's own reading."""
    cfg, model, tb, ref = _engine_pair(engine_setup, "bfloat16", monkeypatch,
                                       use_pallas=True)
    fwd = build_fast_forward(cfg, model, "pallas")
    assert fwd.stack.grad_global[0].dtype == torch.float32
    assert fwd.blocks[0]["convs"][0]["fa"][0].dtype == torch.bfloat16
    got, (h, e_p, pairs) = _heads_input(fwd, tb)
    ref_g = np.asarray(ref.edge_inv_global)
    right = np.abs(got.edge_inv_global.numpy() - ref_g).max()
    planes = [torch.where(got.edge_mask, mirror_plane(pair_scores(
        fwd.stack.grad_global, h, e_p, pairs, fwd.act, torch.bfloat16,
        wd=wd), pairs), 0.0).numpy() for wd in (torch.float32, None)]
    np.testing.assert_array_equal(planes[0], got.edge_inv_global.numpy())
    assert np.abs(planes[1] - ref_g).max() > 2 * right


def _heads_input(fwd, tb):
    """The forward's output, and what its global head took: h after the
    SchNet blocks, the packed edge features and the pair list."""
    captured = []
    original = fwd.scores

    def grab(head, h, e_packed, edge_attr, mask, pairs):
        captured.append((h, e_packed, pairs))
        return original(head, h, e_packed, edge_attr, mask, pairs)

    fwd.scores = grab
    try:
        out = fwd(tb)
    finally:
        del fwd.scores
    return out, captured[0]


def test_trap_pallas_bf16_gin_messages_stay_f32(engine_setup, monkeypatch):
    """At bf16 the 'pallas' GIN layers are f32 messages on bf16-valued
    edge features (:759-764), not K5 and not the slim engines' bf16
    messages: the local plane matches JAX's bf16 'pallas' forward."""
    cfg, model, tb, ref = _engine_pair(engine_setup, "bfloat16", monkeypatch,
                                       use_pallas=True)
    got = build_fast_forward(cfg, model, "pallas")(tb)
    _close(got.edge_inv_local.numpy(), np.asarray(ref.edge_inv_local),
           BF16_ENGINE_TOL)


def test_trap_pk_is_slim(engine_setup):
    """'pk' stores the filter weights and the score heads in bf16
    (langevin.py:399-405, fast_forward.py:364-374) and takes the same
    distance-weight planes as K1."""
    _, cfg, _, tb, variables = engine_setup
    fwd = build_fast_forward(cfg, port_model(cfg, variables), "pk")
    assert fwd.mode == "blocks" and fwd.compute_dtype == torch.bfloat16
    assert fwd.blocks[0]["convs"][1]["fb"][0].dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in fwd.stack.grad_local)
    kw, _ = fwd.stack_inputs(tb)
    assert kw["we"].shape[0] == 2 * cfg.num_convs


def test_trap_dense_pairs_encode_the_diagonal(engine_setup):
    """pack_pairs=False encodes every ordered pair, the diagonal included
    (dist 0, type 0), where the packed mirror repeats pair 0's row; both
    forwards give zero scores on the diagonal."""
    _, cfg, _, tb, variables = engine_setup
    model = port_model(cfg, variables)
    dense_fwd = build_fast_forward(cfg, model, "pallas", pack_pairs=False)
    packed_fwd = build_fast_forward(cfg, model, "pallas")
    n = tb.atom_type.shape[1]
    dist = torch.cdist(tb.pos, tb.pos)
    zeros = torch.zeros(dist.shape, dtype=torch.long)
    _, _, dense, _ = dense_fwd.encode_edges(dist, zeros, None)
    pairs = packed_fwd.prepare(tb)
    _, _, mirrored, _ = packed_fwd.encode_edges(dist, zeros, pairs)
    diag = edge_encode(dense_fwd.ee, torch.zeros(1, 1), torch.zeros(
        1, dtype=torch.long), dense_fwd.gelu)[0]
    torch.testing.assert_close(dense[0, 3, 3], diag, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(mirrored[0, 3, 3], mirrored[0, 0, 1])
    assert not torch.allclose(mirrored[0, 3, 3], diag)
    for fwd in (dense_fwd, packed_fwd):
        out = fwd(tb)
        idx = torch.arange(n)
        assert float(out.edge_inv_global[:, idx, idx].abs().max()) == 0.0
        assert float(out.edge_inv_local[:, idx, idx].abs().max()) == 0.0


def test_mirror_features_is_the_pair_id_gather():
    pairs = triu_pairs(5)
    e = torch.randn(2, 10, 3)
    dense = mirror_features(e, pairs)
    assert dense.shape == (2, 5, 5, 3)
    torch.testing.assert_close(dense[:, 1, 3], e[:, pairs.pair_id[1, 3]])
    torch.testing.assert_close(dense[:, 3, 1], dense[:, 1, 3])
    torch.testing.assert_close(dense[:, 2, 2], e[:, 0])


# ---- the ladder and the runner --------------------------------------------------

def test_pallas_ladder_matches_jax_with_replayed_noise(engine_setup,
                                                      monkeypatch):
    monkeypatch.setattr(jax_fused, "_INTERPRET", True)
    steps = 3
    ladder = dict(n_steps=steps, step_lr=2e-4, w_global=0.3,
                  global_start_sigma=10.0, clip=5.0, clip_local=4.0)
    jcfg, cfg, jb, tb, variables = engine_setup
    rng = np.random.default_rng(3)
    pos_init = rng.normal(size=tb.pos.shape).astype(np.float32)
    key = jax.random.PRNGKey(6)
    ref = jax_run(functools.partial(
        langevin_dynamics_sample, None, None, diffusion=jax_diffusion(jcfg),
        config=JaxSamplerConfig(**ladder),
        forward_fn=jax_fast(jcfg, variables, use_pallas=True)),
        jb, jnp.asarray(pos_init), key)
    noise = []
    for _ in range(steps):
        key, noise_key = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(
            noise_key, tb.pos.shape, jnp.float32)))
    fwd = build_fast_forward(cfg, port_model(cfg, variables), "pallas")
    got = build_fast_sampler(fwd, make_diffusion(cfg), SamplerConfig(
        **ladder))(tb, torch.from_numpy(pos_init),
                   noise=torch.from_numpy(np.stack(noise)))
    assert fwd.calls == steps
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               atol=1e-4)


def test_runner_takes_pk_and_refuses_pallas(engine_setup):
    _, cfg, _, _, variables = engine_setup
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = port_model(cfg, variables)
    args = (model, cfg, make_diffusion(cfg), SamplerConfig(n_steps=2))
    for engine in ("pallas", "pallas-approx"):
        with pytest.raises(ValueError, match="generate.py:258-261"):
            GenerationRunner(*args, engine=engine, device="cpu")
    runner = GenerationRunner(*args, buckets=(32,), chunk_size=4,
                              device="cpu", engine="pk")
    mol = load_fixture()[0]
    assert runner._engine_for(32) == "pk"
    assert runner._capacity_for(mol, "pk") is None
    pg = runner.run([mol], num_confs=3)[0].meta["pos_gen"]
    assert pg.shape == (3, mol.num_nodes, 3) and np.isfinite(pg).all()
    assert runner.forward("pk").calls == 2


# ---- the build ---------------------------------------------------------------------

def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every header it includes
    from csrc/, so editing the shared header rebuilds both kernels that
    include it (needs no nvcc)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    names = [os.path.basename(p) for p in build.sources("fused")]
    assert names == ["fused.cu", "filter_mlp.cuh"]
    before = {n: build.library_path(n) for n in ("fused", "block_packed",
                                                 "stack_packed")}
    with open(csrc / "filter_mlp.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: build.library_path(n) for n in before}
    assert after["fused"] != before["fused"]
    assert after["block_packed"] != before["block_packed"]
    assert after["stack_packed"] == before["stack_packed"]
