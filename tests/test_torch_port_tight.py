"""The port's tight pair lists and tight forward against the JAX package
(agdiff_tpu/models/tight_forward.py), the kernel engines 'pks' / 'pksg'
against JAX `fast_forward` with `packed_stack`, the runner's engine
choice and capacity, and a ladder on the tight engine.

At f32 the bar is the JAX tight-forward test's, 2e-4
(tests/test_tight_forward.py:253-260); the JAX kernel runs in interpret
mode, at N <= 16. Capacities sit below N(N-1)/2, so the lists have pad
slots, and smooth_conv is on, as in the Drugs configs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.eval.generate import GenerationRunner as JaxRunner
from agdiff_tpu.models.fast_forward import build_fast_forward as jax_fast
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.models.tight_forward import (
    build_tight_forward as jax_tight,
    pair_capacity_for as jax_capacity,
    prepare_pairs as jax_prepare,
)
from agdiff_tpu.ops.pallas import stack_packed as jax_stack
from agdiff_tpu.sampling.langevin import (
    SamplerConfig as JaxSamplerConfig,
    langevin_dynamics_sample as jax_ld,
)

from agdiff_torch.data.fixture import load_fixture
from agdiff_torch.eval import generate
from agdiff_torch.eval.generate import GenerationRunner
from agdiff_torch.models.fast_forward import FastForward, build_fast_forward
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.models.tight_forward import (
    TightForward,
    build_tight_forward,
)
from agdiff_torch.ops.pairs import (
    mirror_plane,
    pair_capacity_for,
    prepare_pairs,
    prepare_pairs_shared,
)
from agdiff_torch.sampling.langevin import (
    SamplerConfig,
    build_fast_sampler,
)

from test_torch_port_common import (
    batches,
    configs,
    jax_variables,
    molecules,
    port_model,
)

N = 16
F32_TOL = 2e-4
# bf16 engines against the same JAX engine: both round at the same points,
# but a product summed in another order can flip a bf16 rounding, which
# later layers carry on; measured up to ~2e-3 of the largest score here.
BF16_TOL = 1e-2


@pytest.fixture(scope="module")
def setup():
    """Small smooth-envelope model; a batch of one molecule repeated (the
    generation pattern, shared lists) with noised positions."""
    jcfg, cfg = configs(num_convs=3, smooth_conv=True)
    mol = molecules(1, seed=11)[0]
    assert mol.num_nodes <= N
    jb, tb = batches([mol] * 3, max_nodes=N)
    rng = np.random.default_rng(0)
    pos = (np.asarray(jb.pos) + 0.3 * rng.normal(size=jb.pos.shape)) \
        * np.asarray(jb.node_mask)[..., None]
    pos = pos.astype(np.float32)
    jb = jb.replace(pos=jnp.asarray(pos))
    tb = tb.replace(pos=torch.from_numpy(pos))
    _, variables = jax_variables(jcfg, jb)
    cap = pair_capacity_for(mol.num_nodes, 16)
    assert mol.num_nodes * (mol.num_nodes - 1) // 2 <= cap < N * (N - 1) // 2
    return jcfg, cfg, jb, tb, variables, cap, port_model(cfg, variables)


def _compare(out, ref, tol):
    """The same masks; masked score planes within tol: at f32 the JAX
    test's rtol = atol = tol, at bf16 (tol >= 1e-3) tol of the plane's
    largest score."""
    for name in ("edge_mask", "local_mask"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name, mask in (("edge_inv_global", ref.edge_mask),
                       ("edge_inv_local", ref.local_mask)):
        m = np.asarray(mask)
        got = np.where(m, getattr(out, name).float().numpy(), 0)
        want = np.where(m, np.asarray(getattr(ref, name), np.float32), 0)
        scale = np.abs(want).max()
        assert scale > 1e-3, name
        if tol < 1e-3:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=tol * scale,
                                       err_msg=name)


# ---- pair lists -------------------------------------------------------------

def test_pair_lists_match_prepare_pairs():
    """Per graph: the same valid slots, cells and endpoints, in row-major
    order, and the same dense -> slot map. JAX's pad slots sit on invalid
    cells in row-major order, which include lower-triangle mirrors of
    valid pairs, such as (1, 0); the guard keeps pad slots from writing
    them, and the port's pads write nothing."""
    n, cap = 12, 40
    mask = np.zeros((3, n), bool)
    for b, k in enumerate((9, 7, 5)):
        mask[b, :k] = True
    ref = jax_prepare(jnp.asarray(mask), cap)
    got = prepare_pairs(torch.from_numpy(mask), cap)
    assert not got.shared and got.num_pairs == cap
    mirrors = 0
    for b, k in enumerate((9, 7, 5)):
        valid = np.asarray(ref.valid[b])
        np.testing.assert_array_equal(got.valid[b].numpy(), valid)
        real = valid > 0
        assert real.sum() == k * (k - 1) // 2
        for name in ("idx", "iu", "ju"):
            np.testing.assert_array_equal(
                getattr(got, name)[b].numpy()[real],
                np.asarray(getattr(ref, name)[b])[real])
            assert (getattr(got, name)[b].numpy()[~real] == 0).all()
        pad_i, pad_j = np.divmod(np.asarray(ref.idx[b])[~real], n)
        mirrors += int(((pad_j < pad_i) & (pad_i < k)).sum())
        np.testing.assert_array_equal(got.slot[b].numpy(),
                                      np.asarray(ref.slot[b]))
    assert mirrors > 0
    # mirroring a plane of distinct values returns each valid pair's own
    # value on both of its cells
    shared = prepare_pairs_shared(torch.from_numpy(mask), cap)
    plane = torch.arange(cap, dtype=torch.float32)[None] + 1.0
    dense = mirror_plane(plane, shared)[0].numpy()
    iu, ju = shared.iu.numpy()[:36], shared.ju.numpy()[:36]
    np.testing.assert_array_equal(dense[iu, ju], np.arange(36) + 1.0)
    np.testing.assert_array_equal(dense[ju, iu], np.arange(36) + 1.0)


def test_shared_list_incidence_holds_valid_pairs_only():
    mask = torch.zeros((2, 10), dtype=torch.bool)
    mask[:, :6] = True
    pl = prepare_pairs_shared(mask, 32)
    assert pl.shared and pl.tight and pl.num_valid == 15
    ptr = pl.inc_ptr.numpy()
    assert ptr[-1] == 2 * pl.num_valid and (ptr[6:] == ptr[6]).all()
    assert (pl.inc_pair.numpy() < pl.num_valid).all()
    iu, ju = pl.iu.numpy(), pl.ju.numpy()
    for node in range(10):
        pairs = pl.inc_pair.numpy()[ptr[node]:ptr[node + 1]]
        want = np.nonzero(((iu == node) | (ju == node))
                          & (pl.valid.numpy() > 0))[0]
        np.testing.assert_array_equal(pairs, want)
    with pytest.raises(ValueError, match="capacity"):
        prepare_pairs_shared(mask, 8)
    assert pair_capacity_for(50, 256) == jax_capacity(50, 256) == 1280
    assert pair_capacity_for(9) == jax_capacity(9) == 64


# ---- the tight forward --------------------------------------------------------

@pytest.mark.parametrize("mode", [None, "schnet", "gin", "full"])
def test_tight_forward_matches_jax_f32(setup, mode, monkeypatch):
    """Engine 'tight' (mode None, K1's plain version) and the K1 modes at
    f32 over a shared tight list with pad slots, against JAX's
    build_tight_forward (interpret-mode Pallas for the modes)."""
    monkeypatch.setattr(jax_stack, "_INTERPRET", True)
    jcfg, cfg, jb, tb, variables, cap, model = setup
    ref = jax_tight(jcfg, variables, capacity=cap, shared=True,
                    packed_stack=mode or False)(jb)
    fwd = TightForward(cfg, model, capacity=cap, mode=mode)
    out = fwd(tb)
    assert fwd.calls == 1
    _compare(out, ref, F32_TOL)


def test_tight_forward_per_graph_lists_match_jax(setup):
    """Engine 'tight' with per-graph lists (shared=False) on a batch of
    molecules of different sizes."""
    jcfg, cfg, _, _, variables, _, model = setup
    mols = molecules(3, seed=4)
    jb, tb = batches(mols, max_nodes=N)
    cap = pair_capacity_for(max(m.num_nodes for m in mols), 16)
    ref = jax_tight(jcfg, variables, capacity=cap)(jb)
    out = TightForward(cfg, model, capacity=cap, shared=False)(tb)
    _compare(out, ref, F32_TOL)
    with pytest.raises(ValueError, match="shared"):
        TightForward(cfg, model, mode="full", shared=False)


@pytest.mark.parametrize("engine", ["tight-pks", "tight-pksg", "tight-pksf"])
def test_tight_kernel_engines_match_jax_bf16(setup, engine, monkeypatch):
    """The bf16 engines with slim storage against JAX's (the engine map of
    sampling/langevin.py: store_dtype bf16 and the K1 mode), run eagerly.
    JAX's CPU backend has no bf16 x bf16 -> f32 product for the tight GIN
    scatter of 'tight-pks', so that engine is held against JAX's triu
    'pks': the same function, pad slots aside, which add nothing."""
    monkeypatch.setattr(jax_stack, "_INTERPRET", True)
    jcfg, cfg, jb, tb, variables, cap, model = setup
    mode = {"tight-pks": "schnet", "tight-pksg": "gin",
            "tight-pksf": "full"}[engine]
    slim = dict(compute_dtype=jnp.bfloat16, store_dtype=jnp.bfloat16,
                packed_stack=mode)
    if mode == "schnet":
        ref = jax_fast(jcfg, variables, use_pallas=False, **slim)(jb)
    else:
        ref = jax_tight(jcfg, variables, capacity=cap, shared=True,
                        **slim)(jb)
    fwd = build_tight_forward(dataclasses.replace(cfg, dtype="bfloat16"),
                              model, engine, capacity=cap)
    assert fwd.compute_dtype == torch.bfloat16 and fwd.mode == mode
    _compare(fwd(tb), ref, BF16_TOL)


@pytest.mark.parametrize("mode", ["schnet", "gin"])
def test_pks_engines_match_jax_fast_forward(setup, mode, monkeypatch):
    """Modes 'schnet' / 'gin' on the triu set with the tail here, at f32
    (2e-4) and as the bf16 engines 'pks' / 'pksg' (slim storage), against
    JAX fast_forward with packed_stack."""
    monkeypatch.setattr(jax_stack, "_INTERPRET", True)
    jcfg, cfg, jb, tb, variables, _, model = setup
    ref = jax_fast(jcfg, variables, use_pallas=False, packed_stack=mode)(jb)
    _compare(FastForward(cfg, model, mode=mode)(tb), ref, F32_TOL)
    ref16 = jax_fast(jcfg, variables, use_pallas=False,
                     compute_dtype=jnp.bfloat16, store_dtype=jnp.bfloat16,
                     packed_stack=mode)(jb)
    engine = {"schnet": "pks", "gin": "pksg"}[mode]
    _compare(build_fast_forward(cfg, model, engine)(tb), ref16, BF16_TOL)


def test_engine_names():
    import torch

    from agdiff_torch.models.fast_forward import engine_options

    bf16, fp8 = torch.bfloat16, torch.float8_e4m3fn
    assert engine_options(None) == (False, None, False, None, None)
    assert engine_options("tight") == (True, None, False, None, None)
    assert engine_options("pksg") == (False, "gin", False, None, None)
    assert engine_options("tight-pksf-approx") == (True, "full", True, None,
                                                   None)
    # the engines of JAX's XLA path and the suffixes
    # (agdiff_tpu/sampling/langevin.py:374-405)
    assert engine_options("approx") == (False, None, True, None, None)
    assert engine_options("tight-approx") == (True, None, True, None, None)
    assert engine_options("slim") == engine_options("slim2") == (
        False, "xla", False, bf16, None)
    assert engine_options("tight-slim8") == (True, "xla", False, fp8, None)
    assert engine_options("stack") == (False, "stack", False, None, None)
    assert engine_options("tight-pksf-e16") == (True, "full", False, None,
                                                bf16)
    for bad in ("mono", "pallas-approx", "pallas-e16", "slimmer",
                "tight-bogus"):
        with pytest.raises(ValueError):
            engine_options(bad)


# ---- the runner -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_engine_choice_follows_jax_tpu_rule(setup, dtype):
    """bf16: 'tight-pksf' at bucket >= 40, 'pksf' below; f32: 'tight' and
    the plain packed forward. JAX on a CPU picks the XLA stand-ins
    ('tight-slim' / 'slim') for the Mosaic kernels; the rule is the same."""
    jcfg, cfg, _, _, variables, _, model = setup
    cfg = dataclasses.replace(cfg, dtype=dtype)
    jcfg = dataclasses.replace(jcfg, dtype=dtype)
    port = GenerationRunner(model, cfg, make_diffusion(cfg), SamplerConfig(),
                            device="cpu")
    ref = JaxRunner(None, variables, jax_diffusion(jcfg), JaxSamplerConfig(),
                    use_fast=True, model_config=jcfg)
    want = {"bfloat16": {32: "pksf", 40: "tight-pksf", 64: "tight-pksf",
                         96: "tight-pksf"},
            "float32": {32: None, 40: "tight", 64: "tight", 96: "tight"}}
    for bucket, engine in want[dtype].items():
        assert port._engine_for(bucket) == engine
        jax_engine = ref._engine_for(bucket)
        if jax_engine is not None:
            jax_engine = jax_engine.replace("slim", "pksf")
        assert jax_engine == engine
    fixed = GenerationRunner(model, cfg, make_diffusion(cfg),
                             SamplerConfig(), device="cpu", engine="tight")
    assert fixed._engine_for(32) == "tight"


def test_capacity_covers_the_molecule_or_asserts(setup, monkeypatch):
    _, cfg, _, _, _, _, model = setup
    runner = GenerationRunner(model, cfg, make_diffusion(cfg),
                              SamplerConfig(), device="cpu")
    mol = load_fixture("drugs_synthetic")[0]
    assert runner._capacity_for(mol, "pksf") is None
    assert runner._capacity_for(mol, "tight-pksf") == 1280
    monkeypatch.setattr(generate, "pair_capacity_for", lambda n, multiple: 8)
    with pytest.raises(AssertionError):
        runner._capacity_for(mol, "tight")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_runner_generates_on_tight_engines(setup, dtype):
    """Buckets of 40 and a molecule above every bucket (its own bucket of
    a multiple of 8) run the tight engines end to end; samplers are keyed
    by (engine, retry, capacity)."""
    _, cfg, _, _, _, _, model = setup
    cfg = dataclasses.replace(cfg, dtype=dtype)
    mols = load_fixture()[:2]
    runner = GenerationRunner(model, cfg, make_diffusion(cfg),
                              SamplerConfig(n_steps=3, w_global=0.3),
                              buckets=(40,), chunk_size=4, device="cpu")
    out = runner.run(mols, seed=1, num_confs=3)
    engine = "tight-pksf" if dtype == "bfloat16" else "tight"
    for mol, res in zip(mols, out):
        assert res.meta["pos_gen"].shape == (3, mol.num_nodes, 3)
        assert np.isfinite(res.meta["pos_gen"]).all()
        cap = pair_capacity_for(mol.num_nodes, 256)
        assert (engine, False, cap) in runner._samplers
    assert runner.forwards[engine].calls == 3 * len(mols)
    small = GenerationRunner(model, cfg, make_diffusion(cfg),
                             SamplerConfig(n_steps=2), buckets=(16,),
                             chunk_size=4, device="cpu")
    big = small.run(mols[:1], num_confs=2)[0].meta["pos_gen"]
    assert small.buckets == (16, 24) and np.isfinite(big).all()


def test_tight_ladder_matches_jax_with_replayed_noise(setup):
    """A ladder of a few steps on the f32 tight engine against JAX's with
    the same noise; the pair list is built once for the whole ladder."""
    jcfg, cfg, jb, tb, variables, cap, model = setup
    steps = 6
    ladder = dict(n_steps=steps, step_lr=2e-4, w_global=0.3,
                  global_start_sigma=10.0, clip=5.0, clip_local=4.0)
    rng = np.random.default_rng(3)
    pos_init = rng.normal(size=tb.pos.shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jax_ld(None, None, jb, jnp.asarray(pos_init), key,
                 jax_diffusion(jcfg), JaxSamplerConfig(**ladder),
                 forward_fn=jax_tight(jcfg, variables, capacity=cap,
                                      shared=True))
    noise = []
    for _ in range(steps):
        key, noise_key = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(
            noise_key, tb.pos.shape, jnp.float32)))
    fwd = build_tight_forward(cfg, model, "tight")
    built = []
    prepare = fwd.prepare

    def counting_prepare(batch, capacity=None):
        built.append(capacity)
        return prepare(batch, capacity)

    fwd.prepare = counting_prepare
    run = build_fast_sampler(fwd, make_diffusion(cfg),
                             SamplerConfig(**ladder), pair_capacity=cap)
    got = run(tb, torch.from_numpy(pos_init),
              noise=torch.from_numpy(np.stack(noise)))
    assert built == [cap] and fwd.calls == steps
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos),
                               atol=1e-4)
    np.testing.assert_array_equal(got.nan_flags.numpy(),
                                  np.asarray(ref.nan_flags))
