"""The generation engines of JAX's XLA path, ported without a hand kernel
(agdiff_tpu/sampling/langevin.py:306-436, build_fast_sampler): 'approx',
'tight-approx', 'stack', `tabulate`, 'slim', 'slim2', 'slim8',
'tight-slim', 'tight-slim8' and the suffix '-e16' (also on the K1
engines 'pksf' and 'tight-pksf'), each held against the forward JAX's
build_fast_sampler builds for the same engine name, on numpy-made inputs
and transplanted weights; and the float8 cast the slim8 engines rest on.

Tolerances, on each masked score plane as shares of its largest |value|:
the f32 engines within the 2e-4 class of tests/test_torch_port_tight.py
(rtol = atol); the narrow engines (bf16, float8) max 1e-2, median 1e-4,
p99 5e-3. For 'slim8' and 'tight-slim8' the port's gap to JAX's engine
must also stay below half of JAX's own gap between that engine and its
f32 engine. The JAX references are compiled without XLA's excess
precision (`NARROW_XLA`): with it, XLA's CPU backend drops bf16 roundings
the program states (a bf16 product feeding a sum, the sum of a bf16
einsum before an add), and the tight slim engines then read ~2e-3 off
the port on the global plane; without it the slim engines come out equal
to the port's, and the K1 '-e16' engines within 2e-7.

JAX's CPU backend has no bf16 x bf16 -> f32 product under jit at XLA's
level 0 (tight engines' filter and GIN sums, the interpret-mode kernel's
dots), so those references run with `F32Dots`: the same products with
the bf16 operands widened to f32, which is exact, and f32 sums, as the
TPU's MXU takes them."""

import ast
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import agdiff_tpu.models.fast_forward as jax_ff
import agdiff_tpu.models.tight_forward as jax_tf
from agdiff_tpu.models.schedules import make_diffusion as jax_diffusion
from agdiff_tpu.ops.pallas import stack_packed as jax_stack
from agdiff_tpu.sampling.langevin import (
    SamplerConfig as JaxSamplerConfig,
    build_fast_sampler as jax_fast_sampler,
)

from agdiff_torch.cli.generate import ENGINE_CHOICES
from agdiff_torch.eval.generate import GenerationRunner
from agdiff_torch.kernels import stack_packed as k1
from agdiff_torch.models import fast_forward, tight_forward
from agdiff_torch.models.fast_forward import build_fast_forward, to_float8
from agdiff_torch.models.schedules import make_diffusion
from agdiff_torch.models.tight_forward import build_tight_forward
from agdiff_torch.ops.pairs import pair_capacity_for
from agdiff_torch.sampling.langevin import SamplerConfig

from test_torch_port_common import (
    FAST_XLA,
    batches,
    configs,
    jax_run,
    jax_variables,
    molecules,
    port_model,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16
TABLE = 64     # tabulate's distances per bond type
F32_TOL = 2e-4
NARROW_LIMITS = (1e-2, 1e-4, 5e-3)   # max, median, p99
# the JAX references: every rounding the program states
NARROW_XLA = {**FAST_XLA, "xla_allow_excess_precision": False}


class F32Dots:
    """jax.numpy with every bf16 or float8 operand of a product asked for
    f32 (preferred_element_type) widened to f32 first: exact products,
    f32 sums."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def _widen(args, pet):
        if pet != jnp.float32:
            return args
        return [a.astype(jnp.float32)
                if getattr(a, "dtype", None) in (jnp.bfloat16,
                                                 jnp.float8_e4m3fn)
                else a for a in args]

    def einsum(self, spec, *ops, preferred_element_type=None, **kw):
        return jnp.einsum(spec, *self._widen(ops, preferred_element_type),
                          preferred_element_type=preferred_element_type,
                          **kw)

    def matmul(self, a, b, preferred_element_type=None, **kw):
        a, b = self._widen([a, b], preferred_element_type)
        return jnp.matmul(a, b, preferred_element_type=preferred_element_type,
                          **kw)

    def dot(self, a, b, preferred_element_type=None, **kw):
        a, b = self._widen([a, b], preferred_element_type)
        return jnp.dot(a, b, preferred_element_type=preferred_element_type,
                       **kw)


# engine -> (JAX build_fast_sampler arguments, tolerance class); the
# tight engines run on the molecule's shared list at a capacity below
# N(N-1)/2, so the lists have pad slots
ENGINES = {
    "approx": (dict(engine="approx"), "f32"),
    "tight-approx": (dict(engine="tight-approx"), "f32"),
    "stack": (dict(engine="stack"), "f32"),
    "tabulate": (dict(engine="tight", tabulate=TABLE), "f32"),
    "slim": (dict(engine="slim"), "narrow"),
    "slim2": (dict(engine="slim2"), "narrow"),
    "slim8": (dict(engine="slim8"), "narrow"),
    "tight-slim": (dict(engine="tight-slim"), "narrow"),
    "tight-slim8": (dict(engine="tight-slim8"), "narrow"),
    "slim-e16": (dict(engine="slim-e16"), "narrow"),
    "tight-slim-e16": (dict(engine="tight-slim-e16"), "narrow"),
    "pksf-e16": (dict(engine="pksf-e16"), "narrow"),
    "tight-pksf-e16": (dict(engine="tight-pksf-e16"), "narrow"),
}
# each float8 engine's f32 engine in JAX
F32_OF = {"slim8": dict(engine=None), "tight-slim8": dict(engine="tight")}


@pytest.fixture(scope="module")
def setup():
    """A small smooth-envelope model (as the Drugs configs) and a batch of
    one molecule repeated with noised positions."""
    jcfg, cfg = configs(num_convs=3, smooth_conv=True)
    mol = molecules(1, seed=11)[0]
    assert mol.num_nodes <= N
    jb, tb = batches([mol] * 3, max_nodes=N)
    rng = np.random.default_rng(0)
    pos = ((np.asarray(jb.pos) + 0.3 * rng.normal(size=jb.pos.shape))
           * np.asarray(jb.node_mask)[..., None]).astype(np.float32)
    jb = jb.replace(pos=jnp.asarray(pos))
    tb = tb.replace(pos=torch.from_numpy(pos))
    _, variables = jax_variables(jcfg, jb)
    cap = pair_capacity_for(mol.num_nodes, 16)
    assert mol.num_nodes * (mol.num_nodes - 1) // 2 <= cap < N * (N - 1) // 2
    return jcfg, cfg, jb, tb, variables, cap, port_model(cfg, variables)


def jax_reference(setup, kw):
    """The output of the forward JAX's build_fast_sampler builds from the
    arguments `kw` (captured from its build call), on the batch: bf16
    compute for the narrow engines, f32 otherwise; the tight engines on
    the molecule's shared list."""
    jcfg, _, jb, _, variables, cap, _ = setup
    engine = kw.get("engine") or ""
    narrow = "slim" in engine or "pks" in engine
    built = []
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jax_ff, "build_fast_forward"),
                          (jax_tf, "build_tight_forward")):
            orig = getattr(mod, name)
            mp.setattr(mod, name, lambda *a, _o=orig, **k: built.append(
                _o(*a, **k)) or built[-1])
        mp.setattr(jax_stack, "_INTERPRET", True)
        mp.setattr(jax_tf, "jnp", F32Dots())
        mp.setattr(jax_stack, "jnp", F32Dots())
        jax_fast_sampler(
            jcfg, variables, jax_diffusion(jcfg), JaxSamplerConfig(),
            compute_dtype=jnp.bfloat16 if narrow else jnp.float32,
            pair_capacity=cap, shared_pairs=True, **kw)
        assert len(built) == 1
        return jax.jit(built[0]).lower(jb).compile(
            compiler_options=NARROW_XLA)(jb)


def port_forward(setup, name):
    _, cfg, _, _, _, cap, model = setup
    if name == "tabulate":
        return build_tight_forward(cfg, model, "tight", capacity=cap,
                                   tabulate=TABLE)
    if name in tight_forward.ENGINES:
        return build_tight_forward(cfg, model, name, capacity=cap)
    return build_fast_forward(cfg, model, name)


def plane_errors(got, ref):
    """Per masked score plane: |got - ref| as shares of the plane's
    largest |ref|, as (max, median, p99); the masks must be equal."""
    out = {}
    for name, mask in (("global", "edge_mask"), ("local", "local_mask")):
        m = np.asarray(getattr(ref, mask))
        np.testing.assert_array_equal(
            np.asarray(getattr(got, mask)), m)
        g = np.asarray(getattr(got, f"edge_inv_{name}"), np.float32)[m]
        r = np.asarray(getattr(ref, f"edge_inv_{name}"), np.float32)[m]
        scale = np.abs(r).max()
        assert scale > 1e-3 and np.isfinite(g).all(), name
        d = np.abs(g - r) / scale
        out[name] = (d.max(), np.median(d), np.quantile(d, 0.99))
    return out


@pytest.fixture(scope="module")
def references(setup):
    """JAX's outputs, shared between the cases."""
    return {}


def reference(setup, references, key, kw):
    if key not in references:
        references[key] = jax_reference(setup, kw)
    return references[key]


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_matches_jax(setup, references, name):
    kw, tol = ENGINES[name]
    ref = reference(setup, references, name, kw)
    fwd = port_forward(setup, name)
    launches = dict(k1.launches)
    out = fwd(setup[3])
    assert fwd.calls == 1 and dict(k1.launches) == launches
    if tol == "f32":
        for plane in ("edge_inv_global", "edge_inv_local"):
            np.testing.assert_allclose(
                getattr(out, plane).numpy(),
                np.asarray(getattr(ref, plane)), rtol=F32_TOL,
                atol=F32_TOL, err_msg=plane)
        plane_errors(out, ref)
        return
    errs = plane_errors(out, ref)
    for plane, readings in errs.items():
        for got, limit in zip(readings, NARROW_LIMITS):
            assert got <= limit, (plane, readings)
    if name in F32_OF:
        # the port's float8 gap to JAX's engine against JAX's own gap
        # between the engine and its f32 engine
        f32 = reference(setup, references, f"f32:{name}", F32_OF[name])
        jax_gap = plane_errors(ref, f32)
        for plane in errs:
            assert errs[plane][0] < 0.5 * jax_gap[plane][0], (
                plane, errs[plane], jax_gap[plane])


def test_float8_cast_matches_jax_bit_for_bit():
    """to_float8 against ml_dtypes (JAX's astype) and XLA's convert on a
    sweep: every float8 value, every tie between neighbours and the
    floats beside each tie, subnormals, the largest values and past them
    (|x| > 464 and inf give NaN in JAX, where PyTorch's own cast
    saturates at 448), NaN, -0, and normals at several scales; from f32
    and from bf16."""
    grid = np.arange(256, dtype=np.uint8).view(
        ml_dtypes.float8_e4m3fn).astype(np.float32)
    grid = np.unique(grid[np.isfinite(grid)])
    ties = (grid[1:] + grid[:-1]) / 2
    rng = np.random.default_rng(0)
    x = np.concatenate([
        grid, ties, np.nextafter(ties, np.inf), np.nextafter(ties, -np.inf),
        np.float32([448, 449, 463.99, 464, 464.01, 480, 500, 1e4, 3e38,
                    np.inf, np.nan, -0.0, 2 ** -9, 2 ** -10, 1.5 * 2 ** -10,
                    2 ** -11, 1e-30]),
        *(rng.normal(0, s, 20000) for s in (1e-3, 1.0, 100.0))
    ]).astype(np.float32)
    x = np.concatenate([x, -x])
    for source in (np.float32, ml_dtypes.bfloat16):
        xs = x.astype(source)
        want = xs.astype(ml_dtypes.float8_e4m3fn)
        xla = np.asarray(jax_run(lambda v: v.astype(jnp.float8_e4m3fn),
                                 jnp.asarray(xs)))
        t = torch.from_numpy(xs.astype(np.float32)).to(
            torch.float32 if source is np.float32 else torch.bfloat16)
        got = to_float8(t).view(torch.uint8).numpy()
        for other in (want, xla):
            nan = np.isnan(other.astype(np.float32))
            np.testing.assert_array_equal(
                np.isnan(got.view(ml_dtypes.float8_e4m3fn).astype(
                    np.float32)), nan)
            np.testing.assert_array_equal(got[~nan],
                                          other.view(np.uint8)[~nan])
    # why to_float8 exists: PyTorch's cast saturates
    assert torch.tensor([500.0]).to(torch.float8_e4m3fn).float().item() \
        == 448.0


def _jax_cli_engines(path):
    """The --engine choices of a JAX CLI, read from its source."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--engine"):
            for k in node.keywords:
                if k.arg == "choices":
                    return ast.literal_eval(k.value)
    raise AssertionError(f"no --engine in {path}")


def test_cli_engines_cover_jax_and_build(setup):
    """Every engine the JAX CLIs accept (generate and serve) is one the
    port's CLIs accept, and every port engine name builds a forward; the
    refused combinations raise."""
    from agdiff_torch.cli import serve

    _, cfg, _, _, _, cap, model = setup
    jax_names = set(_jax_cli_engines("agdiff_tpu/cli/generate.py")) | set(
        _jax_cli_engines("agdiff_tpu/cli/serve.py"))
    assert jax_names <= set(ENGINE_CHOICES), jax_names - set(ENGINE_CHOICES)
    assert serve.ENGINE_CHOICES is ENGINE_CHOICES
    for name in fast_forward.ENGINES:
        build_fast_forward(cfg, model, name)
    for name in tight_forward.ENGINES:
        build_tight_forward(cfg, model, name, capacity=cap)
    with pytest.raises(ValueError, match="tabulate"):
        build_tight_forward(cfg, model, "tight-pksf", tabulate=TABLE)
    with pytest.raises(ValueError):
        build_fast_forward(cfg, model, "pallas-e16")


@pytest.mark.parametrize("engine", ["approx", "slim8", "stack", "slim-e16",
                                    "tight-approx", "tight-slim8",
                                    "tight-pksf-e16"])
def test_runner_generates_on_the_engine(setup, engine):
    """GenerationRunner on each kind of engine: finite samples, one forward
    a step, a tight engine's capacity its molecule's, and no hand kernel
    launched (on the CPU the kernel engines take the plain twins)."""
    _, cfg, _, _, _, _, model = setup
    mol = molecules(1, seed=11)[0]
    runner = GenerationRunner(model, cfg, make_diffusion(cfg),
                              SamplerConfig(n_steps=2, w_global=0.3),
                              buckets=(N,), chunk_size=4, device="cpu",
                              engine=engine)
    out = runner.run([mol], num_confs=3)[0].meta["pos_gen"]
    assert out.shape == (3, mol.num_nodes, 3) and np.isfinite(out).all()
    assert runner.forwards[engine].calls == 2
    tight = engine in tight_forward.ENGINES
    cap = pair_capacity_for(mol.num_nodes, 256) if tight else None
    assert (engine, False, cap) in runner._samplers
