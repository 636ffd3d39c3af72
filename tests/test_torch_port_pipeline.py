"""Pipeline parallelism (agdiff_torch/parallel/pipeline.py) against the
JAX package's (tests/test_pipeline_parallel.py) on the CPU. One world of
four gloo ranks, spawned once for the module (tests/torch_port_shard_
ranks.py), runs every case while the JAX references compile on the
conftest's virtual CPU devices.

The toy stack has four stages, one a rank (JAX's test takes eight on its
eight devices; its references here run on make_pp_mesh(4)); the SchNet
stack (hidden 16, six blocks, two stages of three, four microbatches of
one graph, as in JAX's test) runs over the 'pp' axis of a ('dp', 'pp') =
(2, 2) mesh, each 'dp' line a replica. The stage body on the CPU is K3's
plain version (kernels/fused.py), as JAX's use_pallas=False body is XLA.

Tolerances are JAX's: the toy forward rtol 1e-6, its gradients rtol
1e-5 and atol 1e-6, the SchNet stack rtol 2e-5 and atol 1e-5. Against
the port's own sequential stack the pipeline is bit for bit.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agdiff_tpu.data.bucketing import pad_molecules as jax_pad
from agdiff_tpu.data.synthetic import synthetic_dataset
from agdiff_tpu.models.fast_forward import build_fast_forward as jax_fast
from agdiff_tpu.parallel.pipeline import (
    make_pp_mesh as jax_pp_mesh,
    pipeline_apply as jax_pipeline_apply,
    schnet_pipeline as jax_schnet_pipeline,
)

from agdiff_torch.parallel import launch

import torch_port_shard_ranks as ranks
from test_torch_port_common import FAST_XLA, configs, jax_variables

S, M, D = 4, 4, 16
SCHNET = dict(hidden_dim=16, num_convs=6, num_convs_local=2,
              num_diffusion_timesteps=50)
B, N = 4, 16


def _toy():
    ws = jax.random.normal(jax.random.PRNGKey(0), (S, D, D)) * 0.3
    x = jax.random.normal(jax.random.PRNGKey(1), (M, 5, D))
    return ws, x


def _schnet_inputs():
    """JAX's test's inputs (test_pipeline_parallel.py:110-131): h, e, el,
    env of a batch of four graphs, as numpy."""
    key = jax.random.PRNGKey(3)
    h = jax.random.normal(key, (B, N, SCHNET["hidden_dim"]))
    e = jax.random.normal(jax.random.fold_in(key, 1),
                          (B, N, N, SCHNET["hidden_dim"])) * 0.1
    el = jnp.abs(jax.random.normal(jax.random.fold_in(key, 2),
                                   (B, N, N, 1))) + 0.5
    env = jax.nn.sigmoid(jax.random.normal(jax.random.fold_in(key, 3),
                                           (B, N, N)))
    return tuple(np.array(a) for a in (h, e, el, env))


def _jax_run(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)(*args)


@pytest.fixture(scope="module")
def world():
    """(JAX's references, the cases, [each rank's results])."""
    ws, x = _toy()
    jcfg, cfg = configs(**SCHNET)
    mols = synthetic_dataset(4, seed=0, min_heavy=3, max_heavy=4)
    _, variables = jax_variables(jcfg, jax_pad(mols, N, batch_size=B))
    inputs = _schnet_inputs()
    # microbatch axis: four microbatches of one graph
    payload = tuple(torch.from_numpy(a[:, None].copy()) for a in inputs)
    cases = {"toy": dict(kind="toy", ws=torch.from_numpy(np.array(ws)),
                         x=torch.from_numpy(np.array(x))),
             "schnet": dict(kind="schnet", model_config=cfg,
                            variables=variables, payload=payload)}
    box = {}

    def run():
        try:
            box["out"] = launch(ranks.run_cases, 4, cases, device="cpu")
        except BaseException as e:  # noqa: B902 (re-raised below)
            box["err"] = e
    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    mesh = jax_pp_mesh(S)
    refs = {"toy": _jax_run(lambda w, v: jax_pipeline_apply(
        ranks_stage, w, v, mesh=mesh), ws, x)}

    def loss_pipe(w, v):
        return jnp.sum(jax_pipeline_apply(ranks_stage, w, v, mesh=mesh) ** 2)

    refs["grads"] = _jax_run(jax.grad(loss_pipe, argnums=(0, 1)), ws, x)
    fwd = jax_fast(jcfg, variables, use_pallas=False)
    h_seq = jnp.asarray(inputs[0])
    for blk in fwd.schnet_blocks:
        h_seq = fwd.schnet_block(blk, h_seq, *map(jnp.asarray, inputs[1:]))
    run_pp, stacked = jax_schnet_pipeline(fwd, jax_pp_mesh(2))
    refs["schnet"] = _jax_run(lambda p, pl: run_pp(p, pl)[:, 0], stacked,
                              tuple(jnp.asarray(a[:, None]) for a in inputs))
    refs["schnet_sequential"] = np.asarray(h_seq)
    thread.join()
    if "err" in box:
        raise box["err"]
    return refs, cases, box["out"]


def ranks_stage(w, xm):
    return jnp.tanh(xm @ w)


def _sequential(ws, x):
    for s in range(ws.shape[0]):
        x = ranks.toy_stage(ws[s], x)
    return x


def test_pipeline_matches_sequential(world):
    """test_pipeline_parallel.py:38-42: the pipelined toy stack equals the
    sequential one (the port's bit for bit) and JAX's pipeline (rtol
    1e-6), on every rank."""
    refs, cases, out = world
    seq = _sequential(cases["toy"]["ws"], cases["toy"]["x"])
    for r in range(4):
        got = out[r]["toy"]["out"]
        assert torch.equal(got, seq)
        np.testing.assert_allclose(got.numpy(), np.asarray(refs["toy"]),
                                   rtol=1e-6, atol=1e-6)


def test_pipeline_gradients_match_sequential(world):
    """test_pipeline_parallel.py:45-61: the gradients of sum(out ** 2)
    through the pipeline, in the stage weights (each rank holds its
    stage's; summed here) and in x (whole on every rank). They are bit
    for bit the sequential stack's taken microbatch by microbatch (the
    pipeline's order of summation); against the sequential stack over
    the whole batch and against JAX's pipeline they differ in that order
    alone, which moves f32 sums by ~1e-7 of the largest gradient: rtol
    1e-5 (JAX's) and atol 1e-6 (JAX's) of the largest |g|."""
    refs, cases, out = world
    ws = cases["toy"]["ws"].clone().requires_grad_(True)
    x = cases["toy"]["x"].clone().requires_grad_(True)
    (_sequential(ws, x) ** 2).sum().backward()
    wm = cases["toy"]["ws"].clone().requires_grad_(True)
    xm = cases["toy"]["x"].clone().requires_grad_(True)
    sum((_sequential(wm, xm[m]) ** 2).sum() for m in range(M)).backward()
    jw, jx = refs["grads"]
    for r in range(4):
        got = out[r]["toy"]
        for g, mb, whole, jax_g in ((got["grad_w"], wm.grad, ws.grad, jw),
                                    (got["grad_x"], xm.grad, x.grad, jx)):
            assert torch.equal(g, mb)
            top = float(whole.abs().max())
            for want in (whole.numpy(), np.asarray(jax_g)):
                np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                           atol=1e-6 * top)


def test_pipeline_jit_and_placement(world):
    """test_pipeline_parallel.py:64-72: `place` gives each rank its
    stage's weights alone, and `run` on them the sequential stack."""
    _, cases, out = world
    ws = cases["toy"]["ws"]
    seq = _sequential(ws, cases["toy"]["x"])
    for r in range(4):
        got = out[r]["toy"]
        assert got["placed_shape"] == (D, D)
        assert torch.equal(got["placed"], ws[r])
        assert torch.equal(got["jit_out"], seq)


def test_pipeline_pytree_payload(world):
    """test_pipeline_parallel.py:75-88: a (x, aux) payload; aux rides
    through unchanged."""
    _, cases, out = world
    x = cases["toy"]["x"]
    for r in range(4):
        got, aux = out[r]["toy"]["pair"]
        assert torch.equal(got, _sequential(cases["toy"]["ws"], x))
        assert torch.equal(aux, torch.arange(M, dtype=torch.float32)[:, None])


def test_pipeline_stage_count_validation(world):
    """test_pipeline_parallel.py:91-95: stacked weights of another stage
    count than the axis raise ValueError; so does a mesh of more devices
    than the world."""
    _, _, out = world
    got = out[0]["toy"]
    assert got["stage_error"][0] == "ValueError"
    assert got["too_many"][0] == "ValueError"


def test_wrong_rotation_breaks_the_pipeline(world):
    """The planted fault: outputs moved two stages on, not one."""
    _, cases, out = world
    seq = _sequential(cases["toy"]["ws"], cases["toy"]["x"])
    assert not torch.allclose(out[0]["toy"]["wrong"], seq, atol=1e-3)
    assert not torch.allclose(out[0]["schnet"]["wrong"],
                              out[0]["schnet"]["h"], atol=1e-3)


def test_schnet_stack_pipelines(world):
    """test_pipeline_parallel.py:98-131: the SchNet stack of six blocks
    in two stages of three, four microbatches of one graph, against
    JAX's pipeline and JAX's sequential stack (rtol 2e-5, atol 1e-5)."""
    refs, _, out = world
    for r in range(4):
        h = out[r]["schnet"]["h"][:, 0].numpy()
        np.testing.assert_allclose(h, refs["schnet"], rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(h, refs["schnet_sequential"], rtol=2e-5,
                                   atol=1e-5)


def test_schnet_pipeline_equals_its_stages_in_sequence(world):
    """The pipelined stack is bit for bit the stage bodies run one after
    another on one rank, microbatch by microbatch."""
    _, _, out = world
    for r in range(4):
        got = out[r]["schnet"]
        assert torch.equal(got["h"], got["sequential"])


def test_schnet_stage_runs_every_tick(world):
    """Every rank runs its stage every tick, the masked ones too: K3 (its
    plain version here) is called (M + S - 1) x blocks a stage = 5 x 3
    times a rank in a pipelined forward, S x 15 = 30 over the pipeline."""
    _, _, out = world
    assert [out[r]["schnet"]["k3_calls"] for r in range(4)] == [15] * 4
