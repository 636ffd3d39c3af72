"""The correctness check fails the faults a cell can have. Each test
skips the harness's look for a card and drives the rest of a run
(port_bench.run.measure), the timed path broken underneath by a patch of
the program: on the CPU at a small size (the cell's traffic with 40 'ld'
steps, chunks of 8, hidden width 32, its own limit), and, marked `cuda`,
a wrong forward at the cell's own size on the card. A sound run is
correct; each fault makes `correct` false. (One card: no exchange
between chips to leave out.)"""

import copy

import pytest
import torch

from port_bench.run import load_cell, measure

CELLS = ("qm9.testset",)


def small(cell):
    spec = copy.deepcopy(load_cell(cell))
    spec["config"].update(hidden_dim=32, num_convs=2, num_convs_local=2)
    t = spec["traffic"]
    t["sampler"]["n_steps"] = 40
    t["chunk"] = 8
    t["check"]["conformers"] = 4
    for g in t["test_set"]:
        g["refs"] = [3, 3]
    return spec


def run(cell, seed=2 ** 31 + 11, spec=None, device=torch.device("cpu")):
    out, lines = measure(spec or small(cell), seed, 0.0, 0, device)
    return out


def zero_local_head(monkeypatch):
    """The program's local score head outputs 0: its last layer's weight
    and bias are zeroed as the program's model loads them (the reference
    keeps the benchmark's weights)."""
    from agdiff_torch.models.dualenc import DualEncoderEpsNetwork

    load = DualEncoderEpsNetwork.load_state_dict

    def broken(self, state, *args, **kwargs):
        state = {k: (torch.zeros_like(v)
                     if k.startswith("grad_local_dist_mlp.layers_2.") else v)
                 for k, v in state.items()}
        return load(self, state, *args, **kwargs)

    monkeypatch.setattr(DualEncoderEpsNetwork, "load_state_dict", broken)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 8 and out["failed"] == 0
    assert set(out["metrics"]) == {"conformers_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged(cell, monkeypatch):
    from agdiff_torch.sampling import langevin

    def frozen(self, noise, update):
        self.counter += 1

    monkeypatch.setattr(langevin.Ladder, "step", frozen)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(cell, monkeypatch):
    from agdiff_torch.sampling import langevin

    call = langevin.Sampler.__call__

    def half(self, batch, pos_init, generator=None, noise=None):
        out = call(self, batch, pos_init, generator, noise)
        b = out.pos.shape[0] // 2
        pos, traj = out.pos.clone(), out.traj.clone()
        pos[b:2 * b] = pos[:b]      # the second half never ran
        traj[:, b:2 * b] = traj[:, :b]
        return out._replace(pos=pos, traj=traj)

    monkeypatch.setattr(langevin.Sampler, "__call__", half)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    from agdiff_torch.eval import generate

    starts = generate.PackedGenerationRunner._starts

    def shifted(self, keys, bucket):
        # each slot starts from its neighbour's start
        return torch.roll(starts(self, keys, bucket), 1, dims=0)

    monkeypatch.setattr(generate.PackedGenerationRunner, "_starts", shifted)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_output_not_the_ladder_state(cell, monkeypatch):
    from agdiff_torch.sampling import langevin

    call = langevin.Sampler.__call__

    def nudged(self, batch, pos_init, generator=None, noise=None):
        out = call(self, batch, pos_init, generator, noise)
        return out._replace(pos=out.pos + 1e-4 * out.pos.abs().amax())

    monkeypatch.setattr(langevin.Sampler, "__call__", nudged)
    out = run(cell)
    assert out["checks"]["output_off_last_block"]["value"] > 0
    assert not out["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_wrong_forward(cell, monkeypatch):
    zero_local_head(monkeypatch)
    assert not run(cell)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_wrong_forward_card(cell, card, monkeypatch):
    """At the cell's own size, K1's path: one call of the cell's chunk."""
    spec = load_cell(cell)
    sound = run(cell, 2 ** 31 + 31, spec, card)
    assert sound["correct"], sound["checks"]
    zero_local_head(monkeypatch)
    out = run(cell, 2 ** 31 + 31, spec, card)
    print(out["checks"])
    assert not out["correct"], out["checks"]


def test_batch_size_is_the_runners():
    """The reference draws a chunk's noise at the runner's batch size."""
    from agdiff_torch.eval.generate import PackedGenerationRunner

    from port_bench.traffic.testset import batch_size

    runner = PackedGenerationRunner.__new__(PackedGenerationRunner)
    runner.group = None
    for chunk in (8, 48, 128):
        runner.chunk_size = chunk
        for count in range(1, chunk + 1):
            assert batch_size(count, chunk) == runner._batch_size_for(count)


def test_plan_is_the_same_work_for_every_seed():
    """QM9: full chunks of 128 at bucket 32 whatever the seed."""
    from port_bench.traffic.testset import Plan

    for cell, shape in (("qm9.testset", [(32, 128)] * 3),):
        spec = load_cell(cell)
        for seed in (1, 2 ** 31 + 3, 2 ** 33 + 1):
            plan = Plan(spec["traffic"], spec["config"]["buckets"], seed)
            got = []
            for c, _ in zip(plan.chunks(), range(3)):
                got.append((c.bucket, c.conformers))
                for e, _, _ in c.items:
                    assert len(plan.molecule(e)["atom_type"]) <= c.bucket
            assert got == shape, (cell, seed)
