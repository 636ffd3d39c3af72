"""Traffic kind `testset`: conformer generation for GEOM-protocol test
sets through `PackedGenerationRunner.run`, one packed chunk a call.

The mix's file (port_bench/workloads/<traffic>.json) gives:
- `test_set`: the molecules of one test set, a list of groups, each
  `count` molecules of `heavy` = [lo, hi] heavy atoms (at most
  `max_atoms` atoms with hydrogens, which lie within one of the
  configuration's buckets), with `refs` = [lo, hi] reference conformers
  drawn per molecule; a molecule is asked for `protocol` x refs
  conformers (the reference's "2x");
- `engine`, `chunk`: the runner's engine (one whose chunks mix atom
  counts, as `pksf`'s do) and chunk size;
- `sampler`: the ladder's settings;
- `check`: how many conformers the correctness check compares, and the
  limit of its number.

Test sets follow one another, each drawn anew from the seed. The plan
splits a test set into chunks as `run` does: by bucket, slots in
molecule order, `chunk` slots a chunk. A molecule's structure is made
only when a chunk that holds it is run. Set-up warms the ladder of every
bucket of one test set at the chunk's batch size.

The window runs whole calls, one chunk each: a new call starts while the
time the calls have taken plus the last call's time fits in the window's
seconds, and at least one runs. `conformers_per_s` is the window's
conformers over its seconds, from the first call's start to the last
call's end.

Correctness: the ladder keeps its positions after every block of the
noise's 20 steps (the sampler's `traj_stride`), which the harness takes
from the sampler's result. Once the window has closed and the program is
freed, for a sample of the window's conformers drawn from the seed, the
reference (port_bench/reference) follows the program block by block
from those positions, with the same molecules, weights and ladder noise
(reference/noise.py works the starts and the noise out from the seeds
handed to `run`), and is compared as port_bench/compare.py says. Each
conformer `run` returned has to be its ladder's positions after the
last block, bit for bit (`output_off_last_block`, limit 0).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from port_bench import chem, compare
from port_bench.reference import agdiff as ref
from port_bench.reference import noise as ref_noise
from port_bench.work import agdiff as work


class Entry(NamedTuple):
    test_set: int
    index: int
    group: dict
    conformers: int


class Chunk(NamedTuple):
    bucket: int
    items: List[Tuple[Entry, int, int]]   # (entry, first sample, count)

    @property
    def conformers(self) -> int:
        return sum(c for _, _, c in self.items)


def batch_size(count: int, chunk: int) -> int:
    """The runner's batch size for a chunk of `count` slots: the chunk
    size when full, else the next power of two from 8."""
    if count >= chunk:
        return chunk
    b = 8
    while b < count:
        b *= 2
    return min(b, chunk)


def word(*parts: int) -> int:
    """A 31-bit seed word folded from non-negative integers."""
    words = [w for p in parts for w in (p & 0xFFFFFFFF, p >> 32)]
    return int(np.random.SeedSequence(words).generate_state(1)[0]
               ) & 0x7FFFFFFF


class Plan:
    def __init__(self, traffic: dict, buckets, seed: int):
        self.traffic, self.seed = traffic, int(seed)
        self.buckets = sorted(buckets)
        self._mols: Dict[Tuple[int, int], dict] = {}

    def bucket(self, atoms: int) -> int:
        for b in self.buckets:
            if atoms <= b:
                return b
        raise ValueError(f"{atoms} atoms fit no bucket of {self.buckets}")

    def entries(self, t: int) -> List[Entry]:
        rng = np.random.default_rng([word(self.seed, t, 1)])
        out = []
        for group in self.traffic["test_set"]:
            lo, hi = group["refs"]
            for _ in range(group["count"]):
                refs = int(rng.integers(lo, hi + 1))
                out.append(Entry(t, len(out), group,
                                 self.traffic["protocol"] * refs))
        return out

    def test_set_chunks(self, t: int) -> List[Chunk]:
        groups: Dict[int, List[Entry]] = {}
        for e in self.entries(t):
            groups.setdefault(self.bucket(e.group["max_atoms"]),
                              []).append(e)
        size = self.traffic["chunk"]
        out = []
        for bucket, entries in groups.items():
            items, filled = [], 0
            for e in entries:
                first = 0
                while first < e.conformers:
                    take = min(e.conformers - first, size - filled)
                    items.append((e, first, take))
                    first += take
                    filled += take
                    if filled == size:
                        out.append(Chunk(bucket, items))
                        items, filled = [], 0
            if items:
                out.append(Chunk(bucket, items))
        return out

    def chunks(self):
        t = 0
        while True:
            yield from self.test_set_chunks(t)
            t += 1

    def molecule(self, e: Entry) -> dict:
        key = (e.test_set, e.index)
        if key not in self._mols:
            rng = np.random.default_rng([word(self.seed, e.test_set,
                                              e.index, 2)])
            lo, hi = e.group["heavy"]
            while True:
                m = chem.tree_molecule(rng, int(rng.integers(lo, hi + 1)))
                if len(m["atom_type"]) <= e.group["max_atoms"]:
                    break
            self._mols[key] = m
        return self._mols[key]

    def start_key(self, e: Entry, first: int) -> Tuple[int, int]:
        """The item seeds of an entry's part starting at sample `first`."""
        return (word(self.seed, e.test_set, e.index), first)


def program_molecule(mol: dict):
    from agdiff_torch.chem.mol import Molecule

    i, j = mol["bonds"].T
    return Molecule(atom_type=mol["atom_type"], pos=mol["pos"],
                    bond_index=np.stack([np.r_[i, j], np.r_[j, i]]),
                    bond_type=np.ones(2 * len(i), np.int32))


class Traffic:
    """One run of a test-set cell: set-up at construction, then `window`,
    `release` and `check`."""

    def __init__(self, ctx):
        t0 = time.perf_counter()
        from agdiff_torch.config import ModelConfig
        from agdiff_torch.eval.generate import PackedGenerationRunner
        from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
        from agdiff_torch.models.schedules import make_diffusion
        from agdiff_torch.sampling.graphed import LadderGraphs
        from agdiff_torch.sampling.langevin import SamplerConfig

        from port_bench.weights import make_weights

        t1 = time.perf_counter()
        cfg, traffic = ctx["config"], ctx["traffic"]
        self.cfg, self.traffic, self.device = cfg, traffic, ctx["device"]
        self.plan = Plan(traffic, cfg["buckets"], ctx["seed"])
        fields = set(ModelConfig.__dataclass_fields__)
        mcfg = ModelConfig(**{k: v for k, v in cfg.items() if k in fields})
        with torch.device("meta"):
            model = DualEncoderEpsNetwork(mcfg)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        self.weights = make_weights(shapes, word(ctx["seed"], 7),
                                    self.device)
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.weights)
        _sync(self.device)
        t2 = time.perf_counter()
        s = traffic["sampler"]
        scfg = SamplerConfig(
            n_steps=s["n_steps"], ladder=s["ladder"], step_lr=s["step_lr"],
            w_global=s["w_global"], global_start_sigma=s["global_start_sigma"],
            clip=s["clip"], clip_local=s["clip_local"],
            traj_stride=ref_noise.BLOCK)
        self.runner = PackedGenerationRunner(
            model.eval(), mcfg, make_diffusion(mcfg), scfg,
            buckets=cfg["buckets"], chunk_size=traffic["chunk"],
            device=self.device, engine=traffic["engine"])
        self.graphs = LadderGraphs
        t3 = time.perf_counter()
        warmed = set()
        with _KernelBuilds() as builds:
            for c in self.plan.test_set_chunks(0):
                if c.bucket not in warmed:
                    warmed.add(c.bucket)
                    self.runner.warm(
                        program_molecule(self.plan.molecule(c.items[0][0])),
                        num_samples=traffic["chunk"])
            _sync(self.device)
        t4 = time.perf_counter()
        # the parts of set-up, for standard error (PERF.md, setup_s)
        self.setup_parts = dict(program_imports=t1 - t0, weights=t2 - t1,
                                runner=t3 - t2, warm=t4 - t3,
                                kernel_builds=builds.seconds)
        self.calls: List[dict] = []

    def call(self, chunk: Chunk, call_no: int, tracer=None) -> dict:
        mols = [program_molecule(self.plan.molecule(e))
                for e, _, _ in chunk.items]
        seeds = [self.plan.start_key(e, first) for e, first, _ in chunk.items]
        counts = [c for _, _, c in chunk.items]
        run_seed = word(self.plan.seed, call_no, 3)
        captures = self.graphs.captures
        with (tracer() if tracer else _Null()) as trace, \
                _Trajectories() as trajs:
            t0 = time.perf_counter()
            out = self.runner.run(mols, None, seed=run_seed,
                                  num_confs=counts, item_seeds=seeds,
                                  save=False, resume=False)
            t1 = time.perf_counter()
        return dict(chunk=chunk, run_seed=run_seed, start=t0, span_s=t1 - t0,
                    pos=[np.asarray(m.meta["pos_gen"]) for m in out],
                    traj=trajs,
                    captures=self.graphs.captures - captures,
                    trace=trace.result if trace is not None else None,
                    work=self.work(chunk))

    def window(self, seconds: float, tracer=None) -> dict:
        chunks = self.plan.chunks()
        spent = 0.0
        while not self.calls or spent + self.calls[-1]["span_s"] <= seconds:
            self.calls.append(self.call(next(chunks), len(self.calls),
                                        tracer))
            spent += self.calls[-1]["span_s"]
        first, last = self.calls[0], self.calls[-1]
        window_s = last["start"] + last["span_s"] - first["start"]
        conformers = sum(c["chunk"].conformers for c in self.calls)
        return dict(window_s=window_s, conformers=conformers,
                    attempted=conformers, failed=0, calls=len(self.calls),
                    captures=sum(c["captures"] for c in self.calls))

    def end_to_end(self, result: dict) -> dict:
        return {"conformers_per_s": result["conformers"]
                / result["window_s"]}

    def work(self, chunk: Chunk) -> dict:
        """The window's model work of a chunk (port_bench/work): every
        forward of every real conformer, and K1's share per launch."""
        cfg = self.cfg
        act = 2 if cfg["dtype"] == "bfloat16" else 4
        steps = self.traffic["sampler"]["n_steps"]
        fwd = work.Work(0.0, 0.0)
        k1 = work.Work(0.0, 0.0)
        for e, _, count in chunk.items:
            mol = self.plan.molecule(e)
            n = len(mol["atom_type"])
            p = n * (n - 1) // 2
            loc = work.local_pairs(chem.adjacency(mol), cfg["edge_order"])
            fwd = fwd + work.forward(n, p, loc, cfg, act).scale(count)
            k1 = k1 + work.k1(n, p, loc, cfg, act).scale(count)
        k1 = k1 + work.Work(0.0, work.k1_weights(cfg, act))
        return dict(forward=fwd.scale(steps), k1=k1, launches=steps)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.runner = None
        import gc

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=None) -> List[Tuple[str, float, float]]:
        """[(name, value, limit)]: how far each conformer `run` returned
        lies from its ladder's last block, and the sampled conformers'
        block ratio (port_bench/compare.py); `control` puts the reference
        at that precision in the program's place."""
        rows = self.rows()
        states = self.program_states()
        atoms = [len(r[5]["atom_type"]) for r in rows]
        off = 0.0
        for c in self.calls:
            if len(c["traj"]) != 1:     # a NaN retry: not followed
                off = math.inf
                continue
            last = c["traj"][0][-1].cpu().numpy()
            at = 0
            for item, (_, _, count) in enumerate(c["chunk"].items):
                got = c["pos"][item]
                want = last[at:at + count, :got.shape[1]]
                off = max(off, float(np.abs(got - want).max()))
                at += count
        self.judged = compare.judge(states, self.reference,
                                    self.cfg["dtype"], atoms, control)
        return [("output_off_last_block", off, 0.0),
                ("block_ratio", self.judged["number"],
                 self.traffic["check"]["limit"])]

    def program_states(self) -> np.ndarray:
        """The program's positions after every block for `rows()`,
        (blocks, R, N, 3), zero past each molecule's atoms."""
        if "_states" not in self.__dict__:
            rows = self.rows()
            n_max = max(len(r[5]["atom_type"]) for r in rows)
            n_blocks = self.traffic["sampler"]["n_steps"] // ref_noise.BLOCK
            out = np.zeros((n_blocks, len(rows), n_max, 3), np.float32)
            for r, (ci, slot, *_, mol, _) in enumerate(rows):
                traj = self.calls[ci]["traj"]
                if len(traj) == 1:
                    n = len(mol["atom_type"])
                    out[:, r, :n] = traj[0][:, slot, :n].cpu().numpy()
                else:
                    out[:, r] = np.nan
            self._states = out
        return self._states

    def rows(self):
        """(call, slot, entry, first sample, sample index, molecule, the
        program's conformer) of the conformers the check compares, drawn
        from the seed."""
        slots = [(i, s) for i, c in enumerate(self.calls)
                 for s in range(c["chunk"].conformers)]
        rng = np.random.default_rng([word(self.plan.seed, 5)])
        k = min(self.traffic["check"]["conformers"], len(slots))
        rows = []
        for j in sorted(rng.choice(len(slots), k, replace=False)):
            ci, slot = slots[j]
            c, at = self.calls[ci], 0
            for item, (e, first, count) in enumerate(c["chunk"].items):
                if slot < at + count:
                    k = slot - at
                    rows.append((ci, slot, e, first, k,
                                 self.plan.molecule(e), c["pos"][item][k]))
                    break
                at += count
        return rows

    def reference(self, precision=None) -> np.ndarray:
        """The reference's positions after every block for `rows()` at
        `precision` (port_bench/compare.py), each block started from the
        program's state, each precision computed once."""
        cache = self.__dict__.setdefault("_references", {})
        if precision not in cache:
            cache[precision] = self._reference(
                compare.quantizer(precision))
        return cache[precision]

    def _reference(self, quant) -> np.ndarray:
        """The reference's positions after every block for `rows()`,
        from the same molecules, weights, starts and ladder noise."""
        rows = self.rows()
        n_max = max(len(r[5]["atom_type"]) for r in rows)
        b = len(rows)
        dev = self.device
        z = torch.zeros((b, n_max), dtype=torch.int64)
        mask = torch.zeros((b, n_max), dtype=torch.bool)
        adj = torch.zeros((b, n_max, n_max), dtype=torch.int64)
        start = torch.zeros((b, n_max, 3))
        for r, (ci, slot, e, first, k, mol, _) in enumerate(rows):
            n = len(mol["atom_type"])
            bucket = self.calls[ci]["chunk"].bucket
            z[r, :n] = torch.from_numpy(mol["atom_type"].astype(np.int64))
            mask[r, :n] = True
            adj[r, :n, :n] = torch.from_numpy(ref.extend_bond_order(
                chem.adjacency(mol), self.cfg["edge_order"]))
            start[r, :n] = ref_noise.start(
                self.plan.start_key(e, first) + (k,), bucket)[:n]
        streams = {}
        for ci in sorted({r[0] for r in rows}):
            c = self.calls[ci]
            streams[ci] = ref_noise.ChunkNoise(
                c["run_seed"], 0, batch_size(c["chunk"].conformers,
                                             self.traffic["chunk"]),
                c["chunk"].bucket, dev)
        atoms = [len(r[5]["atom_type"]) for r in rows]

        def noise_fn(_):
            blocks = {ci: s.block() for ci, s in streams.items()}
            out = torch.zeros((ref_noise.BLOCK, b, n_max, 3), device=dev)
            for r, row in enumerate(rows):
                out[:, r, :atoms[r]] = blocks[row[0]][:, row[1], :atoms[r]]
            return out

        model = ref.Model(self.weights, self.cfg, quant)
        sampler = dict(self.traffic["sampler"], block=ref_noise.BLOCK)
        states = torch.from_numpy(self.program_states()).to(dev)
        return ref.ld_ladder(model, z.to(dev), mask.to(dev), adj.to(dev),
                             start.to(dev), noise_fn, self.cfg, sampler,
                             states).cpu().numpy()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _KernelBuilds:
    """Within the block, the seconds the program spends building its
    CUDA kernels (agdiff_torch/kernels/build.py: nvcc, the first run in
    a checkout), in `seconds`."""

    def __enter__(self):
        from agdiff_torch.kernels import build

        self.module, self.build, self.seconds = build, build.build, 0.0

        def timed(name):
            t = time.perf_counter()
            try:
                return self.build(name)
            finally:
                self.seconds += time.perf_counter() - t

        build.build = timed
        return self

    def __exit__(self, *exc):
        self.module.build = self.build
        return False


class _Trajectories(list):
    """Within the block, the trajectory of every sampler call (the
    program's positions after each block, (blocks, B, N, 3)): a list
    with one entry per call, two where `run` retried a chunk."""

    def __enter__(self):
        from agdiff_torch.sampling import langevin

        self.cls, self.call = langevin.Sampler, langevin.Sampler.__call__
        keep, call = self.append, self.call

        def kept(sampler, *args, **kwargs):
            out = call(sampler, *args, **kwargs)
            keep(out.traj)
            return out

        self.cls.__call__ = kept
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.call
        return False


class _Null:
    result = None

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False
