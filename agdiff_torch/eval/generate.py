"""Test-set conformer generation (port of agdiff_tpu/eval/generate.py,
GenerationRunner).

Per molecule: num_samples = 2 x num_reference_conformers ("2x") or a fixed
count; pos_init ~ N(0, 1); the annealed Langevin ladder; samples are run in
chunks of one molecule repeated, padded to a power-of-two batch; chunks
whose ladder went non-finite are rerun once with clip_local = 20 and the
flagged samples replaced. A molecule larger than every bucket gets a
bucket of its own, its size rounded up to a multiple of 8.

With use_fast (the default here; the CLI's --fast) engines follow the JAX
package's choice on a TPU: at buckets >= 40 the tight engines, whose pair
list holds the molecule's own pairs at a capacity rounded up to 256 (one
shared list, since a chunk is one molecule repeated); below 40 the triu
engines. An `engine` override takes any triu or tight engine, 'pk' and
'pk-approx' (K2 over the triu pairs) and 'mono' (K6, at the config's
dtype, every bucket, no capacity: agdiff_tpu/eval/generate.py:231-232,
:258-265) among them, but not 'pallas': the JAX runner passes
use_pallas=False (:258-261), so its 'pallas' runs the XLA forward without
the kernels, and the port has no such forward. The 'pallas' kernels run
through build_fast_sampler(build_fast_forward(cfg, model, "pallas"),
...). With use_fast=False the ladder runs on the dense module
(models/dualenc.py), as JAX's build_sampler path does, and `engine` has
no effect (:253-283).

On a CUDA device each ladder replays CUDA graphs (sampling/graphed.py;
graph=False runs the eager loop): a sampler per (engine, retry,
capacity), and in it one set of graphs per batch shape and pair list,
captured at the first run or by `warm`, which captures every ladder
`generate_molecule` will run, as the JAX runner's warm compiles them
(agdiff_tpu/eval/generate.py:334-395). The retry with clip_local = 20 is
a sampler, and graphs, of its own.

`run` writes <out_dir>/samples_<i>.npz as each molecule is done and
samples_all.npz at the end, in the JAX package's format (`load_samples`
reads either package's files), and skips molecules whose file exists
when resuming. Molecule i's generator is seeded from its dataset index
(seed + i, where JAX folds i into its key), so a resumed run or a
partial range gives the conformers of a whole run.

With a data-parallel `group` (parallel/mesh.py; JAX's `mesh`,
agdiff_tpu/eval/generate.py:255-285, :375-425) every rank runs the same
loop over the same chunks: each chunk's graph axis is split over the
ranks, each rank runs its rows' ladder with the engine's kernels, and
the samples come back gathered to every rank (sampling/langevin.py
Sampler). Starts and ladder noise are drawn at the whole chunk's shape
and sliced, so a rank's rows are those of a single-process run. A
chunk's batch size stays a multiple of the ranks (:296-308). Rank 0
alone writes the sample files; which molecules a resumed run skips is
rank 0's decision, sent to every rank.

`PackedGenerationRunner` (agdiff_tpu/eval/generate.py:543-717) fills each
chunk with samples of different molecules of one bucket instead of one
molecule repeated; at a tight engine's bucket, of one atom count, so
that the chunk shares one pair list (and one set of CUDA graphs).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from agdiff_torch.chem.mol import Molecule
from agdiff_torch.config import ModelConfig
from agdiff_torch.data.bucketing import pad_molecules, pick_bucket
from agdiff_torch.device import resolve_device
from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.models.mono_forward import build_monolithic_forward
from agdiff_torch.models.schedules import Diffusion
from agdiff_torch.models.tight_forward import (
    ENGINES as _TIGHT_ENGINES,
    build_tight_forward,
)
from agdiff_torch.ops.pairs import pair_capacity_for
from agdiff_torch.sampling.langevin import (
    SamplerConfig,
    build_fast_sampler,
    build_sampler,
)
from agdiff_torch.utils.profiling import span

RETRY_CLIP_LOCAL = 20.0
TIGHT_FROM_BUCKET = 40
MODULE = "module"   # the sampler key of the dense module path (no --fast)


class GenerationRunner:
    def __init__(self, model, model_config: ModelConfig,
                 diffusion: Diffusion, sampler_config: SamplerConfig,
                 buckets: Sequence[int] = (32, 64), chunk_size: int = 64,
                 device=None, engine: Optional[str] = None,
                 use_fast: bool = True, logger=None, graph: bool = True,
                 group=None):
        if engine is not None and engine.startswith("pallas"):
            raise ValueError(
                "GenerationRunner does not take engine 'pallas': the JAX "
                "runner builds it with use_pallas=False "
                "(agdiff_tpu/eval/generate.py:258-261), i.e. the XLA "
                "forward without the kernels, which the port does not "
                "have; run build_fast_sampler(build_fast_forward(cfg, "
                "model, 'pallas'), ...) for the kernels")
        self.group = group
        self.device = group.device if group else resolve_device(device)
        self.model = model.to(self.device).eval()
        self.model_config = model_config
        self.diffusion = diffusion
        self.sampler_config = sampler_config
        self.retry_config = sampler_config.with_clip_local(RETRY_CLIP_LOCAL)
        self.buckets = tuple(buckets)
        self.chunk_size = chunk_size
        # None: automatic (_engine_for); else the engine of every bucket
        self.engine = engine
        self.use_fast = use_fast
        self.logger = logger
        self.graph = graph   # False: the eager loop on a CUDA device too
        self.forwards: Dict[Optional[str], object] = {}
        self._samplers: Dict[tuple, object] = {}

    def _engine_for(self, bucket: int) -> Optional[str]:
        """The JAX runner's choice on a TPU (agdiff_tpu/eval/generate.py:
        209-246): bf16 configs run 'tight-pksf' (K1 over the molecule's
        tight pair list) at buckets >= 40 and 'pksf' (K1 over the bucket's
        triu set) below; f32 configs run the f32 'tight' engine at >= 40
        and the plain f32 packed forward (None) below. Without use_fast,
        MODULE: the dense module at the config's compute dtype, whatever
        `engine` says (agdiff_tpu/eval/generate.py:233-234, :275-280)."""
        if not self.use_fast:
            return MODULE
        if self.engine is not None:
            return self.engine
        tight = bucket >= TIGHT_FROM_BUCKET
        if self.model_config.dtype == "bfloat16":
            return "tight-pksf" if tight else "pksf"
        return "tight" if tight else None

    def forward(self, engine: Optional[str]):
        """The engine's forward (models/fast_forward.py,
        models/tight_forward.py, models/mono_forward.py), built once; its
        `calls` counts the forwards run. MODULE: the dense module (a bf16
        config's runs at bf16)."""
        if engine == MODULE:
            return self.model
        if engine not in self.forwards:
            if engine == "mono":
                fwd = build_monolithic_forward(self.model_config, self.model)
            else:
                build = (build_tight_forward if engine in _TIGHT_ENGINES
                         else build_fast_forward)
                fwd = build(self.model_config, self.model, engine)
            self.forwards[engine] = fwd
        return self.forwards[engine]

    def _capacity_for(self, mol: Molecule, engine: Optional[str]):
        """A tight engine's pair capacity: the molecule's N(N-1)/2 rounded
        up to 256 (fewer distinct shapes; the gain comes from capacity
        below the bucket's pair count, not from exactness)."""
        if engine not in _TIGHT_ENGINES:
            return None
        n = mol.num_nodes
        capacity = pair_capacity_for(n, multiple=256)
        # a smaller capacity would drop pairs and give wrong conformers
        assert capacity >= n * (n - 1) // 2, (capacity, n)
        return capacity

    def _sampler(self, engine: Optional[str], retry: bool,
                 capacity: Optional[int] = None):
        """The sampler of an (engine, retry, capacity). Its graphs are
        keyed further by batch shape (bucket and batch size), device and
        pair list (sampling/langevin.py Sampler), so that together the
        keys hold everything a graph bakes in. A tight engine's capacity
        is the molecule's, and `run` does not come back to a molecule, so
        a new capacity frees the samplers (and graphs) of the others,
        all but the graphs `warm` captured, which stay."""
        key = (engine, retry, capacity)
        if key not in self._samplers:
            if capacity is not None:
                for k in [k for k in self._samplers if k[:2] == key[:2]]:
                    if not self._samplers[k].release_unpinned():
                        del self._samplers[k]
            cfg = self.retry_config if retry else self.sampler_config
            self._samplers[key] = (
                build_sampler(self.model, self.diffusion, cfg,
                              graph=self.graph, group=self.group)
                if engine == MODULE else
                build_fast_sampler(self.forward(engine), self.diffusion, cfg,
                                   pair_capacity=capacity, graph=self.graph,
                                   group=self.group))
        return self._samplers[key]

    def ladders(self) -> int:
        """The ladders whose graphs the samplers hold."""
        return sum(len(s.ladders) for s in list(self._samplers.values()))

    def warmed_pool_bytes(self) -> int:
        """Device memory of the graph pools `warm` captured."""
        return sum(s.ladders[k].pool_bytes
                   for s in list(self._samplers.values())
                   for k in list(s.pinned))

    def num_samples_for(self, mol: Molecule, num_confs="2x") -> int:
        if isinstance(num_confs, int):
            return num_confs
        if num_confs.endswith("x"):
            return int(num_confs[:-1]) * max(mol.num_ref, 1)
        return int(num_confs)

    def _batch_size_for(self, count: int) -> int:
        """A final partial chunk runs at the next power of two (>= 8), so
        at most log2(chunk_size) batch shapes exist per bucket; under a
        group, at a multiple of its ranks."""
        if count >= self.chunk_size:
            return self.chunk_size
        b = 8
        while b < count:
            b *= 2
        if self.group is not None:
            ranks = self.group.world_size
            b = -(-max(b, ranks) // ranks) * ranks
        return min(b, self.chunk_size)

    @property
    def writer(self) -> bool:
        """Whether this process writes the sample files (rank 0)."""
        return self.group is None or self.group.is_writer

    def _done(self, out_dir, indices, resume: bool) -> set:
        """The indices whose samples_<i>.npz exists, which a resumed run
        loads instead of generating: rank 0's reading, on every rank."""
        done = {i for i in indices if resume and os.path.exists(
            os.path.join(out_dir, f"samples_{i}.npz"))}
        if self.group is not None:
            done = self.group.broadcast_object(done)
        return done

    def _bucket_for(self, mol: Molecule) -> int:
        try:
            return pick_bucket(mol.num_nodes, self.buckets)
        except ValueError:
            # larger than every bucket: the next multiple of 8
            bucket = (mol.num_nodes + 7) // 8 * 8
            self.buckets = tuple(sorted(set(self.buckets) | {bucket}))
            return bucket

    def _batch(self, mol: Molecule, bucket: int, bsz: int):
        return pad_molecules([mol] * bsz, bucket,
                             edge_order=self.model_config.edge_order,
                             batch_size=bsz, device=self.device)

    def warm(self, mol: Molecule, num_samples: Optional[int] = None,
             retry: bool = False, all_sizes: bool = False) -> List[tuple]:
        """Capture the graphs of every ladder generate_molecule(mol,
        num_samples) will run (agdiff_tpu/eval/generate.py:334-395; a
        capture first runs each step kind twice eagerly, a ladder runs
        no further): each batch size its chunks
        take (num_samples default: one chunk), with retry=True the
        clip_local retry's too, with all_sizes=True every batch size
        `_batch_size_for` can give (powers of two from 8 to chunk_size).
        A tight engine's graphs hold the molecule's own pair list, so
        another molecule of the bucket captures at its first run. Returns
        the (bucket, batch size, retry) ladders newly captured; none on
        the CPU, which runs the eager loop. The graphs `warm` captures are
        kept when later molecules capture theirs (Sampler.pinned): a
        tight engine's warmed graphs serve every molecule of the warmed
        molecule's atom count and capacity, so a server warms one molecule
        of each such class (serve/server.py warm_classes)."""
        num_samples = num_samples or self.chunk_size
        bucket = self._bucket_for(mol)
        engine = self._engine_for(bucket)
        capacity = self._capacity_for(mol, engine)
        sizes = set()
        remaining = num_samples
        while remaining > 0:
            count = min(remaining, self.chunk_size)
            sizes.add(self._batch_size_for(count))
            remaining -= count
        if all_sizes:
            b = 8
            while b < self.chunk_size:
                sizes.add(self._batch_size_for(b))
                b *= 2
            sizes.add(self.chunk_size)
        captured = []
        for bsz in sorted(sizes):
            batch = self._batch(mol, bucket, bsz)
            for r in ((False, True) if retry else (False,)):
                if self._sampler(engine, r, capacity).warm(batch):
                    captured.append((bucket, bsz, r))
        return captured

    def generate_molecule(self, mol: Molecule, num_samples: int,
                          generator: torch.Generator) -> np.ndarray:
        """num_samples conformers of `mol` as (num_samples, N, 3)."""
        bucket = self._bucket_for(mol)
        engine = self._engine_for(bucket)
        capacity = self._capacity_for(mol, engine)
        n = mol.num_nodes
        out: List[np.ndarray] = []
        remaining = num_samples
        while remaining > 0:
            count = min(remaining, self.chunk_size)
            bsz = self._batch_size_for(count)
            with span("runner.pad"):
                batch = self._batch(mol, bucket, bsz)
            with span("runner.starts"):
                pos_init = torch.randn(batch.pos.shape, generator=generator,
                                       device=self.device)
            result = self._sampler(engine, False, capacity)(
                batch, pos_init, generator=generator)
            pos, flags = result.pos, result.nan_flags
            with span("runner.wait"):
                flagged = bool(flags.any())
            if flagged:
                with span("runner.retry"):
                    if self.logger:
                        self.logger.warning(
                            "NaN in %d/%d samples; retrying with clip_local",
                            int(flags.sum()), len(flags))
                    retry = self._sampler(engine, True, capacity)(
                        batch, pos_init, generator=generator)
                    pos = torch.where(flags[:, None, None], retry.pos, pos)
            with span("runner.copy_back"):
                out.append(pos[:count, :n].cpu().numpy())
            remaining -= count
        return np.concatenate(out, axis=0)

    @span("runner.run")
    def run(self, dataset: Sequence[Molecule], out_dir: Optional[str] = None,
            seed: int = 0, num_confs="2x", start_idx: int = 0,
            end_idx: Optional[int] = None, resume: bool = True,
            save: bool = True) -> List[Molecule]:
        """Generate for dataset[start_idx:end_idx]; returns copies with
        meta['pos_gen'] (num_samples, N, 3). With an out_dir (and save),
        writes <out_dir>/samples_<i>.npz per molecule and samples_all.npz
        at the end, and with resume loads a molecule whose file exists
        instead of generating it (agdiff_tpu/eval/generate.py:454-503).
        out_dir None writes nothing."""
        with span("runner.plan"):
            save = save and out_dir is not None
            if save and self.writer:
                os.makedirs(out_dir, exist_ok=True)
            end_idx = len(dataset) if end_idx is None else min(
                end_idx, len(dataset))
            done = self._done(out_dir, range(start_idx, end_idx),
                              resume) if save else set()
        results = []
        for i in range(start_idx, end_idx):
            mol = dataset[i]
            path = os.path.join(out_dir, f"samples_{i}.npz") if save else None
            if i in done:
                results.append(load_samples(path)[0])
                continue
            ns = self.num_samples_for(mol, num_confs)
            gen = torch.Generator(device=self.device).manual_seed(seed + i)
            pos_gen = self.generate_molecule(mol, ns, gen)
            with span("runner.collect"):
                if save and self.writer:
                    _save_with_gen(path, mol, pos_gen)
                if self.logger:
                    self.logger.info("molecule %d: %d samples generated "
                                     "(%d atoms)", i, ns, mol.num_nodes)
                results.append(dataclasses.replace(
                    mol, meta={**mol.meta, "pos_gen": pos_gen}))
        if save and self.writer:
            with span("runner.collect"):
                _save_all(os.path.join(out_dir, "samples_all.npz"), results)
        return results


def _save_with_gen(path: str, mol: Molecule, pos_gen: np.ndarray) -> None:
    arrs = mol.to_arrays()
    arrs["pos_gen"] = pos_gen.astype(np.float32)
    np.savez_compressed(path, **{f"m0/{k}": v for k, v in arrs.items()},
                        **{"__num__": np.array(1)})


def _save_all(path: str, mols: List[Molecule]) -> None:
    payload = {"__num__": np.array(len(mols))}
    for k, mol in enumerate(mols):
        arrs = mol.to_arrays()
        if "pos_gen" in mol.meta:
            arrs["pos_gen"] = np.asarray(mol.meta["pos_gen"], np.float32)
        for name, arr in arrs.items():
            payload[f"m{k}/{name}"] = arr
    np.savez_compressed(path, **payload)


def load_samples(path: str) -> List[Molecule]:
    """samples_all.npz or samples_<i>.npz back into Molecules with
    meta['pos_gen'] (agdiff_tpu/eval/generate.py:524-540)."""
    out = []
    with np.load(path, allow_pickle=False) as data:
        for k in range(int(data["__num__"])):
            prefix = f"m{k}/"
            arrs = {name[len(prefix):]: data[name] for name in data.files
                    if name.startswith(prefix)}
            pos_gen = arrs.pop("pos_gen", None)
            mol = Molecule.from_arrays(arrs)
            if pos_gen is not None:
                mol.meta["pos_gen"] = pos_gen
            out.append(mol)
    return out


def slot_seed(*words: int) -> int:
    """A generator seed (63 bits) from a tuple of integers, each taken
    as 32 bits: the port's fold_in of (seed, dataset index, sample
    index), or of a chunk's ladder seed and number."""
    state = np.random.SeedSequence([w & 0xFFFFFFFF for w in words])
    lo, hi = (int(x) for x in state.generate_state(2, np.uint32))
    return (hi & 0x7FFFFFFF) << 32 | lo


class PackedGenerationRunner(GenerationRunner):
    """Generation with molecules packed across a chunk (port of
    agdiff_tpu/eval/generate.py:543-717). The base runner runs one
    molecule repeated per chunk, so a molecule that needs fewer samples
    than the chunk leaves slots idle; this runner groups the requests by
    bucket and expands them into per-sample slots (molecule, sample), so
    that every chunk is full but a group's last. At a bucket whose engine
    is a tight one (TIGHT_FROM_BUCKET and above at bf16, or by override)
    the groups are also by atom count (:604-612): the molecules of a
    chunk then share one tight pair list, which the kernels need, and the
    chunk replays one set of CUDA graphs; each new list's capture frees
    the last list's graphs but those `warm` captured (Sampler.release, as
    per molecule in the base runner). A chunk short of the batch size is
    padded with its last molecule.

    Each slot's start is drawn from a generator of its own, seeded from
    (seed, dataset index, sample index), or from (item_seeds[i][0],
    item_seeds[i][1], sample index): a sample's start does not depend on
    what it was batched with. The ladder's noise is the chunk's: a
    generator seeded from (seed ^ 0x5EED, chunk number), the chunk
    number counting over the run, as JAX folds the chunk number into its
    run key; a flagged chunk is rerun from the same starts with clip_local
    = 20, its noise seeded from (seed ^ 0x5EED, chunk number, 1), and the
    flagged slots take the retry's samples. With a noise-free ladder
    (DDIM at eta 0) a request's samples are then those it gets alone,
    bit for bit where the chunk's batch size is the same."""

    def _starts(self, keys: List[Tuple[int, int, int]], bucket: int):
        """(B, bucket, 3) starts, one draw of each slot's own generator
        (on the host, so every device gets the same starts)."""
        starts = [torch.randn((bucket, 3), generator=torch.Generator()
                              .manual_seed(slot_seed(*k))) for k in keys]
        return torch.stack(starts).to(self.device)

    @span("runner.run")
    def run(self, dataset: Sequence[Molecule], out_dir: Optional[str] = None,
            seed: int = 0, num_confs="2x", start_idx: int = 0,
            end_idx: Optional[int] = None, resume: bool = True,
            save: bool = True,
            item_seeds: Optional[Sequence[Tuple[int, int]]] = None
            ) -> List[Molecule]:
        """As GenerationRunner.run, on packed chunks. num_confs may be a
        per-item list of sample counts (indexed by dataset index);
        item_seeds, a per-item (seed, index) list, seeds item i's starts
        in place of (seed, i)."""
        with span("runner.plan"):
            save = save and out_dir is not None
            if save and self.writer:
                os.makedirs(out_dir, exist_ok=True)
            end_idx = len(dataset) if end_idx is None else min(
                end_idx, len(dataset))
            if item_seeds is not None and len(item_seeds) != len(dataset):
                raise ValueError(f"{len(item_seeds)} item seeds for "
                                 f"{len(dataset)} molecules")
            done = self._done(out_dir, range(start_idx, end_idx),
                              resume) if save else set()
            todo, results = [], {}
            for i in range(start_idx, end_idx):
                mol = dataset[i]
                path = (os.path.join(out_dir, f"samples_{i}.npz") if save
                        else None)
                if i in done:
                    results[i] = load_samples(path)[0]
                    continue
                ns = (int(num_confs[i])
                      if isinstance(num_confs, (list, tuple))
                      else self.num_samples_for(mol, num_confs))
                todo.append((i, mol, ns))
            groups: Dict[tuple, list] = {}
            for i, mol, ns in todo:
                bucket = self._bucket_for(mol)
                size = (mol.num_nodes if self._engine_for(bucket)
                        in _TIGHT_ENGINES else None)
                groups.setdefault((bucket, size), []).append((i, mol, ns))

        collected: Dict[int, list] = {i: [] for i, _, _ in todo}
        chunk_no = 0   # over the run: each chunk's ladder noise its own
        for (bucket, _), items in groups.items():
            engine = self._engine_for(bucket)
            capacity = self._capacity_for(items[0][1], engine)
            slots = [(i, mol, k) for i, mol, ns in items for k in range(ns)]
            for start in range(0, len(slots), self.chunk_size):
                chunk = slots[start:start + self.chunk_size]
                mols = [mol for _, mol, _ in chunk]
                bsz = self._batch_size_for(len(chunk))
                with span("runner.pad"):
                    batch = pad_molecules(
                        mols + [mols[-1]] * (bsz - len(chunk)), bucket,
                        edge_order=self.model_config.edge_order,
                        batch_size=bsz, device=self.device)
                keys = [(seed, i, k) if item_seeds is None else
                        (item_seeds[i][0], item_seeds[i][1], k)
                        for i, _, k in chunk]
                with span("runner.starts"):
                    pos_init = self._starts(
                        keys + [(0, 0, 0)] * (bsz - len(chunk)), bucket)
                run = (seed ^ 0x5EED, chunk_no)
                chunk_no += 1
                result = self._sampler(engine, False, capacity)(
                    batch, pos_init, generator=torch.Generator(
                        device=self.device).manual_seed(slot_seed(*run)))
                pos, flags = result.pos, result.nan_flags
                with span("runner.wait"):
                    flagged = bool(flags.any())
                if flagged:
                    with span("runner.retry"):
                        if self.logger:
                            self.logger.warning(
                                "NaN in %d/%d samples; retrying with "
                                "clip_local", int(flags.sum()), len(flags))
                        retry = self._sampler(engine, True, capacity)(
                            batch, pos_init, generator=torch.Generator(
                                device=self.device).manual_seed(
                                    slot_seed(*run, 1)))
                        pos = torch.where(flags[:, None, None], retry.pos,
                                          pos)
                with span("runner.copy_back"):
                    pos = pos.cpu().numpy()
                    for slot, (i, mol, _) in enumerate(chunk):
                        collected[i].append(pos[slot, :mol.num_nodes])

        with span("runner.collect"):
            for i, mol, ns in todo:
                pos_gen = np.stack(collected[i], axis=0)
                if save and self.writer:
                    _save_with_gen(os.path.join(out_dir,
                                                f"samples_{i}.npz"),
                                   mol, pos_gen)
                if self.logger:
                    self.logger.info("molecule %d: %d samples (packed "
                                     "chunks)", i, ns)
                results[i] = dataclasses.replace(
                    mol, meta={**mol.meta, "pos_gen": pos_gen})
            ordered = [results[i] for i in sorted(results)]
            if save and self.writer:
                _save_all(os.path.join(out_dir, "samples_all.npz"), ordered)
        return ordered
