"""Test-set conformer generation (port of agdiff_tpu/eval/generate.py,
GenerationRunner).

Per molecule: num_samples = 2 x num_reference_conformers ("2x") or a fixed
count; pos_init ~ N(0, 1); the annealed Langevin ladder; samples are run in
chunks of one molecule repeated, padded to a power-of-two batch; chunks
whose ladder went non-finite are rerun once with clip_local = 20 and the
flagged samples replaced. A molecule larger than every bucket gets a
bucket of its own, its size rounded up to a multiple of 8.

Engines follow the JAX package's choice on a TPU: at buckets >= 40 the
tight engines, whose pair list holds the molecule's own pairs at a
capacity rounded up to 256 (one shared list, since a chunk is one
molecule repeated); below 40 the triu engines. An `engine` override takes
any triu or tight engine, 'pk' and 'pk-approx' (K2 over the triu pairs)
among them, but not 'pallas': the JAX runner passes use_pallas=False
(agdiff_tpu/eval/generate.py:258-261), so its 'pallas' runs the XLA
forward without the kernels, and the port has no such forward. The
'pallas' kernels run through build_fast_sampler(build_fast_forward(cfg,
model, "pallas"), ...).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from agdiff_torch.chem.mol import Molecule
from agdiff_torch.config import ModelConfig
from agdiff_torch.data.bucketing import pad_molecules, pick_bucket
from agdiff_torch.device import resolve_device
from agdiff_torch.models.fast_forward import build_fast_forward
from agdiff_torch.models.schedules import Diffusion
from agdiff_torch.models.tight_forward import (
    ENGINES as _TIGHT_ENGINES,
    build_tight_forward,
)
from agdiff_torch.ops.pairs import pair_capacity_for
from agdiff_torch.sampling.langevin import SamplerConfig, build_fast_sampler

RETRY_CLIP_LOCAL = 20.0
TIGHT_FROM_BUCKET = 40


class GenerationRunner:
    def __init__(self, model, model_config: ModelConfig,
                 diffusion: Diffusion, sampler_config: SamplerConfig,
                 buckets: Sequence[int] = (32, 64), chunk_size: int = 64,
                 device=None, engine: Optional[str] = None):
        if engine is not None and engine.startswith("pallas"):
            raise ValueError(
                "GenerationRunner does not take engine 'pallas': the JAX "
                "runner builds it with use_pallas=False "
                "(agdiff_tpu/eval/generate.py:258-261), i.e. the XLA "
                "forward without the kernels, which the port does not "
                "have; run build_fast_sampler(build_fast_forward(cfg, "
                "model, 'pallas'), ...) for the kernels")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.model_config = model_config
        self.diffusion = diffusion
        self.sampler_config = sampler_config
        self.retry_config = sampler_config.with_clip_local(RETRY_CLIP_LOCAL)
        self.buckets = tuple(buckets)
        self.chunk_size = chunk_size
        # None: automatic (_engine_for); else the engine of every bucket
        self.engine = engine
        self.forwards: Dict[Optional[str], object] = {}
        self._samplers: Dict[tuple, object] = {}

    def _engine_for(self, bucket: int) -> Optional[str]:
        """The JAX runner's choice on a TPU (agdiff_tpu/eval/generate.py:
        209-246): bf16 configs run 'tight-pksf' (K1 over the molecule's
        tight pair list) at buckets >= 40 and 'pksf' (K1 over the bucket's
        triu set) below; f32 configs run the f32 'tight' engine at >= 40
        and the plain f32 packed forward (None) below."""
        if self.engine is not None:
            return self.engine
        tight = bucket >= TIGHT_FROM_BUCKET
        if self.model_config.dtype == "bfloat16":
            return "tight-pksf" if tight else "pksf"
        return "tight" if tight else None

    def forward(self, engine: Optional[str]):
        """The engine's forward (models/fast_forward.py,
        models/tight_forward.py), built once; its `calls` counts the
        forwards run."""
        if engine not in self.forwards:
            build = (build_tight_forward if engine in _TIGHT_ENGINES
                     else build_fast_forward)
            self.forwards[engine] = build(self.model_config, self.model,
                                          engine)
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
        key = (engine, retry, capacity)
        if key not in self._samplers:
            cfg = self.retry_config if retry else self.sampler_config
            self._samplers[key] = build_fast_sampler(
                self.forward(engine), self.diffusion, cfg,
                pair_capacity=capacity)
        return self._samplers[key]

    def num_samples_for(self, mol: Molecule, num_confs="2x") -> int:
        if isinstance(num_confs, int):
            return num_confs
        if num_confs.endswith("x"):
            return int(num_confs[:-1]) * max(mol.num_ref, 1)
        return int(num_confs)

    def _batch_size_for(self, count: int) -> int:
        """A final partial chunk runs at the next power of two (>= 8), so
        at most log2(chunk_size) batch shapes exist per bucket."""
        if count >= self.chunk_size:
            return self.chunk_size
        b = 8
        while b < count:
            b *= 2
        return min(b, self.chunk_size)

    def _bucket_for(self, mol: Molecule) -> int:
        try:
            return pick_bucket(mol.num_nodes, self.buckets)
        except ValueError:
            # larger than every bucket: the next multiple of 8
            bucket = (mol.num_nodes + 7) // 8 * 8
            self.buckets = tuple(sorted(set(self.buckets) | {bucket}))
            return bucket

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
            batch = pad_molecules([mol] * bsz, bucket,
                                  edge_order=self.model_config.edge_order,
                                  batch_size=bsz, device=self.device)
            pos_init = torch.randn(batch.pos.shape, generator=generator,
                                   device=self.device)
            result = self._sampler(engine, False, capacity)(
                batch, pos_init, generator=generator)
            pos, flags = result.pos, result.nan_flags
            if bool(flags.any()):
                retry = self._sampler(engine, True, capacity)(
                    batch, pos_init, generator=generator)
                pos = torch.where(flags[:, None, None], retry.pos, pos)
            out.append(pos[:count, :n].cpu().numpy())
            remaining -= count
        return np.concatenate(out, axis=0)

    def run(self, dataset: Sequence[Molecule], seed: int = 0,
            num_confs="2x") -> List[Molecule]:
        """Generate for every molecule; returns copies with
        meta['pos_gen'] (num_samples, N, 3)."""
        results = []
        for i, mol in enumerate(dataset):
            gen = torch.Generator(device=self.device).manual_seed(seed + i)
            pos_gen = self.generate_molecule(
                mol, self.num_samples_for(mol, num_confs), gen)
            results.append(dataclasses.replace(
                mol, meta={**mol.meta, "pos_gen": pos_gen}))
        return results
