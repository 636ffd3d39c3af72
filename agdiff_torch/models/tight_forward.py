"""Eval forward on a molecule's tight pair list (port of
agdiff_tpu/models/tight_forward.py, build_tight_forward :171-567).

A bucket of N = 64 holds molecules of 45-56 atoms at Drugs size: their
real pairs are 990-1540 of the bucket's 2016. The tight list
(ops/pairs.py prepare_pairs) holds only the real pairs, padded to a
capacity sized from the molecule (eval/generate.py), so per-pair work
scales with the molecule. The forward is models/fast_forward.py's on that
list: the working graph, the packed planes ANDed with the list's valid
plane (:416-426), the edge encoder on the packed pairs (:428-431), the
envelope (cosine with smooth_conv), the distance-weight planes (:446-447),
K1 (:461-478) or its plain version, and the mirror back to dense planes
(:380-386). The list depends only on the node mask, so the sampler builds
it once per ladder (`prepare`, :388-392) and passes it to every step.

Engines: 'tight' (f32, K1's plain version in mode 'full'); 'tight-pks',
'tight-pksg', 'tight-pksf' (bf16, K1 in mode 'schnet' / 'gin' / 'full',
slim storage), each also with '-approx'. As in the JAX package, the
score heads go to K1 unnarrowed (its products round them to bf16; its
biases and last layer stay f32), and the kernel engines need a shared
list (:250-255). The tabulated filters (`tabulate`) are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from agdiff_torch.config import ModelConfig
from agdiff_torch.models.dualenc import DualEncoderEpsNetwork
from agdiff_torch.models.fast_forward import FastForward, engine_options
from agdiff_torch.ops.pairs import (
    PairList,
    prepare_pairs,
    prepare_pairs_shared,
)

ENGINES = ("tight",) + tuple(f"tight-{k}{s}" for k in ("pks", "pksg", "pksf")
                             for s in ("", "-approx"))


class TightForward(FastForward):
    """forward(batch, pairs=None) -> ModelOutput over tight pair lists;
    `capacity` is the static pair count (None: the bucket's N(N-1)/2,
    always enough); shared=True uses graph 0's list for the whole batch,
    which is right for one molecule repeated (the generation pattern)."""

    cast_heads = False

    def __init__(self, config: ModelConfig, model: DualEncoderEpsNetwork,
                 *, capacity: Optional[int] = None, shared: bool = True,
                 **kw):
        if kw.get("mode") is not None and not shared:
            raise ValueError("the K1 modes need shared=True: the kernel takes "
                             "one pair list for the whole batch")
        super().__init__(config, model, **kw)
        self.capacity, self.shared = capacity, shared

    def prepare(self, batch, capacity: Optional[int] = None) -> PairList:
        n = batch.atom_type.shape[1]
        cap = capacity or self.capacity or n * (n - 1) // 2
        fn = prepare_pairs_shared if self.shared else prepare_pairs
        return fn(batch.node_mask, cap)


def build_tight_forward(config: ModelConfig, model: DualEncoderEpsNetwork,
                        engine: str = "tight",
                        capacity: Optional[int] = None) -> TightForward:
    """The forward of a tight engine (ENGINES) over shared lists."""
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r} not in {ENGINES}")
    _, mode, approx = engine_options(engine)
    cd = torch.float32 if mode is None else torch.bfloat16
    return TightForward(config, model, capacity=capacity, mode=mode,
                        compute_dtype=cd, approx=approx)
