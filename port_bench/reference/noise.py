"""The random numbers of a packed test-set run, worked out again from the
seeds the benchmark handed to `PackedGenerationRunner.run`.

The runner's contract, as the benchmark holds it: the start of sample k
of item i is one standard-normal draw of shape (bucket, 3) from a CPU
generator seeded with slot_seed(item_seeds[i][0], item_seeds[i][1], k);
a chunk's ladder noise comes from one device generator seeded with
slot_seed(seed ^ 0x5EED, chunk number), drawn as one (BLOCK, B, bucket,
3) standard-normal tensor per block of BLOCK steps, B the chunk's batch
size. `slot_seed` folds 32-bit words into a 63-bit seed through numpy's
SeedSequence.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 20   # ladder steps per noise draw


def slot_seed(*words: int) -> int:
    state = np.random.SeedSequence([w & 0xFFFFFFFF for w in words])
    lo, hi = (int(x) for x in state.generate_state(2, np.uint32))
    return (hi & 0x7FFFFFFF) << 32 | lo


def start(key, bucket: int) -> torch.Tensor:
    """(bucket, 3) start of the sample keyed (word, word, sample index)."""
    gen = torch.Generator().manual_seed(slot_seed(*key))
    return torch.randn((bucket, 3), generator=gen)


class ChunkNoise:
    """The ladder noise of one chunk: `block()` returns the next (BLOCK,
    B, bucket, 3) draw."""

    def __init__(self, run_seed: int, chunk_no: int, batch: int,
                 bucket: int, device):
        self.gen = torch.Generator(device=device).manual_seed(
            slot_seed(run_seed ^ 0x5EED, chunk_no))
        self.shape = (BLOCK, batch, bucket, 3)
        self.device = device

    def block(self) -> torch.Tensor:
        out = torch.empty(self.shape, device=self.device)
        return out.normal_(generator=self.gen)
