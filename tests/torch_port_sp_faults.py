"""The planted faults of the packed sp step (packed_pairs under mode
'sp'), one copy for both places that plant them: the CPU ranks of
tests/torch_port_shard_ranks.py and chip_smoke.py's phase 15 on the card.
Imports numpy, torch and agdiff_torch only."""

import numpy as np
import torch

from agdiff_torch.ops import pairs

# the j-side messages kept on the owner's rank (no reduce-scatter, only the
# rows it holds); the plane's (j, i) half missing; the pairs at distance
# N / 2 owned by both their endpoints' ranks
SP_PACKED_FAULTS = ("packed_j_unscattered", "mirror_dropped",
                    "pair_owned_twice")


def patch_packed(fault, patch):
    """Plant one of SP_PACKED_FAULTS with `patch(obj, attr, value)`."""
    if fault == "packed_j_unscattered":
        def unscattered(self, msg_i, msg_j):
            b, f = msg_i.shape[0], msg_i.shape[-1]
            own = torch.einsum("bpf,pn->bnf", msg_i.float(), self.to_i)
            kept = torch.einsum("bpf,pn->bnf", msg_j.float(), self.to_j)
            parts = (own.view(b, -1, 2, f) + kept.view(b, -1, 2, f)[
                :, self.nodes.rows]).to(msg_i.dtype)
            return parts[:, :, 0] + parts[:, :, 1]
        patch(pairs.OwnedPairs, "scatter", unscattered)
    elif fault == "mirror_dropped":
        def upper_only(self, s):
            b, n = s.shape[0], self.nodes.n
            partial = s.new_zeros((b, n * n), dtype=torch.float32).index_add(
                1, self.i * n + self.j, s.float())
            return self.nodes.columns(partial.view(b, n, n)).to(s.dtype)
        patch(pairs.OwnedPairs, "mirror", upper_only)
    elif fault == "pair_owned_twice":
        real = pairs.pair_owners

        def twice(n):
            i, j = real(n)
            half = np.abs(i - j) * 2 == n
            return np.concatenate([i, j[half]]), np.concatenate([j, i[half]])
        patch(pairs, "pair_owners", twice)
