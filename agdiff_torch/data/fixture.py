"""Small molecule sets stored as JSON under data/fixtures/.

qm9_synthetic.json holds the output of data/synthetic.py's
`synthetic_dataset(4, seed=7, num_conformers=2)` (QM9-sized molecules of
17-23 atoms with two reference conformers each). drugs_synthetic.json
holds `synthetic_dataset(2, seed=7, min_heavy=H, max_heavy=H,
num_conformers=2)` for H = 20 and then H = 28 (Drugs-sized molecules of
50, 56, 69 and 73 atoms). The JAX package's generator gives the same
molecules; tests keep each fixture equal to both.
"""

from __future__ import annotations

import json
import os
from typing import List

from agdiff_torch.chem.mol import Molecule

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")


def load_fixture(name: str = "qm9_synthetic") -> List[Molecule]:
    with open(os.path.join(FIXTURE_DIR, f"{name}.json")) as f:
        raw = json.load(f)
    return [Molecule(**m) for m in raw["molecules"]]
