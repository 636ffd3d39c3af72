"""Bond-type vocabulary (port of agdiff_tpu/chem/constants.py).

Bond types 1..21 follow RDKit's BondType ordering (22 entries with
UNSPECIFIED = 0, which doubles as the radius-edge type); k-hop extended
edges get type NUM_BOND_TYPES + k - 1 (23, 24 for k = 2, 3). The element
table serves the PDB reader and writer (chem/pdb.py).
"""

import enum


class BondType(enum.IntEnum):
    """RDKit's BondType names in its 2022+ order (22 entries)."""

    UNSPECIFIED = 0
    SINGLE = 1
    DOUBLE = 2
    TRIPLE = 3
    QUADRUPLE = 4
    QUINTUPLE = 5
    HEXTUPLE = 6
    ONEANDAHALF = 7
    TWOANDAHALF = 8
    THREEANDAHALF = 9
    FOURANDAHALF = 10
    FIVEANDAHALF = 11
    AROMATIC = 12
    IONIC = 13
    HYDROGEN = 14
    THREECENTER = 15
    DATIVEONE = 16
    DATIVE = 17
    DATIVEL = 18
    DATIVER = 19
    OTHER = 20
    ZERO = 21


NUM_BOND_TYPES = len(BondType)  # 22
#: integer id -> name
BOND_NAMES = {int(bt): bt.name for bt in BondType}

# the periodic table of the GEOM sets and common biomolecules (symbol <->
# atomic number; agdiff_tpu/chem/constants.py:62-69)
ATOM_SYMBOLS = {
    1: "H", 5: "B", 6: "C", 7: "N", 8: "O", 9: "F", 14: "Si", 15: "P",
    16: "S", 17: "Cl", 33: "As", 35: "Br", 53: "I", 80: "Hg", 83: "Bi",
}
ATOMIC_NUMBERS = {v: k for k, v in ATOM_SYMBOLS.items()}
