"""Alanine dipeptide conformer generation (port of
examples/alanine_dipeptide.py; reference: examples/
test_alanine_dipeptide.py).

Builds ACE-ALA-NME (22 atoms) from a z-matrix (NeRF placement) or reads
any PDB (--pdb, chem/pdb.py), samples conformers with the Langevin ladder
through GenerationRunner at bucket 32 in chunks of 50, reports the
heavy-atom Kabsch RMSD of each sample to the input structure, and writes
input.pdb, samples.pdb (one MODEL per sample) and samples.npz (pos_gen,
rmsd) to --out.

The JAX example's runner samples on the dense module; this one takes the
runner's fast engine, as the port's generation CLI does with --fast: on
a bf16 checkpoint 'pksf', the whole eval stack as one hand kernel (K1,
kernels/csrc/stack_packed.cu) on the card, its plain twin on the CPU.
The checkpoint is a log dir or checkpoint directory of cli/train.py or a
reference .pt (cli/_common.py load_inference_bundle); the JAX package's
orbax directories are refused there. The run is on the CUDA card unless
--device says otherwise, with no fallback.

Usage:
  python -m agdiff_torch.examples.alanine_dipeptide <ckpt_or_logdir>
      [--pdb file.pdb] [--num_samples 250] [--n_steps 5000]
      [--w_global 0.3] [--clip_local 20] [--out out_dir] [--device cpu]
  python -m agdiff_torch.examples.alanine_dipeptide --build-only
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from agdiff_torch.chem.constants import BondType
from agdiff_torch.chem.mol import Molecule
from agdiff_torch.chem.pdb import (
    directed_bonds,
    load_pdb,
    perceive_bonds,
    write_pdb,
)
from agdiff_torch.chem.rmsd import kabsch_rmsd

BUCKETS = (32,)
CHUNK = 50


def _nerf(a, b, c, bond, angle, dihedral):
    """Atom d from three reference atoms (natural extension reference
    frame): |cd| = bond, angle(b, c, d), dihedral(a, b, c, d), degrees."""
    angle = np.deg2rad(angle)
    dihedral = np.deg2rad(dihedral)
    bc = c - b
    bc /= np.linalg.norm(bc)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    d_local = bond * np.array([-np.cos(angle),
                               np.sin(angle) * np.cos(dihedral),
                               np.sin(angle) * np.sin(dihedral)])
    return c + d_local[0] * bc + d_local[1] * m + d_local[2] * n


# (atom, its three reference atoms, bond A, angle deg, dihedral deg or a
# key of the torsions below plus an offset), in placement order
_ZMATRIX = (
    ("N1", ("O0", "CH3A", "CA0"), 1.33, 116, 180),
    ("CA1", ("CH3A", "CA0", "N1"), 1.46, 122, 180),
    ("CB1", ("CA0", "N1", "CA1"), 1.52, 110, ("phi", 120)),
    ("C1", ("CA0", "N1", "CA1"), 1.52, 110, ("phi", 0)),
    ("O1", ("N1", "CA1", "C1"), 1.23, 121, ("psi", 180)),
    ("N2", ("N1", "CA1", "C1"), 1.33, 116, ("psi", 0)),
    ("CH3B", ("CA1", "C1", "N2"), 1.46, 122, 180),
    ("H1A", ("O0", "CA0", "CH3A"), 1.09, 109.5, 60),
    ("H2A", ("O0", "CA0", "CH3A"), 1.09, 109.5, 180),
    ("H3A", ("O0", "CA0", "CH3A"), 1.09, 109.5, 300),
    ("HN1", ("CA1", "CA0", "N1"), 1.01, 119, 180),
    ("HA1", ("CA0", "N1", "CA1"), 1.09, 109, ("phi", 240)),
    ("HB1", ("N1", "CA1", "CB1"), 1.09, 109.5, 60),
    ("HB2", ("N1", "CA1", "CB1"), 1.09, 109.5, 180),
    ("HB3", ("N1", "CA1", "CB1"), 1.09, 109.5, 300),
    ("HN2", ("CA1", "C1", "N2"), 1.01, 119, 0),
    ("H1B", ("C1", "N2", "CH3B"), 1.09, 109.5, 60),
    ("H2B", ("C1", "N2", "CH3B"), 1.09, 109.5, 180),
    ("H3B", ("C1", "N2", "CH3B"), 1.09, 109.5, 300),
)
ATOM_ORDER = (
    "CH3A", "H1A", "H2A", "H3A", "CA0", "O0", "N1", "HN1", "CA1", "HA1",
    "CB1", "HB1", "HB2", "HB3", "C1", "O1", "N2", "HN2", "CH3B", "H1B",
    "H2B", "H3B")


def build_alanine_dipeptide(phi=-80.0, psi=-60.0) -> Molecule:
    """ACE-ALA-NME (22 atoms) from standard internal coordinates, centred,
    bonds by covalent radii, SMILES CC(=O)NC(C)C(=O)NC."""
    torsion = {"phi": phi, "psi": psi}
    P = {"CH3A": np.array([0.0, 0.0, 0.0]),
         "CA0": np.array([1.52, 0.0, 0.0])}   # the ACE carbonyl C
    P["O0"] = _nerf(P["CH3A"] + [0, 1, 0], P["CH3A"], P["CA0"], 1.23, 121,
                    0)
    for name, (a, b, c), bond, angle, dihedral in _ZMATRIX:
        if isinstance(dihedral, tuple):
            dihedral = torsion[dihedral[0]] + dihedral[1]
        P[name] = _nerf(P[a], P[b], P[c], bond, angle, dihedral)
    z_of = {"C": 6, "O": 8, "N": 7}
    atom_type = np.array([1 if name.startswith("H") else z_of[name[0]]
                          for name in ATOM_ORDER], np.int32)
    pos = np.array([P[name] for name in ATOM_ORDER], np.float32)
    bond_index = directed_bonds(perceive_bonds(atom_type, pos),
                                len(ATOM_ORDER))
    return Molecule(
        atom_type=atom_type, pos=pos - pos.mean(0), bond_index=bond_index,
        bond_type=np.full(bond_index.shape[1], int(BondType.SINGLE),
                          np.int32),
        smiles="CC(=O)NC(C)C(=O)NC")


def make_runner(ckpt: str, n_steps: int, w_global: float,
                clip_local: float, device=None):
    """The example's GenerationRunner on a checkpoint (buckets (32,),
    chunks of 50, the runner's fast engine)."""
    from agdiff_torch.cli._common import load_inference_bundle
    from agdiff_torch.eval.generate import GenerationRunner
    from agdiff_torch.models.schedules import make_diffusion
    from agdiff_torch.sampling.langevin import SamplerConfig

    config, model, _, _ = load_inference_bundle(ckpt)
    return GenerationRunner(
        model, config.model, make_diffusion(config.model),
        SamplerConfig(n_steps=n_steps, w_global=w_global,
                      clip_local=clip_local),
        buckets=BUCKETS, chunk_size=CHUNK, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", nargs="?", help="log dir, checkpoint directory "
                                            "or reference .pt")
    ap.add_argument("--pdb", default=None, help="use this PDB instead")
    ap.add_argument("--num_samples", type=int, default=250)
    ap.add_argument("--n_steps", type=int, default=5000)
    ap.add_argument("--w_global", type=float, default=0.3)
    ap.add_argument("--clip_local", type=float, default=20.0)
    ap.add_argument("--out", default="./alanine_out")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if not args.build_only and not args.ckpt:
        ap.error("a checkpoint is required without --build-only")

    mol = load_pdb(args.pdb)[0] if args.pdb else build_alanine_dipeptide()
    print(f"alanine dipeptide: {mol.num_nodes} atoms, "
          f"{mol.bond_index.shape[1] // 2} bonds")
    os.makedirs(args.out, exist_ok=True)
    write_pdb(os.path.join(args.out, "input.pdb"), mol, mol.pos)
    if args.build_only:
        return None

    import torch

    runner = make_runner(args.ckpt, args.n_steps, args.w_global,
                         args.clip_local, args.device)
    pos_gen = runner.generate_molecule(
        mol, args.num_samples,
        torch.Generator(device=runner.device).manual_seed(0))
    heavy = mol.atom_type != 1
    rmsds = np.array([kabsch_rmsd(mol.pos[heavy], p[heavy])
                      for p in pos_gen])
    print(f"heavy-atom RMSD vs input: mean {rmsds.mean():.3f} A, "
          f"min {rmsds.min():.3f} A, max {rmsds.max():.3f} A")
    write_pdb(os.path.join(args.out, "samples.pdb"), mol, pos_gen)
    np.savez(os.path.join(args.out, "samples.npz"), pos_gen=pos_gen,
             rmsd=rmsds)
    print(f"wrote {args.num_samples} models -> {args.out}/samples.pdb")
    return pos_gen, rmsds


if __name__ == "__main__":
    main()
