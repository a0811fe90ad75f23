"""Deterministic synthetic peptide/receptor corpus: the port's copy of
``protein_clip_tpu/data/synthetic.py``.

Paired (peptide, receptor) sequences where receptors form
sequence-similarity families (so the clusterer has real work to do) and
peptides are short. The stdlib ``random`` drives it, so both packages write
byte-identical FASTAs for one seed.
"""

from __future__ import annotations

import random
from pathlib import Path

from .fasta import write_fasta

AA = "LAGVSERTIDPKQNFYMHWC"  # 20 canonical residues (ESM vocab ids 4..23)


def _mutate(seq: str, n_mut: int, rng: random.Random) -> str:
    s = list(seq)
    for _ in range(n_mut):
        pos = rng.randrange(len(s))
        s[pos] = rng.choice(AA)
    return "".join(s)


def make_pair_corpus(
    n_families: int = 24,
    members_per_family: tuple[int, int] = (1, 6),
    receptor_len: tuple[int, int] = (60, 180),
    peptide_len: tuple[int, int] = (8, 30),
    mutation_rate: float = 0.1,
    seed: int = 42,
    correlated: bool = False,
) -> tuple[list[str], list[str]]:
    """Return (peptides, receptors), index-paired like the Propedia files.

    Receptors within a family are point-mutated copies of a family ancestor
    (>= 1 - mutation_rate identity), so a min-seq-id 0.5 clusterer groups
    them; peptides are independent random sequences per pair.
    correlated=True plants each pair's peptide inside its receptor, giving
    the corpus a learnable pep<->rec signal.
    """
    rng = random.Random(seed)
    peptides: list[str] = []
    receptors: list[str] = []
    for _ in range(n_families):
        rlen = rng.randint(*receptor_len)
        ancestor = "".join(rng.choice(AA) for _ in range(rlen))
        n_members = rng.randint(*members_per_family)
        for _ in range(n_members):
            rec = _mutate(ancestor, int(mutation_rate * rlen), rng)
            plen = rng.randint(*peptide_len)
            pep = "".join(rng.choice(AA) for _ in range(plen))
            if correlated:
                pos = rng.randrange(max(len(rec) - plen, 1))
                rec = rec[:pos] + pep + rec[pos + plen:]
            peptides.append(pep)
            receptors.append(rec)
    return peptides, receptors


def write_fixture(dir_path, prefix1: str = "peptide", prefix2: str = "receptor",
                  **kwargs) -> None:
    """Write the corpus as the two FASTA files the data pipeline expects."""
    d = Path(dir_path)
    d.mkdir(parents=True, exist_ok=True)
    peps, recs = make_pair_corpus(**kwargs)
    write_fasta(d / f"{prefix1}.fasta", [(f"pep_{i}", s) for i, s in enumerate(peps)])
    write_fasta(d / f"{prefix2}.fasta", [(f"rec_{i}", s) for i, s in enumerate(recs)])
