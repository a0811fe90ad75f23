"""Minimal FASTA IO (the port's copy of the TPU package's ``data/fasta.py``)."""

from __future__ import annotations

from pathlib import Path


def parse_fasta(path: str | Path) -> list[tuple[str, str]]:
    """Return [(record_id, sequence), ...]. record_id = first whitespace token
    after '>', matching BioPython's ``record.id``."""
    records: list[tuple[str, str]] = []
    rid = None
    chunks: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if rid is not None:
                    records.append((rid, "".join(chunks)))
                rid = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line.strip())
    if rid is not None:
        records.append((rid, "".join(chunks)))
    return records


def sequences_only(path: str | Path) -> list[str]:
    """All non-header lines, in file order: the reference's raw read, which
    goes line by line, not record by record."""
    seqs = []
    with open(path) as f:
        for line in f:
            if not line.startswith(">") and line.strip():
                seqs.append(line.strip())
    return seqs


def write_fasta(path: str | Path, records: list[tuple[str, str]]) -> None:
    with open(path, "w") as f:
        for rid, seq in records:
            f.write(f">{rid}\n{seq}\n")
