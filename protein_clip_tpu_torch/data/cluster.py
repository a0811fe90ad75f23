"""Sequence clustering at min-seq-id, which drives the cluster-level data
split: the port of ``protein_clip_tpu/data/cluster.py``.

The bundled C++ greedy clusterer (``native/cluster.cc``) writes an
mmseqs-format TSV (``<rep_id>\\t<member_id>`` per sequence, the
reference's ``mmseqs createtsv`` output), cached on disk so a re-run reads
it back. The TPU package's escape hatch to an external ``mmseqs`` binary is
not ported.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from .native.build import build_library


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library("cluster")))
    lib.pct_cluster.restype = ctypes.c_int
    lib.pct_cluster.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                ctypes.c_double, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def cluster_indices(seqs: list[str], min_seq_id: float = 0.5, band: int = 16) -> list[int]:
    """rep_index[i] = original index of the representative of seqs[i]."""
    n = len(seqs)
    if n == 0:
        return []
    arr = (ctypes.c_char_p * n)(*[s.encode() for s in seqs])
    out = (ctypes.c_int * n)()
    if _lib().pct_cluster(arr, n, float(min_seq_id), int(band), out) < 0:
        raise RuntimeError("pct_cluster failed")
    return list(out)


def cluster_to_tsv(ids: list[str], seqs: list[str], tsv_path: str | Path,
                   min_seq_id: float = 0.5) -> None:
    """Write the mmseqs-format TSV: '<rep_id>\\t<member_id>' per sequence."""
    reps = cluster_indices(seqs, min_seq_id)
    with open(tsv_path, "w") as f:
        for i, rep in enumerate(reps):
            f.write(f"{ids[rep]}\t{ids[i]}\n")


def load_cluster_tsv(tsv_path: str | Path) -> dict[str, list[str]]:
    """TSV -> {rep_id: [member_ids]} in file order."""
    clusters: dict[str, list[str]] = {}
    with open(tsv_path) as f:
        for line in f:
            line = line.strip()
            if line:
                rep, member = line.split("\t")
                clusters.setdefault(rep, []).append(member)
    return clusters


def get_or_build_clusters(ids: list[str], seqs: list[str], tsv_path: str | Path,
                          min_seq_id: float = 0.5) -> dict[str, list[str]]:
    """Reuse the cached TSV, else cluster, write it and load it."""
    tsv_path = Path(tsv_path)
    if not tsv_path.exists():
        cluster_to_tsv(ids, seqs, tsv_path, min_seq_id)
    return load_cluster_tsv(tsv_path)
