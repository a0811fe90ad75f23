"""Cluster-keyed pair datasets and the ``generate_datasets`` pipeline: the
port of ``protein_clip_tpu/data/dataset.py``, plain Python, whose batches
are string-identical to the TPU package's for one seed.

- the split is at *cluster* granularity, 70/15/15 over shuffled cluster ids;
- ``__getitem__`` draws a random member pair from its cluster on every
  access, so each epoch sees different representatives;
- empty clusters are dropped when the pairs are built.

RNG state is explicit (``random.Random`` instances), and ``PairLoader``
reseeds per epoch from (seed, epoch).
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Iterator, Sequence

from . import cluster as cluster_mod
from .fasta import parse_fasta, sequences_only


class ClusterPairDataset:
    """Pairs keyed by cluster; one random member pair per access."""

    def __init__(self, clusters: dict[str, list[tuple[str, str]]],
                 cluster_ids: list[str], seed: int = 42):
        self.clusters = clusters
        self.cluster_ids = cluster_ids
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.cluster_ids)

    def __getitem__(self, idx: int) -> tuple[str, str]:
        members = self.clusters[self.cluster_ids[idx]]
        if not members:
            return "", ""
        return self._rng.choice(members)

    def reseed(self, seed: int) -> None:
        self._rng = random.Random(seed)


class PairLoader:
    """Batched iterator with shuffle and drop_last, like the reference's
    DataLoader. Yields (pep_batch, rec_batch) lists of strings."""

    def __init__(self, dataset: ClusterPairDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 42):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._rng = random.Random(seed)

    def reseed_epoch(self, epoch: int) -> None:
        """Host RNG state from (base seed, epoch) alone: the shuffle order
        and the member sampling of an epoch do not depend on the epochs
        before it (``train/loop.fit`` calls this per epoch)."""
        self._rng = random.Random(self._seed * 1_000_003 + epoch)
        if hasattr(self.dataset, "reseed"):
            self.dataset.reseed(self._seed * 1_000_003 + epoch + 500_009)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple[list[str], list[str]]]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start:start + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            pairs = [self.dataset[i] for i in idxs]
            yield [p[0] for p in pairs], [p[1] for p in pairs]


def split_clusters(cluster_ids: Sequence[str], seed: int = 42,
                   fractions: tuple[float, float] = (0.7, 0.15)
                   ) -> tuple[list[str], list[str], list[str]]:
    """Shuffled cluster-level 70/15/15 split."""
    ids = list(cluster_ids)
    random.Random(seed).shuffle(ids)
    n_train = int(fractions[0] * len(ids))
    n_val = int(fractions[1] * len(ids))
    return ids[:n_train], ids[n_train:n_train + n_val], ids[n_train + n_val:]


def build_pair_clusters(side_a: list[str], side_b: list[str], cluster_tsv: dict[str, list[str]],
                        id_to_seq_b: dict[str, str]) -> dict[str, list[tuple[str, str]]]:
    """Map clusters of side-B sequences to (A, B) sequence pairs. The pair
    lookup goes through a seq(B) -> seq(A) dict built by zip, so duplicate
    B sequences collapse to the last A, as in the reference."""
    b_to_a = dict(zip(side_b, side_a))
    clusters: dict[str, list[tuple[str, str]]] = {}
    for rep_id, member_ids in cluster_tsv.items():
        bucket = clusters.setdefault(rep_id, [])
        for mid in member_ids:
            seq_b = id_to_seq_b[mid]
            if seq_b in b_to_a:
                bucket.append((b_to_a[seq_b], seq_b))
    return {k: v for k, v in clusters.items() if v}


def generate_datasets(data_dir: str | Path, prefix_a: str = "peptide",
                      prefix_b: str = "receptor", min_seq_id: float = 0.5, seed: int = 42,
                      max_sequence_length: int | None = None
                      ) -> tuple[ClusterPairDataset, ClusterPairDataset, ClusterPairDataset]:
    """FASTAs -> cluster side B -> cluster-level split -> (train, val, test).

    Reads ``<data_dir>/<prefix_a>.fasta`` and ``<prefix_b>.fasta``; the
    cluster TSV is cached as ``<prefix_b>DB_clustered.tsv``.
    """
    data_dir = Path(data_dir)
    fb = data_dir / f"{prefix_b}.fasta"
    side_a = sequences_only(data_dir / f"{prefix_a}.fasta")
    side_b = sequences_only(fb)
    if len(side_a) != len(side_b):
        raise ValueError(f"paired FASTAs must align: {len(side_a)} vs {len(side_b)}")
    if max_sequence_length is not None:
        keep = [i for i in range(len(side_a))
                if len(side_a[i]) <= max_sequence_length
                and len(side_b[i]) <= max_sequence_length]
        side_a = [side_a[i] for i in keep]
        side_b = [side_b[i] for i in keep]

    records_b = parse_fasta(fb)
    id_to_seq_b = dict(records_b)
    cluster_tsv = cluster_mod.get_or_build_clusters(
        [rid for rid, _ in records_b], [seq for _, seq in records_b],
        data_dir / f"{prefix_b}DB_clustered.tsv", min_seq_id)
    clusters = build_pair_clusters(side_a, side_b, cluster_tsv, id_to_seq_b)
    train_ids, val_ids, test_ids = split_clusters(list(clusters), seed)
    return (ClusterPairDataset(clusters, train_ids, seed),
            ClusterPairDataset(clusters, val_ids, seed + 1),
            ClusterPairDataset(clusters, test_ids, seed + 2))
