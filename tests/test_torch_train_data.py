"""The port's training data pipeline against the JAX package's, on the CPU:
synthetic FASTAs, the cluster TSV, the cluster-level splits and the
loader's batches must be identical (strings and bytes); the prefetcher
must keep order and re-raise a producer's error."""

import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from protein_clip_tpu.data import cluster as jcluster
from protein_clip_tpu.data import dataset as jdataset
from protein_clip_tpu.data import fasta as jfasta
from protein_clip_tpu.data import synthetic as jsynthetic
from protein_clip_tpu_torch.data import cluster, dataset, fasta, prefetch, synthetic
from protein_clip_tpu_torch.utils import rundir


def _write_both(tmp_path: Path, **kw) -> tuple[Path, Path]:
    jd, pd = tmp_path / "jax", tmp_path / "port"
    jsynthetic.write_fixture(jd, **kw)
    synthetic.write_fixture(pd, **kw)
    return jd, pd


@pytest.mark.parametrize("kw", [dict(n_families=40, seed=0),
                                dict(n_families=25, seed=7, correlated=True),
                                dict(n_families=30, seed=3, prefix1="protein1",
                                     prefix2="protein2", receptor_len=(100, 300))])
def test_synthetic_fastas_are_byte_equal(tmp_path, kw):
    jd, pd = _write_both(tmp_path, **kw)
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in pd.iterdir()) and len(names) == 2
    for name in names:
        assert (jd / name).read_bytes() == (pd / name).read_bytes()


def test_fasta_io_matches(tmp_path):
    records = [("a", "MKV"), ("b c", "LLAG"), ("d", "")]
    jfasta.write_fasta(tmp_path / "j.fasta", records)
    fasta.write_fasta(tmp_path / "p.fasta", records)
    assert (tmp_path / "j.fasta").read_bytes() == (tmp_path / "p.fasta").read_bytes()
    (tmp_path / "x.fasta").write_text(">a\nMKV\nLL\n\n>b\nQQ\n")
    assert fasta.sequences_only(tmp_path / "x.fasta") == jfasta.sequences_only(
        tmp_path / "x.fasta") == ["MKV", "LL", "QQ"]


@pytest.mark.parametrize("n_families,min_seq_id", [(60, 0.5), (30, 0.3)])
def test_cluster_tsv_is_equal(tmp_path, n_families, min_seq_id):
    _, recs = synthetic.make_pair_corpus(n_families=n_families, seed=n_families)
    ids = [f"rec_{i}" for i in range(len(recs))]
    jcluster.cluster_to_tsv(ids, recs, tmp_path / "j.tsv", min_seq_id)
    cluster.cluster_to_tsv(ids, recs, tmp_path / "p.tsv", min_seq_id)
    text = (tmp_path / "p.tsv").read_text()
    assert text == (tmp_path / "j.tsv").read_text()
    reps = cluster.load_cluster_tsv(tmp_path / "p.tsv")
    assert 1 < len(reps) < len(recs)          # families group, not everything
    assert cluster.get_or_build_clusters(ids, recs, tmp_path / "p.tsv") == reps


def _datasets(jd, pd, **kw):
    return (jdataset.generate_datasets(jd, **kw), dataset.generate_datasets(pd, **kw))


@pytest.mark.parametrize("max_len", [None, 150])
def test_generate_datasets_splits_are_equal(tmp_path, max_len):
    jd, pd = _write_both(tmp_path, n_families=80, seed=5)
    (jtr, jva, jte), (ptr, pva, pte) = _datasets(jd, pd, seed=5,
                                                 max_sequence_length=max_len)
    assert (pd / "receptorDB_clustered.tsv").read_text() == (
        jd / "receptorDB_clustered.tsv").read_text()
    for j, p in ((jtr, ptr), (jva, pva), (jte, pte)):
        assert p.cluster_ids == j.cluster_ids
        assert p.clusters == j.clusters
    assert len(ptr) > len(pva) > 0


def test_pair_loader_batches_are_equal_over_two_epochs(tmp_path):
    jd, pd = _write_both(tmp_path, n_families=90, seed=11)
    (jtr, jva, _), (ptr, pva, _) = _datasets(jd, pd, seed=11)
    for (jds, pds, shuffle) in ((jtr, ptr, True), (jva, pva, False)):
        jl = jdataset.PairLoader(jds, 4, shuffle=shuffle, drop_last=True, seed=11)
        pl = dataset.PairLoader(pds, 4, shuffle=shuffle, drop_last=True, seed=11)
        assert len(pl) == len(jl) > 0
        for epoch in range(2):
            jl.reseed_epoch(epoch)
            pl.reseed_epoch(epoch)
            assert list(pl) == list(jl)


def test_prefetch_keeps_order_and_structure():
    def prepare(i):
        return {"ids": torch.full((2,), i, dtype=torch.int8)}, (torch.tensor(float(i)),)

    got = list(prefetch.prefetch_to_device(range(7), prepare, "cpu", depth=2))
    assert [int(b[0]["ids"][0]) for b in got] == list(range(7))
    assert all(isinstance(b, tuple) and isinstance(b[1], tuple) for b in got)
    assert got[3][0]["ids"].dtype == torch.int8 and float(got[3][1][0]) == 3.0


def test_prefetch_reraises_a_producer_error():
    def items():
        yield 1
        yield 2
        raise KeyError("boom")

    seen = []
    with pytest.raises(KeyError, match="boom"):
        for b in prefetch.prefetch_to_device(items(), lambda i: torch.tensor(i), "cpu"):
            seen.append(int(b))
    assert seen == [1, 2]


def test_prefetch_runs_prepare_off_the_consumer_thread():
    threads = []
    list(prefetch.prefetch_to_device(range(3), lambda i: threads.append(
        threading.current_thread()) or torch.tensor(i), "cpu"))
    assert threads and all(t is not threading.main_thread() for t in threads)


def test_run_dir_contract(tmp_path):
    d = rundir.make_run_dir(tmp_path)
    assert d.is_dir() and d.parent == tmp_path
    date, time_, micros = d.name.split("_")
    assert len(date) == 8 and len(time_) == 6 and len(micros) == 6
    assert np.all([s.isdigit() for s in (date, time_, micros)])
