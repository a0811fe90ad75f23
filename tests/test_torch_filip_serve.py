"""The port's FILIP retrieval path as a whole (``embed --filip``, ``serve
--filip``, ``retrieve``) on the CPU against the JAX package's.

The JAX package writes FILIP heads and ESM weights (tiny config, float32);
both packages build their index from the same FASTA and serve or query
it. Token embeddings agree within 1e-5 (the backbone in float32, sums in
another order); scores built from them within 1e-5; the binary wire equals
the JSON path bit for bit.
"""

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest

from protein_clip_tpu.cli import common as jcommon
from protein_clip_tpu.cli import embed as jembed
from protein_clip_tpu.cli import retrieve as jretrieve
from protein_clip_tpu.cli import serve as jserve
from protein_clip_tpu.data.tokenizer import EsmTokenizer as JaxTokenizer
from protein_clip_tpu.models import esm2 as jesm2
from protein_clip_tpu.models import filip as jfilip
from protein_clip_tpu.train.checkpoint import export_npz as jax_export_npz
from protein_clip_tpu_torch.cli import embed, retrieve, serve
from protein_clip_tpu_torch.ops import filip as ops

AAS = "LAGVSERTIDPKQNFYMHWC"
ATOL = 1e-5
JAX_TINY = ["--esm-config", "tiny", "--esm-dtype", "float32"]
TINY = JAX_TINY + ["--device", "cpu"]


def _seqs(rng, n, lo=5, hi=90):
    return ["".join(rng.choice(list(AAS), int(L))) for L in rng.integers(lo, hi, n)]


def _fasta(path, seqs, prefix):
    path.write_text("".join(f">{prefix}{i}\n{s}\n" for i, s in enumerate(seqs)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_filip_serve")
    esm_cfg = jcommon.esm_config("tiny", "float32")
    fcfg = jfilip.FILIPConfig(input_dim=esm_cfg.hidden_size, esm=esm_cfg)
    heads = jfilip.init_params(jax.random.key(7), fcfg)
    esm = jesm2.init_params(jax.random.key(8), esm_cfg)
    jax_export_npz(d / "heads.npz", heads)
    jax_export_npz(d / "esm.npz", esm)
    rng = np.random.default_rng(0)
    corpus, queries = _seqs(rng, 24), _seqs(rng, 3)
    _fasta(d / "corpus.fasta", corpus, "c")
    _fasta(d / "queries.fasta", queries, "q")
    weights = ["--checkpoint", str(d / "heads.npz"), "--esm-weights", str(d / "esm.npz"),
               "--batch-size", "8"]
    for name, main, tiny in (("port", embed.main, TINY), ("jax", jembed.main, JAX_TINY)):
        for extra, suffix in ((["--filip"], "tokens"), ([], "pooled")):
            assert main(tiny + weights + extra + ["--fasta", str(d / "corpus.fasta"),
                                                  "--side", "rec",
                                                  "--out", str(d / f"{name}_{suffix}.npz")]) == 0
    return {"dir": d, "heads": heads, "esm": esm, "fcfg": fcfg, "weights": weights,
            "corpus": corpus, "queries": queries}


def _serve_args(files, index, tiny=TINY, parser=serve.build_argparser):
    return parser().parse_args(tiny + files["weights"] + ["--index", str(index), "--port", "0",
                                                          "--filip"])


@pytest.fixture(scope="module")
def served(files):
    server = serve.make_server(_serve_args(files, files["dir"] / "port_tokens.npz"))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _call(base, path, payload=None, headers=None):
    req = urllib.request.Request(
        base + path, data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


def _jax_tokens(files, seqs, side):
    return jembed.embed_sequences_tokens(files["heads"], files["esm"], seqs, side,
                                         files["fcfg"], JaxTokenizer(), batch_size=8,
                                         pad_batch=True)


def test_embed_filip_index_matches_jax(files):
    d = files["dir"]
    with np.load(d / "port_tokens.npz") as got, np.load(d / "jax_tokens.npz") as want:
        assert set(got.files) == {"ids", "tokens", "lengths"}
        np.testing.assert_array_equal(got["ids"], want["ids"])
        np.testing.assert_array_equal(got["lengths"], want["lengths"])
        assert got["tokens"].shape == want["tokens"].shape == (int(want["lengths"].sum()), 128)
        np.testing.assert_allclose(got["tokens"], want["tokens"], atol=ATOL)
        lengths = got["lengths"]
    # length-sorted rows, each its sequence's tokens plus <cls> and <eos>
    assert list(lengths) == sorted(lengths)
    assert sorted(lengths - 2) == sorted(len(s) for s in files["corpus"])


def test_healthz_reports_filip(served):
    with _call(served, "/healthz") as r:
        health = json.loads(r.read())
    assert health["filip"] is True and health["index_size"] == 24
    assert health["device"] == "cpu"


@pytest.mark.parametrize("side", ["pep", "rec"])
def test_embed_json_matches_jax(served, files, side):
    seqs = files["queries"] + ["MK<mask>TAYIAKQR"]
    with _call(served, "/embed", {"sequences": seqs, "side": side}) as r:
        out = json.loads(r.read())
    want_t, want_m = _jax_tokens(files, seqs, side)
    got_t = np.asarray(out["tokens"], np.float32)
    assert got_t.shape == want_t.shape
    assert out["lengths"] == [int(m.sum()) for m in want_m]
    np.testing.assert_allclose(got_t, want_t, atol=ATOL)


def test_embed_binary_matches_json_with_length_prefix(served, files):
    seqs = _seqs(np.random.default_rng(2), 5)
    with _call(served, "/embed", {"sequences": seqs, "side": "pep"}) as r:
        ref = json.loads(r.read())
    with _call(served, "/embed", {"sequences": seqs, "side": "pep"},
               {"Accept": "application/octet-stream"}) as r:
        assert r.headers["Content-Type"] == "application/octet-stream"
        assert r.headers["X-Dtype"] == "<f4" and r.headers["X-Prefix-Dtype"] == "<i4"
        shape = tuple(int(x) for x in r.headers["X-Shape"].split(","))
        n_pre = int(r.headers["X-Prefix-Len"])
        body = r.read()
    assert n_pre == len(seqs)
    assert np.frombuffer(body[:4 * n_pre], "<i4").tolist() == ref["lengths"]
    assert ref["lengths"] == [len(s) + 2 for s in seqs]
    np.testing.assert_array_equal(np.frombuffer(body[4 * n_pre:], "<f4").reshape(shape),
                                  np.asarray(ref["tokens"], np.float32))


def _jax_service(files, index):
    return jserve.ClipService(_serve_args(files, index, JAX_TINY, jserve.build_argparser))


def _assert_hits_equal(got, want, atol=ATOL):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert [h["rank"] for h in g_row] == [h["rank"] for h in w_row]
        assert [h["id"] for h in g_row] == [h["id"] for h in w_row]
        np.testing.assert_allclose([h["score"] for h in g_row], [h["score"] for h in w_row],
                                   atol=atol, rtol=0)


def test_topk_matches_jax_service(served, files):
    queries = files["queries"]
    with _call(served, "/topk", {"queries": queries, "side": "pep", "k": 5}) as r:
        hits = json.loads(r.read())["hits"]
    want = _jax_service(files, files["dir"] / "jax_tokens.npz").topk(queries, "pep", 5)
    _assert_hits_equal(hits, want)


def _dense_index(files, name):
    """The port's ragged index rewritten as a legacy dense {tokens, mask}."""
    d = files["dir"]
    with np.load(d / "port_tokens.npz") as idx:
        ids, flat, lengths = idx["ids"], idx["tokens"], idx["lengths"]
    tokens = np.zeros((len(ids), int(lengths.max()), flat.shape[1]), np.float32)
    mask = np.zeros(tokens.shape[:2], np.int8)
    for i, (start, n) in enumerate(zip(np.cumsum(lengths) - lengths, lengths)):
        tokens[i, :n] = flat[start:start + n]
        mask[i, :n] = 1
    np.savez(d / name, ids=ids, tokens=tokens, mask=mask)
    return d / name


def test_legacy_dense_index_serves_the_same_hits(files):
    dense = _dense_index(files, "port_dense.npz")
    ragged = serve.ClipService(_serve_args(files, files["dir"] / "port_tokens.npz"))
    service = serve.ClipService(_serve_args(files, dense))
    assert service.corpus_lengths is None and service.corpus_mask.dtype == np.int32
    queries = files["queries"]
    got = service.topk(queries, "rec", 24)
    _assert_hits_equal(got, ragged.topk(queries, "rec", 24), atol=2e-6)
    _assert_hits_equal(got, _jax_service(files, dense).topk(queries, "rec", 24))


def _malformed(files, kind):
    d = files["dir"]
    if kind == "pooled":
        return d / "port_pooled.npz", "token-level"
    with np.load(d / "port_tokens.npz") as idx:
        ids, tokens, lengths = idx["ids"], idx["tokens"], idx["lengths"]
    if kind == "no_lengths_or_mask":
        np.savez(d / "bad.npz", ids=ids, tokens=tokens)
        return d / "bad.npz", "malformed FILIP index"
    np.savez(d / "bad.npz", ids=ids, tokens=tokens[:, :64], lengths=lengths)
    return d / "bad.npz", "token dim 64"


@pytest.mark.parametrize("entry", ["serve", "retrieve"])
@pytest.mark.parametrize("kind", ["pooled", "no_lengths_or_mask", "wrong_dim"])
def test_malformed_index_raises(files, kind, entry):
    index, match = _malformed(files, kind)
    with pytest.raises(ValueError, match=match):
        if entry == "serve":
            serve.ClipService(_serve_args(files, index))
        else:
            retrieve.main(TINY + files["weights"] + [
                "--index", str(index), "--queries", str(files["dir"] / "queries.fasta"),
                "--filip", "--out", str(files["dir"] / "never.tsv")])


def _tsv(path):
    lines = path.read_text().splitlines()
    assert lines[0] == "query_id\trank\thit_id\tscore"
    return [ln.split("\t") for ln in lines[1:]]


@pytest.mark.parametrize("raw_cosine", [False, True])
@pytest.mark.parametrize("mode", ["clip", "filip"])
def test_retrieve_tsv_matches_jax(files, mode, raw_cosine):
    d = files["dir"]
    index = "tokens" if mode == "filip" else "pooled"
    extra = (["--filip"] if mode == "filip" else []) + (["--raw-cosine"] if raw_cosine else [])
    argv = files["weights"] + ["--queries", str(d / "queries.fasta"), "--side", "pep",
                               "--k", "4"] + extra
    launches = ops.filip_similarity_fused.launches
    assert retrieve.main(TINY + argv + ["--index", str(d / f"port_{index}.npz"),
                                        "--out", str(d / "port.tsv")]) == 0
    assert ops.filip_similarity_fused.launches == launches  # the CPU runs no kernel
    assert jretrieve.main(JAX_TINY + argv + ["--index", str(d / f"jax_{index}.npz"),
                                             "--out", str(d / "jax.tsv")]) == 0
    got, want = _tsv(d / "port.tsv"), _tsv(d / "jax.tsv")
    assert len(got) == 3 * 4
    assert [r[:3] for r in got] == [r[:3] for r in want]
    np.testing.assert_allclose([float(r[3]) for r in got], [float(r[3]) for r in want],
                               atol=ATOL, rtol=0)
    assert all(len(r[3].split(".")[1]) == 6 for r in got)  # %.6f


def test_filip_topk_without_index_raises(files):
    args = serve.build_argparser().parse_args(TINY + files["weights"] + ["--filip"])
    with pytest.raises(ValueError, match="no --index"):
        serve.ClipService(args).topk(["MKT"], "pep", 3)
