"""The port's tokenizer and FASTA reader against the JAX package's: ids,
masks and shapes bit-equal."""

import warnings

import numpy as np
import pytest

from protein_clip_tpu.data import fasta as jax_fasta
from protein_clip_tpu.data import tokenizer as jax_tok
from protein_clip_tpu_torch.data import fasta, tokenizer

AAS = "LAGVSERTIDPKQNFYMHWC"

BATCHES = {
    "plain": ["MKTAYIAKQR", "GG", "LAGVSERTIDPKQNFYMHWC" * 3],
    "specials": ["MK<mask>TA<mask>", "<cls>AC<eos>", "<null_1>G<unk>", "A<pad>C"],
    "unknown": ["acde", "XBUZO.-", "A*?!", "<notatoken>K"],
    "with_empty": ["", "A", ""],
}


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_ids_bit_equal(name):
    seqs = BATCHES[name]
    want = jax_tok.EsmTokenizer()(seqs)
    got = tokenizer.EsmTokenizer()(seqs)
    for key in ("input_ids", "attention_mask"):
        assert got[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


def test_bucket_choice_matches():
    ours, theirs = tokenizer.EsmTokenizer(), jax_tok.EsmTokenizer()
    assert tokenizer.DEFAULT_BUCKETS == jax_tok.DEFAULT_BUCKETS
    assert tokenizer.ESM2_VOCAB == jax_tok.ESM2_VOCAB
    for n in range(1, 2200, 7):
        assert ours.bucket_length(n) == theirs.bucket_length(n)
    rng = np.random.default_rng(0)
    for n in (1, 30, 62, 63, 126, 127, 300, 510, 511, 1000, 2046):
        seqs = ["".join(rng.choice(list(AAS), n))]
        np.testing.assert_array_equal(ours(seqs)["input_ids"], theirs(seqs)["input_ids"])


def test_truncation_keeps_eos():
    seqs = ["A" * 2100, "K" * 10]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_tok.EsmTokenizer()(seqs)
    with pytest.warns(UserWarning, match="truncated"):
        got = tokenizer.EsmTokenizer()(seqs)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    assert got["input_ids"].shape == (2, 2048)
    assert got["input_ids"][0, -1] == tokenizer.EOS_ID


def test_pad_to_and_unbucketed():
    seqs = ["ACD", "MKTAYIAKQR"]
    for kw in ({"pad_to": 40}, {"bucketed": False}, {"pad_to": 6}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jax_tok.EsmTokenizer()(seqs, **kw)
            got = tokenizer.EsmTokenizer()(seqs, **kw)
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])


def test_encode_decode_match():
    ours, theirs = tokenizer.EsmTokenizer(), jax_tok.EsmTokenizer()
    for s in ("MK<mask>TA", "ACDEFGHIKLMNPQRSTVWY", ""):
        np.testing.assert_array_equal(ours.encode(s), theirs.encode(s))
        assert ours.decode(ours.encode(s)) == theirs.decode(theirs.encode(s))


def test_parse_fasta_matches(tmp_path):
    path = tmp_path / "x.fasta"
    path.write_text(">a desc\nMKT\nAYI\n\n>b\nGG\n>\nLL\n>c only-header\n")
    assert fasta.parse_fasta(path) == jax_fasta.parse_fasta(path)
