"""ESM-2 tokenizer: NumPy table lookup + static bucket padding.

The port's copy of the TPU package's ``data/tokenizer.py`` NumPy path (the
C++ batch fast path computes the same ids and is not ported). The 33-token
ESM alphabet, the multi-character special tokens (``<mask>`` and the
others, matched longest first), the pad buckets, and truncation that keeps
the ``<eos>`` are the same, so both packages give the same ids.

Buckets keep the set of batch shapes small; the CUDA attention kernel runs
at any length, so on the card they only bound the padding.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np

# The canonical ESM alphabet ordering used by every facebook/esm2_* checkpoint.
ESM2_VOCAB: tuple[str, ...] = (
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K",
    "Q", "N", "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O",
    ".", "-", "<null_1>", "<mask>",
)

CLS_ID = 0
PAD_ID = 1
EOS_ID = 2
UNK_ID = 3
MASK_ID = 32

VOCAB_SIZE = len(ESM2_VOCAB)  # 33

# Static pad buckets (tokens incl. <cls>/<eos>); 2048 caps a 2000-residue
# chain plus its specials.
DEFAULT_BUCKETS: tuple[int, ...] = (
    32, 64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 1024,
    1280, 1536, 2048,
)


def _build_byte_table() -> np.ndarray:
    table = np.full(256, UNK_ID, dtype=np.int32)
    for idx, tok in enumerate(ESM2_VOCAB):
        if len(tok) == 1:
            table[ord(tok)] = idx
    return table


_BYTE_TABLE = _build_byte_table()

# Multi-char special tokens, longest first, for greedy matching.
_SPECIALS = sorted([t for t in ESM2_VOCAB if len(t) > 1], key=len, reverse=True)
_SPECIAL_IDS = {t: ESM2_VOCAB.index(t) for t in _SPECIALS}


@dataclasses.dataclass(frozen=True)
class TokenizerConfig:
    add_special_tokens: bool = True
    buckets: tuple[int, ...] = DEFAULT_BUCKETS


class EsmTokenizer:
    """The ESM-2 vocabulary's tokenizer; ``__call__`` returns NumPy arrays
    padded to a bucket length."""

    vocab = ESM2_VOCAB
    cls_id, pad_id, eos_id, unk_id, mask_id = CLS_ID, PAD_ID, EOS_ID, UNK_ID, MASK_ID
    vocab_size = VOCAB_SIZE

    def __init__(self, config: TokenizerConfig | None = None):
        self.config = config or TokenizerConfig()

    def encode(self, seq: str, add_special_tokens: bool | None = None) -> np.ndarray:
        if add_special_tokens is None:
            add_special_tokens = self.config.add_special_tokens
        ids = self._encode_body(seq)
        if add_special_tokens:
            ids = np.concatenate(([CLS_ID], ids, [EOS_ID])).astype(np.int32)
        return ids

    @staticmethod
    def _encode_body(seq: str) -> np.ndarray:
        if "<" not in seq:
            raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
            return _BYTE_TABLE[raw].astype(np.int32)
        out: list[int] = []
        i = 0
        n = len(seq)
        while i < n:
            if seq[i] == "<":
                for sp in _SPECIALS:
                    if seq.startswith(sp, i):
                        out.append(_SPECIAL_IDS[sp])
                        i += len(sp)
                        break
                else:
                    out.append(int(_BYTE_TABLE[ord(seq[i]) & 0xFF]))
                    i += 1
            else:
                out.append(int(_BYTE_TABLE[ord(seq[i]) & 0xFF])
                           if ord(seq[i]) < 256 else UNK_ID)
                i += 1
        return np.asarray(out, dtype=np.int32)

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        toks = []
        for i in ids:
            t = ESM2_VOCAB[int(i)]
            if skip_special and t in ("<cls>", "<eos>", "<pad>"):
                continue
            toks.append(t)
        return "".join(toks)

    def bucket_length(self, max_len: int) -> int:
        """Smallest configured bucket >= max_len (last bucket clamps)."""
        for b in self.config.buckets:
            if max_len <= b:
                return b
        return self.config.buckets[-1]

    def __call__(self, seqs: Sequence[str], pad_to: int | None = None,
                 bucketed: bool = True) -> dict[str, np.ndarray]:
        """Tokenize a batch -> {'input_ids', 'attention_mask'} int32 arrays,
        padded to ``pad_to``, else to the bucket covering the longest
        sequence (the exact longest length if ``bucketed`` is False).
        Longer sequences are truncated with their <eos> kept."""
        encs = [self.encode(s) for s in seqs]
        max_len = max((len(e) for e in encs), default=2)
        if pad_to is None:
            pad_to = self.bucket_length(max_len) if bucketed else max_len
        if max_len > pad_to:
            warnings.warn(
                f"EsmTokenizer: {sum(len(e) > pad_to for e in encs)} sequence(s) "
                f"longer than the pad/bucket cap {pad_to} were truncated (eos kept)",
                stacklevel=2)
            encs = [np.concatenate((e[: pad_to - 1], [EOS_ID])) if len(e) > pad_to
                    else e for e in encs]
        batch = np.full((len(encs), pad_to), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(encs), pad_to), dtype=np.int32)
        for row, e in enumerate(encs):
            batch[row, : len(e)] = e
            mask[row, : len(e)] = 1
        return {"input_ids": batch, "attention_mask": mask}
