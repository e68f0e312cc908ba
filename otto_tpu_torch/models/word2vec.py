"""Item-embedding models: the vocabulary and the trained table.

Counterpart of the model container of otto_tpu/models/word2vec.py:
`Vocab`, `build_vocab` and `Word2Vec` with `embedding_by_aid`, `save`
and `load`. `load` reads the `.npz` that otto_tpu's `Word2Vec.save`
writes, and `save` writes the same file. The SGNS trainer is not ported
yet. Host-side numpy, as in otto_tpu: the kNN and session-embedding
stages move the table to their device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np

from otto_tpu_torch.config import Word2VecConfig
from otto_tpu_torch.data.schema import Events


class Vocab(NamedTuple):
    """aid <-> dense word-index maps, most frequent word first."""

    aid_of_word: np.ndarray   # [V] int32: word idx -> aid
    word_of_aid: np.ndarray   # [n_aids] int32: aid -> word idx, -1 if absent
    counts: np.ndarray        # [V] int64 word frequencies

    @property
    def size(self) -> int:
        return len(self.aid_of_word)


def build_vocab(
    ev: Events, types: Tuple[int, ...], min_count: int,
    n_aids: Optional[int] = None,
) -> Vocab:
    """The words are the aids seen at least `min_count` times in events of
    `types`, by count descending, ties by aid."""
    m = np.isin(ev.type, np.asarray(types, np.int8))
    aids = ev.aid[m]
    n_aids = n_aids or (int(ev.aid.max()) + 1)
    counts = np.bincount(aids, minlength=n_aids)
    kept_aids = np.nonzero(counts >= min_count)[0]
    order = np.argsort(-counts[kept_aids], kind="stable")
    aid_of_word = kept_aids[order].astype(np.int32)
    word_of_aid = np.full(n_aids, -1, np.int32)
    word_of_aid[aid_of_word] = np.arange(len(aid_of_word), dtype=np.int32)
    return Vocab(aid_of_word, word_of_aid, counts[aid_of_word].astype(np.int64))


@dataclasses.dataclass
class Word2Vec:
    """A trained model: vocabulary + input embeddings."""

    cfg: Word2VecConfig
    vocab: Vocab
    emb: np.ndarray  # [V, dim] float32, row i is word i

    def embedding_by_aid(self, n_aids: int) -> np.ndarray:
        """[n_aids, dim] float32 table by aid, zeros for aids without a
        word."""
        out = np.zeros((n_aids, self.emb.shape[1]), np.float32)
        out[self.vocab.aid_of_word] = self.emb
        return out

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            aid_of_word=self.vocab.aid_of_word,
            word_of_aid=self.vocab.word_of_aid,
            counts=self.vocab.counts,
            emb=self.emb,
        )

    @staticmethod
    def load(path: str, cfg: Word2VecConfig) -> "Word2Vec":
        z = np.load(path)
        vocab = Vocab(z["aid_of_word"], z["word_of_aid"], z["counts"])
        emb = z["emb"]
        if emb.ndim != 2 or emb.shape[0] != vocab.size:
            raise ValueError(
                f"{path}: emb {emb.shape} does not match {vocab.size} words"
            )
        return Word2Vec(cfg, vocab, emb)
