"""Character-level vocabulary with the reference's special-token contract.

Parity with ``Predictor/data_handler/vocab.py:8-85``:
- char tokenizer (``tokenize_fn = list(str)``, ``vocab.py:4-5``);
- specials PAD='$'->0, UNK='%'->1, BOS='^'->2, EOS='&'->3 (``vocab.py:10-17``)
  — the decoder hard-codes sos=2 / eos=3
  (``Predictor/Models/transformer_official.py:53-54``) and CE uses
  ignore_index=0==PAD (``Predictor/Utils/loss.py:5,47-49``), so this ordering
  is a framework-wide invariant;
- ``build(min_count=1, max_vocab=20000)`` keeps the most common tokens
  (``vocab.py:29-34``);
- ``ids_to_str`` strips PAD and space-joins (``vocab.py:75-79``) — the CER
  metric depends on this exact detokenisation.

Persistence is JSON (not a torch pickle as in ``vocab.py:36-53``).

CTC note: the blank symbol reuses id 0 (PAD). PAD never occurs inside a
label sequence (labels carry explicit lengths), so the ids are disjoint in
practice and blank=0 matches the optax/jax CTC convention.
"""

from __future__ import annotations

import hashlib
import json
from collections import Counter
from typing import Iterable, List, Sequence

PAD_ID = 0
UNK_ID = 1
BOS_ID = 2
EOS_ID = 3
BLANK_ID = 0  # CTC blank; shares id 0 with PAD (see module docstring)

IGNORE_ID = PAD_ID  # CE ignore index (``Predictor/Utils/loss.py:5``)


def tokenize_chars(text: str) -> List[str]:
    return list(text)


class Vocab:
    def __init__(
        self,
        pad: str = "$",
        unk: str = "%",
        bos: str = "^",
        eos: str = "&",
    ) -> None:
        self._counter: Counter = Counter()
        self.pad, self.unk, self.bos, self.eos = pad, unk, bos, eos
        self._token2id = {t: i for i, t in enumerate([pad, unk, bos, eos])}
        self._id2token: List[str] | None = None

    # -- building ---------------------------------------------------------
    def consume_sentence(self, sentence: str) -> None:
        self._counter.update(tokenize_chars(sentence))

    def consume_sentence_list(self, sentences: Iterable[str]) -> None:
        for s in sentences:
            self.consume_sentence(s)

    def build(self, min_count: int = 1, max_vocab: int = 20000) -> "Vocab":
        for token, count in self._counter.most_common(max_vocab):
            if count >= min_count and token not in self._token2id:
                self._token2id[token] = len(self._token2id)
        self._id2token = list(self._token2id)
        return self

    # -- conversion -------------------------------------------------------
    def str_to_ids(self, text: str, use_bos: bool = False, use_eos: bool = False) -> List[int]:
        """Tokenize and map to ids (``vocab.py:55-66``). The training dataset
        uses use_bos=False / use_eos=False (``data/data_loader/ai_shell_1.py:52-53``);
        the decoder re-adds sos/eos itself (``transformer_official.py:260-275``)."""
        tokens = tokenize_chars(text)
        if use_bos:
            tokens = [self.bos] + tokens
        if use_eos:
            tokens = tokens + [self.eos]
        return [self._token2id.get(t, UNK_ID) for t in tokens]

    def ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        assert self._id2token is not None, "vocab not built"
        return [self._id2token[i] for i in ids]

    def ids_to_str(self, ids: Sequence[int]) -> str:
        """PAD-stripping, space-joined detok (``vocab.py:75-79``). CER parity
        depends on this normalisation (``Predictor/Utils/score.py:4-13``)."""
        assert self._id2token is not None, "vocab not built"
        pad_id = self._token2id[self.pad]
        return " ".join(self._id2token[i] for i in ids if i != pad_id)

    @property
    def vocab_size(self) -> int:
        return len(self._token2id)

    def fingerprint(self) -> str:
        """Stable hash of the id mapping, stored in checkpoints so resume can
        verify the vocab matches (new capability; reference has none)."""
        assert self._id2token is not None, "vocab not built"
        payload = json.dumps(self._id2token, ensure_ascii=False).encode()
        return hashlib.sha256(payload).hexdigest()[:16]

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        assert self._id2token is not None, "vocab not built"
        blob = {
            "id2token": self._id2token,
            "specials": [self.pad, self.unk, self.bos, self.eos],
        }
        with open(path, "w") as f:
            json.dump(blob, f, ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            blob = json.load(f)
        pad, unk, bos, eos = blob["specials"]
        obj = cls(pad, unk, bos, eos)
        obj._id2token = blob["id2token"]
        obj._token2id = {t: i for i, t in enumerate(blob["id2token"])}
        return obj
