"""AISHELL-1 manifest building (host-side, offline).

Parity with ``data/data_collector/ai_shell_1.py:10-79``:
- walk ``wav/{train,dev,test}/S*/*.wav``;
- join utterance ids against ``transcript/aishell_transcript_v0.8.txt``
  (id = wav basename without extension; text = remaining whitespace-joined
  columns with inner spaces removed, ``ai_shell_1.py:26-36``);
- drop wavs that have no transcript line (``ai_shell_1.py:44-52``);
- emit JSONL ``{"wave": <path>, "tgt": <text>}`` per split
  (``ai_shell_1.py:73-79``).

Extension over the reference (per SURVEY §2.1): each record also carries
``"frames"`` — the utterance sample count read from the wav header — so the
batcher can length-bucket without touching audio payloads.
"""

from __future__ import annotations

import json
import os
import wave as wavelib
from typing import Dict, Iterable, List

from .vocab import Vocab

SPLITS = ("train", "dev", "test")


def load_transcript(path: str) -> Dict[str, str]:
    """Parse ``aishell_transcript_v0.8.txt``: ``<utt_id> <ch> <ch> ...`` →
    {utt_id: text-with-no-spaces} (``ai_shell_1.py:26-36``)."""
    table: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            table[parts[0]] = "".join(parts[1:])
    return table


def wav_num_samples(path: str) -> int:
    """Sample count from the wav header only (no payload read)."""
    try:
        with wavelib.open(path, "rb") as w:
            return w.getnframes()
    except (wavelib.Error, EOFError, OSError):
        return -1


class AiShell1Collector:
    """Builds per-split manifests + the char vocab from the train split."""

    def __init__(self, root: str, transcript: str | None = None) -> None:
        self.root = root
        transcript = transcript or os.path.join(
            root, "transcript", "aishell_transcript_v0.8.txt"
        )
        self.transcript = load_transcript(transcript)
        self.items: Dict[str, List[dict]] = {s: self._collect(s) for s in SPLITS}

    def _collect(self, split: str) -> List[dict]:
        split_dir = os.path.join(self.root, "wav", split)
        records: List[dict] = []
        if not os.path.isdir(split_dir):
            return records
        for speaker in sorted(os.listdir(split_dir)):
            spk_dir = os.path.join(split_dir, speaker)
            if not os.path.isdir(spk_dir):
                continue
            for name in sorted(os.listdir(spk_dir)):
                if not name.endswith(".wav"):
                    continue
                utt_id = name[: -len(".wav")]
                text = self.transcript.get(utt_id)
                if text is None:  # drop untranscribed wavs (ai_shell_1.py:47-52)
                    continue
                path = os.path.join(spk_dir, name)
                records.append(
                    {"wave": path, "tgt": text, "frames": wav_num_samples(path)}
                )
        return records

    def build_vocab(self, min_count: int = 1, max_vocab: int = 20000) -> Vocab:
        """Vocab from TRAIN transcripts only (``ai_shell_1.py:66-71``)."""
        vocab = Vocab()
        vocab.consume_sentence_list(r["tgt"] for r in self.items["train"])
        return vocab.build(min_count=min_count, max_vocab=max_vocab)

    def save(self, out_dir: str) -> Dict[str, str]:
        os.makedirs(out_dir, exist_ok=True)
        paths = {}
        for split, records in self.items.items():
            path = os.path.join(out_dir, f"{split}.jsonl")
            write_manifest(path, records)
            paths[split] = path
        return paths


def write_manifest(path: str, records: Iterable[dict]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


def read_manifest(path: str) -> List[dict]:
    """Read a JSONL manifest (``data/data_loader/ai_shell_1.py:93-94``)."""
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]
