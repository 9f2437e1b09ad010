"""Inference CLI of the port: decode wavs / a manifest with an experiment.

    python -m asr_chinese_e2e_tpu_torch.recognize --exp ckpt/<name> \
        --vocab data/vocab.json --manifest data/test.jsonl --beam_size 10 \
        --out results.json [--device cuda]

Same batches, output and CER line as the JAX package's ``recognize.py``:
duration-bucketed int16 batches padded to ``batch_size`` rows by
repeating row 0, features -> encoder -> batched beam search, and the
Kaldi-style n-best JSON ``{"utts": {id: {"output": [{"rec_text",
"rec_token", "score", "text"?}]}}}``. Only ``mode="beam"`` is ported; the
other modes, mesh decode and pipelined batches are ROADMAP items. Batches
run one after another.
"""

from __future__ import annotations

import json
import sys
import time
import wave as wavelib

import numpy as np
import torch

from .data.features import parse_batch
from .data.io import DEFAULT_BUCKET_SECONDS, load_wav
from .data.manifest import read_manifest
from .decode.beam import beam_search
from .decode.cer import corpus_cer
from .utils.cli import parse_kwargs
from .utils.experiment import load_experiment


def _num_samples(record) -> int:
    """Utterance length in samples: manifest ``frames`` if present, else a
    header read."""
    if "frames" in record:
        return int(record["frames"])
    with wavelib.open(record["wave"], "rb") as w:
        return w.getnframes()


def batched(
    records,
    batch_size,
    max_samples,
    sample_rate: int = 16000,
    bucket_seconds=DEFAULT_BUCKET_SECONDS,
):
    """Duration-bucketed decode batches with static shapes: each chunk is
    padded to its bucket's sample boundary and to ``batch_size`` rows
    (short chunks repeat row 0). Yields (chunk_records, wave (batch_size,
    boundary) int16, lengths int32); rows past ``len(chunk_records)`` are
    padding."""
    boundaries = sorted(
        {min(int(s * sample_rate), max_samples) for s in bucket_seconds}
    )
    if boundaries[-1] < max_samples:
        boundaries.append(max_samples)
    groups: dict[int, list] = {}
    for r in records:
        n = min(_num_samples(r), max_samples)
        b = next(x for x in boundaries if n <= x)
        groups.setdefault(b, []).append(r)
    for b in sorted(groups):
        rs = groups[b]
        for i in range(0, len(rs), batch_size):
            chunk = rs[i : i + batch_size]
            wave = np.zeros((batch_size, b), np.int16)
            lengths = np.zeros((batch_size,), np.int32)
            for j, r in enumerate(chunk):
                w = load_wav(r["wave"], dtype=np.int16)[:b]
                wave[j, : len(w)] = w
                lengths[j] = len(w)
            # pad rows duplicate row 0 (valid audio, no empty rows downstream)
            for j in range(len(chunk), batch_size):
                wave[j] = wave[0]
                lengths[j] = lengths[0]
            yield chunk, wave, lengths


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def recognize(
    exp: str,
    vocab: str,
    manifest: str = None,
    wav: str = None,
    mode: str = "beam",
    which: str = "best",
    beam_size: int = 10,
    nbest: int = 1,
    max_decode_len: int = 64,
    batch_size: int = 8,
    max_seconds: float = 15.0,
    length_penalty: float = 0.0,
    mesh_data: int = 0,
    out: str = None,
    device: str = "cuda",
    **_,
):
    """Decode and return ``{"utts": ..., "cer"?: ..., "timing": ...}``;
    ``timing`` (wall seconds of the encode and search phases, batch count
    and audio seconds) is returned but not written to ``out``."""
    if mode != "beam":
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (ROADMAP §1, items 2-3: joint and "
            "rescore decoding, the remaining recognize modes)"
        )
    if mesh_data:
        raise NotImplementedError(
            "mesh_data is not ported yet (ROADMAP §1, item 7: parallelism)"
        )
    dev = torch.device(device)
    model, _, feat_cfg, voc = load_experiment(exp, vocab, which, device=dev)
    if manifest:
        records = read_manifest(manifest)
    elif wav:
        records = [{"wave": w} for w in wav.split(",")]
    else:
        raise SystemExit("need --manifest or --wav")

    results = {"utts": {}}
    hyps_all, refs_all = [], []
    timing = {"batches": 0, "encode_s": 0.0, "search_s": 0.0, "audio_s": 0.0}
    max_samples = int(max_seconds * feat_cfg.sample_rate)
    for chunk, wave, lengths in batched(
        records, batch_size, max_samples, feat_cfg.sample_rate
    ):
        t0 = time.perf_counter()
        with torch.inference_mode():
            wave_d = torch.from_numpy(wave).to(dev)
            lengths_d = torch.from_numpy(lengths).to(dev)
            feats, feat_lens = parse_batch(wave_d, lengths_d, feat_cfg)
            enc_out, enc_lens = model.encode(feats, feat_lens)
        _sync(dev)
        t1 = time.perf_counter()
        res = beam_search(
            model, enc_out, enc_lens, beam_size, max_decode_len, length_penalty
        ).materialize()
        t2 = time.perf_counter()
        timing["batches"] += 1
        timing["encode_s"] += t1 - t0
        timing["search_s"] += t2 - t1
        timing["audio_s"] += float(lengths[: len(chunk)].sum()) / feat_cfg.sample_rate

        ids_nb = res.nbest_ids(nbest)
        for b, record in enumerate(chunk):
            utt_id = record["wave"].rsplit("/", 1)[-1].rsplit(".", 1)[0]
            outputs = []
            for rank, ids in enumerate(ids_nb[b]):
                toks = voc.ids_to_tokens(ids)
                entry = {
                    "rec_text": "".join(toks),
                    "rec_token": " ".join(toks),
                    "score": float(res.scores[b, rank]),
                }
                if "tgt" in record:
                    entry["text"] = record["tgt"]
                outputs.append(entry)
            results["utts"][utt_id] = {"output": outputs}
            best_text = outputs[0]["rec_text"]
            print(f"{utt_id}\t{best_text}")
            if "tgt" in record:
                hyps_all.append(best_text)
                refs_all.append(record["tgt"])

    if refs_all:
        cer = corpus_cer(hyps_all, refs_all)
        print(f"# CER: {cer:.2f}% over {len(refs_all)} utts", file=sys.stderr)
        results["cer"] = cer
    if out:
        with open(out, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)
        print(f"# wrote {out}", file=sys.stderr)
    results["timing"] = timing
    return results


def main():
    _, kwargs = parse_kwargs(sys.argv[1:])
    if kwargs.pop("help", False) or not kwargs:
        print(__doc__)
        return
    recognize(**kwargs)


if __name__ == "__main__":
    main()
