"""Inference CLI of the port: decode wavs / a manifest with an experiment.

    python -m asr_chinese_e2e_tpu_torch.recognize --exp ckpt/<name> \
        --vocab data/vocab.json --manifest data/test.jsonl --mode beam \
        --beam_size 10 --out results.json [--device cuda]

Same batches, modes, output and CER line as the JAX package's
``recognize.py``: duration-bucketed int16 batches padded to ``batch_size``
rows by repeating row 0, features -> encoder -> the mode's search, and the
Kaldi-style n-best JSON ``{"utts": {id: {"output": [{"rec_text",
"rec_token", "score", "text"?}]}}}``.

Modes: ctc_greedy | attention_greedy | beam | rescore | joint (``rescore``:
CTC prefix beam, ``ctc_beam_impl`` "device" (tensors on the card) or
"host" (the exact numpy search), then attention rescoring; ``joint``: the
one-pass joint CTC/attention beam, ``ctc_weight`` and ``ctc_prune``).
``pipeline_depth`` batches are dispatched before the oldest is drained,
with the wav reading on a prefetch thread; 0 runs batch after batch.

``mesh_data`` (> 0, or -1 for every rank): data-parallel decode across
processes, one per device, launched by ``torchrun`` (``python -m torch.
distributed.run --nproc_per_node N -m asr_chinese_e2e_tpu_torch.recognize
... --mesh_data N``). In ``beam`` mode each rank encodes and searches its
rows of each batch and ``decode/distributed.py::distributed_beam_search``
gathers the n-best, which equals one process's; the other modes decode
every batch whole on each rank. Rank 0 alone prints and writes ``out``.
``batch_size`` must divide the data axis.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import sys
import time
import wave as wavelib

import numpy as np
import torch

from .data.batching import _prefetched
from .data.features import parse_batch
from .data.io import DEFAULT_BUCKET_SECONDS, load_wav
from .data.manifest import read_manifest
from .decode.beam import beam_search
from .decode.cer import corpus_cer
from .decode.ctc_prefix import attention_rescore, ctc_prefix_beam_batch
from .decode.ctc_prefix_device import ctc_prefix_beam_device, device_nbest_to_lists
from .decode.greedy import attention_greedy_decode, ctc_greedy_decode, tokens_to_ids
from .decode.distributed import distributed_beam_search
from .decode.joint import joint_beam_search
from .parallel.sharding import batch_rows, initialize_distributed, local_rank, make_mesh
from .utils.cli import parse_kwargs
from .utils.debug import annotate
from .utils.experiment import CKPT_DIR, load_experiment


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


MODES = ("ctc_greedy", "attention_greedy", "beam", "rescore", "joint")
_EXP_CACHE: dict = {}
_CALLS = itertools.count()  # the request id of each call's spans


def _mtime(path: str) -> float:
    return os.path.getmtime(path) if os.path.exists(path) else 0.0


def _load_experiment_cached(exp, vocab, which, device):
    """Memoized ``load_experiment``: repeated ``recognize`` calls in one
    process reuse one model on ``device`` and restore the checkpoint once.
    Keyed on the modification times of the training index and of the
    port's checkpoint directory, so a new save or export reloads."""
    key = (
        os.path.abspath(exp), os.path.abspath(vocab), which, str(device),
        _mtime(os.path.join(exp, "checkpoints", "index.json")),
        _mtime(os.path.join(exp, CKPT_DIR)),
    )
    if key not in _EXP_CACHE:
        _EXP_CACHE[key] = load_experiment(exp, vocab, which, device=device)
    return _EXP_CACHE[key]


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
    ctc_weight: float = 0.3,
    length_penalty: float = 0.0,
    ctc_beam_impl: str = "device",
    ctc_prune: int = 30,
    mesh_data: int = 0,
    pipeline_depth: int = 1,
    out: str = None,
    device: str = "cuda",
    **_,
):
    """Decode and return ``{"utts": ..., "cer"?: ..., "timing": ...}``;
    ``timing`` (wall seconds of the encode and search phases, batch count
    and audio seconds) is returned but not written to ``out``."""
    with annotate("recognize", request=next(_CALLS)):
        if mode not in MODES:
            raise SystemExit(f"unknown mode {mode}")
        dev = torch.device(device)
        mesh, writer = None, True
        if mesh_data:
            world, rank = initialize_distributed(backend="gloo" if dev.type == "cpu" else None)
            if mesh_data not in (-1, world):
                raise SystemExit(f"mesh_data {mesh_data} needs as many processes (torchrun); "
                                 f"this run has {world}")
            mesh = make_mesh(data=mesh_data)
            if batch_size % mesh.shape["data"]:
                raise SystemExit(f"batch_size {batch_size} not divisible by mesh_data "
                                 f"{mesh.shape['data']}")
            writer = rank == 0
            if dev.type == "cuda" and world > 1:
                dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
        sharded = mesh is not None and mesh.shape["data"] > 1 and mode == "beam"
        model, _, feat_cfg, voc = _load_experiment_cached(exp, vocab, which, dev)
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

        def search(enc_out, enc_lens):
            """The mode's search on one batch; returns what ``drain`` reads."""
            if mode == "ctc_greedy":
                return model.ctc_log_probs(enc_out), enc_lens
            if mode == "attention_greedy":
                return attention_greedy_decode(model, enc_out, enc_lens, max_decode_len)
            if mode == "beam":
                if sharded:
                    return distributed_beam_search(
                        model, enc_out, enc_lens, beam_size, max_decode_len, mesh,
                        length_penalty, local_rows=True,
                    )
                return beam_search(
                    model, enc_out, enc_lens, beam_size, max_decode_len, length_penalty
                )
            if mode == "joint":
                return joint_beam_search(
                    model, enc_out, enc_lens, beam_size, max_decode_len,
                    ctc_weight=ctc_weight, ctc_prune=ctc_prune,
                )
            # rescore: the host n-best feeds the rescoring forward, so this
            # mode drains here
            with annotate("rescore.ctc_log_probs"):
                lp = model.ctc_log_probs(enc_out)
            if ctc_beam_impl == "device":
                with annotate("rescore.prefix_beam"):
                    beam = ctc_prefix_beam_device(lp, enc_lens, beam_size=beam_size)
                with annotate("rescore.nbest_to_host"):
                    ctc_nbest = device_nbest_to_lists(*beam)
            else:
                with annotate("sync.rescore.log_probs"):
                    lp_host, lens_host = lp.cpu().numpy(), enc_lens.cpu().numpy()
                with annotate("rescore.prefix_beam"):
                    ctc_nbest = ctc_prefix_beam_batch(lp_host, lens_host, beam_size)
            with annotate("rescore.forward"):
                best = attention_rescore(model, enc_out, enc_lens, ctc_nbest, ctc_weight)
            return [[(ids, 0.0)] for ids in best]

        def dispatch(chunk, wave, lengths):
            """Features, encoder and the mode's search for one batch; reads
            nothing back but what the search itself syncs on."""
            # the spans recognize.encode and recognize.search sit at the
            # bounds of timing's encode_s and (less the drain) search_s
            with annotate("recognize.encode"):
                t0 = time.perf_counter()
                audio_s = float(lengths[: len(chunk)].sum()) / feat_cfg.sample_rate
                if sharded:  # this rank's rows of the batch
                    rows = batch_rows(mesh, len(wave))
                    wave, lengths = wave[rows], lengths[rows]
                with torch.inference_mode():
                    with annotate("sync.recognize.batch_to_device"):  # pageable copies
                        wave_d = torch.from_numpy(wave).to(dev)
                        lengths_d = torch.from_numpy(lengths).to(dev)
                    feats, feat_lens = parse_batch(wave_d, lengths_d, feat_cfg)
                    enc_out, enc_lens = model.encode(feats, feat_lens)
                    with annotate("sync.recognize.encode"):
                        _sync(dev)
                t1 = time.perf_counter()
            with annotate("recognize.search"), torch.inference_mode():
                pending = search(enc_out, enc_lens)
            timing["batches"] += 1
            timing["encode_s"] += t1 - t0
            timing["search_s"] += time.perf_counter() - t1
            timing["audio_s"] += audio_s
            return chunk, pending

        def drain(chunk, pending):
            """Read one batch's results back: per utterance [(ids, score)]."""
            t0 = time.perf_counter()
            if mode == "ctc_greedy":
                nbest_out = [[(ids, 0.0)] for ids in ctc_greedy_decode(*pending)]
            elif mode == "attention_greedy":
                tokens, scores = pending
                nbest_out = [
                    [(ids, float(s))]
                    for ids, s in zip(tokens_to_ids(tokens), scores.cpu().numpy())
                ]
            elif mode in ("beam", "joint"):
                ids_nb = pending.nbest_ids(nbest)
                nbest_out = [
                    [(ids, float(pending.scores[b, k])) for k, ids in enumerate(ids_nb[b])]
                    for b in range(len(chunk))
                ]
            else:  # rescore drained in dispatch
                nbest_out = pending
            timing["search_s"] += time.perf_counter() - t0
            return nbest_out

        def consume(chunk, nbest_out):
            for record, hyps in zip(chunk, nbest_out):
                utt_id = record["wave"].rsplit("/", 1)[-1].rsplit(".", 1)[0]
                outputs = []
                for ids, score in hyps:
                    toks = voc.ids_to_tokens(ids)
                    entry = {
                        "rec_text": "".join(toks),
                        "rec_token": " ".join(toks),
                        "score": score,
                    }
                    if "tgt" in record:
                        entry["text"] = record["tgt"]
                    outputs.append(entry)
                results["utts"][utt_id] = {"output": outputs}
                best_text = outputs[0]["rec_text"]
                if writer:
                    print(f"{utt_id}\t{best_text}")
                if "tgt" in record:
                    hyps_all.append(best_text)
                    refs_all.append(record["tgt"])

        chunks = batched(records, batch_size, max_samples, feat_cfg.sample_rate)
        if pipeline_depth > 0:
            chunks = _prefetched(chunks, depth=max(2, pipeline_depth + 1))
        pending_q: collections.deque = collections.deque()

        def drain_oldest():
            c, p = pending_q.popleft()
            with annotate("recognize.drain"):
                nbest_out = drain(c, p)
            with annotate("recognize.consume"):
                consume(c, nbest_out)

        chunks = iter(chunks)
        while True:
            with annotate("recognize.next_batch"):  # wav reads and row padding
                item = next(chunks, None)
            if item is None:
                break
            with annotate("recognize.dispatch"):
                pending_q.append(dispatch(*item))
            while len(pending_q) > pipeline_depth:
                drain_oldest()
        while pending_q:
            drain_oldest()

        if refs_all:
            cer = corpus_cer(hyps_all, refs_all)
            if writer:
                print(f"# CER: {cer:.2f}% over {len(refs_all)} utts", file=sys.stderr)
            results["cer"] = cer
        if out and writer:
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
