"""Host-side input pipeline: length-bucketed static-shape batching,
per-host sharding. A copy of the JAX package's jax-free
``data/batching.py`` (wav reading and the bucket boundaries live in
``data/io.py``); the PyTorch trainer keeps the static shapes, which keep
the number of distinct kernel shapes small.

Replaces the reference's DataLoader stack (``data/data_loader/ai_shell_1.py:
12-104``, ``Predictor/data_handler/padder.py:4-28``) with a TPU-first
design (SURVEY §7 risk register "static shapes vs variable-length audio"):

- the reference pads each batch to its own max length (``padder.py:4-28``),
  which would force an XLA recompile per batch; here utterances are bucketed
  by duration and every batch is padded to its bucket's fixed boundary, so
  there is exactly ONE compiled program per bucket;
- batches carry RAW waveforms — fbank/CMVN/LFR run on device inside the
  jitted step (the reference parses audio per-utterance on the host,
  ``processor.py:61-71``);
- ``drop_last`` semantics preserved (``ai_shell_1.py:103``) — required
  anyway so per-bucket global batch sizes are consistent across hosts;
- multi-host: each host reads a disjoint manifest shard under a shared
  seed (reference has no multi-host story, SURVEY §2.8).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np

from .io import DEFAULT_BUCKET_SECONDS, load_wav
from .manifest import read_manifest
from .vocab import Vocab

def _round_label_pad(n: int) -> int:
    """Label pad boundary for a bucket whose longest target is ``n`` tokens.

    The decoder runs at L+1 (BOS-prefixed teacher forcing), so pick L such
    that L+1 is a multiple of 8 — sublane-aligned decoder activations, the
    label-axis analogue of the time-axis capping in ``decode/joint.py``.
    """
    return max(7, -(-(n + 1) // 8) * 8 - 1)


@dataclasses.dataclass
class Batch:
    """One static-shape training batch (the ``Pack`` analogue,
    ``Predictor/Utils/pack.py:3-27``, as plain arrays)."""

    wave: np.ndarray  # (B, S) float32, zero-padded to bucket boundary
    wave_lengths: np.ndarray  # (B,) int32 valid sample counts
    labels: np.ndarray  # (B, L) int32, PAD(0)-padded
    label_lengths: np.ndarray  # (B,) int32
    texts: List[str]  # raw transcripts (for CER at eval cadence)
    bucket: int  # bucket boundary in samples (compile key)


class BucketedLoader:
    """Length-bucketed, shuffled, per-host-sharded batch iterator."""

    def __init__(
        self,
        manifest_path: str,
        vocab: Vocab,
        batch_size: int,
        max_target_len: int = 64,
        bucket_seconds: Sequence[float] = DEFAULT_BUCKET_SECONDS,
        sample_rate: int = 16000,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_hosts: int = 1,
        host_id: int = 0,
        max_frames: int | None = None,
        use_native_io: bool = True,
        io_threads: int = 8,
        prefetch: int = 2,
        feat_cfg=None,
        label_bucketing: bool = True,
        wire_dtype: str = "float32",
    ) -> None:
        """``feat_cfg``: when set AND the manifest rows carry a
        ``"feature"`` path (predumped features, the reference's
        ``pre_dump_features`` analogue, ``ai_shell_1.py:44-64``), batches
        hold cached (T, D) features instead of waveforms; ``frames`` is
        then a feature-frame count and bucket boundaries are converted
        accordingly. Feed such batches to a trainer built with
        ``raw_features=True``."""
        records = read_manifest(manifest_path)
        self.cached_features = bool(records) and "feature" in records[0]
        self.feat_cfg = feat_cfg
        if self.cached_features:
            assert feat_cfg is not None, "cached-feature manifest needs feat_cfg"
            self.boundaries = [
                int(feat_cfg.num_lfr_frames(feat_cfg.num_frames(int(s * sample_rate))))
                for s in bucket_seconds
            ]
            self.feature_dim = int(np.load(records[0]["feature"], mmap_mode="r").shape[1])
        else:
            self.boundaries = [int(s * sample_rate) for s in bucket_seconds]
        max_samples = self.boundaries[-1]
        kept = []
        bucket_label_max: dict[int, int] = {}
        for r in records:
            n = r.get("frames", -1)
            if n < 0:
                n = max_samples  # unknown length -> top bucket
            if max_frames is not None and n > max_frames:
                continue  # the reference's (commented) length filter
            if n > max_samples:
                continue
            n_tok = len(vocab.str_to_ids(r["tgt"]))
            if n_tok > max_target_len:
                continue
            kept.append((r, n))
            b = self._bucket_of(n)
            bucket_label_max[b] = max(bucket_label_max.get(b, 0), n_tok)
        self.records = kept
        # per-bucket label pad boundary computed over the FULL manifest so
        # every host pads identically (lockstep shapes). Padding labels to
        # the bucket's real max (rounded, _round_label_pad) instead of
        # max_target_len keeps ONE program per bucket while running the
        # decoder/CE at ~batch-scale L, not the global cap (the label-axis
        # analogue of pad-to-bucket on the time axis; round-2 VERDICT #1).
        self.label_boundaries = {
            b: min(max_target_len, _round_label_pad(mx))
            for b, mx in bucket_label_max.items()
        } if label_bucketing else {}
        self.vocab = vocab
        self.batch_size = batch_size
        self.max_target_len = max_target_len
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.io_threads = io_threads
        self.prefetch = prefetch
        # "int16" ships raw PCM16 samples to the device (half the
        # host->device bytes of float32 — significant when the transfer
        # link, not HBM, is the wire); ``features.parse_batch`` scales by
        # 1/32768 on device, bit-exact vs the float path for mono audio
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be float32|int16, got {wire_dtype}")
        self.wire_dtype = wire_dtype
        self._native = None
        if use_native_io:
            from . import native

            if native.available():
                self._native = native

    def _bucket_of(self, n_samples: int) -> int:
        for b in self.boundaries:
            if n_samples <= b:
                return b
        return self.boundaries[-1]

    def __len__(self) -> int:
        """Exact number of batches this host emits per epoch — identical on
        every host, and independent of the shuffle order (global per-bucket
        counts do not depend on the permutation)."""
        counts: dict[int, int] = {}
        for _, n in self.records:
            b = self._bucket_of(n)
            counts[b] = counts.get(b, 0) + 1
        gsz = self.batch_size * self.num_hosts
        if self.drop_last or self.num_hosts > 1:
            return sum(c // gsz for c in counts.values())
        return sum(-(-c // gsz) for c in counts.values())

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """Deterministic per-epoch stream (see ``_global_batches`` for the
        multi-host lockstep guarantee). Batches are assembled ``prefetch``
        ahead on a background thread so decode/IO overlaps device compute."""
        if self.prefetch > 0:
            yield from _prefetched(self._epoch_sync(epoch), self.prefetch)
        else:
            yield from self._epoch_sync(epoch)

    def _global_batches(self, epoch: int) -> Iterator[tuple]:
        """The GLOBAL per-epoch batch schedule, derived purely from
        (seed, epoch): shuffle the full record list, fill buckets in stream
        order, emit a global batch of ``batch_size * num_hosts`` records
        when a bucket fills. Every host computes this same schedule and
        takes its own contiguous slice of each global batch, so all hosts
        emit the SAME number of batches in the SAME bucket order — an SPMD
        requirement: one host seeing fewer/other-shaped steps deadlocks
        every collective (round-2 VERDICT #3; the hazard is absent from the
        reference only because it has no multi-host story, SURVEY §2.8).

        ``drop_last=False`` tail batches are only emitted single-host;
        under multiple hosts a partial global batch cannot be split into
        equal per-host shapes, so it is dropped regardless.

        Tail batches compile one extra XLA program per (bucket, tail-size)
        pair — bounded by n_buckets per corpus since the tail size is a
        function of the corpus, not the epoch. Padding tails to full rows
        was considered and rejected: duplicated rows bias every
        batch-mean metric (eval exactness tests would break) and
        zero-length rows NaN the attention softmax (all positions masked).
        Training/eval default to ``drop_last=True`` (reference parity,
        ``ai_shell_1.py:103``); full-coverage decoding uses
        ``recognize.batched``'s padded chunks, which DO pad (duplicating
        row 0) because the decode path drops pad rows on host and
        computes no batch-mean metrics on device.
        """
        order = np.arange(len(self.records))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        gsz = self.batch_size * self.num_hosts
        pending: dict[int, list] = {}
        for idx in order:
            record, n = self.records[idx]
            b = self._bucket_of(n)
            pending.setdefault(b, []).append((record, n))
            if len(pending[b]) == gsz:
                yield b, pending.pop(b)
        if not self.drop_last and self.num_hosts == 1:
            for b, items in pending.items():
                if items:
                    yield b, items

    def _epoch_sync(self, epoch: int = 0) -> Iterator[Batch]:
        lo = self.host_id * self.batch_size
        hi = lo + self.batch_size
        for b, items in self._global_batches(epoch):
            local = items[lo:hi] if self.num_hosts > 1 else items
            yield self._collate(local, b)

    def _collate(self, items: list, boundary: int) -> Batch:
        """Pad waves to the bucket boundary and targets to the bucket's
        label boundary (the ``collat`` analogue, ``ai_shell_1.py:67-88`` —
        minus the per-batch-max padding and the host->GPU copy). Wav decode
        goes through the native C++ threadpool when available."""
        bsz = len(items)
        label_pad = self.label_boundaries.get(boundary, self.max_target_len)
        labels = np.zeros((bsz, label_pad), dtype=np.int32)
        label_lengths = np.zeros((bsz,), dtype=np.int32)
        texts = []
        if self.cached_features:
            wave = np.zeros((bsz, boundary, self.feature_dim), dtype=np.float32)
            wave_lengths = np.zeros((bsz,), dtype=np.int32)
            for i, (record, _) in enumerate(items):
                x = np.load(record["feature"])
                n = min(len(x), boundary)
                wave[i, :n] = x[:n]
                wave_lengths[i] = n
        elif self._native is not None:
            read = (
                self._native.read_wav_batch_i16
                if self.wire_dtype == "int16"
                else self._native.read_wav_batch
            )
            wave, wave_lengths = read(
                [record["wave"] for record, _ in items],
                boundary,
                num_threads=self.io_threads,
            )
            wave_lengths = wave_lengths.astype(np.int32)
        else:
            dt = np.int16 if self.wire_dtype == "int16" else np.float32
            wave = np.zeros((bsz, boundary), dtype=dt)
            wave_lengths = np.zeros((bsz,), dtype=np.int32)
            for i, (record, _) in enumerate(items):
                x = load_wav(record["wave"], dtype=dt)
                n = min(len(x), boundary)
                wave[i, :n] = x[:n]
                wave_lengths[i] = n
        for i, (record, _) in enumerate(items):
            ids = self.vocab.str_to_ids(record["tgt"])  # no bos/eos
            label_lengths[i] = len(ids)
            labels[i, : len(ids)] = ids
            texts.append(record["tgt"])
        return Batch(wave, wave_lengths, labels, label_lengths, texts, boundary)


def _prefetched(it: Iterator[Batch], depth: int) -> Iterator[Batch]:
    """Run ``it`` on a daemon thread, buffering ``depth`` batches."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # surface errors on the consumer side
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
