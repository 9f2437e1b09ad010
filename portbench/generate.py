"""The one traffic generator: reads a mix file (``traffic/<mix>.json``) and
makes its clips, transcripts and batches from the run's seed.

Every seed gets the same set of clip durations: the quantiles (i + 0.5) / n
of a log-normal of the mix's mean and sigma, clipped to the mix's range.
The seed changes the order in which they come, which clips share a batch,
the waveforms (Gaussian noise at the mix's RMS, int16) and the transcripts'
ids (uniform in the mix's id range, ``chars_per_s`` x duration of them,
rounded, at least one). So the work a run does is the same for every seed.

Training batches follow the port's ``BucketedLoader``: clips grouped by the
smallest duration boundary that holds them, waves zero-padded to the
boundary, labels to the bucket's label boundary (L + 1 a multiple of 8, at
least 7, at most ``max_target_len``; the rule is copied from
``data/batching.py::_round_label_pad``). A batch holds ``batch`` clips or,
where the mix gives ``batch_seconds`` instead, as many clips as fill that
many padded seconds at its boundary (a batch of frames, as ESPnet's
``batch_bins`` sizes one). A bucket gets a number of batches in proportion
to its share of the clips over its clips a batch (largest remainders,
``pool_batches`` in all)."""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

SAMPLE_RATE = 16000


def _lognormal(mix: dict):
    d = mix["duration"]
    sigma = float(d["sigma"])
    mu = math.log(float(d["mean_s"])) - sigma * sigma / 2.0
    return mu, sigma, float(d["min_s"]), float(d["max_s"])


def _quantile(mu, sigma, lo, hi, q: float) -> float:
    return min(hi, max(lo, math.exp(mu + sigma * NormalDist().inv_cdf(q))))


def durations(mix: dict, n: int) -> list:
    """The mix's n clip durations in seconds, ascending."""
    mu, sigma, lo, hi = _lognormal(mix)
    return [_quantile(mu, sigma, lo, hi, (i + 0.5) / n) for i in range(n)]


def label_length(mix: dict, seconds: float) -> int:
    return max(1, int(round(mix["chars_per_s"] * seconds)))


def round_label_pad(n: int) -> int:
    return max(7, -(-(n + 1) // 8) * 8 - 1)


def _clips_a_batch(mix: dict, boundary: float) -> int:
    if "batch" in mix:
        return int(mix["batch"])
    return int(float(mix["batch_seconds"]) // boundary)


def _bucket_batches(mix: dict) -> list:
    """[(boundary seconds, (lo, hi] cdf range, batches)] of a training mix."""
    mu, sigma, lo, hi = _lognormal(mix)
    cdf = lambda s: NormalDist().cdf((math.log(s) - mu) / sigma)
    bounds = [float(b) for b in mix["bucket_seconds"]]
    edges, prev = [], 0.0
    for b in bounds:
        top = 1.0 if b >= hi else cdf(b)
        edges.append((b, prev, top))
        prev = top
    total = int(mix["pool_batches"])
    weight = [(top - bot) / _clips_a_batch(mix, b) for b, bot, top in edges]
    exact = [w / sum(weight) * total for w in weight]
    counts = [int(x) for x in exact]
    for i in sorted(range(len(exact)), key=lambda i: counts[i] - exact[i])[: total - sum(counts)]:
        counts[i] += 1
    return [(b, bot, top, c) for (b, bot, top), c in zip(edges, counts) if c > 0]


def _waves(lengths, width: int, rms: float, gen: torch.Generator, device) -> torch.Tensor:
    """(n, width) int16 noise on ``device``, zero past each length."""
    n = len(lengths)
    x = torch.randn((n, width), generator=gen, device=device) * (rms * 32768.0)
    x = x.round_().clamp_(-32768, 32767)
    valid = torch.arange(width, device=device)[None, :] < torch.tensor(lengths, device=device)[:, None]
    return (x * valid).to(torch.int16)


def _labels(rng: np.random.Generator, mix: dict, n_tokens: list, width: int) -> np.ndarray:
    lo, hi = mix["label_ids"]
    out = np.zeros((len(n_tokens), width), np.int32)
    for i, n in enumerate(n_tokens):
        out[i, :n] = rng.integers(lo, hi, size=n)
    return out


def train_pool(mix: dict, seed: int, device) -> list:
    """The mix's pool of training batches in the seed's order: dicts of
    host numpy arrays (``wave`` int16 (B, S), ``wave_lengths``, ``labels``
    (B, L), ``label_lengths``) and ``audio_s``, the batch's unpadded
    seconds."""
    mu, sigma, lo, hi = _lognormal(mix)
    rng = np.random.default_rng(int(seed))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    pool = []
    for boundary, bot, top, count in _bucket_batches(mix):
        bsz = _clips_a_batch(mix, boundary)
        n = count * bsz
        secs = [_quantile(mu, sigma, lo, hi, bot + (i + 0.5) / n * (top - bot)) for i in range(n)]
        secs = [secs[i] for i in rng.permutation(n)]
        width = int(boundary * SAMPLE_RATE)
        n_tok = [label_length(mix, s) for s in secs]
        label_pad = min(int(mix["max_target_len"]), round_label_pad(max(n_tok)))
        for j in range(count):
            part = slice(j * bsz, (j + 1) * bsz)
            lens = [min(width, int(round(s * SAMPLE_RATE))) for s in secs[part]]
            toks = n_tok[part]
            pool.append({
                "wave": _waves(lens, width, mix["rms"], gen, device).cpu().numpy(),
                "wave_lengths": np.asarray(lens, np.int32),
                "labels": _labels(rng, mix, toks, label_pad),
                "label_lengths": np.asarray(toks, np.int32),
                "audio_s": sum(lens) / SAMPLE_RATE,
            })
    return [pool[i] for i in rng.permutation(len(pool))]


def clips(mix: dict, seed: int, device) -> list:
    """The mix's ``clips`` decode clips in the seed's order: int16 numpy
    arrays of their own lengths."""
    n = int(mix["clips"])
    rng = np.random.default_rng(int(seed))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    secs = durations(mix, n)
    secs = [secs[i] for i in rng.permutation(n)]
    lens = [int(round(s * SAMPLE_RATE)) for s in secs]
    out = []
    for start in range(0, n, 128):
        part = lens[start : start + 128]
        waves = _waves(part, max(part), mix["rms"], gen, device).cpu().numpy()
        out += [waves[i, :m].copy() for i, m in enumerate(part)]
    return out
