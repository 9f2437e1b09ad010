"""Calls of the port's ``recognize.recognize`` (traffic ``driver:
recognize_calls``), one client in a closed loop.

Set-up makes the weights from the seed and writes, under the run's scratch
directory, an experiment that ``recognize`` loads (the vocabulary,
``config.json``, ``torch_checkpoints/best.pt``), the mix's clips as int16
wavs and, for ``request: corpus``, one manifest of all of them. It warms
up with one call over a clip of every padded length the mix uses (the
first call also loads the experiment, which ``recognize`` keeps).

``request: corpus``: each call decodes the whole manifest (a job); the
window makes whole calls until ``--seconds`` have passed and runs from the
first call's start to the last call's end: ``decode_audio_s_per_s``.
``request: clip``: each call decodes one clip, the next sent when the last
returns, the clips in the seed's order: ``decode_request_p95_ms`` over
every request of the window. The per-utterance lines ``recognize`` prints
go to a null sink. With ``--trace 1`` a further ``trace_calls`` calls run
under the profiler.

After the window the program's model is dropped and the plain reference
(``reference/decode.py``) takes a sample, drawn from the seed, of the
requests answered in the window, with the longest clip in it, and judges
each served hypothesis (``checks`` below)."""

from __future__ import annotations

import contextlib
import json
import os
import time
import wave as wavelib

import numpy as np
import torch

from .. import checks, generate, port
from ..common import (bucket_of, decode_boundaries, free_cuda, log, peak_bytes, spread_line,
                      sync)
from ..reference import decode as refdec
from ..reference.model import Model
from ..reference.precision import Precision, no_tf32
from ..trace import traced
from ..weights import make_weights

SR = 16000
SUMMARY = ("wall_s", "timing", "what", "served_len")


def write_wav(path: str, samples: np.ndarray) -> None:
    with wavelib.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(samples.astype("<i2").tobytes())


def write_clips(root: str, clips: list) -> list:
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    paths = []
    for i, c in enumerate(clips):
        p = os.path.join(root, "wav", f"u{i:05d}.wav")
        write_wav(p, c)
        paths.append(p)
    return paths


def write_manifest(path: str, paths: list, clips: list) -> str:
    with open(path, "w") as f:
        for p, c in zip(paths, clips):
            f.write(json.dumps({"wave": p, "frames": int(len(c))}) + "\n")
    return path


def utt_id(path: str) -> str:
    return os.path.basename(path).rsplit(".", 1)[0]


class Client:
    """One client of ``recognize``: calls it with the mix's options and
    keeps each call's wall time, ``timing`` and served hypotheses."""

    def __init__(self, exp: str, vocab: str, options: dict, device):
        from asr_chinese_e2e_tpu_torch.recognize import recognize

        self.recognize, self.exp, self.vocab = recognize, exp, vocab
        self.options = dict(options, device=device.type)
        self.calls = []

    def call(self, keep: bool = True, **what) -> dict:
        with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
            t0 = time.perf_counter()
            res = self.recognize(self.exp, self.vocab, **what, **self.options)
            t1 = time.perf_counter()
        served_len = max((len(u["output"][0]["rec_token"].split()) for u in res["utts"].values()),
                         default=0)
        rec = {"start": t0, "end": t1, "wall_s": t1 - t0, "timing": res["timing"],
               "utts": res["utts"], "what": what, "served_len": served_len}
        if keep:
            self.calls.append(rec)
        return rec


def served(call: dict, uid: str, token_ids: dict):
    """(ids, score) of the best hypothesis served for ``uid``."""
    best = call["utts"][uid]["output"][0]
    toks = best["rec_token"].split(" ") if best["rec_token"] else []
    return [token_ids[t] for t in toks], float(best["score"])


def sample(rng, n_total: int, n: int, must: int) -> list:
    idx = list(rng.choice(n_total, size=min(n, n_total), replace=False))
    if must not in idx:
        idx[-1] = must
    return sorted(int(i) for i in idx)


class Capture:
    """What the timed path computes for the requests to be judged, kept by
    reference (no copy, no sync): the CTC log-probs (the program's model
    method wrapped in place) and the rescoring forward's score of each
    n-best hypothesis with the hypotheses it scored (the rescoring's scorer
    wrapped in place). ``detach`` puts both back."""

    def __init__(self, wanted):
        self.wanted, self.current, self.lp, self.att = set(wanted), None, {}, {}
        self._undo = []

    def attach(self) -> None:
        from asr_chinese_e2e_tpu_torch import recognize as rec
        from asr_chinese_e2e_tpu_torch.decode import ctc_prefix

        model = next(iter(rec._EXP_CACHE.values()))[0]
        inner = model.ctc_log_probs

        def ctc_log_probs(enc_out):
            lp = inner(enc_out)
            if self.current in self.wanted:
                self.lp[self.current] = lp
            return lp

        model.ctc_log_probs = ctc_log_probs
        scorer = ctc_prefix._rescore_scores

        def rescore_scores(model, labels, label_lengths, enc, enc_lens):
            att = scorer(model, labels, label_lengths, enc, enc_lens)
            if self.current in self.wanted:
                self.att[self.current] = (labels, label_lengths, att)
            return att

        ctc_prefix._rescore_scores = rescore_scores
        self._undo.append(lambda: setattr(ctc_prefix, "_rescore_scores", scorer))

    def detach(self) -> None:
        for undo in self._undo:
            undo()
        self._undo.clear()

    def scored(self, call: int):
        """[(hypothesis ids, the program's rescoring score)] of a judged
        request, or None."""
        if call not in self.att:
            return None
        labels, lengths, att = (x.cpu() for x in self.att[call])
        return [(labels[i, : int(n)].tolist(), float(a))
                for i, (n, a) in enumerate(zip(lengths.tolist(), att.tolist()))]


def run(ctx) -> dict:
    dev = ctx.device
    config, mix = ctx.config, ctx.mix
    weights = make_weights(config["model"], config["vocab_size"], ctx.seed, dev)
    exp, vocab = port.write_experiment(config, weights, ctx.workdir)
    del weights
    clips = generate.clips(mix, ctx.seed, dev)
    paths = write_clips(ctx.workdir, clips)
    bounds = decode_boundaries(mix)
    client = Client(exp, vocab, mix["recognize"], dev)
    corpus = mix["request"] == "corpus"
    rng = np.random.default_rng(ctx.seed)
    order = rng.permutation(len(clips))
    longest = int(np.argmax([len(c) for c in clips]))

    first_of = {}
    for i, c in enumerate(clips):
        first_of.setdefault(bucket_of(len(c), bounds), i)
    warm = sorted(first_of.values())
    if corpus:
        manifest = write_manifest(os.path.join(ctx.workdir, "corpus.jsonl"), paths, clips)
        client.call(keep=False, manifest=write_manifest(
            os.path.join(ctx.workdir, "warm.jsonl"), [paths[i] for i in warm],
            [clips[i] for i in warm]))
    else:
        for i in warm:
            client.call(keep=False, wav=paths[i])
    # the clip requests to judge, drawn before the window among the first
    # pass over the clips, the longest clip's among them
    wanted = [] if corpus else sample(rng, len(clips), int(mix["check_sample"]),
                                      int(np.flatnonzero(order == longest)[0]))
    capture = Capture(wanted)
    if mix["recognize"]["mode"] == "rescore":
        capture.attach()
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < ctx.seconds:
            if corpus:
                client.call(manifest=manifest)
            else:
                capture.current = len(client.calls)
                client.call(wav=paths[int(order[len(client.calls) % len(clips)])])
    finally:
        capture.current = None
        capture.detach()
    sync(dev)
    calls = client.calls
    window_s = calls[-1]["end"] - calls[0]["start"]
    log(spread_line("wall a call", [c["wall_s"] for c in calls]))
    if corpus:
        log("walls of the calls, s: " + " ".join(f"{c['wall_s']:.4f}" for c in calls))

    record = {"kind": "decode", "config": config, "mix": mix, "window_s": window_s,
              "calls": [{k: c[k] for k in SUMMARY} for c in calls],
              "clip_samples": [len(c) for c in clips], "paths": paths, "trace": None,
              "traced_calls": [], "traced_launches": {}}
    if ctx.trace and dev.type == "cuda":
        n = int(mix["trace_calls"])
        what = ([{"manifest": manifest}] * n if corpus else
                [{"wav": paths[int(order[(len(calls) + j) % len(clips)])]} for j in range(n)])
        before = port.launches()
        traced_calls = []
        record["trace"] = traced(lambda: traced_calls.extend(
            client.call(keep=False, **w) for w in what))
        after = port.launches()
        record["traced_launches"] = {k: after[k] - before[k] for k in after}
        record["traced_calls"] = [{k: c[k] for k in SUMMARY} for c in traced_calls]
    record["memory_peak_bytes"] = peak_bytes(dev)
    audio = sum(c["timing"]["audio_s"] for c in calls)
    lat_ms = [c["wall_s"] * 1e3 for c in calls]
    record["e2e"] = {"setup_s": setup_s, "decode_audio_s_per_s": audio / window_s,
                     "decode_request_p95_ms": float(np.percentile(lat_ms, 95))}
    n_utts = len(clips) if corpus else 1
    record["attempted"] = len(calls) * n_utts
    record["failed"] = sum(n_utts - len(c["utts"]) for c in calls)

    if corpus:
        pairs = [(ci, i) for ci in range(len(calls)) for i in range(len(clips))]
        picked = [pairs[j] for j in sample(rng, len(pairs), int(mix["check_sample"]),
                                           pairs.index((0, longest)))]
    else:
        picked = [(ci, int(order[ci % len(clips)])) for ci in wanted if ci < len(calls)]
    record["judged_clips"] = [i for _, i in picked]
    token_ids = {t: i for i, t in enumerate(port.vocab_tokens(config["vocab_size"]))}
    items = []
    for ci, i in picked:
        ids, score = served(calls[ci], utt_id(paths[i]), token_ids)
        lp = capture.lp.get(ci)
        items.append({"clip": clips[i], "ids": ids, "score": score,
                      "lp": None if lp is None else lp[0].float().cpu(),
                      "scored": capture.scored(ci)})
    # the program is let go before the reference runs
    del client, capture
    _drop_program_model()
    free_cuda(dev)
    no_tf32()
    numbers, details = judge_decode(ctx, items, Precision("f32"))
    log(f"decode check: {details}")
    record["correct"], record["checks"] = checks.judge(numbers, ctx.limits)
    if record["failed"]:
        record["correct"] = False
    return record


def _drop_program_model() -> None:
    from asr_chinese_e2e_tpu_torch import recognize as rec

    rec._EXP_CACHE.clear()


def reference_model(ctx, prec: Precision) -> Model:
    w = make_weights(ctx.config["model"], ctx.config["vocab_size"], ctx.seed, ctx.device)
    return Model(ctx.config["model"], w, prec)


def judge_decode(ctx, items, prec: Precision) -> tuple:
    """(numbers, details) of the served hypotheses ``items`` (each its
    clip, served ids and score and, in rescore mode, the CTC log-probs the
    program computed for it) against the reference over the same clips;
    each number the worst (``max``) or the count (``sum``) over the items,
    as the mix's ``numbers`` say."""
    dev, mix = ctx.device, ctx.mix
    model = reference_model(ctx, prec)
    bounds = decode_boundaries(mix)
    opts = mix["recognize"]
    out = []
    with torch.no_grad():
        for it in items:
            clip = torch.from_numpy(it["clip"]).to(dev)
            (enc, t_enc), = refdec.encode_clips(model, [clip], ctx.config["features"], bounds)
            if opts["mode"] == "beam":
                out.append(_judge_beam(model, enc, it["ids"], it["score"], opts))
            else:
                out.append(_judge_rescore(model, enc, t_enc, it, opts, mix["search"]))
    reduce = {"max": max, "sum": sum}
    numbers = {k: float(reduce[how](o[k] for o in out)) for k, how in mix["numbers"].items()}
    details = {k: [o[k] for o in out] for k in out[0]}
    return numbers, details


def _judge_beam(model, enc, ids, score, opts) -> dict:
    """The served score against the reference's teacher-forced score of the
    served tokens, and of EOS where the hypothesis finished."""
    ref_score = refdec.beam_score(model, enc, ids, len(ids) < int(opts["max_decode_len"]))
    return {"score_gap": abs(score - ref_score), "served_len": len(ids)}


def _judge_rescore(model, enc, t_enc, it, opts, search) -> dict:
    """The program's CTC log-probs against the reference's over the clip's
    frames (``ctc_lp_gap``, the widest gap); the rescoring forward's score
    of each hypothesis it scored against the reference decoder's score of
    the same hypothesis (``rescore_att_gap``, the widest gap a target
    token: the score is a sum over the hypothesis and EOS); and the search
    between them, followed from the program's log-probs: the reference's
    prefix beam over them (bit for bit the program's search), whose n-best
    has to hold the served hypothesis (``nbest_misses``, exact)."""
    ref_lp = torch.log_softmax(model.ctc_logits(enc).float(), dim=-1)
    prog_lp = it["lp"][:t_enc].to(ref_lp.device)
    nbest = refdec.ctc_prefix_beam(prog_lp, int(opts["beam_size"]), int(search["prune"]),
                                   int(search["max_prefix_len"]))
    hyps = it["scored"]
    ref_att = refdec.rescore_scores(model, enc, [(h, 0.0) for h, _ in hyps],
                                    float(opts["ctc_weight"]))
    att_gap = max(abs(a - r[2]) / (len(h) + 1) for (h, a), r in zip(hyps, ref_att))
    return {"ctc_lp_gap": float((prog_lp - ref_lp).abs().max()),
            "rescore_att_gap": float(att_gap),
            "nbest_misses": 0 if any(list(p) == it["ids"] for p, _ in nbest) else 1,
            "served_len": len(it["ids"])}


def control_items(ctx, clips, prec: Precision) -> list:
    """The served items of the reference put in the program's place at
    ``prec``: its own search over each clip (the control of ``correct``)."""
    mix, opts = ctx.mix, ctx.mix["recognize"]
    model = reference_model(ctx, prec)
    bounds = decode_boundaries(mix)
    items = []
    with torch.no_grad():
        for c in clips:
            clip = torch.from_numpy(c).to(ctx.device)
            (enc, _), = refdec.encode_clips(model, [clip], ctx.config["features"], bounds)
            if opts["mode"] == "beam":
                ids, _, score = refdec.attention_beam(model, enc, int(opts["beam_size"]),
                                                      int(opts["max_decode_len"]))
                items.append({"clip": c, "ids": ids, "score": score, "lp": None})
                continue
            lp = torch.log_softmax(model.ctc_logits(enc).float(), dim=-1)
            nbest = refdec.ctc_prefix_beam(lp, int(opts["beam_size"]),
                                           int(mix["search"]["prune"]),
                                           int(mix["search"]["max_prefix_len"]))
            scored = refdec.rescore_scores(model, enc, nbest, float(opts["ctc_weight"]))
            best = max(range(len(scored)), key=lambda i: (scored[i][3], -i))
            items.append({"clip": c, "ids": list(scored[best][0]), "score": 0.0,
                          "lp": lp.cpu(), "scored": [(list(s[0]), s[2]) for s in scored]})
    return items
