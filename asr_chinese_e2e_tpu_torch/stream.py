"""Streaming recognition in torch: energy-gated segmentation + incremental
decode (``asr_chinese_e2e_tpu/stream.py``).

- ``EnergyGate`` segments any int16 PCM chunk source with the reference
  recorder's LEVEL / COUNT_NUM / SAVE_LENGTH semantics
  (``Predictor/recorder.py:7-73``); pure numpy, copied.
- ``StreamingRecognizer`` runs gated segments through the model. Prefix
  re-encode: the open prefix is zero-padded to its duration bucket, then
  ``parse_batch`` (the fbank kernel on the card), ``encode`` (the windowed
  attention kernel with ``ASR_BANDED_WINDOW=1`` on a streaming model) and
  the CTC head. Incremental (a causal-banded model with a CTC head and
  fixed CMVN): each cadence featurizes and encodes only the new frames
  against per-layer left-context tails (``encode_chunk``), in plain torch,
  exactly as the offline pass would. Partials are CTC greedy; finals use
  ``mode`` (ctc_greedy | beam | joint; joint reads the segment's CTC
  log-probs, which the incremental path keeps chunk by chunk).

The duration buckets stay although torch compiles nothing per shape: they
define the featurization (segments are zero-padded to their bucket before
framing) that the incremental final must reproduce exactly.

    python -m asr_chinese_e2e_tpu_torch.stream --exp <exp_dir> \
        --vocab <vocab.json> --wav <audio.wav> [--mode beam|joint] \
        [--incremental auto|on|off] [--chunk_ms 125] [--device cuda]
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Iterable, List, Optional

import numpy as np
import torch

from .data.features import FeatureConfig, dct_matrix, logmel_from_frames, parse_batch
from .data.io import DEFAULT_BUCKET_SECONDS, load_wav
from .data.vocab import BLANK_ID, Vocab
from .decode.beam import beam_search
from .decode.greedy import ctc_greedy_decode
from .decode.joint import joint_beam_search
from .models.transformer import init_chunk_state


@dataclasses.dataclass
class Event:
    """One recognition event: ``kind`` "partial" (prefix hypothesis, may be
    revised) or "final" (segment closed); ``t0``/``t1`` the segment bounds
    in seconds of stream time (for partials ``t1`` is the prefix end)."""

    kind: str
    text: str
    t0: float
    t1: float


class EnergyGate:
    """Energy-gated utterance segmenter (``recorder.py:7-73`` semantics).

    Chunks of ``chunk`` samples are speech-active when more than
    ``count_num`` samples exceed ``level``; activity arms a hangover of
    ``save_length`` chunks, and the buffered run is emitted as one segment
    when the hangover expires. ``pre_roll`` leading silent chunks are kept.
    """

    def __init__(
        self,
        level: int = 500,
        count_num: int = 20,
        save_length: int = 8,
        chunk: int = 2000,
        pre_roll: int = 1,
        max_segment_samples: Optional[int] = None,
    ) -> None:
        self.level = level
        self.count_num = count_num
        self.save_length = save_length
        self.chunk = chunk
        self.pre_roll = pre_roll
        self.max_segment_samples = max_segment_samples
        self.reset()

    def _emit(self) -> Optional[tuple]:
        if not self._buf:
            return None
        seg = np.concatenate(self._buf)
        start = self._seg_start
        self._buf = []
        self._hangover = 0
        return start, seg

    def feed(self, samples: np.ndarray) -> List[tuple]:
        """Feed int16 PCM; returns completed segments as
        ``(start_sample, np.int16 array)`` tuples."""
        x = np.concatenate([self._tail, np.asarray(samples, np.int16)])
        out: List[tuple] = []
        n_full = len(x) // self.chunk
        for i in range(n_full):
            c = x[i * self.chunk : (i + 1) * self.chunk]
            active = int(np.sum(c > self.level)) > self.count_num
            if active:
                if not self._buf:
                    self._seg_start = self._stream_pos - sum(
                        len(r) for r in self._roll
                    )
                    self._buf = list(self._roll)
                self._hangover = self.save_length
            if self._hangover > 0:
                self._buf.append(c)
                self._hangover -= 1
                if self._hangover == 0:
                    seg = self._emit()
                    if seg is not None:
                        out.append(seg)
                if (
                    self.max_segment_samples is not None
                    and self._buf
                    and sum(len(b) for b in self._buf) >= self.max_segment_samples
                ):
                    seg = self._emit()
                    if seg is not None:
                        out.append(seg)
            self._roll.append(c)
            self._roll = self._roll[-self.pre_roll :] if self.pre_roll else []
            self._stream_pos += self.chunk
        self._tail = x[n_full * self.chunk :]
        return out

    def finish(self) -> List[tuple]:
        """Flush: close any open segment (stream ended mid-speech)."""
        out: List[tuple] = []
        if self._tail.size:
            pad = np.zeros((self.chunk - len(self._tail),), np.int16)
            out.extend(self.feed(pad))
        seg = self._emit()
        if seg is not None:
            out.append(seg)
        return out

    def reset(self) -> None:
        """Clear all stream state (tail, pre-roll, open buffer, position),
        keeping the parameters: the start of a new independent stream."""
        self._tail = np.zeros((0,), np.int16)
        self._roll: List[np.ndarray] = []
        self._buf: List[np.ndarray] = []
        self._hangover = 0
        self._stream_pos = 0  # samples consumed, for segment timestamps
        self._seg_start = 0

    @property
    def in_speech(self) -> bool:
        return bool(self._buf)

    def open_prefix(self) -> Optional[tuple]:
        """(start_sample, concatenated samples) of the segment being
        captured: the partial-hypothesis input."""
        if not self._buf:
            return None
        return self._seg_start, np.concatenate(self._buf)


class StreamingRecognizer:
    """Recognizer over chunked int16 PCM for a model on any device.

    ``incremental``: "on" encodes only new frames per cadence (needs
    ``causal_encoder=True``, ``attention_band`` > 0, a linear frontend, a
    CTC head, ``cmvn_mode='fixed'`` and no delta features; both encoder
    families: the conformer carries its causal conv's input too), "off"
    re-encodes the padded prefix, "auto"
    picks "on" when the model allows it. Partials are CTC greedy; finals
    use ``mode``: "ctc_greedy", "beam" or "joint" (the joint CTC/attention
    beam at ``ctc_weight``)."""

    def __init__(
        self,
        model,
        vocab: Vocab,
        feat_cfg: FeatureConfig,
        mode: str = "ctc_greedy",
        bucket_seconds: Iterable[float] = DEFAULT_BUCKET_SECONDS,
        partial_every_s: float = 1.0,
        beam_size: int = 10,
        max_len: int = 64,
        ctc_weight: float = 0.3,
        gate: Optional[EnergyGate] = None,
        incremental: str = "auto",  # "auto" | "on" | "off"
        chunk_frames: int = 32,  # LFR frames per incremental chunk (~0.96 s)
    ) -> None:
        if mode not in ("ctc_greedy", "beam", "joint"):
            raise ValueError(f"unknown stream decode mode {mode!r}")
        if incremental not in ("auto", "on", "off"):
            raise ValueError(
                f"incremental must be 'auto', 'on' or 'off', got {incremental!r}"
            )
        self.model, self.vocab, self.feat_cfg = model, vocab, feat_cfg
        self.mode = mode
        self.device = next(model.parameters()).device
        self.sr = feat_cfg.sample_rate
        self.buckets = [int(s * self.sr) for s in bucket_seconds]
        self.partial_every = int(partial_every_s * self.sr)
        self.beam_size, self.max_len = beam_size, max_len
        self.ctc_weight = ctc_weight
        self.gate = gate or EnergyGate(max_segment_samples=self.buckets[-1])
        self.chunk_frames = chunk_frames
        cfg = model.cfg
        can_inc = (
            cfg.get("causal_encoder", False)
            and cfg.get("attention_band", 0) > 0
            and cfg.get("frontend", "linear") == "linear"
            # both encoder families stream: the conformer carries its
            # causal depthwise conv's input (ConformerBlock.chunk_step)
            and cfg.get("encoder_type", "transformer") in ("transformer", "conformer")
            and cfg.get("ctc_weight", 0.0) > 0.0
            and feat_cfg.cmvn_mode == "fixed"
            and not feat_cfg.use_delta
            and not feat_cfg.use_delta_delta
        )
        if incremental == "on" and not can_inc:
            raise ValueError(
                "incremental streaming requires causal_encoder=True, "
                "attention_band>0, a CTC head, a linear-frontend transformer or "
                "conformer encoder, cmvn_mode='fixed' and no delta features"
            )
        self.incremental = can_inc if incremental == "auto" else incremental == "on"
        self._chunk_index = None
        self.reset_stream()

    # -- prefix re-encode ----------------------------------------------------
    def _bucket_of(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    @torch.inference_mode()
    def _run_encode(self, samples: np.ndarray):
        """(enc_out, enc_lens, CTC log-probs) of the segment zero-padded to
        its bucket."""
        n = min(len(samples), self.buckets[-1])
        wave = np.zeros((1, self._bucket_of(n)), np.int16)
        wave[0, :n] = samples[:n]
        feats, feat_lens = parse_batch(
            torch.from_numpy(wave).to(self.device),
            torch.tensor([n], dtype=torch.int32, device=self.device),
            self.feat_cfg,
        )
        enc_out, enc_lens = self.model.encode(feats, feat_lens)
        return enc_out, enc_lens, self.model.ctc_log_probs(enc_out)

    def _ctc_text(self, lp, enc_lens) -> str:
        return self.vocab.ids_to_str(ctc_greedy_decode(lp, enc_lens)[0])

    def _search_text(self, enc_out, enc_lens, lp) -> str:
        """The ``beam`` or ``joint`` final's best hypothesis."""
        if self.mode == "beam":
            res = beam_search(self.model, enc_out, enc_lens, self.beam_size, self.max_len)
        else:
            res = joint_beam_search(
                self.model, enc_out, enc_lens, self.beam_size, self.max_len,
                ctc_weight=self.ctc_weight, ctc_log_probs=lp,
            )
        return self.vocab.ids_to_str(res.nbest_ids(1)[0][0])

    def _final_text(self, samples: np.ndarray) -> str:
        enc_out, enc_lens, lp = self._run_encode(samples)
        if self.mode == "ctc_greedy":
            return self._ctc_text(lp, enc_lens)
        return self._search_text(enc_out, enc_lens, lp)

    # -- incremental (chunked causal) path -----------------------------------
    def _chunk_indices(self):
        """(frame index (nb, win), LFR index (E, m)) of one chunk: nb = E n
        + (m - n) base frames (m - n frames overlap the next chunk)."""
        if self._chunk_index is None:
            cfg, e = self.feat_cfg, self.chunk_frames
            n, m = cfg.lfr_n, cfg.lfr_m
            nb = e * n + (m - n)
            fidx = np.arange(nb)[:, None] * cfg.hop_length + np.arange(cfg.win_length)
            lidx = np.arange(e)[:, None] * n + np.arange(m)[None, :]
            self._chunk_index = tuple(
                torch.from_numpy(a).to(self.device) for a in (fidx, lidx)
            )
        return self._chunk_index

    @torch.inference_mode()
    def _run_chunk(self, wave_slice: np.ndarray, base_valid: int, offset: int):
        """Featurize a pre-padded sample slice (framing, log-mel, fixed
        CMVN, chunk-local LFR clipped at ``base_valid`` base frames) and
        encode it against the carried tails. Returns (enc (E, d), CTC
        log-probs (E, V), their argmax ids (E,))."""
        cfg = self.feat_cfg
        fidx, lidx = self._chunk_indices()
        w = torch.from_numpy(wave_slice).to(self.device).float() * (1.0 / 32768.0)
        feats = logmel_from_frames(w[fidx][None], cfg)  # (1, nb, n_mels)
        if cfg.feature_type == "mfcc":
            feats = feats @ torch.from_numpy(dct_matrix(cfg.n_mels, cfg.n_mfcc)).to(
                feats.device
            )
        feats = (feats - cfg.cmvn_mean) / cfg.cmvn_std
        # tail clipping (base_valid < nb) happens only on the final flush,
        # mirroring lfr_stack's clip at the utterance's last valid frame
        idx = lidx.clamp(max=base_valid - 1)
        st = feats[0][idx].reshape(1, self.chunk_frames, -1)
        enc, self._inc_tails, lp = self.model.encode_chunk(st, self._inc_tails, offset)
        return enc[0], lp[0], lp[0].argmax(dim=-1)

    def _inc_reset(self, start: int) -> None:
        self._inc_start = start
        self._inc_lfr_done = 0
        self._inc_tails = init_chunk_state(self.model.cfg, 1, self.device)
        self._inc_enc, self._inc_lp, self._inc_ids = [], [], []

    def _inc_advance(self, start: int, prefix: np.ndarray, final: bool) -> None:
        """Encode the newly complete LFR frames of the open segment.

        ``prefix``: all segment samples so far. Mid-stream only frames
        whose analysis windows are fully determined by received samples are
        emitted (identical to the offline featurization of the eventual
        segment); ``final`` flushes the tail with the offline end padding
        and LFR edge clipping."""
        if start != self._inc_start:
            self._inc_reset(start)
        cfg = self.feat_cfg
        hop, win = cfg.hop_length, cfg.win_length
        n, m = cfg.lfr_n, cfg.lfr_m
        e = self.chunk_frames
        nb = e * n + (m - n)
        samp = (nb - 1) * hop + win
        pad = cfg.n_fft // 2
        prefix = prefix[: self.buckets[-1]]
        if len(prefix) <= pad:
            return
        if final:
            # the offline path zero-pads the segment to its duration bucket
            # and reflect-pads THAT wave, so the tail windows read bucket
            # zeros: do the same
            bwave = np.zeros((self._bucket_of(len(prefix)),), prefix.dtype)
            bwave[: len(prefix)] = prefix
            padded = np.pad(bwave, (pad, pad), mode="reflect")
            total_base = len(prefix) // hop + 1  # center=True frame count
            target_lfr = -(-total_base // n)
        else:
            padded = np.pad(prefix, (pad, 0), mode="reflect")
            avail_base = (len(padded) - win) // hop + 1
            # LFR frame j needs base frames [jn, jn+m); emit once all real
            total_base = None
            target_lfr = max(0, (avail_base - m) // n + 1)
        while True:
            j0 = self._inc_lfr_done
            todo = target_lfr - j0
            if todo <= 0 or (not final and todo < e):
                break  # mid-stream: full chunks only
            s0 = j0 * n * hop
            sl = padded[s0 : s0 + samp]
            if len(sl) < samp:
                sl = np.pad(sl, (0, samp - len(sl)))
            base_valid = nb if not final else min(total_base - j0 * n, nb)
            n_valid = min(e, todo)
            enc, lp, ids = self._run_chunk(sl, base_valid, j0)
            # enc and lp stay on the device until a beam or joint final
            # needs them; partials fetch only the argmax ids
            self._inc_enc.append(enc[:n_valid])
            self._inc_lp.append(lp[:n_valid])
            self._inc_ids.append(ids[:n_valid].cpu().numpy())
            self._inc_lfr_done = j0 + n_valid

    def _inc_text(self) -> str:
        if not self._inc_ids:
            return ""
        # greedy collapse over the accumulated per-frame argmax ids
        row = np.concatenate(self._inc_ids)
        keep = np.concatenate([[True], row[1:] != row[:-1]])
        collapsed = row[keep]
        return self.vocab.ids_to_str(collapsed[collapsed != BLANK_ID].tolist())

    def _inc_final_text(self, start: int, seg: np.ndarray) -> str:
        """Final decode from the accumulated encoder output (no re-encode)."""
        self._inc_advance(start, seg, final=True)
        if self.mode == "ctc_greedy" or not self._inc_enc:
            text = self._inc_text()
        else:
            # the bucket-length encoder output the prefix path would give,
            # zero past the accumulated frames (the search masks by length),
            # and CTC rows padded blank-certain
            bucket = self._bucket_of(min(len(seg), self.buckets[-1]))
            t_b = self.feat_cfg.num_lfr_frames(self.feat_cfg.num_frames(bucket))
            with torch.inference_mode():
                enc_cat = torch.cat(self._inc_enc, dim=0)  # (T, d)
                lp_cat = torch.cat(self._inc_lp, dim=0)  # (T, V)
                t = enc_cat.shape[0]
                enc = enc_cat.new_zeros((1, t_b, enc_cat.shape[1]))
                enc[0, :t] = enc_cat
                lp = lp_cat.new_full((1, t_b, lp_cat.shape[1]), -1e9)
                lp[0, :, BLANK_ID] = 0.0
                lp[0, :t] = lp_cat
                enc_lens = torch.tensor([t], dtype=torch.int32, device=enc.device)
            text = self._search_text(enc, enc_lens, lp)
        self._inc_start = None  # segment closed; the next one resets
        return text

    # -- public API ----------------------------------------------------------
    def reset_stream(self) -> None:
        """Start a new independent stream on this recognizer: clears the
        energy gate and any open incremental segment; stream timestamps
        restart at 0."""
        self.gate.reset()
        self._since_partial = 0
        self._inc_start: Optional[int] = None
        self._inc_lfr_done = 0
        self._inc_tails = None
        self._inc_enc, self._inc_lp, self._inc_ids = [], [], []

    def _final_event(self, start: int, seg: np.ndarray) -> Event:
        text = (
            self._inc_final_text(start, seg) if self.incremental
            else self._final_text(seg)
        )
        return Event("final", text, start / self.sr, (start + len(seg)) / self.sr)

    def feed(self, samples: np.ndarray) -> List[Event]:
        """Feed a chunk of int16 PCM; returns recognition events."""
        events: List[Event] = []
        for start, seg in self.gate.feed(samples):
            events.append(self._final_event(start, seg))
            self._since_partial = 0
        if self.gate.in_speech:
            self._since_partial += len(samples)
            if self._since_partial >= self.partial_every:
                self._since_partial = 0
                start, prefix = self.gate.open_prefix()
                if self.incremental:
                    # O(chunk): encode only the newly completed frames
                    self._inc_advance(start, prefix, final=False)
                    text = self._inc_text()
                else:
                    _, enc_lens, lp = self._run_encode(prefix)
                    text = self._ctc_text(lp, enc_lens)
                events.append(Event(
                    "partial", text, start / self.sr, (start + len(prefix)) / self.sr
                ))
        return events

    def finish(self) -> List[Event]:
        """End of stream: flush the gate and decode any open segment."""
        return [self._final_event(start, seg) for start, seg in self.gate.finish()]


def wav_chunks(path: str, chunk_samples: int = 2000):
    """Yield int16 chunks from a PCM16 wav: the file-driven stand-in for a
    live audio source."""
    x = load_wav(path, dtype=np.int16)
    for i in range(0, len(x), chunk_samples):
        yield x[i : i + chunk_samples]


def main(argv=None) -> None:
    """Stream a wav file through the recognizer and print the events (the
    port of ``scripts/stream_demo.py``)."""
    from .utils.cli import parse_kwargs
    from .utils.experiment import load_experiment

    _, kw = parse_kwargs(sys.argv[1:] if argv is None else argv)
    if kw.pop("help", False) or not {"exp", "vocab", "wav"} <= set(kw):
        print(__doc__)
        return
    model, _, feat_cfg, vocab = load_experiment(
        kw["exp"], kw["vocab"], which=kw.get("which", "best"),
        device=torch.device(kw.get("device", "cuda")),
    )
    rec = StreamingRecognizer(
        model, vocab, feat_cfg, mode=kw.get("mode", "ctc_greedy"),
        beam_size=int(kw.get("beam_size", 10)),
        ctc_weight=float(kw.get("ctc_weight", 0.3)),
        incremental=kw.get("incremental", "auto"),
    )
    print(
        "# encode path:",
        "incremental (O(chunk) partials)" if rec.incremental
        else "prefix re-encode (train with --causal_encoder true "
             "--attention_band N --cmvn_mode fixed for incremental)",
        flush=True,
    )
    chunk = int(feat_cfg.sample_rate * float(kw.get("chunk_ms", 125)) / 1000)
    for c in [*wav_chunks(kw["wav"], chunk), None]:
        for ev in rec.feed(c) if c is not None else rec.finish():
            print(f"[{ev.kind:7s} {ev.t0:6.2f}-{ev.t1:6.2f}s] {ev.text}", flush=True)


if __name__ == "__main__":
    main()
