"""Matmul FLOPs of the work a cell does (elementwise work left out, as MFU
accounting does).

``analytic_train_flops`` and ``rnn_forward_flops`` are copies of the
port's ``asr_chinese_e2e_tpu_torch/bench.py`` functions of those names (the
JAX bench's count), over the configuration file's ``model`` and
``features`` sections; ``portbench/tests`` holds them equal to the
originals. The decode counts are the benchmark's own, in the same terms."""

from __future__ import annotations

RNN_NAMES = ("BiLSTMCTC", "LAS")

FEATURE_DEFAULTS = {"sample_rate": 16000, "n_mels": 80, "win_length": 400, "hop_length": 160,
                    "n_fft": 400, "center": True, "lfr_m": 4, "lfr_n": 3}


def _feat(features: dict) -> dict:
    return dict(FEATURE_DEFAULTS, **features)


def num_frames(feat: dict, n_samples: int) -> int:
    f = _feat(feat)
    if f["center"]:
        return n_samples // f["hop_length"] + 1
    return (n_samples - f["win_length"]) // f["hop_length"] + 1


def num_lfr_frames(feat: dict, n_frames: int) -> int:
    return -(-n_frames // _feat(feat)["lfr_n"])


def feature_dim(feat: dict) -> int:
    f = _feat(feat)
    return f["n_mels"] * f["lfr_m"]


def fbank_flops(feat: dict, t_frames: int) -> int:
    """The DFT as two matmuls and the mel product, per utterance."""
    f = _feat(feat)
    n_bins = f["n_fft"] // 2 + 1
    return t_frames * f["win_length"] * (2 * n_bins) * 2 + t_frames * n_bins * f["n_mels"] * 2


def analytic_train_flops(cfg: dict, feat: dict, vocab_size: int, batch: int,
                         n_samples: int, label_len: int) -> float:
    """Matmul FLOPs of one train step (fwd + bwd = 3x fwd)."""
    t_frames = num_frames(feat, n_samples)
    t = num_lfr_frames(feat, t_frames)
    l = label_len + 1  # decoder is BOS-prefixed
    v = vocab_size
    fwd = fbank_flops(feat, t_frames)
    if cfg.get("model_name") in RNN_NAMES:
        return 3.0 * (fwd + rnn_forward_flops(cfg, feat, v, t, l)) * batch
    d, ff = cfg["d_model"], cfg["d_ff"]
    le, ld = cfg["num_encoder_layers"], cfg["num_decoder_layers"]
    if cfg.get("frontend", "linear") == "conv2d":
        c, f = d // 8, feature_dim(feat)
        t1, f1 = -(-t // 2), -(-f // 2)
        t, f2 = -(-t1 // 2), -(-f1 // 2)
        fwd += t1 * f1 * c * 9 * 2 + t * f2 * c * 9 * c * 2 + t * f2 * c * d * 2
    else:
        fwd += t * feature_dim(feat) * d * 2
    layer = 4 * t * d * d * 2 + 2 * t * t * d * 2 + 2 * t * d * ff * 2
    if cfg.get("encoder_type", "transformer") == "conformer":
        k = cfg.get("conv_kernel_size", 15)
        layer += 2 * t * d * ff * 2 + t * d * 2 * d * 2 + t * d * d * 2 + t * d * k * 2
    fwd += le * layer
    if float(cfg.get("ctc_weight", 0.0)) > 0:
        fwd += t * d * v * 2
    fwd += ld * (4 * l * d * d * 2 + 2 * l * l * d * 2 + 2 * l * d * d * 2
                 + 2 * t * d * d * 2 + 2 * l * t * d * 2 + 2 * l * d * ff * 2)
    fwd += l * d * v * 2
    return 3.0 * fwd * batch


def rnn_forward_flops(cfg: dict, feat: dict, v: int, t: int, l: int) -> int:
    """Matmul FLOPs of one utterance's RNN forward past the fbank."""
    h, n_in = cfg["hidden_size"], feature_dim(feat)
    fwd = 0
    for i in range(cfg["num_encoder_layers"]):
        fwd += 2 * t * 4 * h * ((n_in if i == 0 else 2 * h) + h) * 2
    if float(cfg.get("ctc_weight", 0.0)) > 0:
        fwd += t * 2 * h * v * 2
    if cfg.get("model_name") == "LAS":
        e, a, f, k = cfg["embed_dim"], cfg["attention_dim"], cfg["location_filters"], cfg["location_kernel"]
        step = 4 * h * (e + 2 * h + h) * 2 + h * a * 2
        step += t * f * k * 2 + t * f * a * 2 + t * a * 2 + t * 2 * h * 2
        step += (h + 2 * h) * v * 2
        fwd += l * step + t * 2 * h * a * 2
    return fwd


# -- decoding (the benchmark's own count) ------------------------------------


def encoder_flops(cfg: dict, feat: dict, n_samples: int, with_ctc: bool, vocab_size: int) -> int:
    """One utterance padded to ``n_samples``: fbank, the linear frontend,
    the encoder layers and, ``with_ctc``, the CTC head."""
    t_frames = num_frames(feat, n_samples)
    t = num_lfr_frames(feat, t_frames)
    d, ff = cfg["d_model"], cfg["d_ff"]
    out = fbank_flops(feat, t_frames) + t * feature_dim(feat) * d * 2
    out += cfg["num_encoder_layers"] * (4 * t * d * d * 2 + 2 * t * t * d * 2 + 2 * t * d * ff * 2)
    if with_ctc:
        out += t * d * vocab_size * 2
    return out


def beam_flops(cfg: dict, feat: dict, n_samples: int, vocab_size: int, beam: int,
               steps: int) -> int:
    """The cached beam over one utterance: the cross-attention K/V once,
    then per step and hypothesis the decoder's projections, attention over
    the prefix so far and over the encoder frames, the FFN and the output
    projection."""
    t = num_lfr_frames(feat, num_frames(feat, n_samples))
    d, ff, v = cfg["d_model"], cfg["d_ff"], vocab_size
    ld = cfg["num_decoder_layers"]
    out = ld * 2 * t * d * d * 2
    for i in range(steps):
        per_row = ld * (4 * d * d * 2 + 2 * (i + 1) * d * 2 + 2 * d * d * 2
                        + 2 * t * d * 2 + 2 * d * ff * 2) + d * v * 2
        out += beam * per_row
    return out


def rescore_flops(cfg: dict, feat: dict, n_samples: int, vocab_size: int, n_hyps: int,
                  hyp_len: int) -> int:
    """The teacher-forced rescoring forward over ``n_hyps`` hypotheses of
    ``hyp_len`` tokens (+ BOS), each with its own cross-attention K/V."""
    t = num_lfr_frames(feat, num_frames(feat, n_samples))
    d, ff, v = cfg["d_model"], cfg["d_ff"], vocab_size
    l = hyp_len + 1
    per_hyp = cfg["num_decoder_layers"] * (
        4 * l * d * d * 2 + 2 * l * l * d * 2 + 2 * l * d * d * 2
        + 2 * t * d * d * 2 + 2 * l * t * d * 2 + 2 * l * d * ff * 2) + l * d * v * 2
    return n_hyps * per_hyp
