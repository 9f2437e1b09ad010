"""The port's rel-pos conformer (ESPnet's AISHELL-1 conformer:
``pos_enc_type`` "rel", ``ffn_activation`` "swish", the conv2d frontend
with ``frontend_channels`` and ``frontend_padding`` "valid") against the
plain float32 reference ``tests/plain_espnet_conformer.py`` on the CPU, at
2 + 2 layers and d 32: the loss and every leaf's gradient, the diagonal
index of the positional term against ESPnet's ``rel_shift``, an
utterance's loss alone and inside a padded batch, the subsampler's shapes,
``recognize`` (beam) against the reference's encoder, and the routes the
encoder refuses; what ``chip_smoke.py``'s phase 7c expects (K11/K12's
bounds, the dropout masks of a step); a rel-pos call's route by device and
dtype (the plain version on the CPU only). The ``card`` cases hold K11/K12
to the plain version in bf16, and f32 CUDA tensors to a ValueError, on an
NVIDIA card and skip without one."""

import json

import numpy as np
import pytest
import torch

import chip_smoke
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab
from asr_chinese_e2e_tpu_torch.losses import model_loss
from asr_chinese_e2e_tpu_torch.models import layers
from asr_chinese_e2e_tpu_torch.models import transformer as tmod
from asr_chinese_e2e_tpu_torch.models.layers import ConvSubsampler, relpos_table
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer, default_config
from asr_chinese_e2e_tpu_torch.ops import fused_attention as fa
from asr_chinese_e2e_tpu_torch.recognize import recognize
from asr_chinese_e2e_tpu_torch.utils.experiment import save_torch_checkpoint
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus
from tests.plain_espnet_conformer import PlainConformer, rel_shift, sinusoids

VOCAB = 40
# f32 on both sides, the same weights: the port and the reference differ only
# in the order of their sums (the diagonal index against rel_shift's copy,
# the CTC recursion's plain version against F.ctc_loss, the attention's
# explicit backward against autograd's), about 1e-7 of each value here; 1e-5
# leaves a hundredfold room and catches any term left out or misplaced
TOL = 1e-5


def relpos_config(**overrides) -> Config:
    base = dict(d_model=32, num_heads=2, head_dim=16, d_ff=64, num_encoder_layers=2,
                num_decoder_layers=2, norm_type="pre", encoder_type="conformer",
                pos_enc_type="rel", ffn_activation="swish", frontend="conv2d",
                frontend_channels=16, frontend_padding="valid", input_dim=20,
                conv_kernel_size=15, attn_impl="fused", attn_weight_dropout=False,
                ctc_weight=0.3, label_smoothing=0.1, dropout_impl="hash")
    base.update(overrides)
    return default_config().build(**base)


def plain_cfg(cfg: Config) -> dict:
    return {k: cfg.get(k) for k in ("d_model", "num_heads", "head_dim", "num_encoder_layers",
                                     "num_decoder_layers", "ctc_weight", "label_smoothing")}


def model_and_plain(seed=0, **overrides):
    cfg = relpos_config(**overrides)
    model = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(seed))
    w = {k: v.detach().clone().requires_grad_(True) for k, v in model.state_dict().items()}
    return cfg, model, PlainConformer(plain_cfg(cfg), w), w


def batch(seed=1, lengths=(90, 71, 40), label_lengths=(6, 4, 2)):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(len(lengths), max(lengths), 20, generator=g)
    labels = torch.randint(4, VOCAB, (len(lengths), max(label_lengths)), generator=g)
    ll = torch.tensor(label_lengths)
    labels = labels * (torch.arange(labels.shape[1])[None] < ll[:, None])
    return feats, torch.tensor(lengths), labels, ll


def port_loss(model, cfg, feats, lengths, labels, ll):
    out = model(feats, lengths, labels, ll)
    return model_loss(out, labels, ll, cfg.ctc_weight, cfg.label_smoothing)[0], out


def rel_gap(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_loss_and_every_leaf_gradient_match_the_plain_reference():
    cfg, model, plain, w = model_and_plain()
    feats, lengths, labels, ll = batch()
    loss, _ = port_loss(model, cfg, feats, lengths, labels, ll)
    loss.backward()
    ref, _ = plain.loss(feats, lengths, labels, ll)
    ref.backward()
    assert abs(loss.item() - ref.item()) <= TOL * abs(ref.item())
    grads = dict(model.named_parameters())
    assert set(grads) == set(w)
    # a key projection's bias has no gradient in exact arithmetic (a softmax
    # row does not move when every score shifts alike): its round-off is
    # measured against the median leaf's gradient, as every leaf's floor
    norms = sorted(float(x.grad.norm()) for x in w.values())
    floor = norms[len(norms) // 2]
    for name, p in grads.items():
        ref_grad = w[name].grad
        gap = float((p.grad - ref_grad).norm()) / max(float(ref_grad.norm()), floor)
        assert gap <= TOL, name


def test_diagonal_index_equals_espnet_rel_shift():
    g = torch.Generator().manual_seed(3)
    for b, h, t in ((2, 3, 7), (1, 4, 33), (3, 2, 64)):
        x = torch.randn(b, h, t, 2 * t - 1, generator=g)
        pos = x.transpose(0, 1).contiguous()  # (H, B, T, 2T - 1), as the kernels take it
        assert torch.equal(fa.relpos_diagonal(pos, t), rel_shift(x))


def test_relpos_table_rows_are_relative_positions():
    t, d = 9, 16
    table = relpos_table(t, d, "cpu")
    assert table.shape == (2 * t - 1, d)
    assert torch.allclose(table, sinusoids(np.arange(t - 1, -t, -1), d), atol=1e-7)
    assert torch.allclose(table[t - 1], sinusoids(np.array([0]), d)[0])


def test_an_utterance_loss_is_the_same_alone_and_in_a_padded_batch():
    cfg, model, _, _ = model_and_plain(seed=4)
    feats, lengths, labels, ll = batch(seed=5, lengths=(120, 97, 43), label_lengths=(7, 5, 3))
    with torch.no_grad():
        _, out = port_loss(model, cfg, feats, lengths, labels, ll)
        keys = ("logits", "gold", "ctc_logits", "enc_lengths")
        for i in range(3):
            n, m = int(lengths[i]), int(ll[i])
            row = {k: out[k][i : i + 1] for k in keys}
            in_batch = model_loss(row, labels[i : i + 1], ll[i : i + 1], cfg.ctc_weight,
                                  cfg.label_smoothing)[0]
            alone, _ = port_loss(model, cfg, feats[i : i + 1, :n], lengths[i : i + 1],
                                 labels[i : i + 1, :m], ll[i : i + 1])
            assert abs(float(in_batch) - float(alone)) <= TOL * abs(float(alone)), i


@pytest.mark.parametrize("t", [40, 41, 1001])
def test_valid_subsampler_at_256_channels(t):
    sub = ConvSubsampler(256, 80, channels=256, padding="valid")
    assert sub.conv1.weight.shape == (256, 256, 3, 3)
    assert sub.proj.weight.shape == (256, 19 * 256)
    with torch.no_grad():
        y, lengths = sub(torch.zeros(2, t, 80), torch.tensor([t, t - 9]))
    assert y.shape == (2, ((t - 1) // 2 - 1) // 2, 256)
    assert lengths.tolist() == [((n - 1) // 2 - 1) // 2 for n in (t, t - 9)]


def test_default_keys_keep_the_modules():
    cfg = default_config().build(d_model=32, num_heads=2, head_dim=16, d_ff=64,
                                 num_encoder_layers=1, num_decoder_layers=1,
                                 encoder_type="conformer", frontend="conv2d", input_dim=20)
    model = SpeechTransformer(cfg, VOCAB)
    front = model.encoder.frontend_mod
    assert front.padding == "same" and front.conv0.out_channels == 4
    assert model.encoder.final_norm is None
    assert type(model.encoder.layers[0].attn) is tmod.MultiHeadAttention
    assert model.encoder.layers[0].ffn1.act is torch.relu


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = tmp_path_factory.mktemp("espnet_conformer")
    corpus = make_synth_corpus(str(root / "corpus"), n_train=0, n_dev=0, n_test=5,
                               n_tone_chars=6, vocab_size=20, seconds_range=(0.6, 2.0),
                               tone_sec=0.3, seed=0)
    vocab = Vocab.load(corpus["vocab"])
    cfg = relpos_config(n_mels=20, lfr_m=1, lfr_n=1, fbank_impl="pallas")
    model = SpeechTransformer(cfg, vocab.vocab_size, torch.Generator().manual_seed(7))
    exp = root / "exp"
    exp.mkdir()
    Config(**cfg.to_dict()).save(str(exp / "config.json"))
    save_torch_checkpoint(str(exp), model.state_dict(), vocab.fingerprint(), "latest")
    return str(exp), corpus, cfg, model


def test_recognize_beam_encodes_as_the_plain_reference(experiment, monkeypatch, tmp_path):
    exp, corpus, cfg, model = experiment
    seen = []
    encode = SpeechTransformer.encode

    def keep(self, feats, lengths):
        enc, enc_len = encode(self, feats, lengths)
        seen.append((feats, lengths, enc, enc_len))
        return enc, enc_len

    monkeypatch.setattr(SpeechTransformer, "encode", keep)
    res = recognize(exp, corpus["vocab"], manifest=corpus["test"], device="cpu", mode="beam",
                    beam_size=3, batch_size=2, max_decode_len=6, out=str(tmp_path / "r.json"))
    assert len(res["utts"]) == 5 and seen
    plain = PlainConformer(plain_cfg(cfg), {k: v.detach() for k, v in model.state_dict().items()})
    for feats, lengths, enc, enc_len in seen:
        ref, ref_len = plain.encode(feats.float(), lengths)
        assert torch.equal(enc_len, ref_len)
        for b in range(enc.shape[0]):
            n = int(ref_len[b])
            assert rel_gap(enc[b, :n].float(), ref[b, :n]) <= TOL
    assert json.loads((tmp_path / "r.json").read_text())


@pytest.mark.parametrize("overrides, match", [
    (dict(attn_impl="ring"), "ring"),
    (dict(attention_band=8), "band or causal"),
    (dict(causal_encoder=True, attention_band=8), "band or causal"),
    (dict(encoder_type="transformer"), "conformer"),
])
def test_the_encoder_refuses_the_routes_it_does_not_take(overrides, match):
    with pytest.raises(ValueError, match=match):
        SpeechTransformer(relpos_config(**overrides), VOCAB)


def test_the_encoder_does_not_stream():
    model = SpeechTransformer(relpos_config(frontend="linear"), VOCAB)
    with pytest.raises(ValueError, match="does not stream"):
        model.encoder.encode_chunk(torch.zeros(1, 4, 20), model.encoder.init_chunk_tails(1), 0)


def test_heads_split_over_model_are_refused():
    model = SpeechTransformer(relpos_config(), VOCAB)
    attn = model.encoder.layers[0].attn
    monkey = type("Split", (), {"index": 0, "size": 2})()
    attn.q_proj.tp = monkey
    with pytest.raises(ValueError, match="not sharded"):
        attn.relpos(torch.zeros(1, 5, 32), torch.zeros(9, 32), torch.tensor([5]))


# -- what chip_smoke.py's phase 7c expects of the card --------------------------


def test_relpos_bounds_match_the_hand_reckoning():
    """At the fill batch's 10 s bucket, (409, 4, 249, 64) bf16: K11 moves
    q, k, v, out (4 x 26.07 M elements) and the 101.4 M positional terms a
    row reads, 411.4 MB; K12 eight tensors and the terms read and written,
    822.9 MB; both bound by those bytes at 3.35 TB/s (0.1228 and 0.2456
    ms) against 26.0 and 64.9 GFLOP of tensor-core time (0.026 and 0.066
    ms)."""
    fwd = chip_smoke.relpos_fwd_bound(409, 4, 249, 64)
    bwd = chip_smoke.relpos_bwd_bound(409, 4, 249, 64)
    assert fwd["bytes"] == 2 * (4 * 409 * 4 * 249 * 64 + 409 * 4 * 249 * 249) == 411_437_640
    assert bwd["bytes"] == 2 * (8 * 409 * 4 * 249 * 64 + 2 * 409 * 4 * 249 * 249)
    assert fwd["flops"] / 1e9 == pytest.approx(25.97, abs=0.01)
    assert bwd["flops"] / 1e9 == pytest.approx(64.92, abs=0.01)
    assert fwd["bound_by"] == bwd["bound_by"] == "bytes"
    assert fwd["bound_ms"] == pytest.approx(0.1228, abs=1e-4)
    assert bwd["bound_ms"] == pytest.approx(0.2456, abs=1e-4)


def test_the_chip_check_counts_every_dropout_mask_of_a_step():
    """``ESPNET_MASKS`` is what a train step of ``ESPNET_CONFORMER`` draws
    (at tiny widths, its depths): each mask launches K10 forward and
    backward on the card, but the relative table's, which needs no
    gradient, forward only."""
    widths = dict(d_model=16, num_heads=4, head_dim=4, d_ff=32, frontend_channels=4)
    cfg = default_config().build(ctc_weight=0.3, dropout_impl="hash", attn_impl="fused",
                                 **{**chip_smoke.ESPNET_CONFORMER, **widths})
    model = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(0))
    needs_grad = []
    forward = layers.ConfigurableDropout.forward

    def counted(self, x, rng, heads=None):
        if rng is not None and self.rate > 0.0:
            needs_grad.append(x.requires_grad)
        return forward(self, x, rng, heads)

    feats = torch.randn(2, 120, 80)
    labels = torch.randint(4, VOCAB, (2, 5))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers.ConfigurableDropout, "forward", counted)
        model(feats, torch.tensor([120, 100]), labels, torch.tensor([5, 4]),
              rng=torch.Generator().manual_seed(1))
    assert len(needs_grad) == chip_smoke.ESPNET_MASKS == 69
    assert needs_grad.count(False) == 1


# -- on the card: K11 / K12 against the plain version, bf16 -------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K11/K12 are CUDA kernels with no CPU mode")
    return torch.device("cuda")


# K11/K12 write bf16: against the f32 plain version on the same bf16 inputs
# that rounding alone is 1.66e-3 of each tensor's norm, and the kernels
# read 1.65-1.82e-3 on an H100 (out, dq, dk, dv, dpos, whole and per utterance). A bar
# of 1e-2 on every tensor's relative norm gap leaves that room and catches
# a gradient off by 3 % (3.0e-2), or wrong on a few of its rows (dpos = dS
# scale is about 1e-2 of dq's size: an absolute bar would pass it whatever
# it held)
CARD_GAP = 1e-2


@pytest.mark.card
def test_k11_k12_match_the_plain_version_in_bf16(card):
    q, k, v, pos, lengths = chip_smoke._relpos_kernel_inputs((64, 4, 250, 64), card, 0)
    scale = 64 ** -0.5
    args = [x.clone().requires_grad_(True) for x in (q, k, v, pos)]
    out = fa.fused_attention_general(args[0], args[1], args[2], lengths, lengths, 0, scale,
                                     0.0, False, 0, args[3])
    dout = torch.randn_like(out)
    out.backward(dout)
    ref = fa.attention_reference(q.float(), k.float(), v.float(), lengths, lengths, 0, scale,
                                 0.0, False, 0, pos.float())
    grads = fa.attention_backward_reference(q.float(), k.float(), v.float(), lengths, lengths,
                                            0, scale, 0.0, False, 0, dout.float(), pos.float())
    rows = (torch.arange(q.shape[2], device=card)[None, :] < lengths[:, None])[:, None, :, None]
    assert rel_gap(out.detach().float() * rows, ref * rows) <= CARD_GAP
    for name, got, want in zip(("dq", "dk", "dv", "dpos"), args, grads):
        assert rel_gap(got.grad.float(), want) <= CARD_GAP, name


@pytest.mark.card
def test_relpos_refuses_f32_cuda_tensors(card):
    q, k, v, pos, lengths = (x.float() if x.is_floating_point() else x
                             for x in chip_smoke._relpos_kernel_inputs((2, 4, 16, 64), card, 0))
    with pytest.raises(ValueError, match="bf16 only"):
        fa.fused_attention_general(q, k, v, lengths, lengths, 0, 0.125, 0.0, False, 0, pos)


@pytest.mark.parametrize("device, dtypes, want", [
    ("cpu", (torch.float32, torch.float32), False),
    ("cpu", (torch.bfloat16, torch.bfloat16), False),
    ("cuda", (torch.bfloat16, torch.bfloat16), True),
    ("cuda", (torch.float32, torch.float32), ValueError),
    ("cuda", (torch.bfloat16, torch.float32), ValueError),
])
def test_relpos_takes_the_plain_version_on_the_cpu_only(device, dtypes, want):
    """On the card the positional term runs K11/K12 or raises: it never
    falls back to the plain version's (B, H, T, T) scores there."""
    if want is ValueError:
        with pytest.raises(ValueError, match="bf16 only"):
            fa.relpos_on_kernels(device, *dtypes)
    else:
        assert fa.relpos_on_kernels(device, *dtypes) is want
