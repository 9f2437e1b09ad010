"""The rescore mode's device CTC prefix beam search (``csrc/ctc_prefix_beam.cu``,
K9): the port of the ``lax.scan`` over frames in
``asr_chinese_e2e_tpu/decode/ctc_prefix_device.py::ctc_prefix_beam_device``.

The beam is kept as tensors: prefixes (B, K, L), lengths (B, K), last tokens
(B, K) and the per-prefix (log p ending in blank, ending in non-blank) pair.
Each frame merges duplicate prefixes, prunes the vocabulary to the frame's
top P classes, scores K·(P+1) candidates (the +1 is the "stay" candidate:
blank or repeat of the last token), folds an extension that recreates a
beam into that beam's stay candidate, and keeps the stable top K. Past each
utterance's length the carry is frozen. The kernel runs the whole loop in
one call: a row pass, four warps a frame row for every frame an utterance
has, then one warp per utterance, a beam a lane, carrying the beams' parent
relation from frame to frame (the design is in the source's note).

``decode/ctc_prefix_device.py::ctc_prefix_beam_device`` launches it on CUDA
tensors; its plain version there, ``ctc_prefix_beam_reference`` (a host loop
over frames of tensor operations), serves CPU tensors.
"""

from __future__ import annotations

import torch

from ..data.vocab import BLANK_ID
from ._build import check, load_library

# what the kernel holds: beam, prune and stored prefix length
MAX_BEAM = 32
MAX_PRUNE = 32
MAX_PREFIX_LEN = 128


def _check_inputs(log_probs, logit_lengths, beam_size, prune, max_prefix_len) -> int:
    """Raise ``ValueError`` on what K9 does not take; returns P, the
    prune width the search uses (``min(prune, C)``)."""
    if log_probs.dtype != torch.float32 or log_probs.dim() != 3:
        raise ValueError(
            f"ctc prefix beam kernel: want (B, T, C) f32 log-probs, got "
            f"{tuple(log_probs.shape)} {log_probs.dtype}"
        )
    bsz, _, vocab = log_probs.shape
    p = min(prune, vocab)
    limits = (("beam_size", beam_size, MAX_BEAM), ("prune", p, MAX_PRUNE),
              ("max_prefix_len", max_prefix_len, MAX_PREFIX_LEN))
    for name, value, most in limits:
        if not 1 <= value <= most:
            raise ValueError(
                f"ctc prefix beam kernel: {name} {value} outside [1, {most}]"
            )
    if tuple(logit_lengths.shape) != (bsz,):
        raise ValueError(
            f"ctc prefix beam kernel: lengths {tuple(logit_lengths.shape)} for batch {bsz}"
        )
    if log_probs.device.type != "cuda":
        raise ValueError(f"ctc prefix beam kernel: needs CUDA tensors, got {log_probs.device}")
    return p


def ctc_prefix_beam_kernel(log_probs, logit_lengths, beam_size, prune, max_prefix_len):
    """K9 on CUDA tensors, one call for the whole search: the contract of
    ``ctc_prefix_beam_device``, for f32 log-probs."""
    logit_lengths = torch.as_tensor(logit_lengths, device=log_probs.device)
    p = _check_inputs(log_probs, logit_lengths, beam_size, prune, max_prefix_len)
    bsz, t_max, vocab = log_probs.shape
    k, l = beam_size, max_prefix_len
    dev = log_probs.device
    lp = log_probs.contiguous()
    lengths = logit_lengths.to(torch.int64).contiguous()
    top_val = torch.empty((bsz, t_max, p), dtype=torch.float32, device=dev)
    top_idx = torch.empty((bsz, t_max, p), dtype=torch.int32, device=dev)
    prefixes = torch.empty((bsz, k, l), dtype=torch.int64, device=dev)
    plen = torch.empty((bsz, k), dtype=torch.int64, device=dev)
    scores = torch.empty((bsz, k), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.asr_ctc_prefix_beam(
            lp.data_ptr(), lengths.data_ptr(), top_val.data_ptr(), top_idx.data_ptr(),
            prefixes.data_ptr(), plen.data_ptr(), scores.data_ptr(), bsz, t_max, vocab, k,
            p, l, BLANK_ID, torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_ctc_prefix_beam")
    ctc_prefix_beam_kernel.launches += 1
    return prefixes, plen, scores


# kernel launches so far (the CPU path does not count)
ctc_prefix_beam_kernel.launches = 0
