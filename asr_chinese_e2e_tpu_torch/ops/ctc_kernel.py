"""CTC loss with a fused forward-backward (``csrc/ctc.cu``): the port of the
TPU kernels ``asr_chinese_e2e_tpu/ops/ctc_pallas.py::_alpha_kernel`` (K3)
and ``_beta_kernel`` with ``_ctc_bwd`` (K4).

``ctc_loss_kernel`` has the contract of ``ctc_loss_pallas``: per-utterance
NLL from (B, T, C) logits, differentiable in the logits, with the gradient
in the logits' dtype. It is selected by ``ctc_impl="pallas"``. On CPU
tensors it runs the plain versions ``ctc_alpha_reference`` and
``ctc_beta_reference`` (the counterparts of ``_run_recursions`` +
``_loss_from_alpha`` and of ``_ctc_bwd``); on CUDA tensors it launches the
kernels or raises.
"""

from __future__ import annotations

import torch

from ._build import check, load_library
from .ctc import BIG_NEG, alpha_step, extend_labels, loss_from_alpha, skip_mask


def _emissions(logits32, lse, ext):
    """(B, T, S) log-probs of the extended labels, by a direct gather."""
    t_max = logits32.shape[1]
    return logits32.gather(2, ext[:, None, :].expand(-1, t_max, -1)) - lse[..., None]


def _shift_left(x: torch.Tensor, k: int) -> torch.Tensor:
    """new[:, s] = x[:, s+k], filled with BIG_NEG."""
    return torch.cat([x[:, k:], torch.full_like(x[:, :k], BIG_NEG)], dim=1)


def _compute_dtype(logits) -> torch.dtype:
    """f32 for bf16/f32 logits; f64 logits stay f64 (the float64
    evaluations the card's checks hold the kernels to)."""
    return torch.promote_types(logits.dtype, torch.float32)


def ctc_alpha_reference(logits, ext, logit_lengths, label_lengths, blank_id=0):
    """Plain version of K3. Returns (loss (B,), alpha (B, T, S), lse (B, T)),
    all float32 (float64 for float64 logits); alpha is frozen past each
    logit length."""
    logits32 = logits.to(_compute_dtype(logits))
    lse = torch.logsumexp(logits32, dim=-1)
    emit = _emissions(logits32, lse, ext)
    t_max, s = emit.shape[1], emit.shape[2]
    skip = skip_mask(ext, blank_id)
    lens = logit_lengths.to(logits.device)
    s_idx = torch.arange(s, device=logits.device)[None, :]
    alpha = torch.where(s_idx <= 1, emit[:, 0], torch.full_like(emit[:, 0], BIG_NEG))
    table = [alpha]
    for t in range(1, t_max):
        alpha = alpha_step(alpha, emit[:, t], skip, (t < lens)[:, None])
        table.append(alpha)
    return loss_from_alpha(alpha, label_lengths), torch.stack(table, dim=1), lse


def ctc_beta_reference(
    logits, ext, logit_lengths, label_lengths, lse, alpha, loss, g, blank_id=0
):
    """Plain version of K4: the reverse beta' recursion, gamma = alpha +
    beta' - emit, z = exp(min(gamma + loss, 0)) masked past the length,
    the scatter of z onto the classes and the log-softmax chain, scaled by
    the cotangent ``g`` (B,). Returns d_logits in the logits' dtype
    (arithmetic in f32, f64 for f64 logits). For f32 (and f64) logits each
    row of z is normalised by its sum where the label can be aligned (loss
    < 1e29), softmax - scattered / sum(z), as the kernel does: sum(z) is 1
    in exact arithmetic, and in f32 it carries the rounding of the terms
    near the loss into the whole row (``csrc/ctc.cu``)."""
    logits32 = logits.to(_compute_dtype(logits))
    emit = _emissions(logits32, lse, ext)
    bsz, t_max, s = emit.shape
    dev = logits.device
    skip = skip_mask(ext, blank_id)
    lens = logit_lengths.to(dev)[:, None]
    last = (2 * label_lengths.to(dev)).long()[:, None]
    s_idx = torch.arange(s, device=dev)[None, :]
    big = torch.full((bsz, s), BIG_NEG, dtype=logits32.dtype, device=dev)
    betas = [None] * t_max
    beta = big
    for t in range(t_max - 1, -1, -1):
        final = torch.where(
            (s_idx == last) | (s_idx == (last - 1).clamp(min=0)), emit[:, t], big
        )
        if t == t_max - 1:
            beta = torch.where(t == lens - 1, final, big)
        else:
            stay = torch.logaddexp(beta, _shift_left(beta, 1))
            skip_next = _shift_left(torch.where(skip, beta, big), 2)
            new = torch.logaddexp(stay, skip_next) + emit[:, t]
            beta = torch.where(t == lens - 1, final, torch.where(t < lens - 1, new, big))
        betas[t] = beta
    gamma = alpha + torch.stack(betas, dim=1) - emit
    z = torch.exp(torch.clamp(gamma + loss[:, None, None], max=0.0))
    t_mask = torch.arange(t_max, device=dev)[None, :, None] < lens[:, :, None]
    z = torch.where(t_mask, z, torch.zeros_like(z))
    scattered = torch.zeros_like(logits32).scatter_add_(
        2, ext[:, None, :].expand(-1, t_max, -1), z
    )
    softmax = torch.exp(logits32 - lse[..., None])
    zs = z.sum(-1, keepdim=True)
    w, inv = zs, torch.ones_like(zs)
    if logits.dtype != torch.bfloat16:
        normalise = (loss < 1e29)[:, None, None]
        pos = zs > 0
        w = torch.where(normalise, pos.to(zs.dtype), zs)
        inv = torch.where(normalise, torch.where(pos, 1.0 / torch.where(pos, zs, 1.0), 0.0), inv)
    d_logits = softmax * w - scattered * inv
    return (d_logits * g.to(logits32.dtype)[:, None, None]).to(logits.dtype)


def _check_kernel_inputs(logits, ext, logit_lengths, label_lengths):
    if logits.device.type != "cuda":
        raise ValueError(f"ctc kernel: unsupported device {logits.device}")
    if logits.dim() != 3 or logits.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"ctc kernel: want (B, T, C) f32/bf16, got {tuple(logits.shape)} {logits.dtype}"
        )
    if not logits.is_contiguous():
        raise ValueError("ctc kernel: logits must be contiguous")
    if logits.data_ptr() % 16:  # K4's rows share the gradient's 16-byte alignment
        raise ValueError("ctc kernel: logits must start on a 16-byte boundary")
    bsz = logits.shape[0]
    if ext.shape[0] != bsz or ext.shape[1] > 1024:
        raise ValueError(f"ctc kernel: extended labels {tuple(ext.shape)}")
    dev = logits.device
    as_i32 = lambda x: x.to(device=dev, dtype=torch.int32).contiguous()
    lens, lab_lens = as_i32(logit_lengths), as_i32(label_lengths)
    if lens.shape != (bsz,) or lab_lens.shape != (bsz,):
        raise ValueError("ctc kernel: lengths must be (B,)")
    return as_i32(ext), lens, lab_lens


def ctc_alpha_kernel(logits, ext, logit_lengths, label_lengths, blank_id=0):
    """K3 on checked CUDA tensors (int32 ext and lengths on the logits'
    device): returns (loss (B,), alpha (B, T, S), lse (B, T)), float32.
    Alpha rows at t >= the logit length are left unwritten. Two launches:
    the row pass, a warp per (b, t) row, writing the log-sum-exp and the
    (B, T, S) emission table (scratch, allocated here); the recursion, a
    block per utterance and a thread per state. f32 logits take the
    accurate exp / log, bf16 logits the approximate ones."""
    bsz, t_max, c = logits.shape
    s = ext.shape[1]
    dev = logits.device
    lse = torch.empty((bsz, t_max), dtype=torch.float32, device=dev)
    emit = torch.empty((bsz, t_max, s), dtype=torch.float32, device=dev)
    alpha = torch.empty((bsz, t_max, s), dtype=torch.float32, device=dev)
    loss = torch.empty((bsz,), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.asr_ctc_alpha(
            logits.data_ptr(), ext.data_ptr(), logit_lengths.data_ptr(),
            label_lengths.data_ptr(), lse.data_ptr(), emit.data_ptr(), alpha.data_ptr(),
            loss.data_ptr(), bsz, t_max, c, s, int(blank_id),
            int(logits.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_ctc_alpha")
    ctc_alpha_kernel.launches += 1
    return loss, alpha, lse


def ctc_beta_kernel(
    logits, ext, logit_lengths, label_lengths, lse, alpha, loss, g, blank_id=0
):
    """K4 on the tensors K3 used and produced, plus the cotangent ``g``
    (B,): returns d_logits (B, T, C) in the logits' dtype. Two launches: the
    reverse recursion, a block per utterance and a thread per state,
    writing the posteriors z (B, T, S); the gradient rows, a warp per (b, t)
    row. The design by dtype as in ``ctc_alpha_kernel``."""
    bsz, t_max, c = logits.shape
    s = ext.shape[1]
    dev = logits.device
    g = g.to(device=dev, dtype=torch.float32).contiguous()
    z = torch.empty((bsz, t_max, s), dtype=torch.float32, device=dev)
    d_logits = torch.empty_like(logits)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.asr_ctc_beta(
            logits.data_ptr(), ext.data_ptr(), logit_lengths.data_ptr(),
            label_lengths.data_ptr(), lse.data_ptr(), alpha.data_ptr(),
            loss.data_ptr(), g.data_ptr(), z.data_ptr(), d_logits.data_ptr(),
            bsz, t_max, c, s, int(blank_id), int(logits.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_ctc_beta")
    ctc_beta_kernel.launches += 1
    return d_logits


class _CTCLoss(torch.autograd.Function):
    """K3 forward, K4 backward (plain versions on the CPU). Saves the
    logits, the alpha table and the row log-sum-exp."""

    @staticmethod
    def forward(ctx, logits, logit_lengths, labels, label_lengths, blank_id):
        ext = extend_labels(labels.long().to(logits.device), blank_id)
        if logits.device.type == "cpu":
            lens, lab_lens = logit_lengths, label_lengths
            loss, alpha, lse = ctc_alpha_reference(logits, ext, lens, lab_lens, blank_id)
        else:
            ext, lens, lab_lens = _check_kernel_inputs(
                logits, ext, logit_lengths, label_lengths
            )
            loss, alpha, lse = ctc_alpha_kernel(logits, ext, lens, lab_lens, blank_id)
        ctx.blank_id = blank_id
        ctx.save_for_backward(logits, ext, lens, lab_lens, lse, alpha, loss)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, ext, lens, lab_lens, lse, alpha, loss = ctx.saved_tensors
        fn = ctc_beta_reference if logits.device.type == "cpu" else ctc_beta_kernel
        d_logits = fn(logits, ext, lens, lab_lens, lse, alpha, loss, g, ctx.blank_id)
        return d_logits, None, None, None, None


def ctc_loss_kernel(logits, logit_lengths, labels, label_lengths, blank_id: int = 0):
    """Per-utterance CTC NLL (B,) float32 from (B, T, C) logits (f32 or
    bf16); labels (B, L) 0-padded, blank ``blank_id``. Same contract as the
    JAX package's ``ctc_loss_pallas``."""
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ctc kernel: unsupported device {logits.device}")
    return _CTCLoss.apply(logits, logit_lengths, labels, label_lengths, int(blank_id))


# kernel launches so far (the CPU path does not count)
ctc_alpha_kernel.launches = 0
ctc_beta_kernel.launches = 0
