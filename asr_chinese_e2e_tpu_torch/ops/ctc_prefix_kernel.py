"""The joint CTC/attention search's CTC prefix registers (``csrc/ctc_prefix.cu``,
K8): the port of the ``lax.scan`` over frames in
``asr_chinese_e2e_tpu/decode/joint.py::_ctc_selected_registers``.

For each of the B*K selected extensions h = g·token of a decode step, the
per-frame registers r_nb(t) (CTC prefix mass ending in a non-blank) and
r_b(t) (ending in a blank) from the parent's registers and the CTC
log-probs. The recursion is sequential in T and independent across
hypotheses: one kernel launch per decode step, a warp per hypothesis, which
scans the frames as compositions of affine maps in the log semiring (32
chunks of frames, then a replay of each chunk from its carry-in).

``ctc_selected_registers`` runs the plain version
``ctc_selected_registers_reference`` (a loop over frames on tensors) on CPU
tensors and launches the kernel on CUDA tensors, or raises.
"""

from __future__ import annotations

import torch

from ..data.vocab import BLANK_ID
from ._build import check, load_library

LOG_ZERO = -1e30


def _lae(a, b):
    return torch.logaddexp(a, b)


def _frame_inputs(ctc_lp_flat, frame_mask, token):
    """(xs (B, K, T) of each token, blank (B, 1, T)), masked: log-zero and 0
    on padded frames, where emitting is impossible and blank is free."""
    b = token.shape[0]
    c = ctc_lp_flat.shape[0] // b
    base = torch.arange(b, device=token.device)[:, None] * c
    xs = ctc_lp_flat[base + token]
    blank = ctc_lp_flat[base[:, 0] + BLANK_ID][:, None, :]
    fm = frame_mask[:, None, :]
    return torch.where(fm, xs, LOG_ZERO), torch.where(fm, blank, 0.0)


def ctc_selected_registers_reference(ctc_lp_flat, frame_mask, r_nb_g, r_b_g, token, last,
                                     is_empty):
    """Plain version of K8. ctc_lp_flat: (B*C, T) f32 class-major log-probs;
    frame_mask: (B, T) bool; r_nb_g, r_b_g: (B, K, T) registers of the
    selected parents; token, last: (B, K); is_empty: bool or (B, K) bool.
    Returns (r_nb, r_b), (B, K, T) f32, held on padded frames."""
    xs, blank = _frame_inputs(ctc_lp_flat, frame_mask, token)
    phi = torch.where((token == last)[:, :, None], r_b_g, _lae(r_b_g, r_nb_g))
    empty = torch.as_tensor(is_empty, device=token.device)
    r_nb = torch.where(empty, xs[..., 0], LOG_ZERO)
    r_b = torch.full_like(r_nb, LOG_ZERO)
    out_nb, out_b = [r_nb], [r_b]
    for t in range(1, xs.shape[-1]):
        x = xs[..., t]
        nb = _lae(r_nb + x, phi[..., t - 1] + x)
        bb = _lae(r_b, r_nb) + blank[..., t]
        valid = frame_mask[:, t, None]
        r_nb, r_b = torch.where(valid, nb, r_nb), torch.where(valid, bb, r_b)
        out_nb.append(r_nb)
        out_b.append(r_b)
    return torch.stack(out_nb, dim=-1), torch.stack(out_b, dim=-1)


def ctc_selected_registers_kernel(ctc_lp_flat, frame_mask, r_nb_g, r_b_g, token, last,
                                  is_empty):
    """K8 on CUDA tensors, one launch; same contract as the plain version,
    but ``is_empty`` is one bool for every hypothesis (the search's first
    step)."""
    b, k = token.shape
    t_max = ctc_lp_flat.shape[-1]
    dev = ctc_lp_flat.device
    if ctc_lp_flat.dtype != torch.float32 or ctc_lp_flat.dim() != 2 or ctc_lp_flat.shape[0] % b:
        raise ValueError(
            f"ctc prefix kernel: want (B*C, T) f32 log-probs, got "
            f"{tuple(ctc_lp_flat.shape)} {ctc_lp_flat.dtype}"
        )
    for name, x in (("r_nb_g", r_nb_g), ("r_b_g", r_b_g)):
        if x.shape != (b, k, t_max) or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"ctc prefix kernel: {name} {tuple(x.shape)} {x.dtype} {x.device}")
    if frame_mask.shape != (b, t_max) or frame_mask.dtype != torch.bool:
        raise ValueError(f"ctc prefix kernel: frame_mask {tuple(frame_mask.shape)}")
    if last.shape != (b, k):
        raise ValueError(f"ctc prefix kernel: last {tuple(last.shape)}")
    if not isinstance(is_empty, bool):
        raise ValueError(f"ctc prefix kernel: is_empty must be a bool, got {type(is_empty)}")
    as_i64 = lambda x: x.to(device=dev, dtype=torch.int64).contiguous()
    token, last = as_i64(token), as_i64(last)
    lp, fm = ctc_lp_flat.contiguous(), frame_mask.to(dev).contiguous()
    g_nb, g_b = r_nb_g.contiguous(), r_b_g.contiguous()
    r_nb = torch.empty((b, k, t_max), dtype=torch.float32, device=dev)
    r_b = torch.empty_like(r_nb)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.asr_ctc_prefix_registers(
            lp.data_ptr(), fm.data_ptr(), g_nb.data_ptr(), g_b.data_ptr(), token.data_ptr(),
            last.data_ptr(), int(is_empty), r_nb.data_ptr(), r_b.data_ptr(), b, k,
            lp.shape[0] // b, t_max, BLANK_ID, torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_ctc_prefix_registers")
    ctc_selected_registers_kernel.launches += 1
    return r_nb, r_b


def ctc_selected_registers(ctc_lp_flat, frame_mask, r_nb_g, r_b_g, token, last, is_empty):
    """The registers of the selected extensions: the plain version on CPU
    tensors, K8 on CUDA tensors."""
    dev = ctc_lp_flat.device.type
    if dev == "cpu":
        fn = ctc_selected_registers_reference
    elif dev == "cuda":
        fn = ctc_selected_registers_kernel
    else:
        raise ValueError(f"ctc prefix kernel: unsupported device {ctc_lp_flat.device}")
    return fn(ctc_lp_flat, frame_mask, r_nb_g, r_b_g, token, last, is_empty)


# kernel launches so far (the CPU path does not count)
ctc_selected_registers_kernel.launches = 0
