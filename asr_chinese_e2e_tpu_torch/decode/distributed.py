"""Distributed decode: data-parallel beam search and the exchange of score
tiles across ranks (``asr_chinese_e2e_tpu/decode/distributed.py``).

Decoding is data-parallel: each rank runs the whole beam search
(``decode/beam.py``) on its rows of the batch, and only the finished
tiles cross between ranks. Beam rows are independent across utterances,
so the gathered n-best equals one process's ``beam_search`` of the whole
batch.

- ``distributed_beam_search``: each rank searches its rows, then one
  gather over ``data`` of the (B_local, K, L) tokens, (B_local, K) scores
  and finished flags gives every rank the global n-best.
- ``exchange_scores``: (B_local, K) score tiles -> the global (B, K).
- ``distributed_rescore_scores``: fuse lambda ctc + (1 - lambda) att per
  rank, exchange the tiles, return the global scores and each
  utterance's best hypothesis; ``make_sharded_rescorer`` binds it to a
  mesh.

The tiles are a few KB. gloo gathers only CPU tensors, so they are
gathered as one ``all_reduce`` of a zero buffer in which each rank writes
its rows (``parallel/collectives.py::all_gather_cat``): exact, and the
same call on NCCL and on gloo with CUDA tensors.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import all_gather_cat
from ..parallel.sharding import DATA_AXIS, batch_rows
from .beam import BeamResult, beam_search


def distributed_beam_search(
    model, enc_out, enc_lengths, beam_size: int, max_len: int, mesh,
    length_penalty: float = 0.0, data_axis: str = DATA_AXIS, local_rows: bool = False,
) -> BeamResult:
    """Data-parallel batched beam search over ``mesh``'s ``data_axis``.

    ``enc_out`` / ``enc_lengths`` are the global batch (every rank the
    same), of which each rank searches its rows; with ``local_rows`` they
    are already this rank's rows of a global batch of equal shares. Every
    rank returns the global n-best (device tensors), identical to one
    process's ``beam_search`` of the global batch. A global batch that does
    not divide the axis is searched whole on every rank."""
    dp = mesh.shape[data_axis]
    if dp == 1 or (not local_rows and enc_out.shape[0] % dp):
        return beam_search(model, enc_out, enc_lengths, beam_size, max_len, length_penalty)
    if not local_rows:
        rows = batch_rows(mesh, enc_out.shape[0])
        enc_out, enc_lengths = enc_out[rows], enc_lengths[rows]
    res = beam_search(model, enc_out, enc_lengths, beam_size, max_len, length_penalty)
    group = mesh.group(data_axis)
    tokens = torch.as_tensor(res.tokens, device=enc_out.device)
    scores = torch.as_tensor(res.scores, device=enc_out.device)
    finished = torch.as_tensor(res.finished, device=enc_out.device)
    return BeamResult(
        all_gather_cat(tokens, group), all_gather_cat(scores, group),
        all_gather_cat(finished.to(torch.int32), group).bool(),
    )


def exchange_scores(local_scores: torch.Tensor, group) -> torch.Tensor:
    """(B_local, K) score tile -> (B_global, K), the ranks' tiles in rank
    order along the batch."""
    return all_gather_cat(local_scores, group)


def distributed_rescore_scores(ctc_scores, att_scores, ctc_weight: float, group):
    """Fuse lambda ctc + (1 - lambda) att on this rank's (B_local, K) tiles,
    exchange them, and return the global (B, K) fused scores and each
    utterance's best hypothesis index."""
    fused = ctc_weight * ctc_scores + (1.0 - ctc_weight) * att_scores
    global_fused = exchange_scores(fused, group)
    return global_fused, global_fused.argmax(dim=-1)


def make_sharded_rescorer(mesh, data_axis: str = DATA_AXIS):
    """(ctc_scores, att_scores, lambda) of the global batch (every rank the
    same) -> (global fused scores, best index), each rank fusing its rows."""
    group = mesh.group(data_axis)

    def rescore(ctc_scores, att_scores, ctc_weight):
        bsz = ctc_scores.shape[0]
        rows = batch_rows(mesh, bsz)
        if rows.stop - rows.start == bsz:  # one rank, or rows that do not divide
            return distributed_rescore_scores(ctc_scores, att_scores, float(ctc_weight), None)
        return distributed_rescore_scores(ctc_scores[rows], att_scores[rows],
                                          float(ctc_weight), group)

    return rescore
