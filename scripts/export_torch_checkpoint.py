"""Export a JAX experiment's orbax checkpoint as the PyTorch port's
checkpoint ``<exp>/torch_checkpoints/<which>.pt``.

A tool that imports both packages: it restores the parameters with the
JAX package's ``load_experiment`` (``best`` falls back to ``latest`` as
there) and maps them with the port's ``torch_state_from_flax``. Run:

    python scripts/export_torch_checkpoint.py --exp ckpt/<name> \
        --vocab data/vocab.json [--which best]

Then decode with ``python -m asr_chinese_e2e_tpu_torch.recognize``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def export(exp: str, vocab: str, which: str = "best") -> str:
    """Write the port checkpoint for ``exp``; returns its path."""
    import jax
    import numpy as np

    from asr_chinese_e2e_tpu.utils.experiment import load_experiment
    from asr_chinese_e2e_tpu_torch.core.config import Config
    from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
    from asr_chinese_e2e_tpu_torch.utils.experiment import save_torch_checkpoint

    _, params, cfg, _, voc = load_experiment(exp, vocab, which)
    params = jax.tree.map(np.asarray, jax.device_get(params))
    state = torch_state_from_flax(params, Config(**cfg.to_dict()), voc.vocab_size)
    return save_torch_checkpoint(exp, state, voc.fingerprint(), which)


def main():
    from asr_chinese_e2e_tpu_torch.utils.cli import parse_kwargs

    _, kwargs = parse_kwargs(sys.argv[1:])
    if kwargs.pop("help", False) or "exp" not in kwargs or "vocab" not in kwargs:
        print(__doc__)
        return
    print(export(**kwargs))


if __name__ == "__main__":
    main()
