r"""Preprocessing CLI of the port (the root ``preprocess.py`` of the JAX
package): extract the AISHELL-1 archive, build manifests + vocab, and
predump features.

    python -m asr_chinese_e2e_tpu_torch.preprocess pipeline --archive data_aishell.tgz --out data/
    python -m asr_chinese_e2e_tpu_torch.preprocess extract  --archive data_aishell.tgz --out data/
    python -m asr_chinese_e2e_tpu_torch.preprocess build    --root data/data_aishell --out data/
    python -m asr_chinese_e2e_tpu_torch.preprocess features --manifest data/train.jsonl \
        --out data/feats/train [--n_mels 80 --lfr_m 4 --lfr_n 3 --batch_size 32 \
        --max_seconds 15.0] [--device cuda]

``features`` computes through ``data/features.py::parse_batch`` with the
fbank kernel K5 (one launch per chunk of ``batch_size``; CMVN and LFR
after it) on ``--device`` (``cuda`` unless the caller asks for ``cpu``,
which runs the plain version), and writes one ``.npy`` of (T, D) float32
features per utterance plus ``manifest.jsonl`` with rows ``{"feature",
"wave", "tgt", "frames"}``: what ``BucketedLoader(..., feat_cfg=...)``
reads and ``Trainer(raw_features=True)`` trains on.
"""

from __future__ import annotations

import os
import sys

from .data.extract import extract_aishell1
from .data.manifest import AiShell1Collector
from .utils.cli import parse_kwargs


def extract(archive: str, out: str = "data/") -> str:
    root = extract_aishell1(archive, out)
    print(f"extracted to {root}")
    return root


def build(root: str, out: str = "data/", min_count: int = 1, max_vocab: int = 20000):
    collector = AiShell1Collector(root)
    for split, records in collector.items.items():
        print(f"{split}: {len(records)} utterances")
    vocab = collector.build_vocab(min_count=min_count, max_vocab=max_vocab)
    os.makedirs(out, exist_ok=True)
    vocab_path = os.path.join(out, "vocab.json")
    vocab.save(vocab_path)
    print(f"vocab: {vocab.vocab_size} tokens -> {vocab_path}")
    paths = collector.save(out)
    for split, path in paths.items():
        print(f"manifest[{split}] -> {path}")


def pipeline(archive: str, out: str = "data/", **kw):
    root = extract(archive, out)
    build(root, out, **kw)


def features(
    manifest: str,
    out: str,
    n_mels: int = 80,
    lfr_m: int = 4,
    lfr_n: int = 3,
    batch_size: int = 32,
    max_seconds: float = 15.0,
    device: str = "cuda",
    **_,
) -> str:
    """Predump features to ``.npy`` + a cached-feature manifest (the
    reference's ``pre_dump_features``, ``data/data_loader/ai_shell_1.py:44-64``);
    returns the manifest's path."""
    import numpy as np
    import torch

    from .data.features import FeatureConfig, parse_batch
    from .data.io import load_wav
    from .data.manifest import read_manifest, write_manifest

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but CUDA is not available")
    cfg = FeatureConfig(n_mels=n_mels, lfr_m=lfr_m, lfr_n=lfr_n, fbank_impl="pallas")
    records = read_manifest(manifest)
    os.makedirs(out, exist_ok=True)
    max_samples = int(max_seconds * cfg.sample_rate)
    new_records = []
    for start in range(0, len(records), batch_size):
        chunk = records[start : start + batch_size]
        waves = [load_wav(r["wave"])[:max_samples] for r in chunk]
        wave = np.zeros((len(chunk), max(len(w) for w in waves)), np.float32)
        lengths = np.zeros((len(chunk),), np.int32)
        for j, w in enumerate(waves):
            wave[j, : len(w)] = w
            lengths[j] = len(w)
        with torch.inference_mode():
            feats, feat_lens = parse_batch(
                torch.from_numpy(wave).to(dev), torch.from_numpy(lengths).to(dev), cfg
            )
            feats, feat_lens = feats.cpu().numpy(), feat_lens.cpu().numpy()
        for j, r in enumerate(chunk):
            utt = r["wave"].rsplit("/", 1)[-1].rsplit(".", 1)[0]
            path = os.path.join(out, utt + ".npy")
            np.save(path, feats[j, : feat_lens[j]])
            new_records.append(
                {"feature": path, "wave": r["wave"], "tgt": r["tgt"],
                 "frames": int(feat_lens[j])}
            )
        if (start // batch_size) % 50 == 0:
            print(f"{start + len(chunk)}/{len(records)}")
    out_manifest = os.path.join(out, "manifest.jsonl")
    write_manifest(out_manifest, new_records)
    print(f"wrote {len(new_records)} cached-feature rows -> {out_manifest}")
    return out_manifest


def main():
    if any(a in ("--help", "-h") for a in sys.argv[1:]):
        print(__doc__)
        return
    positional, kwargs = parse_kwargs(sys.argv[1:])
    cmd = positional[0] if positional else "pipeline"
    fn = {
        "extract": extract,
        "build": build,
        "pipeline": pipeline,
        "features": features,
    }.get(cmd)
    if fn is None:
        print(__doc__)
        sys.exit(1)
    fn(**kwargs)


if __name__ == "__main__":
    main()
