"""String-keyed model registry (``asr_chinese_e2e_tpu/core/registry.py``):
each name maps to (model class, default config function). The transformer
names and ``Conformer`` resolve to ``SpeechTransformer``; ``BiLSTMCTC`` and
``LAS`` to the RNN family, ``ExampleModel`` to the null model.
"""

from __future__ import annotations

from typing import Callable, Tuple

from .config import Config

_REGISTRY: dict[str, Tuple[type, Callable[[], Config]]] = {}


def register(name: str, model_cls: type, default_config: Callable[[], Config]) -> None:
    _REGISTRY[name] = (model_cls, default_config)


def get_model(name: str) -> Tuple[type, Callable[[], Config]]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def _populate() -> None:
    from ..models import example, rnn, transformer

    st, default = transformer.SpeechTransformer, transformer.default_config
    register("SpeechTransformer", st, default)
    # reference aliases (Predictor/Models/__init__.py:1-5), each with the
    # variant's distinguishing hyperparameters
    register("TransformerOffical", st, default)
    register("Transformer", st, lambda: default().build(d_ff=512))
    register(
        "TransformerNew", st,
        lambda: default().build(d_model=256, num_heads=4, d_ff=256, attention_band=50),
    )
    register("TransformerNew2", st, default)
    # conv-augmented encoder blocks (Gulati et al. 2020) over the same
    # decoder, CTC head and decoding modes
    register(
        "Conformer", st,
        lambda: default().build(encoder_type="conformer", norm_type="pre"),
    )
    register("BiLSTMCTC", rnn.BiLSTMCTC, rnn.default_ctc_config)
    register("LAS", rnn.LAS, rnn.default_las_config)
    register("ExampleModel", example.ExampleModel, example.default_config)


_populate()
