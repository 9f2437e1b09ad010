"""Three-tier merge config system.

Reproduces the reference's config semantics (``Predictor/Bases/base_config.py:4-46``,
``main.py:55-63``): a data-level config is combined with the model's default
config, then CLI kwargs are applied last. Precedence: CLI > model config >
data/train config. Unknown keys are *added*, not rejected
(``base_config.py:12-15``).

Differences from the reference (deliberate):
- persistence is JSON, not a torch pickle (``base_config.py:33-41``);
- ``show()`` returns the string instead of printing tensors.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterator, Mapping


class Config:
    """Attribute-access config with reference merge semantics.

    >>> c = Config(a=1)
    >>> c.combine(Config(b=2)).build(a=3)
    >>> (c.a, c.b)
    (3, 2)
    """

    def __init__(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- merge tiers ------------------------------------------------------
    def combine(self, other: "Config | Mapping[str, Any]") -> "Config":
        """Tier-2 merge: model defaults override data/train config
        (mirrors ``BaseConfig.fn_combine``, ``base_config.py:17-20``)."""
        items = other.items() if isinstance(other, Mapping) else vars(other).items()
        for k, v in items:
            setattr(self, k, v)
        return self

    def build(self, **kwargs: Any) -> "Config":
        """Tier-3 merge: CLI kwargs win; unknown keys are added
        (mirrors ``BaseConfig.fn_build``, ``base_config.py:7-15``)."""
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    # -- mapping-ish ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dict(vars(self))

    def items(self) -> Iterator[Any]:
        return vars(self).items()

    def get(self, key: str, default: Any = None) -> Any:
        return vars(self).get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in vars(self)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and vars(self) == vars(other)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in sorted(vars(self).items()))
        return f"Config({inner})"

    def show(self) -> str:
        return "\n".join(f"{k}: {v}" for k, v in sorted(vars(self).items()))

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True, default=str)

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls(**json.load(f))


def resolve_config(
    data_config: Config,
    model_default_config: Config,
    cli_kwargs: Mapping[str, Any],
) -> Config:
    """The full three-stage merge as done by ``main.py:55-63``."""
    cfg = Config(**data_config.to_dict())
    cfg.combine(model_default_config)
    cfg.build(**dict(cli_kwargs))
    return cfg
