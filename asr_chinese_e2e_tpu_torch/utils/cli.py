"""Tiny CLI kwargs parser with the reference's semantics.

The reference drives everything through ``fire.Fire`` with arbitrary
``--key=value`` kwargs that the config merge *adds* rather than rejects
(``main.py:103``, ``base_config.py:12-15``). ``fire`` is not available in
this image; this parser accepts ``--key value`` and ``--key=value``,
auto-coercing values (int → float → bool → str, with JSON lists)."""

from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple


def coerce(value: str) -> Any:
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value[:1] in "[{":
        try:
            return json.loads(value)
        except json.JSONDecodeError:
            pass
    return value


def parse_kwargs(argv: List[str]) -> Tuple[List[str], Dict[str, Any]]:
    """Split argv into (positional, {key: value})."""
    positional: List[str] = []
    kwargs: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg.startswith("--"):
            body = arg[2:]
            if "=" in body:
                key, val = body.split("=", 1)
                kwargs[key] = coerce(val)
            elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                kwargs[body] = coerce(argv[i + 1])
                i += 1
            else:
                kwargs[body] = True
        else:
            positional.append(arg)
        i += 1
    return positional, kwargs
