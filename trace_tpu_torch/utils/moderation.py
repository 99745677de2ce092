"""Content-moderation hook (trace_tpu/utils/moderation.py; reference
trace/utils.py:102-120).

The reference posts user text to a moderation endpoint and returns a flagged
bool, swallowing request errors. Here the check is pluggable: register a
callable (a local classifier, a proxied endpoint) with
``set_moderation_backend``; without one, or when it raises,
``violates_moderation`` fails open (returns False), as the reference does
when its request fails.
"""

from __future__ import annotations

from typing import Callable, Optional

_backend: Optional[Callable[[str], bool]] = None


def set_moderation_backend(fn: Optional[Callable[[str], bool]]) -> None:
    """fn(text) -> True if the text violates policy. None disables."""
    global _backend
    _backend = fn


def violates_moderation(text: str) -> bool:
    """True if a registered backend flags ``text`` (newlines removed); False
    otherwise, also when the backend raises."""
    if _backend is None:
        return False
    try:
        return bool(_backend(text.replace("\n", "")))
    except Exception:
        return False
