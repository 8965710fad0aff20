"""Shared parsing for numeric ``TPUSNAPSHOT_*`` env knobs.

One contract for every knob: a malformed value logs a warning and falls
back to the default — it must never raise. Several knobs are read inside
take/restore paths, where a config typo raising would abort a checkpoint
that could otherwise have completed with the default.
"""

import logging
import os

logger = logging.getLogger(__name__)


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning(
            f"Ignoring malformed {name}={raw!r}; using default {default}"
        )
        return default


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return float(raw)
    except ValueError:
        logger.warning(
            f"Ignoring malformed {name}={raw!r}; using default {default}"
        )
        return default
