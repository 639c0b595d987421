"""Per-component logging.

Parity with ``pkg/logger/logger.go:15-56``: each component logs to its own
file under a shared log dir (reference: ``/kubeshare/log/<component>.log``)
plus stderr, with a numeric level knob 0..3 → ERROR..DEBUG
(``logger.go:41-45``).
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {0: logging.ERROR, 1: logging.WARNING, 2: logging.INFO, 3: logging.DEBUG}

_FORMAT = "%(asctime)s %(levelname).1s [%(name)s] %(message)s"


def get_logger(component: str, level: int = 2, log_dir: str | None = None) -> logging.Logger:
    """Return the logger for *component*, configured once.

    ``log_dir`` defaults to ``$KUBESHARE_TPU_LOG_DIR`` if set, else logging
    is stderr-only (the hostPath dir only exists on deployed nodes).
    """
    logger = logging.getLogger(component)
    if getattr(logger, "_kubeshare_configured", False):
        return logger

    logger.setLevel(_LEVELS.get(level, logging.INFO))
    formatter = logging.Formatter(_FORMAT)

    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(formatter)
    logger.addHandler(stream)

    log_dir = log_dir or os.environ.get("KUBESHARE_TPU_LOG_DIR")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, f"{component}.log"))
        fh.setFormatter(formatter)
        logger.addHandler(fh)

    logger.propagate = False
    logger._kubeshare_configured = True  # type: ignore[attr-defined]
    return logger
