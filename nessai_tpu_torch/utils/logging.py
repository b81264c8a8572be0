"""Logger configuration. Counterpart of ``nessai_tpu/utils/logging.py``."""

import logging
import os
import sys

__all__ = ["configure_logger"]


def configure_logger(output=None, label="nessai", log_level="INFO", stream=sys.stdout):
    """Configure the ``nessai_tpu_torch`` logger with a stream handler and,
    when ``label`` is set, a file handler writing ``<output>/<label>.log``."""
    if isinstance(log_level, str):
        try:
            level = getattr(logging, log_level.upper())
        except AttributeError:
            raise ValueError(f"log_level {log_level} not understood")
    else:
        level = int(log_level)
    logger = logging.getLogger("nessai_tpu_torch")
    logger.setLevel(level)
    formatter = logging.Formatter(
        "%(asctime)s nessai_tpu_torch %(levelname)-8s: %(message)s",
        datefmt="%m-%d %H:%M",
    )
    if not any(
        isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.FileHandler)
        for h in logger.handlers
    ):
        sh = logging.StreamHandler(stream)
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    if label:
        output = os.getcwd() if output is None else output
        os.makedirs(output, exist_ok=True)
        log_file = os.path.abspath(os.path.join(output, f"{label}.log"))
        if not any(
            getattr(h, "baseFilename", None) == log_file
            for h in logger.handlers
        ):
            fh = logging.FileHandler(log_file)
            fh.setFormatter(formatter)
            logger.addHandler(fh)
    for h in logger.handlers:
        h.setLevel(level)
    return logger
