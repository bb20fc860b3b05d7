"""Global logging configuration.

Copy of notsofar_tpu/utils/logging_def.py (the port imports nothing from
the JAX package): one basicConfig for the whole process plus named child
loggers per module.
"""
import logging
import sys

_INITIALIZED = False


def _init_logging():
    global _INITIALIZED
    if _INITIALIZED:
        return
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        stream=sys.stdout,
    )
    _INITIALIZED = True


def get_logger(name: str) -> logging.Logger:
    """Return a named logger, initializing global config on first use."""
    _init_logging()
    return logging.getLogger(name)
