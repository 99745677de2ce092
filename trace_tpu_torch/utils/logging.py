"""Logging utilities (trace_tpu/utils/logging.py; reference trace/utils.py:
17-57): a daily-rotating file logger shared by every logger, a file-like
that redirects writes to a logger, and a print gated to process 0.

The log directory is ``TRACE_TPU_LOGDIR`` (default ``./log_dir``), read at
import, as in the JAX package.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys

LOGDIR = os.environ.get("TRACE_TPU_LOGDIR", "./log_dir")

_handler = None


class StreamToLogger:
    """File-like that redirects writes to a logger, a line at a time; a
    partial line waits for its newline or ``flush`` (utils.py:60-90)."""

    def __init__(self, logger: logging.Logger, log_level=logging.INFO):
        self.terminal = sys.stdout
        self.logger = logger
        self.log_level = log_level
        self.linebuf = ""

    def __getattr__(self, attr):
        return getattr(self.terminal, attr)

    def write(self, buf):
        temp_linebuf = self.linebuf + buf
        self.linebuf = ""
        for line in temp_linebuf.splitlines(True):
            if line.endswith("\n"):
                self.logger.log(self.log_level, line.rstrip())
            else:
                self.linebuf += line

    def flush(self):
        if self.linebuf:
            self.logger.log(self.log_level, self.linebuf.rstrip())
        self.linebuf = ""


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    """The logger ``logger_name`` at INFO. The first call opens
    ``LOGDIR/logger_filename`` (rotated daily, UTC) and adds it to every
    logger that exists then; the root logger's handlers get the format."""
    global _handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )

    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=logging.INFO)
    for h in root.handlers:
        h.setFormatter(formatter)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if _handler is None:
        os.makedirs(LOGDIR, exist_ok=True)
        filename = os.path.join(LOGDIR, logger_filename)
        _handler = logging.handlers.TimedRotatingFileHandler(filename, when="D", utc=True)
        _handler.setFormatter(formatter)
        for item in logging.root.manager.loggerDict.values():
            if isinstance(item, logging.Logger):
                item.addHandler(_handler)
    return logger


def rank0_print(*args, **kwargs):
    """Print only on process 0: the rank of an initialized
    ``torch.distributed`` group, else this one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        print(*args, **kwargs)
