"""Logging: print + append to log.txt (counterpart of fr_tpu/utils/logger.py,
reference utils/logger.py:1-4)."""

from __future__ import annotations


def print_log(logger, msg) -> None:
    print(msg)
    if logger is not None:
        with open(logger, "a") as f:
            f.write(str(msg) + "\n")
