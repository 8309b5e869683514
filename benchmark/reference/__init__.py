"""The plain float32 reference of the benchmark's cells. It imports
neither JAX, nor the JAX package, nor the program.

Encoder families (``families/<kind>.py``) and optimizers
(``optimizers/<name>.py``) are files found by the names a configuration
gives, so a configuration of a new family or optimizer comes as new files
only."""

from __future__ import annotations

import importlib
import re
from pathlib import Path

from benchmark.harness import BenchError

_MODULE = re.compile(r"^[a-z][a-z0-9_]{0,63}$")


def by_file(folder: str, name: str):
    """The module ``benchmark/reference/<folder>/<name>.py``; a name with
    no such file raises BenchError naming the file."""
    path = Path(__file__).resolve().parent / folder / f"{name}.py"
    if not (isinstance(name, str) and _MODULE.match(name)
            and path.is_file()):
        raise BenchError(f"no file {path} for {name!r}")
    return importlib.import_module(f"benchmark.reference.{folder}.{name}")
