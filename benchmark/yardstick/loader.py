"""Finds the files of a configuration, a metric or a FLOP count by name."""

from __future__ import annotations

import importlib.util
import os

from benchmark.yardstick.cell import BENCH_DIR


def load(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
