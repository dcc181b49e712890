"""Fixtures of the benchmark's CPU tests: tiny configurations and a tiny mix
(`data/`), found by name as the harness finds the real ones."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny(monkeypatch):
    """The harness reading `tests/data/<name>.json` for configurations and mixes."""
    from benchmark import harness

    monkeypatch.setattr(harness, "load", lambda kind, name: json.loads((DATA / f"{name}.json").read_text()))
    return harness


@pytest.fixture
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())
