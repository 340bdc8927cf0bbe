"""The table of peaks that rooflines are shares of (``peaks.json``)."""

from __future__ import annotations

import functools
import json
import pathlib


@functools.cache
def peaks() -> dict:
    return json.loads((pathlib.Path(__file__).parent / "peaks.json").read_text())
