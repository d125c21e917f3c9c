"""Tailer of a command trial's output — the port's own copy of the Python
tailer of ``katib_tpu/native/tailer.py``.

The subprocess executor polls a running trial's stdout (or metrics file)
for metric lines to enforce early-stopping rules, as Katib's
file-metricscollector sidecar watches its file. The tailer keeps an offset
and a partial-line buffer, so a line written in pieces is parsed once,
whole; it parses TEXT lines under the collector's filters, or JSON lines.
The JAX package also has a C++ tailer for the default TEXT filter; the
port's ``make_tailer`` returns the Python one until that is ported.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

from .metrics import parse_json_lines, parse_text_lines

# (metric name, raw value, line index): the index grows across polls, so a
# caller can stamp rows in the order of the lines
Parsed = Tuple[str, str, int]


class PyTailer:
    """Offset and partial-line buffer over one file; each whole line parsed
    by runtime.metrics (custom filters and JSON lines included)."""

    def __init__(
        self,
        path: str,
        metric_names: Sequence[str],
        filters: Optional[Sequence[str]] = None,
        json_format: bool = False,
    ):
        self._path = path
        self._names = list(metric_names)
        self._filters = list(filters) if filters else None
        self._json = json_format
        self._offset = 0
        self._buffered = ""
        self._line_index = 0

    def poll(self) -> List[Parsed]:
        if not os.path.exists(self._path):
            return []
        with open(self._path, "r", errors="replace") as f:
            f.seek(self._offset)
            chunk = f.read()
            self._offset = f.tell()
        if not chunk:
            return []
        self._buffered += chunk
        lines = self._buffered.split("\n")
        self._buffered = lines.pop()
        out: List[Parsed] = []
        for line in lines:
            idx = self._line_index
            self._line_index += 1
            if self._json:
                logs = parse_json_lines([line], self._names)
            else:
                logs = parse_text_lines([line], self._names, self._filters)
            for log in logs:
                # values are float-parseable: the filter's value group can
                # match a bare sign
                try:
                    float(log.value)
                except (TypeError, ValueError):
                    continue
                out.append((log.metric_name, log.value, idx))
        return out

    def close(self) -> None:
        pass


def make_tailer(path: str, metric_names: Sequence[str], filters: Optional[Sequence[str]] = None,
                json_format: bool = False) -> PyTailer:
    """The tailer for a trial's watched file (the Python tailer, whatever the
    filter: the C++ tailer is not ported yet)."""
    return PyTailer(path, metric_names, filters, json_format)
