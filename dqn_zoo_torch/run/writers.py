"""Result writers (port of dqn_zoo_tpu/run/writers.py).

CsvWriter: header written once, append-mode writes, serializable state for
resume. Unlike the reference, a row that adds columns to a resumed file's
fieldnames (a newer version's extra column) widens the header in place
instead of raising; dropping or reordering columns still raises.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Mapping, Optional, Sequence


class CsvWriter:
  """Writes dict rows to CSV, one header, append-friendly, resumable."""

  def __init__(self, fname: str):
    self._fname = fname
    dirname = os.path.dirname(fname)
    if dirname:
      os.makedirs(dirname, exist_ok=True)
    self._header_written = False
    self._fieldnames: Optional[Sequence[str]] = None
    self._rows_written = 0

  def write(self, values: Mapping[str, Any]) -> None:
    keys = list(values.keys())
    if self._fieldnames is None:
      self._fieldnames = keys
    if keys != list(self._fieldnames):
      if keys[:len(self._fieldnames)] != list(self._fieldnames):
        raise ValueError(f"Fields changed: {keys} vs {self._fieldnames}")
      self._widen(keys)
    with open(self._fname, "a", newline="") as f:
      writer = csv.DictWriter(f, fieldnames=self._fieldnames)
      if not self._header_written:
        writer.writeheader()
        self._header_written = True
      writer.writerow(values)
    self._rows_written += 1

  def _widen(self, keys) -> None:
    """Rewrites the file under the wider header; old rows get blanks."""
    rows = []
    if self._header_written and os.path.exists(self._fname):
      with open(self._fname, "r", newline="") as f:
        rows = list(csv.DictReader(f))
      with open(self._fname, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=keys)
        writer.writeheader()
        writer.writerows(rows)
    self._fieldnames = keys

  def close(self) -> None:
    pass

  def get_state(self) -> Mapping[str, Any]:
    return {
        "header_written": self._header_written,
        "fieldnames": self._fieldnames,
        "rows_written": self._rows_written,
    }

  def set_state(self, state: Mapping[str, Any]) -> None:
    self._header_written = state["header_written"]
    self._fieldnames = state["fieldnames"]
    if "rows_written" in state:
      self._rows_written = int(state["rows_written"])
      self._truncate_to(self._rows_written)

  def _truncate_to(self, rows: int) -> None:
    if not os.path.exists(self._fname):
      return
    with open(self._fname, "r", newline="") as f:
      lines = f.readlines()
    keep = (1 if self._header_written else 0) + rows
    if len(lines) > keep:
      with open(self._fname, "w", newline="") as f:
        f.writelines(lines[:keep])


class NullWriter:
  """No-op writer."""

  def write(self, values) -> None:
    del values

  def close(self) -> None:
    pass

  def get_state(self):
    return {}

  def set_state(self, state) -> None:
    del state
