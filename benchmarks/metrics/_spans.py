"""Readings of the port's spans (``harness/spans.py``): ``ctx["summary"]``
carries the span table as ``spans`` where the run reduced it. Times are
over the profiled batches' units (samples or questions), in us; None where
the run has no table or the span never opened."""
from __future__ import annotations

from typing import Optional


def span_us(name: str, kind: str):
    """A reader of span ``name``'s ``kind`` ("host" or "device") seconds, a
    unit, in us."""
    def read(ctx) -> Optional[float]:
        s = ctx["summary"]
        table = getattr(s, "spans", None)
        row = table.rows.get(name) if table is not None else None
        if row is None or not row.calls or s.units <= 0:
            return None
        return getattr(row, f"{kind}_s") / s.units * 1e6
    return read


def coverage_pct(ctx) -> Optional[float]:
    """The busy device time of the profiled batches laid to any span (%)."""
    table = getattr(ctx["summary"], "spans", None)
    share = table.coverage() if table is not None else None
    return None if share is None else 100.0 * share
