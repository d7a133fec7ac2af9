"""Arithmetic shared by the readers."""

from __future__ import annotations

__all__ = ["mean"]


def mean(values) -> float:
    vals = list(values)
    return sum(vals) / len(vals)
