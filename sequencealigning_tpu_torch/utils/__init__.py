"""Utility layer: CIGARs, the alignment bar line, guards, statistics.

The port's copy of sequencealigning_tpu/utils.
"""

from sequencealigning_tpu_torch.utils.cigar import (
    Cigar,
    cigar_from_ops,
    ops_from_pair,
)

__all__ = ["Cigar", "cigar_from_ops", "ops_from_pair"]
