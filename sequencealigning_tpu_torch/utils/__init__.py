"""Utility layer: CIGARs, alignment printing, guards, statistics, timing.

The port's copy of sequencealigning_tpu/utils.
"""

from sequencealigning_tpu_torch.utils.cigar import (
    Cigar,
    cigar_from_ops,
    ops_from_pair,
)
from sequencealigning_tpu_torch.utils.pprint import format_alignment

__all__ = ["Cigar", "cigar_from_ops", "ops_from_pair", "format_alignment"]
