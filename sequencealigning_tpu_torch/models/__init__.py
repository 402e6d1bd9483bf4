from sequencealigning_tpu_torch.models.banded import BandedAligner
from sequencealigning_tpu_torch.models.base import (
    Aligner,
    PairResult,
    get_aligner,
)
from sequencealigning_tpu_torch.models.gotoh import GotohAligner

__all__ = ["Aligner", "PairResult", "get_aligner", "BandedAligner",
           "GotohAligner"]
