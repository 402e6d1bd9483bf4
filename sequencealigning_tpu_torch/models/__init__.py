from sequencealigning_tpu_torch.models.astar import AStarAligner
from sequencealigning_tpu_torch.models.banded import BandedAligner
from sequencealigning_tpu_torch.models.base import (
    Aligner,
    PairResult,
    get_aligner,
)
from sequencealigning_tpu_torch.models.gotoh import GotohAligner
from sequencealigning_tpu_torch.models.linear import LinearNWAligner
from sequencealigning_tpu_torch.models.wfa import WfaAligner

__all__ = ["Aligner", "PairResult", "get_aligner", "AStarAligner",
           "BandedAligner", "GotohAligner", "LinearNWAligner", "WfaAligner"]
