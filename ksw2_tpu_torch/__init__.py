"""ksw2_tpu_torch — the PyTorch + CUDA port of ksw2_tpu (the strips, rows,
band and batched routes, one- and two-piece and splice, scores and
CIGARs).  Imports torch and numpy only."""
from .api import Aligner

__all__ = ["Aligner"]
