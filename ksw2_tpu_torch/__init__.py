"""ksw2_tpu_torch — the PyTorch + CUDA port of ksw2_tpu (the strips, rows,
band, batched and single-pair routes, one- and two-piece and splice,
scores and CIGARs; the linear-gap and global engines and the ksw2-test
CLI, ``python -m ksw2_tpu_torch.cli``).  Imports torch and numpy only."""
from .api import Aligner

__all__ = ["Aligner"]
