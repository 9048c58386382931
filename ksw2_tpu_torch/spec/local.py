"""Local alignment (Smith-Waterman, affine gaps): the NumPy oracle.

The port's copy of ``ksw2_tpu/spec/local.py``.  The reference declares
``ksw_ll_qinit`` / ``ksw_ll_i16`` (``ksw2.h:92-93``) and implements
neither; the JAX package implements the capability, and this row DP
defines its semantics: H(i, j) = max(0, H(i-1, j-1) + s, E, F) with E and
F affine (open ``q``, extend ``e``), the result the maximum H over the
matrix with its end cell, the first in row-major order (target row i,
query column j) on ties.  It scores with the full ``m * m`` matrix; the
batched engine (kernel 18, :mod:`ksw2_tpu_torch.ops.batch_local`) reads
only its match, mismatch and N entries, so the two agree on simple
matrices only.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def local_align(query: np.ndarray, target: np.ndarray, m: int,
                mat: np.ndarray, q: int, e: int) -> Tuple[int, int, int]:
    """Smith-Waterman affine, row DP.  Returns (score, te, qe): the best
    score and its target and query end positions, (0, -1, -1) when no
    cell scores above 0."""
    mat = np.asarray(mat, dtype=np.int64).reshape(m, m)
    qlen, tlen = len(query), len(target)
    NEG = -(10 ** 9)
    Hrow = np.zeros(qlen + 1, np.int64)
    Erow = np.full(qlen + 1, NEG, np.int64)
    best, bt, bq = 0, -1, -1
    for i in range(tlen):
        row = mat[int(target[i])]
        F = NEG
        Hnew = np.zeros(qlen + 1, np.int64)      # H[i, -1] = 0 (local)
        for j in range(1, qlen + 1):
            E = max(Hrow[j] - q, Erow[j]) - e
            F = max(Hnew[j - 1] - q, F) - e
            h = max(Hrow[j - 1] + row[int(query[j - 1])], E, F, 0)
            Hnew[j] = h
            Erow[j] = E
            if h > best:
                best, bt, bq = int(h), i, j - 1
        Hrow = Hnew
    return best, bt, bq


__all__ = ["local_align"]
