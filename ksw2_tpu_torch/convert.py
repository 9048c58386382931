"""Carry a JAX-package configuration over to the port.

The port has no weights: what carries across is the scoring
configuration of an ``Aligner`` and the parameters of a prepared strips
launch.  Both sides are plain values here (the port never imports the
JAX package): a caller reads the attributes of a ``ksw2_tpu.Aligner`` or
``StripParams._asdict()`` into a dict and passes it in.
"""
from __future__ import annotations

import numpy as np

from .api import Aligner
from .ops.strips import StripParams


def aligner_from_jax(cfg: dict, device="cuda") -> Aligner:
    """The port's :class:`Aligner` for the attributes of a
    ``ksw2_tpu.Aligner`` given as plain values: ``m``, ``mat`` (int8,
    m*m), ``q``, ``e``, ``q2``/``e2`` (None for one-piece), ``w``,
    ``zdrop``, ``end_bonus`` and ``flag`` (``splice`` when present must
    be unset: splice costs are not ported, ROADMAP item 9)."""
    return Aligner(q=int(cfg["q"]), e=int(cfg["e"]), q2=cfg.get("q2"),
                   e2=cfg.get("e2"), w=int(cfg["w"]),
                   zdrop=int(cfg["zdrop"]), end_bonus=int(cfg["end_bonus"]),
                   flag=int(cfg["flag"]), m=int(cfg["m"]),
                   mat=np.asarray(cfg["mat"], np.int8).reshape(-1),
                   splice=bool(cfg.get("splice", False)), device=device)


def strip_params_from_jax(d: dict) -> StripParams:
    """The port's :class:`StripParams` for a one- or two-piece
    ``ksw2_tpu.ops.wavefront_strips.StripParams._asdict()``.  The TPU
    layout fields (``n_rows``, ``s``, ``t_pad``, ``t_real``) have no
    counterpart; splice params raise."""
    if d.get("spl"):
        raise NotImplementedError("splice strips params (ROADMAP item 9)")
    return StripParams(**{k: d[k] for k in StripParams._fields})


__all__ = ["aligner_from_jax", "strip_params_from_jax"]
