"""Carry a JAX-package configuration over to the port.

The port has no weights: what carries across is the scoring
configuration of an ``Aligner``, the parameters of a prepared strips
launch, the single-pair engines' forward (one-piece, two-piece,
splice) and walk parameters, and the linear-gap and global engines'
launch parameters.  Both
sides are plain values here (the port never imports the JAX package): a
caller reads the attributes of a ``ksw2_tpu.Aligner`` or a parameter
tuple's ``_asdict()`` into a dict and passes it in.
"""
from __future__ import annotations

import numpy as np

from .api import Aligner
from .ops.extd import ExtdParams
from .ops.exts import ExtsPairParams
from .ops.extz_fwd import ExtzParams
from .ops.strips import StripParams
from .ops.traceback_device import TbParams

# the TPU layout fields of the linear-gap and global engines' parameter
# tuples (ops/wavefront_extf.py, wavefront_gg2.py, wavefront_batch_extf.py,
# wavefront_batch_gg2.py): the port's kernels take none of them
_LAYOUT = ("chunk", "n_rows", "p_rows", "p", "n_diag")


def aligner_from_jax(cfg: dict, device="cuda") -> Aligner:
    """The port's :class:`Aligner` for the attributes of a
    ``ksw2_tpu.Aligner`` given as plain values: ``m``, ``mat`` (int8,
    m*m), ``q``, ``e``, ``q2``/``e2`` (None for one-piece), ``w``,
    ``zdrop``, ``end_bonus``, ``flag`` and, when present, ``splice``,
    ``noncan`` and ``junc_bonus``."""
    return Aligner(q=int(cfg["q"]), e=int(cfg["e"]), q2=cfg.get("q2"),
                   e2=cfg.get("e2"), w=int(cfg["w"]),
                   zdrop=int(cfg["zdrop"]), end_bonus=int(cfg["end_bonus"]),
                   flag=int(cfg["flag"]), m=int(cfg["m"]),
                   mat=np.asarray(cfg["mat"], np.int8).reshape(-1),
                   splice=bool(cfg.get("splice", False)),
                   noncan=int(cfg.get("noncan", 0)),
                   junc_bonus=int(cfg.get("junc_bonus", 0)), device=device)


def strip_params_from_jax(d: dict) -> StripParams:
    """The port's :class:`StripParams` for a one-piece, two-piece or
    splice ``ksw2_tpu.ops.wavefront_strips.StripParams._asdict()``.  The
    TPU layout fields (``n_rows``, ``s``, ``t_pad``, ``t_real``) have no
    counterpart."""
    return StripParams(**{k: d[k] for k in StripParams._fields})


def extz_params_from_jax(d: dict) -> ExtzParams:
    """The port's :class:`ExtzParams` for a ``ksw2_tpu.ops.wavefront.
    ExtzParams._asdict()``.  The TPU layout fields (``chunk``, ``n_rows``,
    ``p_rows``) have no counterpart."""
    return ExtzParams(**{k: int(d[k]) for k in ExtzParams._fields})


def extd_params_from_jax(d: dict) -> ExtdParams:
    """The port's :class:`~ksw2_tpu_torch.ops.extd.ExtdParams` for a
    ``ksw2_tpu.ops.wavefront_extd.ExtdParams._asdict()`` (post-swap costs,
    the pre-swap ``q + e``).  The TPU layout fields (``chunk``,
    ``n_rows``, ``p_rows``) have no counterpart."""
    return ExtdParams(**{k: int(d[k]) for k in ExtdParams._fields})


def exts_params_from_jax(d: dict) -> ExtsPairParams:
    """The port's :class:`~ksw2_tpu_torch.ops.exts.ExtsPairParams` for a
    ``ksw2_tpu.ops.wavefront_exts.ExtsParams._asdict()``.  The TPU layout
    fields (``chunk``, ``n_rows``, ``p_rows``) have no counterpart."""
    return ExtsPairParams(**{k: int(d[k]) for k in ExtsPairParams._fields})


def tb_params_from_jax(d: dict) -> TbParams:
    """The port's :class:`TbParams` for a ``ksw2_tpu.ops.traceback_device.
    TbParams._asdict()``.  The TPU store's fields (``p_rows``, ``blk``,
    ``n_blocks``, ``full_rows``) have no counterpart: the port's store is
    compact and walked in closed form."""
    return TbParams(**{k: int(d[k]) for k in TbParams._fields})


def launch_values_from_jax(d: dict) -> dict:
    """The port's launch values of the linear-gap and global engines
    (kernels 7, 8, 15, 16) for the ``_asdict()`` of a
    ``ksw2_tpu.ops.wavefront_extf.ExtfParams``, ``wavefront_gg2.Gg2Params``,
    ``wavefront_batch_extf.BatchExtfParams`` or
    ``wavefront_batch_gg2.BatchGg2Params``: every field but the TPU layout
    ones (``chunk``, ``n_rows``, ``p_rows``, ``p``, ``n_diag``), which have
    no counterpart, as int; the batched gg2 tuple's ``matt`` becomes the
    score table ``mat`` (int32, m*m)."""
    out = {k: int(v) for k, v in d.items()
           if k not in _LAYOUT and k != "matt"}
    if "matt" in d:
        out["mat"] = np.asarray(d["matt"], np.int32)
    return out


__all__ = ["aligner_from_jax", "launch_values_from_jax",
           "strip_params_from_jax", "extz_params_from_jax",
           "extd_params_from_jax", "exts_params_from_jax",
           "tb_params_from_jax"]
