"""Pair-batch scheduler for the rows, strips, band, batched, any-device
and single-pair routes.

Port of ``ksw2_tpu/batch/scheduler.py``'s score, CIGAR and splice paths:
jobs are bucketed by shape and each bucket takes the first route of the
JAX package's table that accepts it.  One-piece scores: rows, strips,
band, batched, any-device (``scheduler.py:202, 242-286``); two-piece
scores: strips, band, batched, the single-pair two-piece engine
(``scheduler.py:482-521``); CIGARs, EQX included: strips, band, batched
(``scheduler.py:639-754``), then the single-pair engine of the costs
(``scheduler.py:755-767``: kernels 12 or 13 with 17; one-piece keeps M
ops); two-piece SCORE_ONLY with ``end_bonus`` or EXTZ_ONLY: band, then
batched, in score form, then the single-pair two-piece engine
(``scheduler.py:609-617, 690-767``); splice (exts), scores and CIGARs
with N ops: strips in its ``spl`` form, then the batched exts engine,
then the single-pair splice engine (kernel 14 with 17;
``scheduler.py:916-1119``).  The buckets that fall to a single-pair
engine go out together, split only by ``ops.strips.LAUNCH_BYTES``, so
their pairs' chains run at once; so do the band route's, the batched
route's whose pairs take kernel E's register form (score and CIGAR
paths) and, on the score paths, the strips route's.  Every launch
is enqueued on the current CUDA stream before anything waits.  A handle's
``result()`` synchronises on the event recorded after the batch's
device-to-host copies, so several batches in flight overlap one batch's
host work with the next one's device work.  On ``device="cpu"`` the same
path runs the kernels' plain versions synchronously.

Every bucket of these paths has a ported route; nothing falls back.
``align_batch_scores(_async)`` with ``run_fn`` sends every bucket through
that engine instead, as the JAX scheduler does (``scheduler.py:160-290``;
``parallel.mesh.make_sharded_run_fn`` is the sharded one).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..core.flags import NEG_INF, Flag
from ..core.result import ExtzResult
from ..ops.band import band_ineligible_reason, band_prep, band_records
from ..ops.band_walker import band_cigar_launch, unpack_band_cigars
from ..ops.bands import n_col_bytes
from ..ops.batch import (batch_form, batch_forward_cuda,
                         batch_ineligible_reason)
from ..ops.batch_xla import BatchSpec, any_device_prep
from ..ops.extd import (extd_cigar_launch, extd_prep, extd_records,
                        unpack_extd_cigars)
from ..ops.exts import (exts_cigar_launch, exts_prep, exts_records,
                        unpack_single_exts_cigars)
from ..ops.extz import (extz_cigar_launch, extz_prep, extz_records,
                        unpack_extz_cigars)
from ..ops.batch_exts import (batch_exts_cigar_launch,
                              batch_exts_ineligible_reason, batch_exts_prep,
                              batch_exts_records, batch_exts_resets,
                              unpack_exts_cigars)
from ..ops.records import FIELD_ORDER, NFIELDS, degenerate
from ..ops.rows import rows_eligible, rows_records
from ..ops.strips import (TMAX, QMAX, canonical_costs, launch_tv,
                          packing_fits, strips_extd_ineligible_reason,
                          strips_exts_ineligible_reason,
                          strips_ineligible_reason, strips_exts_prep,
                          strips_prep, strips_records)
from ..ops.strips_walker import (strips_cigar_extd_ineligible_reason,
                                 strips_cigar_ineligible_reason,
                                 strips_cigar_launch, unpack_cigars)

_SCORES_LT = (128, 256, 512, 768, 1024, 1280, 1536, 2048, 2560, 3072)

# The batched route is the band route's launch glue with kernel E / E2
# (csrc/batch_fwd.cu) as its forward; it converts one- and two-piece
# CIGARs to =/X when the flag asks (batch_pallas.py:499-505, 773-782),
# where the band route keeps one-piece M ops.
batch_records = functools.partial(band_records, cuda=batch_forward_cuda)
batch_cigar_launch = functools.partial(band_cigar_launch,
                                       cuda=batch_forward_cuda)
unpack_batch_cigars = functools.partial(unpack_band_cigars,
                                        eqx_one_piece=True)


@dataclasses.dataclass
class AlignJob:
    query: np.ndarray   # encoded uint8
    target: np.ndarray
    w: int = -1


def resolve_device(device) -> torch.device:
    """A torch.device for ``device``; a CUDA device without a card
    raises rather than running on the CPU, and so does an index past
    the visible cards."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch.cuda.is_available() "
                               "is false; pass device='cpu' for the plain "
                               "versions")
        if dev.index is not None and \
                not 0 <= dev.index < torch.cuda.device_count():
            raise ValueError(f"{dev}: only {torch.cuda.device_count()} "
                             "CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _bucket_len(n: int, quantum: int = 128, coarse: bool = False) -> int:
    """A copy of the JAX package's ``_bucket_len`` (``scheduler.py:23-44``):
    128-steps to 3072, then 4096 + 2048 k; ``coarse`` doubles to 2048,
    then steps by 2048."""
    n = max(n, 1)
    if coarse:
        b = quantum
        while b < n:
            b = b * 2 if b < 2048 else b + 2048
        return b
    if n <= 3072:
        return -(-n // quantum) * quantum
    b = 4096
    while b < n:
        b += 2048
    return b


def _bucket_key(qn: int, tn: int) -> Tuple[int, int]:
    """(Lq, Lt) bucket: the strips envelope's canonical ladders for
    t <= 3072 and q <= 4608 (``scheduler.py:50-63``), the JAX package's
    ``_bucket_key`` above them (``scheduler.py:66-78``).  Buckets only
    group pairs; the band route's ``Lt > 512`` test reads ``Lt``."""
    if tn <= TMAX and qn <= QMAX:
        Lq = 512
        while Lq < qn:
            Lq *= 2
        for Lt in _SCORES_LT:
            if Lt >= tn:
                return (min(Lq, QMAX), Lt)
    return _jax_bucket_key(qn, tn)


def _jax_bucket_key(qn: int, tn: int) -> Tuple[int, int]:
    """The JAX package's ``_bucket_key`` (``scheduler.py:66-78``):
    targets step by 128 to 3072.  The splice path buckets with it alone:
    a bucket's junction tracks decide its route, so it keeps the JAX
    package's grouping."""
    Lt = _bucket_len(tn)
    if Lt > 3072:
        return (_bucket_len(qn, coarse=True), _bucket_len(tn, coarse=True))
    return (_bucket_len(qn, coarse=True), Lt)


def _heaviest_first(buckets: Dict[Tuple[int, int], List[int]], jobs):
    """Bucket items ordered biggest-compute-first, so the device starts
    on the heaviest launches while the host still preps the rest."""
    def cost(kv):
        _, idxs = kv
        return -sum(len(jobs[i].query) * len(jobs[i].target) for i in idxs)
    return sorted(buckets.items(), key=cost)


class _Bucket(NamedTuple):
    idxs: List[int]
    qlen: np.ndarray
    tlen: np.ndarray
    w: np.ndarray        # w = -1 replaced by max(qlen, tlen)
    route: str           # "rows", "strips", "band", "batch", "any" or
    #                      "single" (the single-pair engine of the costs)


def _route(jobs, mat, qe: int, results, choose, key=_bucket_key,
           strips_costs=None) -> List[_Bucket]:
    """Reset empty jobs, and every job when scoring is degenerate
    (``-min_sc > 2 * qe``); bucket the rest by ``key`` and pick every
    bucket's route (``_Bucket.route``) with ``choose(Lt, qlen, tlen, w,
    raw_w, idxs)``.  Returns the buckets heaviest first; a
    bucket's pairs on the anti-diagonal routes are ordered longest first,
    so its launches pad little (and a block's warps finish together).
    The buckets routed to the single-pair engine ("any" or "single") come
    back as one, and so do the band route's (:func:`_merged`).  With
    ``strips_costs``, the (post-swap) ``(q, e)`` of a score path, the
    strips route's buckets come back as one too (:func:`_merged_strips`).
    The score and CIGAR paths merge the batched route's buckets by form
    afterwards (:func:`_merged_batch`)."""
    min_sc = int(np.asarray(mat).reshape(-1)[1:].min())
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, job in enumerate(jobs):
        if len(job.query) == 0 or len(job.target) == 0 or \
                -min_sc > 2 * qe:
            ez = ExtzResult()
            ez.reset()
            results[i] = ez
            continue
        buckets.setdefault(key(len(job.query), len(job.target)),
                           []).append(i)
    out = []
    for (_, Lt), idxs in _heaviest_first(buckets, jobs):
        qlen = np.array([len(jobs[i].query) for i in idxs], np.int32)
        tlen = np.array([len(jobs[i].target) for i in idxs], np.int32)
        raw = np.array([jobs[i].w for i in idxs], np.int32)
        wv = np.where(raw >= 0, raw, np.maximum(qlen, tlen)).astype(np.int32)
        route = choose(Lt, qlen, tlen, wv, raw, idxs)
        if route not in ("rows", "strips"):
            order = np.argsort(-(qlen.astype(np.int64) + tlen), kind="stable")
            idxs = [idxs[k] for k in order]
            qlen, tlen, wv = qlen[order], tlen[order], wv[order]
        out.append(_Bucket(idxs, qlen, tlen, wv, route))
    out = _merged(_merged(out, _SINGLE), ("band",))
    if strips_costs is not None:
        out = _merged_strips(out, mat, *strips_costs)
    return out


_SINGLE = ("any", "single")


def _merged(buckets: List[_Bucket], routes,
            joins=lambda bk: True) -> List[_Bucket]:
    """``buckets`` with those whose route is in ``routes`` (and that
    ``joins``) merged into one at the place of the first, its pairs
    longest first.  The JAX bucket key only groups pairs: the single-pair
    forward and the band forward take mixed lengths in one launch, so a
    batch's jobs on either go out together, split only by
    ``ops.strips.LAUNCH_BYTES``, and their chains run at once instead of
    one bucket after another.  A pair's result does not depend on the
    launch it lands in."""
    group = [bk for bk in buckets if bk.route in routes and joins(bk)]
    if len(group) < 2:
        return buckets
    idxs = [i for bk in group for i in bk.idxs]
    qlen, tlen, w = (np.concatenate([getattr(bk, f) for bk in group])
                     for f in ("qlen", "tlen", "w"))
    order = np.argsort(-(qlen.astype(np.int64) + tlen), kind="stable")
    merged = _Bucket([idxs[k] for k in order], qlen[order], tlen[order],
                     w[order], group[0].route)
    taken = {id(bk) for bk in group}
    out = []
    for bk in buckets:
        if bk is group[0]:
            out.append(merged)
        elif id(bk) not in taken:
            out.append(bk)
    return out


def _merged_strips(buckets: List[_Bucket], mat, q: int,
                   e: int) -> List[_Bucket]:
    """``buckets`` with the strips route's score buckets merged into one
    (:func:`_merged`): kernel A lays each pair's strips out by its own
    query, so a launch of mixed lengths runs each pair at its own
    size, and the launch's ``tv`` (its largest bucket's) only widens the
    merge key, which the replay decodes with the same ``tv``.  Each
    bucket passed the strips envelope at its own ``tv``; when the int32
    packing guard fails at the merged one, the buckets stay apart."""
    group = [bk for bk in buckets if bk.route == "strips"]
    if len(group) < 2:
        return buckets
    qlen = np.concatenate([bk.qlen for bk in group])
    tlen = np.concatenate([bk.tlen for bk in group])
    if not packing_fits(qlen, tlen, mat, q, e, launch_tv(tlen)):
        return buckets
    return _merged(buckets, ("strips",))


def _merged_batch(buckets: List[_Bucket], m: int) -> List[_Bucket]:
    """``buckets`` with the batched route's buckets merged by kernel E's
    form (``ops.batch.batch_form`` of their widest ``n_col_bytes``, so a
    bucket's pairs all take one form): those of the register form into
    one and those of the wide form into another (:func:`_merged`), each
    split only by ``ops.strips.LAUNCH_BYTES``.  Both forms keep a pair's
    state whatever the launch's target length (the register form in a
    warp's registers, the wide form in a block a pair), so a batch's
    short-banded jobs go out as one launch and its wide jobs as another,
    longest first.  The two stay apart: a merged launch takes the form of
    its widest pair."""
    def narrow(bk):
        # n_col_bytes grows with min(qlen, tlen, w + 1): its widest pair's
        widest = np.minimum(np.minimum(bk.qlen, bk.tlen),
                            bk.w.astype(np.int64) + 1).argmax()
        return batch_form(n_col_bytes(int(bk.qlen[widest]),
                                      int(bk.tlen[widest]),
                                      int(bk.w[widest])), m) > 0
    out = _merged(buckets, ("batch",), narrow)
    return _merged(out, ("batch",), lambda bk: not narrow(bk))


def _to_host(tensors: List[torch.Tensor], dev: torch.device):
    """Start device-to-host copies of ``tensors``; returns the host
    tensors and the event that marks their arrival (None on the CPU)."""
    if dev.type != "cuda":
        return tensors, None
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return host, ev


def _ez_of(r) -> ExtzResult:
    """The ExtzResult of one (NFIELDS,) record."""
    return ExtzResult(max=int(r[0]), max_t=int(r[1]), max_q=int(r[2]),
                      mqe=int(r[3]), mqe_t=int(r[4]), mte=int(r[5]),
                      mte_q=int(r[6]), score=int(r[7]), zdropped=bool(r[8]))


class PendingScores:
    """Handle for an in-flight :func:`align_batch_scores_async` or
    :func:`align_batch_scores2_async` batch: every launch and
    device-to-host copy is enqueued; :meth:`result` waits on the batch's
    event.  With ``guard`` (the reference's degenerate-scoring test on
    the cheaper arm) every launched job reads as reset."""

    def __init__(self, results, pieces, event, guard: bool = False):
        self._results = results
        self._pieces = pieces          # [(idxs, host (B, 9) records)]
        self._event = event
        self._guard = guard
        self._done = False

    def _wait(self):
        if self._event is not None:
            self._event.synchronize()
            self._event = None

    def result(self) -> List[ExtzResult]:
        if not self._done:
            self._wait()
            for idxs, rec in self._pieces:
                arr = rec.numpy()
                for k, i in enumerate(idxs):
                    if self._guard:
                        ez = ExtzResult()
                        ez.reset()
                        self._results[i] = ez
                        continue
                    self._results[i] = _ez_of(arr[k])
            self._done = True
        return self._results

    def result_array(self) -> np.ndarray:
        """The whole batch's records as ONE ``(n_jobs, NFIELDS)`` int32
        array in job order (columns = ``ops.records.FIELD_ORDER``);
        empty and degenerate jobs carry reset rows."""
        if self._done:
            raise RuntimeError("result() already consumed this handle")
        self._wait()
        out = np.empty((len(self._results), NFIELDS), np.int32)
        out[:, (0, 8)] = 0
        out[:, (1, 2, 4, 6)] = -1
        out[:, (3, 5, 7)] = NEG_INF
        if not self._guard:
            for idxs, rec in self._pieces:
                out[np.asarray(idxs)] = rec.numpy()
        self._done = True
        return out


def _score_chooser(flag, m, mat, zdrop, q, e, two=False, q2=0, e2=0):
    """The score path's route table for one bucket (``scheduler.py:
    202, 242-286, 482-521``): one-piece rows, then strips, band, batched,
    any-device; two-piece strips, band, batched, single-pair."""
    def choose(Lt, ql, tl, w, _raw, _idxs):
        if not two and rows_eligible(ql, tl, w, flag, zdrop, m, mat):
            return "rows"
        if two:
            reason = strips_extd_ineligible_reason(ql, tl, w, flag, m, mat,
                                                   zdrop, q, e, q2, e2)
        else:
            reason = strips_ineligible_reason(ql, tl, w, flag, m, mat, zdrop,
                                              q, e)
        if reason is None:
            return "strips"
        band = band_ineligible_reason(Lt, ql, tl, w, mat, flag, cigar=False,
                                      two=two)
        if band is None:
            return "band"
        batch = batch_ineligible_reason(Lt, ql, tl, mat, flag, zdrop,
                                        cigar=False, two=two)
        if batch is None:
            return "batch"
        return "single" if two else "any"
    return choose


def _cigar_path_score_chooser(flag, mat):
    """Two-piece SCORE_ONLY with ``end_bonus`` or EXTZ_ONLY
    (``scheduler.py:609-617, 676-767``): the CIGAR path's buckets in score
    form, so no strips; the band route on the jobs' raw ``w``, then the
    batched route, then the single-pair two-piece engine (which takes
    every EXTZ_ONLY bucket: the batch routes refuse them)."""
    def choose(Lt, ql, tl, _w, raw, _idxs):
        if band_ineligible_reason(Lt, ql, tl, raw, mat, flag, cigar=True,
                                  two=True) is None:
            return "band"
        if batch_ineligible_reason(Lt, ql, tl, mat, flag, -1, cigar=True,
                                   two=True) is None:
            return "batch"
        return "single"
    return choose


def _cigar_chooser(flag, m, mat, zdrop, q, e, two=False, q2=0, e2=0):
    """The CIGAR path's route table for one bucket (``scheduler.py:
    639-767``): strips, band, batched, then the single-pair engine of the
    costs."""
    def choose(Lt, ql, tl, w, raw, _idxs):
        if two:
            reason = strips_cigar_extd_ineligible_reason(
                ql, tl, w, flag, m, mat, zdrop, q, e, q2, e2)
        else:
            reason = strips_cigar_ineligible_reason(ql, tl, w, flag, m, mat,
                                                    zdrop, q, e)
        if reason is None:
            return "strips"
        # the band route reads the jobs' RAW w (scheduler.py:672), the
        # batched route the resolved one (scheduler.py:730)
        band = band_ineligible_reason(Lt, ql, tl, raw, mat, flag, cigar=True,
                                      two=two)
        if band is None:
            return "band"
        batch = batch_ineligible_reason(Lt, ql, tl, mat, flag, zdrop,
                                        cigar=True, two=two)
        if batch is None:
            return "batch"
        return "single"
    return choose


def _score_pieces(jobs, buckets, m, mat, q, e, zdrop, flag, dev, two=False,
                  q2=0, e2=0):
    """Prep and enqueue every bucket's launches on its route; returns
    [(job indices, device records)]."""
    runs = {"rows": rows_records, "strips": strips_records,
            "band": band_records, "batch": batch_records,
            "any": extz_records, "single": extd_records}
    pieces = []
    for bk in buckets:
        qs = [jobs[i].query for i in bk.idxs]
        ts = [jobs[i].target for i in bk.idxs]
        if bk.route == "any":
            launches = any_device_prep(qs, ts, bk.qlen, bk.tlen, bk.w, m,
                                       mat, q, e, zdrop, flag)
        elif bk.route == "single":          # two-piece only
            launches = extd_prep(qs, ts, bk.qlen, bk.tlen, bk.w, m, mat, q, e,
                                 q2, e2, zdrop, flag, cig=False)
        elif bk.route in ("band", "batch"):
            launches = band_prep(qs, ts, bk.qlen, bk.tlen, bk.w, m, mat, q, e,
                                 zdrop, flag, two=two, q2=q2, e2=e2)
        else:
            launches = strips_prep(qs, ts, bk.qlen, bk.tlen, m, mat, q, e,
                                   zdrop, flag, two=two, q2=q2, e2=e2)
        run = runs[bk.route]
        pieces += _run_launches(bk.idxs, launches, lambda ln: run(ln, dev))
    return pieces


def align_batch_scores_async(
    jobs: Sequence[AlignJob],
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    zdrop: int = -1,
    flag: Flag | int = Flag.SCORE_ONLY,
    device="cuda",
    run_fn=None,
) -> PendingScores:
    """Submit a one-piece score batch without waiting.  Each bucket takes
    the first route that accepts it: rows, strips, band, batched, and the
    any-device route for the rest (``scheduler.py:202, 242-286`` in the
    JAX package).  With ``run_fn`` every bucket goes through it instead
    (:func:`_run_fn_scores`)."""
    dev = resolve_device(device)
    flag = Flag(int(flag)) | Flag.SCORE_ONLY
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    if run_fn is not None:
        return _run_fn_scores(jobs, m, mat, q, e, zdrop, flag, run_fn)
    results: List[Optional[ExtzResult]] = [None] * len(jobs)
    buckets = _merged_batch(_route(jobs, mat, q + e, results,
                                   _score_chooser(flag, m, mat, zdrop, q, e),
                                   strips_costs=(q, e)), m)
    pieces = _score_pieces(jobs, buckets, m, mat, q, e, zdrop, flag, dev)
    return _pending_scores(results, pieces, dev, False)


def _run_launches(idxs, launches, run):
    """[(the launch's job indices, run(launch))] over a bucket's
    launches."""
    out = []
    pos = 0
    for ln in launches:
        B = len(ln.qlen)
        out.append((idxs[pos:pos + B], run(ln)))
        pos += B
    return out


def _pending_scores(results, pieces, dev, guard) -> PendingScores:
    host, ev = _to_host([p[1] for p in pieces], dev)
    return PendingScores(results,
                         [(p[0], h) for p, h in zip(pieces, host)], ev,
                         guard)


def pad_rows(seqs, width: Optional[int] = None, dtype=np.uint8
             ) -> np.ndarray:
    """``(B, width)`` zero-padded rows of the 1-D symbol arrays ``seqs``
    (``width`` None: the longest, at least 1)."""
    if width is None:
        width = max([len(s) for s in seqs] + [1])
    out = np.zeros((len(seqs), width), dtype)
    for k, s in enumerate(seqs):
        out[k, :len(s)] = s
    return out


def _run_fn_scores(jobs, m, mat, q, e, zdrop, flag, run_fn) -> PendingScores:
    """Every bucket through ``run_fn(spec, Q, T, qlen, tlen, w)`` on host
    arrays, as the JAX scheduler runs a pluggable engine
    (``scheduler.py:160-290``): ``(B, Lq)`` / ``(B, Lt)`` int32 sequences
    padded to the bucket's key, the resolved bands, and a dict of ``(B,)``
    fields back; the rows, strips, band and batched choices are off
    (``scheduler.py:243-270``; a sharded ``run_fn`` makes its own).
    Empty jobs and degenerate scoring reset, as on the other paths."""
    results: List[Optional[ExtzResult]] = [None] * len(jobs)
    guard = degenerate(mat, q, e)
    sc_N = -e if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, job in enumerate(jobs):
        if len(job.query) == 0 or len(job.target) == 0 or guard:
            results[i] = ExtzResult()
            results[i].reset()
            continue
        buckets.setdefault(_bucket_key(len(job.query), len(job.target)),
                           []).append(i)
    pieces = []
    for (Lq, Lt), idxs in _heaviest_first(buckets, jobs):
        qlen = np.array([len(jobs[i].query) for i in idxs], np.int32)
        tlen = np.array([len(jobs[i].target) for i in idxs], np.int32)
        raw = np.array([jobs[i].w for i in idxs], np.int32)
        wv = np.where(raw >= 0, raw, np.maximum(qlen, tlen)).astype(np.int32)
        spec = BatchSpec(Lq=Lq, Lt=Lt, m=int(m), sc_mch=int(mat[0]),
                         sc_mis=int(mat[1]), sc_N=sc_N, q=int(q), e=int(e),
                         zdrop=int(zdrop), flag=int(flag))
        out = run_fn(spec,
                     pad_rows([jobs[i].query for i in idxs], Lq, np.int32),
                     pad_rows([jobs[i].target for i in idxs], Lt, np.int32),
                     qlen, tlen, wv)
        rec = np.stack([np.asarray(out[k]) for k in FIELD_ORDER], axis=1)
        pieces.append((idxs, torch.from_numpy(rec.astype(np.int32))))
    return PendingScores(results, pieces, None, guard)


def align_batch_scores(jobs, m, mat, q, e, zdrop=-1,
                       flag: Flag | int = Flag.SCORE_ONLY,
                       device="cuda", run_fn=None) -> List[ExtzResult]:
    """Score a batch of one-piece extension jobs, bucketed by shape
    (through ``run_fn`` when one is given)."""
    return align_batch_scores_async(jobs, m, mat, q, e, zdrop=zdrop,
                                    flag=flag, device=device,
                                    run_fn=run_fn).result()


def align_batch_scores2_async(
    jobs: Sequence[AlignJob],
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    q2: int,
    e2: int,
    zdrop: int = -1,
    flag: Flag | int = Flag.SCORE_ONLY,
    device="cuda",
) -> PendingScores:
    """Submit a two-piece (extd) score batch without waiting; the same
    handle as :func:`align_batch_scores_async`.  Each bucket takes strips,
    else band, else batched, else the single-pair two-piece engine
    (``scheduler.py:482-521``).  As in the JAX
    package (``scheduler.py:463-465, 526-528``) a job is reset when
    scoring is degenerate against the PRE-swap ``q + e``, and the handle's
    guard tests the cheaper arm; the two differ when the costs swap."""
    flag = Flag(int(flag)) | Flag.SCORE_ONLY
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    return _scores2_async(
        jobs, m, mat, q, e, q2, e2, zdrop, flag, device,
        _score_chooser(flag, m, mat, zdrop, q, e, True, q2, e2))


def _scores2_async(jobs, m, mat, q, e, q2, e2, zdrop, flag, device,
                   choose) -> PendingScores:
    """The two-piece score path with the route table ``choose``."""
    dev = resolve_device(device)
    results: List[Optional[ExtzResult]] = [None] * len(jobs)
    qc, ec = canonical_costs(q, e, q2, e2)[:2]
    buckets = _merged_batch(_route(jobs, mat, q + e, results, choose,
                                   strips_costs=(qc, ec)), m)
    pieces = _score_pieces(jobs, buckets, m, mat, q, e, zdrop, flag, dev,
                           True, q2, e2)
    min_sc = int(mat[1:].min())
    return _pending_scores(results, pieces, dev, -min_sc > 2 * (qc + ec))


def align_batch_scores2(jobs, m, mat, q, e, q2, e2, zdrop=-1,
                        flag: Flag | int = Flag.SCORE_ONLY,
                        device="cuda") -> List[ExtzResult]:
    """Score a batch of two-piece extension jobs, bucketed by shape."""
    return align_batch_scores2_async(jobs, m, mat, q, e, q2, e2,
                                     zdrop=zdrop, flag=flag,
                                     device=device).result()


class PendingAligns:
    """Handle for an in-flight :func:`align_batch_async` batch (scores +
    CIGARs); :meth:`result` waits and assembles once."""

    def __init__(self, finish: Callable[[], List[ExtzResult]]):
        self._finish = finish
        self._results = None

    def result(self) -> List[ExtzResult]:
        if self._results is None:
            self._results = self._finish()
        return self._results


def align_batch_async(
    jobs: Sequence[AlignJob],
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    q2: Optional[int] = None,
    e2: Optional[int] = None,
    zdrop: int = -1,
    end_bonus: int = 0,
    flag: Flag | int = Flag.NONE,
    device="cuda",
) -> PendingAligns:
    """Submit a full-alignment batch (scores + CIGARs) without waiting.

    One-piece (``q2 is None``) SCORE_ONLY batches take the score path;
    two-piece SCORE_ONLY batches with neither ``end_bonus`` nor EXTZ_ONLY
    take the two-piece score path, the others the band, then the batched
    route in score form, then the single-pair two-piece engine; every
    other batch takes the CIGAR path, where each bucket takes strips,
    else band, else batched, else the single-pair engine of its costs
    (``scheduler.py:564-577, 609-617, 639-767`` in the JAX package)."""
    two = q2 is not None
    if two and e2 is None:
        raise ValueError("two-piece costs need both q2 and e2")
    dev = resolve_device(device)
    flag = Flag(int(flag))
    if flag & Flag.SCORE_ONLY:
        if not two:
            h = align_batch_scores_async(jobs, m, mat, q, e, zdrop=zdrop,
                                         flag=flag, device=dev)
        elif end_bonus == 0 and not flag & Flag.EXTZ_ONLY:
            h = align_batch_scores2_async(jobs, m, mat, q, e, q2, e2,
                                          zdrop=zdrop, flag=flag,
                                          device=dev)
        else:
            mat = np.asarray(mat, dtype=np.int8).reshape(-1)
            h = _scores2_async(jobs, m, mat, q, e, q2, e2, zdrop, flag, dev,
                               _cigar_path_score_chooser(flag, mat))
        return PendingAligns(h.result)
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    q2, e2 = q2 or 0, e2 or 0
    results: List[Optional[ExtzResult]] = [None] * len(jobs)

    # the reference resets after its swap (ksw2_extd2_sse.c:93-100)
    qc, ec = canonical_costs(q, e, q2, e2)[:2] if two else (q, e)
    buckets = _merged_batch(_route(
        jobs, mat, qc + ec, results,
        _cigar_chooser(flag, m, mat, zdrop, q, e, two, q2, e2)), m)
    cig_runs = {"band": (band_cigar_launch, unpack_band_cigars),
                "batch": (batch_cigar_launch, unpack_batch_cigars)}
    pieces = []
    for bk in buckets:
        qs = [jobs[i].query for i in bk.idxs]
        ts = [jobs[i].target for i in bk.idxs]
        if bk.route == "single" and two:
            launches = extd_prep(qs, ts, bk.qlen, bk.tlen, bk.w, m, mat, q,
                                 e, q2, e2, zdrop, flag, cig=True)
            pieces += _run_launches(bk.idxs, launches, lambda ln: (
                functools.partial(unpack_extd_cigars, ln, mat=mat,
                                  end_bonus=end_bonus),
                extd_cigar_launch(ln, end_bonus, dev)))
        elif bk.route == "single":
            launches = extz_prep(qs, ts, bk.qlen, bk.tlen, bk.w, m, mat, q,
                                 e, zdrop, flag, cig=True)
            pieces += _run_launches(bk.idxs, launches, lambda ln: (
                functools.partial(unpack_extz_cigars, ln, mat=mat,
                                  end_bonus=end_bonus),
                extz_cigar_launch(ln, end_bonus, dev)))
        elif bk.route in cig_runs:
            launch, unpack = cig_runs[bk.route]
            launches = band_prep(qs, ts, bk.qlen, bk.tlen, bk.w, m, mat, q, e,
                                 zdrop, flag, cig=True, two=two, q2=q2,
                                 e2=e2)
            pieces += _run_launches(bk.idxs, launches, lambda ln: (
                functools.partial(unpack, ln, mat=mat, end_bonus=end_bonus),
                launch(ln, end_bonus, dev)))
        else:
            launches = strips_prep(qs, ts, bk.qlen, bk.tlen, m, mat, q, e,
                                   zdrop, flag, cig=True, two=two, q2=q2,
                                   e2=e2)
            # the launch's params carry the POST-swap costs
            pieces += _run_launches(bk.idxs, launches, lambda ln: (
                functools.partial(unpack_cigars, mat=mat, q=ln.prm.q,
                                  e=ln.prm.e, end_bonus=end_bonus,
                                  flag=flag),
                strips_cigar_launch(ln, end_bonus, dev)))
    return _pending_aligns(results, pieces, dev)


def _pending_aligns(results, pieces, dev) -> PendingAligns:
    """Start the device-to-host copies of every piece ``(job indices,
    (unpack, device tensors))`` and return the handle whose ``result()``
    waits once and fills ``results`` with ``unpack(*host arrays)``."""
    flat = [t for _, (_, ts) in pieces for t in ts]
    host, ev = _to_host(flat, dev)

    def finish() -> List[ExtzResult]:
        if ev is not None:
            ev.synchronize()
        k = 0
        for idxs, (unpack, ts) in pieces:
            arrs = [t.numpy() for t in host[k:k + len(ts)]]
            k += len(ts)
            for i, ez in zip(idxs, unpack(*arrs)):
                results[i] = ez
        return results

    return PendingAligns(finish)


def _score_ezs(rec) -> List[ExtzResult]:
    return [_ez_of(r) for r in rec]


def _splice_chooser(flag, m, mat, zdrop, q, e, q2, juncs, junc_bonus):
    """The splice path's route table for one bucket (``scheduler.py:
    963-1027``): strips in its ``spl`` form unless the bucket has a
    junction track (or there is a ``junc_bonus``), then the batched exts
    engine (targets up to 1536, no EXTZ_ONLY), then the single-pair exts
    engine."""
    def choose(Lt, ql, tl, w, _raw, idxs):
        junc_any = juncs is not None and any(juncs[i] is not None
                                             for i in idxs)
        reason = strips_exts_ineligible_reason(ql, tl, w, flag, m, mat,
                                               zdrop, q, e, q2, junc_any,
                                               junc_bonus)
        if reason is None:
            return "strips"
        if batch_exts_ineligible_reason(Lt, flag) is None:
            return "batch"
        return "single"
    return choose


def plan_splice(jobs, m, mat, q, e, q2, noncan, zdrop, junc_bonus, flag,
                juncs, results) -> List[Tuple[List[int], str, list]]:
    """Route and prep a splice batch (host only, no device work): reset
    empty jobs, every job under degenerate scoring and the batched and
    single-pair buckets the exts guard resets
    (``batch_exts.batch_exts_resets``) into ``results``; route the rest by
    the splice table; and prep each bucket's launches in score form under
    SCORE_ONLY, else with bytes.  Returns ``(job indices, route,
    launches)`` a bucket, heaviest first, with route "strips"
    (``strips.Launch``), "batch" (``band.BandLaunch`` with site rows) or
    "single" (``extz.ExtzLaunch`` with site rows; one entry for all the
    single-pair buckets)."""
    cig = not flag & Flag.SCORE_ONLY
    buckets = _route(jobs, mat, q + e, results,
                     _splice_chooser(flag, m, mat, zdrop, q, e, q2, juncs,
                                     junc_bonus), key=_jax_bucket_key)
    plan = []
    for bk in buckets:
        qs = [jobs[i].query for i in bk.idxs]
        ts = [jobs[i].target for i in bk.idxs]
        if bk.route == "strips":
            launches = strips_exts_prep(qs, ts, bk.qlen, bk.tlen, m, mat, q,
                                        e, q2, noncan, zdrop, flag, cig=cig)
        elif batch_exts_resets(m, mat, q, e, q2):
            for i in bk.idxs:
                results[i] = ExtzResult()
                results[i].reset()
            continue
        else:
            prep = batch_exts_prep if bk.route == "batch" else exts_prep
            launches = prep(
                qs, ts, bk.qlen, bk.tlen, m, mat, q, e, q2, noncan, zdrop,
                flag, None if juncs is None else [juncs[i] for i in bk.idxs],
                junc_bonus, cig=cig)
        plan.append((bk.idxs, bk.route, launches))
    return plan


def align_batch_splice_async(
    jobs: Sequence[AlignJob],
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    q2: int,
    noncan: int,
    zdrop: int = -1,
    junc_bonus: int = 0,
    flag: Flag | int = Flag.NONE,
    juncs: Optional[Sequence[Optional[np.ndarray]]] = None,
    device="cuda",
) -> PendingAligns:
    """Submit a spliced (mRNA-to-genome) batch without waiting: scores,
    or CIGARs with N ops for introns unless SCORE_ONLY.  ``juncs``
    optionally gives per-job junction tracks.  Each bucket takes strips
    in its ``spl`` form, else the batched exts engine, else the
    single-pair exts engine (``scheduler.py:916-1119``); the batched and
    single-pair routes reset their jobs when ``q2 <= q + e`` (or ``m <=
    1``), as exts2 does, while the strips route runs them, as the JAX
    package's does (ROADMAP Queue 3).  The launches are
    :func:`plan_splice`'s."""
    dev = resolve_device(device)
    flag = Flag(int(flag))
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    q, e, q2, noncan = int(q), int(e), int(q2), int(noncan)
    if juncs is not None and len(juncs) != len(jobs):
        raise ValueError(f"{len(juncs)} junction tracks for {len(jobs)} jobs")
    results: List[Optional[ExtzResult]] = [None] * len(jobs)
    plan = plan_splice(jobs, m, mat, q, e, q2, noncan, zdrop, junc_bonus,
                       flag, juncs, results)
    pieces = []
    records = {"strips": strips_records, "batch": batch_exts_records,
               "single": exts_records}
    for idxs, route, launches in plan:
        if flag & Flag.SCORE_ONLY:
            run = records[route]
            pieces += _run_launches(idxs, launches, lambda ln: (
                _score_ezs, (run(ln, dev),)))
        elif route == "strips":
            pieces += _run_launches(idxs, launches, lambda ln: (
                functools.partial(unpack_cigars, mat=mat, q=q, e=e,
                                  end_bonus=0, flag=flag,
                                  min_intron=ln.prm.lt),
                strips_cigar_launch(ln, 0, dev)))
        elif route == "batch":
            pieces += _run_launches(idxs, launches, lambda ln: (
                functools.partial(unpack_exts_cigars, ln, mat=mat),
                batch_exts_cigar_launch(ln, 0, dev)))
        else:
            pieces += _run_launches(idxs, launches, lambda ln: (
                functools.partial(unpack_single_exts_cigars, ln, mat=mat),
                exts_cigar_launch(ln, dev)))
    return _pending_aligns(results, pieces, dev)


def align_batch_splice(jobs, m, mat, q, e, q2, noncan, zdrop=-1,
                       junc_bonus=0, flag: Flag | int = Flag.NONE,
                       juncs=None, device="cuda") -> List[ExtzResult]:
    """Spliced alignment of a batch of jobs (see
    :func:`align_batch_splice_async`)."""
    return align_batch_splice_async(jobs, m, mat, q, e, q2, noncan,
                                    zdrop=zdrop, junc_bonus=junc_bonus,
                                    flag=flag, juncs=juncs,
                                    device=device).result()


def align_batch(jobs, m, mat, q, e, q2=None, e2=None, zdrop=-1,
                end_bonus=0, flag: Flag | int = Flag.NONE,
                device="cuda") -> List[ExtzResult]:
    """Full alignment (scores + CIGARs) for a batch of jobs; one-piece
    when ``q2`` is None, else two-piece."""
    return align_batch_async(jobs, m, mat, q, e, q2=q2, e2=e2, zdrop=zdrop,
                             end_bonus=end_bonus, flag=flag,
                             device=device).result()


__all__ = ["AlignJob", "PendingScores", "PendingAligns", "resolve_device",
           "align_batch_scores", "align_batch_scores_async",
           "align_batch_scores2", "align_batch_scores2_async", "align_batch",
           "align_batch_async", "align_batch_splice",
           "align_batch_splice_async", "plan_splice", "pad_rows"]
