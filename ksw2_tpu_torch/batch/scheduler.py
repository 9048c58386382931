"""Pair-batch scheduler for the strips and rows routes.

Port of ``ksw2_tpu/batch/scheduler.py``'s score and CIGAR paths for one-
and two-piece costs: jobs are bucketed by shape, each bucket is checked
against the strips envelope, one-piece score buckets that
``rows_eligible`` accepts run the rows kernel (the JAX route's priority),
and every launch is enqueued on the current CUDA stream before anything
waits.  A handle's ``result()`` synchronises on the
event recorded after the batch's device-to-host copies, so several
batches in flight overlap one batch's host work with the next one's
device work.  On ``device="cpu"`` the same path runs the kernels' plain
versions synchronously.

A job outside the envelope raises ``NotImplementedError`` naming its
route and the ROADMAP.md item that brings it; nothing falls back.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.flags import NEG_INF, Flag
from ..core.result import ExtzResult
from ..ops.records import NFIELDS
from ..ops.rows import rows_eligible, rows_records
from ..ops.strips import (TMAX, QMAX, canonical_costs,
                          strips_extd_ineligible_reason,
                          strips_ineligible_reason, strips_prep,
                          strips_records)
from ..ops.strips_walker import (strips_cigar_extd_ineligible_reason,
                                 strips_cigar_ineligible_reason,
                                 strips_cigar_launch, unpack_cigars)

_SCORES_LT = (128, 256, 512, 768, 1024, 1280, 1536, 2048, 2560, 3072)


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


def _bucket_key_scores(qn: int, tn: int) -> Optional[Tuple[int, int]]:
    """(Lq, Lt) bucket on the strips envelope's canonical ladders, or
    None for a pair outside it."""
    if tn > TMAX or qn > QMAX:
        return None
    Lq = 512
    while Lq < qn:
        Lq *= 2
    for Lt in _SCORES_LT:
        if Lt >= tn:
            return (min(Lq, QMAX), Lt)
    return None


def _heaviest_first(buckets: Dict[Tuple[int, int], List[int]], jobs):
    """Bucket items ordered biggest-compute-first, so the device starts
    on the heaviest launches while the host still preps the rest."""
    def cost(kv):
        _, idxs = kv
        return -sum(len(jobs[i].query) * len(jobs[i].target) for i in idxs)
    return sorted(buckets.items(), key=cost)


def _route(jobs, mat, qe: int, results, reason_fn, what: str):
    """Reset empty jobs, and every job when scoring is degenerate
    (``-min_sc > 2 * qe``); bucket the rest, check every bucket against
    the envelope and return the buckets' (idxs, qlen, tlen, w) heaviest
    first.  Raises before anything runs."""
    min_sc = int(np.asarray(mat).reshape(-1)[1:].min())
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, job in enumerate(jobs):
        if len(job.query) == 0 or len(job.target) == 0 or \
                -min_sc > 2 * qe:
            ez = ExtzResult()
            ez.reset()
            results[i] = ez
            continue
        key = _bucket_key_scores(len(job.query), len(job.target))
        if key is None:
            raise NotImplementedError(
                f"{what}: job {i} (query {len(job.query)}, target "
                f"{len(job.target)}) is outside the strips envelope; "
                "targets over 3072 or queries over 4608 run on the "
                "any-device and single-pair engines (ROADMAP items 7, 12)")
        buckets.setdefault(key, []).append(i)
    out = []
    for _, idxs in _heaviest_first(buckets, jobs):
        qlen = np.array([len(jobs[i].query) for i in idxs], np.int32)
        tlen = np.array([len(jobs[i].target) for i in idxs], np.int32)
        wv = np.array([jobs[i].w if jobs[i].w >= 0
                       else max(len(jobs[i].query), len(jobs[i].target))
                       for i in idxs], np.int32)
        reason = reason_fn(qlen, tlen, wv)
        if reason is not None:
            raise NotImplementedError(f"{what}: {reason}")
        out.append((idxs, qlen, tlen, wv))
    return out


def _to_host(tensors: List[torch.Tensor], dev: torch.device):
    """Start device-to-host copies of ``tensors``; returns the host
    tensors and the event that marks their arrival (None on the CPU)."""
    if dev.type != "cuda":
        return tensors, None
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return host, ev


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
                    r = arr[k]
                    if self._guard:
                        ez = ExtzResult()
                        ez.reset()
                        self._results[i] = ez
                        continue
                    self._results[i] = ExtzResult(
                        max=int(r[0]), max_t=int(r[1]), max_q=int(r[2]),
                        mqe=int(r[3]), mqe_t=int(r[4]), mte=int(r[5]),
                        mte_q=int(r[6]), score=int(r[7]),
                        zdropped=bool(r[8]))
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


def align_batch_scores_async(
    jobs: Sequence[AlignJob],
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    zdrop: int = -1,
    flag: Flag | int = Flag.SCORE_ONLY,
    device="cuda",
) -> PendingScores:
    """Submit a one-piece score batch without waiting.  A bucket that
    ``rows_eligible`` accepts runs the rows kernel, every other bucket
    the strips kernel (``scheduler.py:242-247`` in the JAX package)."""
    dev = resolve_device(device)
    flag = Flag(int(flag)) | Flag.SCORE_ONLY
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    results: List[Optional[ExtzResult]] = [None] * len(jobs)
    buckets = _route(
        jobs, mat, q + e, results,
        lambda ql, tl, w: strips_ineligible_reason(ql, tl, w, flag, m, mat,
                                                   zdrop, q, e),
        "score route")
    pieces = []
    for idxs, qlen, tlen, wv in buckets:
        run = rows_records if rows_eligible(qlen, tlen, wv, flag, zdrop, m,
                                            mat) else strips_records
        launches = strips_prep([jobs[i].query for i in idxs],
                               [jobs[i].target for i in idxs], qlen, tlen,
                               m, mat, q, e, zdrop, flag)
        pieces += _run_launches(idxs, launches, lambda ln: run(ln, dev))
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


def align_batch_scores(jobs, m, mat, q, e, zdrop=-1,
                       flag: Flag | int = Flag.SCORE_ONLY,
                       device="cuda") -> List[ExtzResult]:
    """Score a batch of one-piece extension jobs, bucketed by shape."""
    return align_batch_scores_async(jobs, m, mat, q, e, zdrop=zdrop,
                                    flag=flag, device=device).result()


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
    handle as :func:`align_batch_scores_async`.  As in the JAX package
    (``scheduler.py:463-465, 526-528``) a job is reset when scoring is
    degenerate against the PRE-swap ``q + e``, and the handle's guard
    tests the cheaper arm; the two differ when the costs swap."""
    dev = resolve_device(device)
    flag = Flag(int(flag)) | Flag.SCORE_ONLY
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    results: List[Optional[ExtzResult]] = [None] * len(jobs)
    buckets = _route(
        jobs, mat, q + e, results,
        lambda ql, tl, w: strips_extd_ineligible_reason(
            ql, tl, w, flag, m, mat, zdrop, q, e, q2, e2),
        "two-piece score route")
    pieces = []
    for idxs, qlen, tlen, _ in buckets:
        launches = strips_prep([jobs[i].query for i in idxs],
                               [jobs[i].target for i in idxs], qlen, tlen,
                               m, mat, q, e, zdrop, flag, two=True, q2=q2,
                               e2=e2)
        pieces += _run_launches(idxs, launches,
                                lambda ln: strips_records(ln, dev))
    qc, ec = canonical_costs(q, e, q2, e2)[:2]
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
    two-piece SCORE_ONLY batches with ``end_bonus == 0`` and no
    EXTZ_ONLY take the two-piece score path; every other batch takes the
    strips CIGAR route (``scheduler.py:564-577, 609-617, 651-663`` in
    the JAX package)."""
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
            raise NotImplementedError(
                "two-piece SCORE_ONLY batches with end_bonus or EXTZ_ONLY "
                "run on the band and batched extd engines (ROADMAP items "
                "10, 11)")
        return PendingAligns(h.result)
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    results: List[Optional[ExtzResult]] = [None] * len(jobs)
    if two:
        # the reference resets after its swap (ksw2_extd2_sse.c:93-100)
        qc, ec = canonical_costs(q, e, q2, e2)[:2]
        buckets = _route(
            jobs, mat, qc + ec, results,
            lambda ql, tl, w: strips_cigar_extd_ineligible_reason(
                ql, tl, w, flag, m, mat, zdrop, q, e, q2, e2),
            "two-piece CIGAR route")
    else:
        buckets = _route(
            jobs, mat, q + e, results,
            lambda ql, tl, w: strips_cigar_ineligible_reason(
                ql, tl, w, flag, m, mat, zdrop, q, e),
            "CIGAR route")
    pieces = []
    for idxs, qlen, tlen, _ in buckets:
        launches = strips_prep([jobs[i].query for i in idxs],
                               [jobs[i].target for i in idxs], qlen, tlen,
                               m, mat, q, e, zdrop, flag, cig=True, two=two,
                               q2=q2 or 0, e2=e2 or 0)
        pieces += _run_launches(
            idxs, launches,
            lambda ln: (ln.prm, strips_cigar_launch(ln, end_bonus, dev)))
    host, ev = _to_host([t for _, (_, ts) in pieces for t in ts], dev)

    def finish() -> List[ExtzResult]:
        if ev is not None:
            ev.synchronize()
        for k, (idxs, (prm, _)) in enumerate(pieces):
            rec, res, runs = (t.numpy() for t in host[3 * k:3 * k + 3])
            # the launch's params carry the POST-swap costs
            ezs = unpack_cigars(rec, res, runs, mat, prm.q, prm.e,
                                end_bonus, flag)
            for i, ez in zip(idxs, ezs):
                results[i] = ez
        return results

    return PendingAligns(finish)


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
           "align_batch_async"]
