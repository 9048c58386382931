"""ksw2-test-compatible command-line interface of the PyTorch port.

Port of ``ksw2_tpu/cli.py``: the same options, algorithm names, defaults
and TSV output as the reference CLI (``cli.c:159-259``).  Extensions:

* ``--backend {pair,batch}``: ``pair`` aligns pair by pair (the JAX CLI's
  ``tpu`` / ``spec``); ``batch`` is the whole-file dispatch: extz2 and
  extd2 through the scheduler (``align_batch``), exts2 through the splice
  scheduler, extf2 through the batched extf kernel (kernel 7) and gg2_sse
  through the batched gg2 kernel (kernel 8) with the flat walk, for pairs
  of targets up to 1024 (gg2_sse also ``qlen <= tlen + w``,
  ``ksw2_tpu/cli.py:147-152``); extf2 and gg2_sse pairs beyond take the
  single-pair kernels 15 and 16 in one launch, the others the per-pair
  dispatch.
* ``--device {cuda,cpu}``: ``cuda`` (the default) runs the CUDA kernels
  and raises without a card; ``cpu`` runs their plain PyTorch versions.
* exts2 CIGARs print intron ops as ``N`` and use the JAX CLI's fixed A1
  B2 costs (``ksw2_tpu/cli.py:106, 193``).
* ``gg``, ``gg2``, ``extz`` and ``extd`` (the non-SSE algorithms) have no
  kernel: they run the port's copies of the NumPy spec engines on every
  backend and device, as the JAX CLI does on every backend.

Usage: ``python -m ksw2_tpu_torch.cli [options] <DNA-target> <DNA-query>``
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from .batch.scheduler import resolve_device
from .core.flags import NEG_INF, Flag
from .core.matrix import encode_dna, simple_mat
from .core.result import ExtzResult
from .ops.bands import resolve_bands

ALGOS = ("gg", "gg2", "gg2_sse", "extz", "extz2_sse", "extd", "extd2_sse",
         "extf2_sse", "exts2_sse", "test")
BATCH_ALGOS = ("extz2_sse", "extd2_sse", "gg2_sse", "extf2_sse",
               "exts2_sse")
BATCH_LT = 1024           # the whole-file dispatch's targets (cli.py:147)


def _gg_ez(score: int, cigar) -> ExtzResult:
    ez = ExtzResult()
    ez.reset()
    ez.score = score
    ez.max, ez.max_t, ez.max_q = 0, -1, -1
    ez.cigar = list(cigar)
    return ez


def dispatch(algo: str, qseq: str, tseq: str, m: int = 5, a: int = 2,
             b: int = 4, q: int = 4, e: int = 2, q2: int = 13, e2: int = 1,
             w: int = -1, zdrop: int = -1, flag: Flag | int = Flag.NONE,
             device="cuda") -> ExtzResult:
    """One pair with the reference CLI's parameter mapping
    (``ksw2_tpu/cli.py:dispatch``)."""
    flag = Flag(int(flag))
    mat = simple_mat(m, a, -b)
    qs = encode_dna(qseq)
    ts = encode_dna(tseq)
    score_only = bool(flag & Flag.SCORE_ONLY)
    if algo == "gg":
        from .spec import rowdp
        score, cig = rowdp.gg(qs, ts, m, mat, q, e, w=w,
                              with_cigar=not score_only)
        ez = _gg_ez(score, cig if not score_only else [])
        ez.mqe = ez.mte = NEG_INF
        return ez
    if algo == "gg2":
        from .spec.gg2 import gg2
        score, cig, _ = gg2(qs, ts, m, mat, q, e, w=w,
                            with_cigar=not score_only)
        return _gg_ez(score, cig if not score_only else [])
    if algo == "gg2_sse":
        from .ops.gg2 import gg2_device
        score, cig, _ = gg2_device(qs, ts, m, mat, q, e, w=w, device=device)
        return _gg_ez(score, cig)
    if algo == "extz":
        from .spec import rowdp
        return rowdp.extz(qs, ts, m, mat, q, e, w=w, zdrop=zdrop, flag=flag)
    if algo == "extz2_sse":
        from .ops.extz import extz2_device
        return extz2_device(qs, ts, m, mat, q, e, w=w, zdrop=zdrop,
                            flag=flag, device=device)
    if algo == "extd":
        from .spec import rowdp
        return rowdp.extd(qs, ts, m, mat, q, e, q2, e2, w=w, zdrop=zdrop,
                          flag=flag)
    if algo == "extd2_sse":
        from .ops.extd import extd2_device
        return extd2_device(qs, ts, m, mat, q, e, q2, e2, w=w, zdrop=zdrop,
                            flag=flag, device=device)
    if algo == "extf2_sse":
        from .ops.extf import extf2_device
        return extf2_device(qs, ts, int(mat[0]), int(mat[1]), e, w=w,
                            xdrop=zdrop, device=device)
    if algo == "exts2_sse":
        from .ops.exts import exts2_device
        return exts2_device(qs, ts, 5, simple_mat(5, 1, -2), 2, 1, 32, 4,
                            zdrop=zdrop, junc_bonus=0,
                            flag=flag | Flag.SPLICE_FOR, device=device)
    if algo == "test":
        from .ops.extd import extd2_device
        return extd2_device(qs, ts, m, mat, 4, 2, 24, 1, w=751, zdrop=400,
                            flag=Flag.APPROX_MAX, device=device)
    print(f"ERROR: can't find algorithm '{algo}'", file=sys.stderr)
    sys.exit(1)


def print_aln(tname: str, qname: str, ez: ExtzResult, out=None) -> None:
    fields = [tname, qname] + ez.tsv_fields()
    print("\t".join(fields), file=out if out is not None else sys.stdout)


def _pad(enc, idxs):
    Lq = max(len(enc[i][0]) for i in idxs)
    Lt = max(len(enc[i][1]) for i in idxs)
    Q = np.zeros((len(idxs), Lq), np.uint8)
    T = np.zeros((len(idxs), Lt), np.uint8)
    for k, i in enumerate(idxs):
        Q[k, :len(enc[i][0])] = enc[i][0]
        T[k, :len(enc[i][1])] = enc[i][1]
    return Q, T


def batch_eligible(algo: str, qlen: int, tlen: int, w: int) -> bool:
    """Whether the whole-file dispatch sends a pair of ``algo`` at the
    resolved band ``w`` to the batched kernels (``ksw2_tpu/cli.py:147-152``):
    targets of 1 to 1024, a query, and for gg2_sse ``qlen <= tlen + w``."""
    ok = 0 < tlen <= BATCH_LT and qlen > 0
    return ok and (algo != "gg2_sse" or qlen <= tlen + w)


def batch_other(algo: str, pairs, mat, q: int, e: int, w: int, zdrop: int,
                flag, kw, device) -> List[ExtzResult]:
    """Whole-file batched dispatch for gg2_sse / extf2_sse / exts2_sse
    (``ksw2_tpu/cli.py:_batch_other``): pairs with targets of up to 1024
    (and, for gg2_sse, ``qlen <= tlen + w``) take the batched kernels;
    extf2 and gg2_sse pairs beyond take kernels 15 and 16 in one launch,
    exts2 pairs beyond the per-pair dispatch."""
    enc = [(encode_dna(qrec.seq), encode_dna(trec.seq))
           for trec, qrec in pairs]
    n = len(enc)
    results: List[Optional[ExtzResult]] = [None] * n
    wv = resolve_bands(enc, w)
    elig = [batch_eligible(algo, len(qs), len(ts), wk)
            for (qs, ts), wk in zip(enc, wv)]
    idxs = [i for i in range(n) if elig[i]]
    rest = [i for i in range(n) if not elig[i]]
    if algo == "gg2_sse":
        from .ops.batch_gg2 import gg2_batch_align
        from .ops.gg2 import gg2_pairs
        outs = []
        if idxs:
            Q, T = _pad(enc, idxs)
            outs = gg2_batch_align(
                Q, T, [len(enc[i][0]) for i in idxs],
                [len(enc[i][1]) for i in idxs], 5, mat, q, e,
                [wv[i] for i in idxs], device=device)
        outs += gg2_pairs([enc[i] for i in rest], 5, mat, q, e,
                          [wv[i] for i in rest], device=device)
        for i, (score, cig) in zip(idxs + rest, outs):
            results[i] = _gg_ez(score, cig)
    elif algo == "extf2_sse":
        from .ops.batch_extf import extf_batch_device
        from .ops.extf import extf_pairs
        if idxs:
            Q, T = _pad(enc, idxs)
            out = extf_batch_device(
                Q, T, [len(enc[i][0]) for i in idxs],
                [len(enc[i][1]) for i in idxs], int(mat[0]), int(mat[1]), e,
                w=[wv[i] for i in idxs], xdrop=zdrop, device=device)
            for k, i in enumerate(idxs):
                ez = ExtzResult()
                ez.reset()
                for f in ("max", "max_t", "max_q", "score"):
                    setattr(ez, f, int(out[f][k]))
                ez.zdropped = bool(out["zdropped"][k])
                results[i] = ez
        for i, ez in zip(rest, extf_pairs(
                [enc[i] for i in rest], int(mat[0]), int(mat[1]), e,
                [wv[i] for i in rest], zdrop, device)):
            results[i] = ez
    else:   # exts2_sse
        from .batch.scheduler import AlignJob, align_batch_splice
        if idxs:
            jobs = [AlignJob(enc[i][0], enc[i][1]) for i in idxs]
            ezs = align_batch_splice(jobs, 5, simple_mat(5, 1, -2), 2, 1,
                                     32, 4, zdrop=zdrop,
                                     flag=flag | Flag.SPLICE_FOR,
                                     device=device)
            for i, ez in zip(idxs, ezs):
                results[i] = ez
        for i in rest:
            results[i] = dispatch(algo, pairs[i][1].seq, pairs[i][0].seq,
                                  **kw)
    return results


def _two(sv: str):
    parts = str(sv).split(",")
    v1 = int(parts[0])
    return v1, int(parts[1]) if len(parts) > 1 else v1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ksw2-torch", add_help=True,
        description="PyTorch/CUDA pairwise alignment (ksw2-test "
                    "compatible)")
    ap.add_argument("-t", dest="algo", default="extd",
                    help=f"algorithm: {', '.join(ALGOS)} [extd]")
    ap.add_argument("-w", dest="w", type=int, default=-1,
                    help="band width [inf]")
    ap.add_argument("-R", dest="rep", type=int, default=1,
                    help="repeat (benchmark) [1]")
    ap.add_argument("-z", dest="zdrop", type=int, default=-1,
                    help="Z-drop [-1]")
    ap.add_argument("-r", dest="right", action="store_true",
                    help="gap right alignment")
    ap.add_argument("-s", dest="score_only", action="store_true",
                    help="score only")
    ap.add_argument("-g", dest="approx", action="store_true",
                    help="approximate max")
    ap.add_argument("-K", dest="no_kalloc", action="store_true",
                    help="(compat no-op: no arena allocator here)")
    ap.add_argument("-A", dest="a", type=int, default=2,
                    help="match score [2]")
    ap.add_argument("-B", dest="b", type=int, default=4,
                    help="mismatch penalty [4]")
    ap.add_argument("-O", dest="gapo", default="4,13",
                    help="gap open [4,13]")
    ap.add_argument("-E", dest="gape", default="2,1", help="gap ext [2,1]")
    ap.add_argument("-a", dest="all_vs_all", action="store_true",
                    help="all vs all")
    ap.add_argument("--backend", default="pair", choices=("pair", "batch"),
                    help="pair by pair, or whole-file batches [pair]")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the CUDA kernels or their plain PyTorch "
                         "versions [cuda]")
    ap.add_argument("--stats", action="store_true",
                    help="print the km_stat-style engine report to stderr")
    ap.add_argument("target", help="target FASTA/FASTQ (or literal "
                                   "sequence)")
    ap.add_argument("query", help="query FASTA/FASTQ (or literal sequence)")
    args = ap.parse_args(argv)

    if args.stats:
        raise NotImplementedError(
            "--stats: the km_stat report on torch.cuda.memory_stats "
            "(ROADMAP item 16)")
    device = resolve_device(args.device)
    q, q2 = _two(args.gapo)
    e, e2 = _two(args.gape)
    flag = Flag.NONE
    if args.right:
        flag |= Flag.RIGHT
    if args.score_only:
        flag |= Flag.SCORE_ONLY
    if args.approx:
        flag |= Flag.APPROX_MAX | Flag.APPROX_DROP
    kw = dict(a=args.a, b=args.b, q=q, e=e, q2=q2, e2=e2, w=args.w,
              zdrop=args.zdrop, flag=flag, device=device)

    t_is_file = os.path.exists(args.target)
    q_is_file = os.path.exists(args.query)
    if not t_is_file and not q_is_file:
        # literal sequences (the reference maps argv[optind+1] to the query)
        ez = dispatch(args.algo, args.query, args.target, **kw)
        print_aln("first", "second", ez)
        return 0
    if not (t_is_file and q_is_file):
        print("ERROR: need two readable files or two literal sequences",
              file=sys.stderr)
        return 1

    from .io.fasta import read_fastx

    if not args.all_vs_all:
        pairs = list(zip(read_fastx(args.target), read_fastx(args.query)))
    else:
        targets = list(read_fastx(args.target))
        pairs = [(trec, qrec) for qrec in read_fastx(args.query)
                 for trec in targets]

    if args.backend == "batch" and args.algo in BATCH_ALGOS:
        mat = simple_mat(5, args.a, -args.b)
        for _ in range(args.rep):
            if args.algo in ("extz2_sse", "extd2_sse"):
                from .batch.scheduler import AlignJob, align_batch
                jobs = [AlignJob(encode_dna(qrec.seq), encode_dna(trec.seq),
                                 w=args.w) for trec, qrec in pairs]
                two = args.algo == "extd2_sse"
                ezs = align_batch(jobs, 5, mat, q, e,
                                  q2=q2 if two else None,
                                  e2=e2 if two else None, zdrop=args.zdrop,
                                  flag=flag, device=device)
            else:
                ezs = batch_other(args.algo, pairs, mat, q, e, args.w,
                                  args.zdrop, flag, kw, device)
        for (trec, qrec), ez in zip(pairs, ezs):
            print_aln(trec.name, qrec.name, ez)
        return 0

    for trec, qrec in pairs:
        for _ in range(args.rep):
            ez = dispatch(args.algo, qrec.seq, trec.seq, **kw)
        print_aln(trec.name, qrec.name, ez)
    return 0


if __name__ == "__main__":
    sys.exit(main())
