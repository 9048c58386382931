"""Build the port's kernels before a deployment's first batch, and check
each kernel family on the card.

Port of ``ksw2_tpu/precompile.py``.  The JAX package compiles one XLA
program a bucket shape and fills its persistent compile cache ahead of
time.  The port compiles no program a shape and has no JIT to warm: its
kernels are one library, built by nvcc from ``csrc/`` into
``build/ksw2_tpu_torch/`` under a hash of the sources, which later
processes load in milliseconds.  So this step

1. builds the library (``_build.build()``), the one cost a process would
   otherwise pay at its first batch, and the only thing this step leaves
   behind for later processes;
2. loads it;
3. launches each kernel family once on the card at the shapes of the JAX
   package's ladder (``ksw2_tpu/precompile.py:_ladder``), through the
   entry points a user calls: one-piece scores at every ladder shape
   (two-piece scores and CIGARs too without ``--quick``), and at the
   ladder's shapes, once each, the rows, band, batched, splice (strips
   and annotated), single-pair (one-, two-piece, splice), linear-gap,
   global and local engines.  These launches are a self-test of the
   built library on this card: the CUDA context, the caching allocator
   and anything they warm belong to this process and end with it;
4. prints the km_stat report (:mod:`ksw2_tpu_torch.utils.stats`).

``--quick`` and ``--scores`` keep the JAX command's names; they choose
the self-test's shapes and costs (costs are runtime arguments of every
kernel), and neither changes what a later process loads.  It raises when
there is no card.  Usage::

    python -m ksw2_tpu_torch.precompile [--quick] [--scores A,B,O,E]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _ladder(quick: bool):
    """(Lq, Lt) bucket shapes of the standard short-read ladder
    (``ksw2_tpu/precompile.py:_ladder``)."""
    lts = [128, 256, 512, 1024, 1536] if quick else \
        [128, 256, 512, 768, 1024, 1280, 1536, 2048, 2560, 3072]
    return [(min(max(lt * 2, 512), 4608), lt) for lt in lts]


def _warmups(args, rng, device="cuda"):
    """(name, function) of each launch the step makes on ``device``."""
    from .api import Aligner
    from .core.flags import Flag
    from .core.matrix import simple_mat
    from .ops.batch_extf import extf_batch_device
    from .ops.batch_gg2 import gg2_batch_align
    from .ops.batch_local import local_batch_device
    from .ops.extf import extf2_device

    a, b, q, e = (int(v) for v in args.scores.split(","))
    mat = simple_mat(5, a, -b)
    B = 8
    ladder = _ladder(args.quick)

    def pairs(Lq, Lt, n=B):
        return [(rng.integers(0, 4, Lq).astype(np.uint8),
                 rng.integers(0, 4, Lt).astype(np.uint8)) for _ in range(n)]

    def arrays(ps):
        return (np.stack([p for p, _ in ps]), np.stack([t for _, t in ps]),
                np.array([len(p) for p, _ in ps], np.int32),
                np.array([len(t) for _, t in ps], np.int32))

    SO = Flag.SCORE_ONLY

    def aligner(**kw):
        return Aligner(a, b, q, e, device=device, **kw)

    one = aligner(zdrop=200, flag=SO)
    two = aligner(q2=13, e2=1, zdrop=200, flag=SO)
    cig = aligner(zdrop=200)
    out = []
    for Lq, Lt in ladder:
        ps = pairs(Lq, Lt)
        out.append((f"extz scores ({Lq},{Lt},B={B})",
                    lambda ps=ps: one.extend_batch(ps)))
        if not args.quick:
            out += [(f"extd scores ({Lq},{Lt},B={B})",
                     lambda ps=ps: two.extend_batch(ps)),
                    (f"extz cigar ({Lq},{Lt},B={B})",
                     lambda ps=ps: cig.extend_batch(ps))]
    (Lq0, Lt0), (Lqn, Ltn) = ladder[0], ladder[-1]
    small, large = pairs(Lq0, Lt0), pairs(Lqn, Ltn, 2)
    short = pairs(Lt0, Lt0)
    spl = Aligner(1, 2, 2, 1, q2=32, noncan=9, zdrop=200, splice=True,
                  flag=Flag.SPLICE_FOR, device=device)
    ann = Aligner(1, 2, 2, 1, q2=32, noncan=9, zdrop=200, splice=True,
                  junc_bonus=9, flag=Flag.SPLICE_FOR, device=device)
    junc = np.zeros(Lt0, np.uint8)
    junc[Lt0 // 3], junc[2 * Lt0 // 3] = 1, 2
    Q, T, ql, tl = arrays(small)
    out += [
        (f"rows scores ({Lt0},{Lt0},B={B})", lambda: one.extend_batch(short)),
        (f"extz cigar ({Lq0},{Lt0},B={B})", lambda: cig.extend_batch(small)),
        (f"band w=751 ({Lqn},{Ltn},B=2)",
         lambda: aligner(w=751, zdrop=400, flag=SO).extend_batch(large)),
        (f"batched w=100 ({Lq0},{Lt0},B={B})",
         lambda: aligner(w=100, zdrop=100).extend_batch(small)),
        (f"splice cigar ({Lq0},{Lt0},B={B})",
         lambda: spl.extend_batch(small)),
        (f"splice annotated ({Lq0},{Lt0},B={B})",
         lambda: ann.extend_batch(small, juncs=[junc] * B)),
        (f"single extz ({Lq0},{Lt0})", lambda: cig.extend(*small[0])),
        (f"single extd ({Lq0},{Lt0})",
         lambda: aligner(q2=13, e2=1, zdrop=200).extend(*small[0])),
        (f"single exts ({Lq0},{Lt0})", lambda: spl.extend(*small[0])),
        (f"extf batch ({Lq0},{Lt0},B={B})",
         lambda: extf_batch_device(Q, T, ql, tl, a, b, e, device=device)),
        (f"extf single ({Lq0},{Lt0})",
         lambda: extf2_device(*small[0], a, b, e, device=device)),
        (f"gg2 batch ({Lq0},{Lt0},B={B})",
         lambda: gg2_batch_align(Q, T, ql, tl, 5, mat, q, e,
                                 device=device)),
        (f"gg2 single ({Lq0},{Lt0})", lambda: cig.global_align(*small[0])),
        (f"local ({Lq0},{Lt0},B={B})",
         lambda: local_batch_device(Q, T, ql, tl, 5, mat, q, e,
                                    device=device)),
    ]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="self-test the 5 core shapes, one-piece scores "
                         "only on each")
    ap.add_argument("--scores", default="2,4,4,2",
                    help="A,B,O,E simple costs of the self-test [2,4,4,2]")
    args = ap.parse_args(argv)

    import torch

    from . import _build
    from .utils.stats import format_stats

    if not torch.cuda.is_available():
        raise RuntimeError("precompile warms the kernels on a CUDA card, "
                           "and torch.cuda.is_available() is false")
    t_start = time.time()
    path = _build.build()
    _build.library()
    print(f"  library {path.name}: built and loaded in "
          f"{time.time() - t_start:.1f}s", file=sys.stderr)
    warm = _warmups(args, np.random.default_rng(0))
    for name, fn in warm:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        print(f"  {name}: {time.time() - t0:.2f}s", file=sys.stderr)
    print(format_stats(), file=sys.stderr)
    print(f"warmed {len(warm)} launches in {time.time() - t_start:.0f}s; "
          f"the kernel library is built", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
