#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ksw2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds the kernels from ``ksw2_tpu_torch/csrc`` (one
   compiler per source, all at once);
3. kernel A (strips forward) against its plain PyTorch version on the
   card, one- and two-piece, score and with bytes, default and swapped
   two-piece costs: D, Dq, hl, the 9-field records and the direction
   bytes, exactly;
4. kernel B (strips walker) against its plain version on 3-state and
   7-bit bytes: end cells and runs;
5. the rows kernel against its plain version and against kernel A's
   streams on the same short-pair launches;
6. the main path through ``Aligner.extend_batch(_async)``, one path at a
   time with the launch counters set to 0 just before it and read just
   after: one-piece (extz) scores and CIGARs on the seeded mixed
   workload (seed 777, A2 B4 O4 E2, z100), two-piece (extd, O4,13 E2,1)
   scores and CIGARs on the same workload, and short-pair scores on a
   second seeded workload (seed 778, q and t <= 128) that takes the rows
   route.  Each reference anchor is asserted, each path must have
   launched its kernels, and sampled pairs are held against the port's
   plain CPU route;
7. times: every kernel and its plain version at main-path shapes (CUDA
   events), and the main paths' walls and Gcells/s.

It exits non-zero, before any result line, when there is no CUDA card or
any phase fails.  The last line is the ``{"ok": true, ...}`` record.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# reference-binary anchors of the seeded mixed workload (bench/
# regen_checksums.py): extz2_sse / extd2_sse -s -z100 sums of max, and
# -z100 (sum of max, CIGAR runs)
MIXED_SCORE = 165978
WHALE_CIGAR = (32960, 5953)
SHORT_CIGAR = (133018, 23643)
MIXED_EXTD_SCORE = 166480
WHALE_EXTD_CIGAR = (33093, 5889)
# sum of max of short_jobs() at A2 B4 O4 E2 -s -z100; tests/
# test_torch_rows.py recomputes it from the byte-parity spec
# ksw2_tpu.spec.diagdiff.extz2
SHORT_ROWS_SCORE = 25332

EXTD = (4, 2, 13, 1)          # minimap2's -O4,13 -E2,1: no swap
SWAPPED = (24, 1, 4, 2)       # swaps the pieces: off0 = -19

FWD_SRC = "ksw2_tpu_torch/csrc/strips_fwd.cu"
WALK_SRC = "ksw2_tpu_torch/csrc/strips_walk.cu"
ROWS_SRC = "ksw2_tpu_torch/csrc/rows_fwd.cu"
FWD_REPLACES = "ksw2_tpu/ops/wavefront_strips.py:110"
WALK_REPLACES = "ksw2_tpu/ops/strips_walker.py:72"
ROWS_REPLACES = "ksw2_tpu/ops/wavefront_rows.py:84"


def random_pair(rng: np.random.Generator, tlen: int, divergence: float = 0.1,
                indel: float = 0.05, with_n: bool = False):
    """A target and a mutated copy as query; the same draws as
    ``tests/refcmp.py:random_pair``, so seeds give the same pairs."""
    alpha = "ACGT" + ("N" if with_n else "")
    t = "".join(rng.choice(list("ACGT"), size=tlen))
    qchars = []
    i = 0
    while i < tlen:
        r = rng.random()
        if r < indel / 2:
            i += int(rng.integers(1, 8))
            continue
        if r < indel:
            qchars.extend(rng.choice(list(alpha), size=int(rng.integers(1, 8))))
        if rng.random() < divergence:
            qchars.append(str(rng.choice(list(alpha))))
        else:
            qchars.append(t[i])
        i += 1
    q = "".join(qchars)
    return t, (q or "A")


def mixed_jobs(seed: int = 777):
    """The seeded mixed-512 workload as (query, target) nt4 arrays
    (``bench/regen_checksums.py:mixed_jobs``)."""
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(seed)
    lens = rng.choice([150, 250, 400, 700, 1100, 1500, 3000], 512,
                      p=[.3, .25, .15, .12, .08, .06, .04])
    jobs = []
    for L in lens:
        t, q = random_pair(rng, int(L), divergence=0.15, indel=0.06)
        jobs.append((encode_dna(q), encode_dna(t)))
    return jobs


def short_jobs(seed: int = 778):
    """The seeded short-pair workload: 512 ``random_pair`` draws with
    targets uniform in 16-120 bp, 15% divergence and 6% indels, keeping
    the pairs whose query is at most 128 bp (the rows route's shape)."""
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 121, 512)
    jobs = []
    for L in lens:
        t, q = random_pair(rng, int(L), divergence=0.15, indel=0.06)
        if len(q) <= 128:
            jobs.append((encode_dna(q), encode_dna(t)))
    return jobs


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ~50 ms of GPU sleep, long enough for the host to enqueue a timed run
SLEEP_CYCLES = 10 ** 8


def cuda_ms(fn, reps: int, hide_host: bool = False) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls after one
    warm-up, by CUDA events on the current stream.  With ``hide_host``
    the stream first sleeps while the host enqueues the calls, so a
    kernel shorter than its wrapper's host work is timed on the device,
    not at the host's enqueue rate (kernels; a plain version's host work
    is part of its cost, so it is timed without)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the port's "
                           "smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def phase_build():
    from ksw2_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text() if \
        path.with_suffix(".log").exists() else ""
    usage = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": secs, "library": path.name,
          "ptxas": usage})


def _launch(pairs, flag, zdrop, cig, mat=None, costs=None):
    """One strips launch of ``pairs``: A2 B4 (or ``mat``) with O4 E2, or
    the two-piece ``costs`` (q, e, q2, e2)."""
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.strips import strips_prep

    mat = simple_mat(5, 2, -4) if mat is None else mat
    q, e, q2, e2 = (4, 2, 0, 0) if costs is None else costs
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    lns = strips_prep([q for q, _ in pairs], [t for _, t in pairs], ql, tl,
                      5, mat, q, e, zdrop, flag, cig=cig,
                      two=costs is not None, q2=q2, e2=e2)
    assert len(lns) == 1
    return lns[0]


def _generic_mat():
    m = np.array([[3, -5, -2, -6, -1],
                  [-5, 2, -6, -3, -1],
                  [-2, -6, 4, -5, -1],
                  [-6, -3, -5, 2, -1],
                  [-1, -1, -1, -1, -1]], np.int8)
    return m.reshape(-1)


def fwd_cases(jobs):
    """(name, launch) cases for kernel A: main-path shapes plus seeded
    variety samples (RIGHT, zdrop -1/30/100, GENERIC_SC, score and cig),
    one-piece, two-piece at minimap2's costs and at costs that swap."""
    from ksw2_tpu_torch.core.flags import Flag

    whale = [p for p in jobs if len(p[1]) > 2048]
    mid = [p for p in jobs if 600 < len(p[1]) <= 768]
    rng = np.random.default_rng(5)
    sample = [jobs[i] for i in rng.choice(len(jobs), 24, replace=False)]
    rng = np.random.default_rng(6)
    sample2 = [jobs[i] for i in rng.choice(len(jobs), 24, replace=False)]
    return [
        ("whale_cig_z100", _launch(whale, Flag.NONE, 100, True)),
        ("mixed700_score_z100", _launch(mid, Flag.SCORE_ONLY, 100, False)),
        ("mixed700_cig_z100", _launch(mid, Flag.NONE, 100, True)),
        ("sample_score_zm1", _launch(sample, Flag.SCORE_ONLY, -1, False)),
        ("sample_cig_right_z30", _launch(sample, Flag.RIGHT, 30, True)),
        ("sample_generic_cig_z100",
         _launch(sample, Flag.GENERIC_SC, 100, True, _generic_mat())),
        ("whale_extd_cig_z100",
         _launch(whale, Flag.NONE, 100, True, costs=EXTD)),
        ("mixed700_extd_score_z100",
         _launch(mid, Flag.SCORE_ONLY, 100, False, costs=EXTD)),
        ("mixed700_extd_cig_z100",
         _launch(mid, Flag.NONE, 100, True, costs=EXTD)),
        ("sample_extd_score_zm1",
         _launch(sample, Flag.SCORE_ONLY, -1, False, costs=EXTD)),
        ("sample_extd_cig_right_z30",
         _launch(sample, Flag.RIGHT, 30, True, costs=EXTD)),
        ("sample_swapped_score_z30",
         _launch(sample2, Flag.SCORE_ONLY, 30, False, costs=SWAPPED)),
        ("sample_swapped_cig_z100",
         _launch(sample2, Flag.NONE, 100, True, costs=SWAPPED)),
        ("sample_swapped_cig_right_zm1",
         _launch(sample2, Flag.RIGHT, -1, True, costs=SWAPPED)),
    ]


def rows_cases(short):
    """(name, launch) cases for the rows kernel: the short-pair main-path
    launch plus seeded samples (zdrop -1, GENERIC_SC)."""
    from ksw2_tpu_torch.core.flags import Flag

    rng = np.random.default_rng(7)
    sample = [short[i] for i in rng.choice(len(short), 40, replace=False)]
    return [
        ("short_score_z100", _launch(short, Flag.SCORE_ONLY, 100, False)),
        ("short_sample_score_zm1",
         _launch(sample, Flag.SCORE_ONLY, -1, False)),
        ("short_sample_generic_z30",
         _launch(sample, Flag.SCORE_ONLY | Flag.GENERIC_SC, 30, False,
                 _generic_mat())),
    ]


def _max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def phase_kernel_a(cases):
    import torch
    from ksw2_tpu_torch.ops import strips as S

    worst = 0
    out = {}
    for name, ln in cases:
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        kd = S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm)
        pd = S.strips_forward_plain(qs, ts, ql, tl, tab, ln.prm)
        torch.cuda.synchronize()
        errs = {k: _max_err(a, b)
                for k, a, b in zip(("D", "Dq", "hl"), kd[:3], pd[:3])}
        ra = S.replay_records(ln.prm, *kd[:3], ql, tl)
        rb = S.replay_records(ln.prm, *pd[:3], ql, tl)
        errs["records"] = _max_err(ra, rb)
        if ln.prm.cig:
            ii = torch.arange(ln.prm.tv, device="cuda")[None, :, None]
            jj = torch.arange(qs.shape[1], device="cuda")[None, None, :]
            live = (ii < tl[:, None, None]) & (jj < ql[:, None, None])
            diff = (kd[3].int() - pd[3].int()).abs()
            errs["d8"] = int(torch.where(live, diff, 0).max())
        worst = max(worst, *errs.values())
        out[name] = {"pairs": int(qs.shape[0]), "Lq": int(qs.shape[1]),
                     "tv": ln.prm.tv, "two": ln.prm.two,
                     "off0": ln.prm.off0, "max_abs_err": errs}
        if any(errs.values()):
            emit({"phase": "kernel_a", "case": name, "FAIL": errs})
            raise AssertionError(f"kernel A differs from plain on {name}")
    emit({"phase": "kernel_a", "max_abs_err": worst, "cases": out})
    return worst


def phase_kernel_b(cases):
    import torch
    from ksw2_tpu_torch.ops import strips as S
    from ksw2_tpu_torch.ops import strips_walker as W

    worst = 0
    out = {}
    for name, ln in cases:
        if not ln.prm.cig:
            continue
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        D, Dq, hl, d8 = S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm)
        rec = S.replay_records(ln.prm, D, Dq, hl, ql, tl)
        starts = W.start_cells(rec, ql, tl, ln.prm.flag, 0)
        kr, kruns = W.strips_walk_cuda(d8, starts)
        pr, pruns = W.strips_walk_plain(d8, starts)
        torch.cuda.synchronize()
        err = _max_err(kr, pr)
        n = kr[:, 2].cpu().numpy()
        ka, pa = kruns.cpu().numpy(), pruns.cpu().numpy()
        for b in range(len(n)):
            err = max(err, int(np.abs(ka[b, :n[b]].astype(np.int64)
                                      - pa[b, :n[b]]).max(initial=0)))
        worst = max(worst, err)
        out[name] = {"pairs": len(n), "runs": int(n.sum()),
                     "bytes": "7-bit" if ln.prm.two else "3-state",
                     "max_abs_err": err}
        if err:
            emit({"phase": "kernel_b", "case": name, "FAIL": err})
            raise AssertionError(f"kernel B differs from plain on {name}")
    emit({"phase": "kernel_b", "max_abs_err": worst, "cases": out})
    return worst


def phase_rows(cases):
    """The rows kernel against its plain version and against kernel A's
    streams on the same launch (the two routes compute one function)."""
    import torch
    from ksw2_tpu_torch.ops import rows as R
    from ksw2_tpu_torch.ops import strips as S

    worst = 0
    out = {}
    for name, ln in cases:
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        kd = R.rows_forward_cuda(qs, ts, ql, tl, tab, ln.prm)
        pd = R.rows_forward_plain(qs, ts, ql, tl, tab, ln.prm)
        ad = S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm)
        torch.cuda.synchronize()
        errs = {k: _max_err(a, b)
                for k, a, b in zip(("D", "Dq", "hl"), kd[:3], pd[:3])}
        errs["records"] = _max_err(S.replay_records(ln.prm, *kd[:3], ql, tl),
                                   S.replay_records(ln.prm, *pd[:3], ql, tl))
        errs["vs_kernel_a"] = max(_max_err(a, b)
                                  for a, b in zip(kd[:3], ad[:3]))
        worst = max(worst, *errs.values())
        out[name] = {"pairs": int(qs.shape[0]), "Lq": int(qs.shape[1]),
                     "tv": ln.prm.tv, "max_abs_err": errs}
        if any(errs.values()):
            emit({"phase": "rows", "case": name, "FAIL": errs})
            raise AssertionError(f"the rows kernel differs on {name}")
    emit({"phase": "rows", "max_abs_err": worst, "cases": out})
    return worst


def _cells(pairs):
    return sum(len(q) * len(t) for q, t in pairs)


def _timed(fn, reps=3):
    """(result of the first call, its wall, walls of ``reps`` more)."""
    t0 = time.perf_counter()
    first = fn()
    w0 = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return first, w0, walls


def _path(path, runs_spec, needs, never=()):
    """Drive one main path: the launch counters are set to 0 just before
    it and read just after.  ``runs_spec`` rows are (name, fn, pairs,
    batches, anchor, kind, aligner); kind "score" sums max, "stream"
    gives a list of per-batch sums, "cigar" gives [sum max, CIGAR ops];
    the runs with an aligner are sampled against the CPU route.
    Fails when an anchor is missed, when a kernel in ``needs`` never
    launched or one in ``never`` did.  Returns the counts, the runs and
    the (pairs, results, aligner) of the runs to sample."""
    from ksw2_tpu_torch import _build

    runs = {}
    results = {}
    _build.LAUNCHES.clear()
    for name, fn, pairs, n_batches, want, kind, aln in runs_spec:
        out, w0, walls = _timed(fn)
        if kind == "stream":
            got = out
        elif kind == "cigar":
            got = [sum(ez.max for ez in out),
                   sum(len(ez.cigar) for ez in out)]
        else:
            got = sum(ez.max for ez in out)
        if aln is not None:
            results[name] = (pairs, out, aln)
        med = float(np.median(walls))
        runs[name] = {"got": got, "anchor": want,
                      "pairs": n_batches * len(pairs), "first_wall_s": w0,
                      "walls_s": walls,
                      "gcells_per_s": n_batches * _cells(pairs) / med / 1e9,
                      "pairs_per_s": n_batches * len(pairs) / med}
    counts = dict(_build.LAUNCHES)
    emit({"phase": "main_path", "path": path, "launches": counts,
          "runs": runs})
    bad = [name for name, r in runs.items() if r["got"] != r["anchor"]]
    if bad:
        raise AssertionError(f"{path}: anchors missed: {bad}")
    for k in needs:
        if counts.get(k, 0) < 1:
            raise AssertionError(f"the {path} path never launched {k}")
    for k in never:
        if counts.get(k, 0):
            raise AssertionError(f"the {path} path launched {k}")
    return counts, runs, results


def phase_main_path(jobs, short):
    from ksw2_tpu_torch import Aligner
    from ksw2_tpu_torch.core.flags import Flag

    whale = [p for p in jobs if len(p[1]) > 2048]
    short1536 = [p for p in jobs if len(p[1]) <= 1536]
    prod = jobs * 4
    scorer = Aligner(a=2, b=4, q=4, e=2, zdrop=100, flag=Flag.SCORE_ONLY)
    cigar = Aligner(a=2, b=4, q=4, e=2, zdrop=100)
    q, e, q2, e2 = EXTD
    scorer2 = Aligner(a=2, b=4, q=q, e=e, q2=q2, e2=e2, zdrop=100,
                      flag=Flag.SCORE_ONLY)
    cigar2 = Aligner(a=2, b=4, q=q, e=e, q2=q2, e2=e2, zdrop=100)

    def stream8(aln):
        def run():
            hs = [aln.extend_batch_async(jobs) for _ in range(8)]
            return [sum(ez.max for ez in h.result()) for h in hs]
        return run

    paths = [
        ("extz", [
            ("mixed512_score", lambda: scorer.extend_batch(jobs), jobs, 1,
             MIXED_SCORE, "score", scorer),
            ("mixed2048_score", lambda: scorer.extend_batch(prod), prod, 1,
             4 * MIXED_SCORE, "score", None),
            ("stream8_mixed512_score", stream8(scorer), jobs, 8,
             [MIXED_SCORE] * 8, "stream", None),
            ("short1536_cigar", lambda: cigar.extend_batch(short1536),
             short1536, 1, list(SHORT_CIGAR), "cigar", cigar),
            ("whale_cigar", lambda: cigar.extend_batch(whale), whale, 1,
             list(WHALE_CIGAR), "cigar", cigar)],
         ("strips_fwd", "strips_walk"), ()),
        ("extd", [
            ("mixed512_extd_score", lambda: scorer2.extend_batch(jobs),
             jobs, 1, MIXED_EXTD_SCORE, "score", scorer2),
            ("stream8_mixed512_extd_score", stream8(scorer2), jobs, 8,
             [MIXED_EXTD_SCORE] * 8, "stream", None),
            ("whale_extd_cigar", lambda: cigar2.extend_batch(whale), whale,
             1, list(WHALE_EXTD_CIGAR), "cigar", cigar2)],
         ("strips_fwd", "strips_walk"), ()),
        ("rows", [
            ("short_rows_score", lambda: scorer.extend_batch(short), short,
             1, SHORT_ROWS_SCORE, "score", scorer)],
         ("rows_fwd",), ("strips_fwd",)),
    ]
    counts = {}
    runs = {}
    results = {}
    for path, spec, needs, never in paths:
        c, r, res = _path(path, spec, needs, never)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        runs[path] = r
        results.update(res)

    # sampled pairs against the port's plain CPU route (which the CPU
    # test suite holds against the JAX package and the NumPy spec)
    rng = np.random.default_rng(16)
    checked = 0
    for name, (pairs, ezs, aln) in results.items():
        cpu = Aligner(a=2, b=4, q=aln.q, e=aln.e, q2=aln.q2, e2=aln.e2,
                      zdrop=aln.zdrop, flag=aln.flag, device="cpu")
        idx = rng.choice(len(pairs), min(8, len(pairs)), replace=False)
        ref = cpu.extend_batch([pairs[i] for i in idx])
        for i, r in zip(idx, ref):
            g = ezs[i]
            a = (g.max, g.max_t, g.max_q, g.mqe, g.mqe_t, g.mte, g.mte_q,
                 g.score, g.zdropped, g.cigar)
            b = (r.max, r.max_t, r.max_q, r.mqe, r.mqe_t, r.mte, r.mte_q,
                 r.score, r.zdropped, r.cigar)
            if a != b:
                raise AssertionError(f"{name} pair {i}: GPU {a[:9]} vs "
                                     f"CPU {b[:9]}")
            checked += 1
    emit({"phase": "oracle", "pairs_checked": checked,
          "runs": sorted(results),
          "against": "Aligner(device='cpu') plain route"})
    return counts, runs


def phase_times(cases, rcases):
    import torch
    from ksw2_tpu_torch.ops import rows as R
    from ksw2_tpu_torch.ops import strips as S
    from ksw2_tpu_torch.ops import strips_walker as W

    out = {}
    for name, ln in cases:
        if name.startswith("sample"):
            continue
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        row = {"pairs": int(qs.shape[0]), "Lq": int(qs.shape[1]),
               "tv": ln.prm.tv}
        row["fwd_ms"] = cuda_ms(
            lambda: S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm), 5,
            True)
        row["fwd_plain_ms"] = cuda_ms(
            lambda: S.strips_forward_plain(qs, ts, ql, tl, tab, ln.prm), 1)
        if ln.prm.cig:
            D, Dq, hl, d8 = S.strips_forward_cuda(qs, ts, ql, tl, tab,
                                                  ln.prm)
            rec = S.replay_records(ln.prm, D, Dq, hl, ql, tl)
            starts = W.start_cells(rec, ql, tl, ln.prm.flag, 0)
            row["walk_ms"] = cuda_ms(lambda: W.strips_walk_cuda(d8, starts),
                                     5, True)
            row["walk_plain_ms"] = cuda_ms(
                lambda: W.strips_walk_plain(d8, starts), 1)
        row["cells"] = int((ql.long() * tl.long()).sum())
        row["fwd_gcells_per_s"] = row["cells"] / row["fwd_ms"] / 1e6
        out[name] = row
    for name, ln in rcases:
        if name.startswith("short_sample"):
            continue
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        row = {"pairs": int(qs.shape[0]), "Lq": int(qs.shape[1]),
               "tv": ln.prm.tv}
        row["rows_ms"] = cuda_ms(
            lambda: R.rows_forward_cuda(qs, ts, ql, tl, tab, ln.prm), 20,
            True)
        row["rows_plain_ms"] = cuda_ms(
            lambda: R.rows_forward_plain(qs, ts, ql, tl, tab, ln.prm), 1)
        row["fwd_ms"] = cuda_ms(
            lambda: S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm), 20,
            True)
        row["cells"] = int((ql.long() * tl.long()).sum())
        row["rows_gcells_per_s"] = row["cells"] / row["rows_ms"] / 1e6
        out[name] = row
    emit({"phase": "times", "cases": out})
    return out


def main() -> int:
    import torch

    import ksw2_tpu_torch  # noqa: F401  (outside a checkout: fail first)

    phase_device()
    torch.manual_seed(0)
    phase_build()
    jobs = mixed_jobs()
    short = short_jobs()
    cases = fwd_cases(jobs)
    rcases = rows_cases(short)
    err_a = phase_kernel_a(cases)
    err_b = phase_kernel_b(cases)
    err_r = phase_rows(rcases)
    counts, _ = phase_main_path(jobs, short)
    times = phase_times(cases, rcases)
    whale = times["whale_cig_z100"]
    rows = times["short_score_z100"]
    print(json.dumps({"kernels": [
        {"name": "strips_fwd", "route": "cuda", "source": FWD_SRC,
         "replaces": FWD_REPLACES, "launches": counts["strips_fwd"],
         "max_abs_err": err_a, "ms": whale["fwd_ms"],
         "plain_ms": whale["fwd_plain_ms"]},
        {"name": "strips_walk", "route": "cuda", "source": WALK_SRC,
         "replaces": WALK_REPLACES, "launches": counts["strips_walk"],
         "max_abs_err": err_b, "ms": whale["walk_ms"],
         "plain_ms": whale["walk_plain_ms"]},
        {"name": "rows_fwd", "route": "cuda", "source": ROWS_SRC,
         "replaces": ROWS_REPLACES, "launches": counts["rows_fwd"],
         "max_abs_err": err_r, "ms": rows["rows_ms"],
         "plain_ms": rows["rows_plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
