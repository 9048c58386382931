#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ksw2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line.  Phase 6 runs right after 2b; then
the kernel phases 3-5h and phase 6's check against the CPU route run
side by side in ``PHASE_WORKERS`` processes on the one card (they are
bound by the host: a plain version launches many small operations), and
their lines follow in phase order; phase 7 runs last, alone.  Each
phase's seconds go to stderr as it ends.

1. device: the card's name and power limit (nvidia-smi) and its int32
   rate (132 SMs x 64 lanes x the maximum SM clock);
2. build: nvcc builds the kernels from ``ksw2_tpu_torch/csrc`` (one
   compiler per source, all at once);
2b. operations: in child processes, ``python -m
   ksw2_tpu_torch.precompile --quick`` (builds, loads and launches each
   kernel family once, then prints the km_stat report, which must list
   kernel 18's launches and the allocator counters) and one small
   ``python -m ksw2_tpu_torch.cli --stats`` run (its stderr must show
   non-zero launches and the allocator counters);
3. kernel A (strips forward) against its plain PyTorch version on the
   card, one- and two-piece, score and with bytes, default and swapped
   two-piece costs: D, Dq, hl, the 9-field records and the direction
   bytes, exactly; also on queries at strip edges (128 k +- 1 bp), short
   pairs packed several to a block, a 4608 bp query over a cluster of 8
   blocks and the one score launch the scheduler makes of the mixed-512
   batch, one- and two-piece;
4. kernel B (strips walker, walk.cuh's row-major form) against its
   plain version on 3-state and 7-bit bytes: end cells and runs;
5. the rows kernel (kernel 3, the lane-pipelined row sweep) against its
   plain version and against kernel A's streams on the same short-pair
   launches;
5b. band: kernels C / C2 (band forward, one- and two-piece) against
   their plain version, records and direction bytes exactly, in score,
   CIG and APPROX forms with bands from 1 to 1472 on pairs of up to 900
   bp, the shortest long-banded pair cut to 2 kb, the kernel's edges
   (tiles of 32 and 64 positions, targets around a tile edge, a Z-drop,
   the H0 walk across tiles) and one merged launch of several buckets,
   and kernel D (band walker) against its plain version on the kernels'
   bytes;
5c. batch: kernels E / E2 (batched forward, one- and two-piece) against
   their plain version, records and direction bytes exactly, in both
   forms: the wide form (band_fwd.cu's block a pair) on launches of
   w 0, 1, 16, 100 and unbanded pairs on targets up to 1700 (P = 1-14
   rows a pair on the TPU) and at its layout's edges (ncol 1552 CIGARs,
   the tile switch at ncol 1600 / 1616, 3072-bp score targets, m 12
   and 20), and the register form (one warp a pair, a window of
   128 or 256 positions in registers) at w 16 and 100 and at its
   windows' edges (w 63, 64, 191), on long pairs whose window slides
   dozens of times and on a sweep of Z-drops over every diagonal of a
   group; score, CIG and APPROX, zdrop -1/20/100, RIGHT, GENERIC_SC,
   default and swapped two-piece costs; and at every launch shape of the
   main path: the one launch a form of the short-banded workload and the
   wide form's merged EQX CIGAR and end_bonus score launches (below);
   kernel D on their bytes;
5d. splice: kernel A's spl form (score and CIG) with kernel B's nop
   form on its bytes, and kernel 6 (batched exts forward, one warp a
   pair; score, CIG and APPROX) with kernel D walking its bytes with
   min_intron, against their plain versions exactly, on seeded spliced
   pairs of 30-900 bp (RIGHT, SPLICE_REV, FLANK, GENERIC_SC, junction
   tracks), on queries at strip edges and on the one launch of each form
   the scheduler makes of the splice workload and of splice-wide
   (below: the kernel on the whole launch, the plain versions on
   ``SPLICE_WIDE_PLAIN_PAIRS`` of its pairs); kernel 6 in both its forms
   on every one of its launches (the register form where the launch
   takes it, the wide form, band_fwd.cu's block a pair, always), at
   ncol 208 / 224 and at its window's edge (shorter sides of 192, 193,
   448 and 449 bp), on a pair whose window slides ~40 times and on pairs
   that Z-drop on and between group edges;
5e. single: kernel 12 (single-pair forward, tiles of 32 positions:
   pairs of 30-1500 bp over 1-48 tiles; score, CIG and APPROX forms,
   w -1, 0, 1, 16, 751 and 2000, zdrop -1/100, RIGHT, GENERIC_SC,
   EXTZ_ONLY with end_bonus; the hand-off pairs at tiles of 32 and 64
   positions: diagonals ending on a hand-off group and one past it, targets
   shorter than a tile, tiles starting mid-group, the H0 walk across
   tiles) against its plain version, records, stops and direction bytes
   exactly, and kernel 17 (single-pair walker) on its bytes
   (upper_force 1 and 0, min_intron 0 and 5), also on the launch the
   scheduler makes of the sr-extension workload (below);
5f. single2: kernels 13 and 14, and 17 on their bytes, the hand-off
   pairs too, and kernel 14 on one launch of mixed lengths;
5g. linear_global: kernels 7 and 15 (batched and single-pair extf)
   against their plain version's records, kernels 8 and 16 (batched and
   single-pair gg2) against theirs (without and with the reference's
   u/v/x/y/s block overrun) on scores and every byte of the flat store,
   kernels 15 and 16 at tiles of 32 and 64 positions, and band_walk's
   flat form on the kernels' bytes, exactly: seeded pairs of 30-1500 bp,
   banded and unbanded, xdrop -1 and 40, two pairs with qlen > tlen + w,
   the first 64 pairs of each launch of the CLI path (below) and the
   tiled kernels' edge cases (X-drops at diagonal 1 and at tile edges,
   first empty bands before the last diagonal, gg2 walks that run off u,
   an empty query);
5h. local: kernel 18 (batched local alignment, one warp a pair) against
   its plain version, (score, te, qe) exactly, on the JAX bench's local
   set, local-mixed and edge pairs (empty, all-N, all-mismatch, tied
   maxima, targets of 128, queries of 129-512 bp), at A2 B4 q4 e2 and
   on a generic matrix, and on the edge pairs with the first 256 of
   local-mixed at gap opens q in {-2, 0, 4, 11} and e in {0, 1, 2};
5i. walk: kernels 17, D and B (the walkers, a block of two warps a pair
   over windows of the store staged in shared memory) against their
   plain versions, exactly, at the main path's launch shapes that
   phases 4-5g leave out (the 50 kb pair's one- and two-piece compact
   stores, the MT pair's, splice-long's 4 launches with min_intron, the
   long-banded CIGAR launches' rotated bytes, the MT pair's flat store)
   and on random bytes (walks across hundreds of windows, starts at the
   windows' edges, min_intron, upper_force 0, flat overruns, row-major
   stores, launches of 1 to 4096 pairs);
5j. mesh (in the pool): the port's ``parallel/`` on a mesh of 4 logical
   shards of cuda:0 (every card when there are more), each case twice,
   the launch counters set to 0 before its first run and read after it
   (the case's kernels at least once a shard, the halo's exactly once a
   shard and a round, no other kernel): the mixed-512 scores through
   ``make_sharded_run_fn`` and
   ``extend_batch(mesh=)`` (``MIXED_SCORE``), its CIGARs through
   ``extend_batch(mesh=)`` (targets on both sides of 1536), the whale
   through ``sharded_strips_cigar`` (``WHALE_CIGAR``), the short-banded
   4096 through kernels E, E2 and ``sharded_extz_align``
   (``BATCH_PINS``), the 1024 annotated splice pairs through kernel 6,
   the CLI's batched extf pairs through kernel 7 and the 50 kb pair
   through ``halo_extz_score`` (``SINGLE_PINS["single_score"]`` and
   kernel 12's 9 fields), each run equal to the other and to the port's
   unsharded route on the same input (``Aligner.extend_batch``,
   ``extf_batch_device``, kernel 12), whose walls stand beside the
   mesh's; the halo kernel (``csrc/halo_fwd.cu``) against its
   plain twin on the 50 kb pair's 2 kb cut, every state plane and package
   exactly; two processes of ``python -m ksw2_tpu_torch.parallel.dryrun``
   with gloo on the card, their checksums equal;
6. the main path through ``Aligner.extend_batch(_async)``, one path at a
   time with the launch counters set to 0 just before it and read just
   after: one-piece (extz) scores and CIGARs on the seeded mixed
   workload (seed 777, A2 B4 O4 E2, z100), two-piece (extd, O4,13 E2,1)
   scores and CIGARs on the same workload (a score batch launches kernel
   A once, its strips buckets merged; a CIGAR batch once a bucket:
   asserted against the planner), short-pair scores on a second
   seeded workload (seed 778, q and t <= 128) that takes the rows route,
   the band route on the seeded long-banded workload (seed 779, 128
   pairs of 4-16 kb at -w751 -z400: extz, extd and approx scores, extz
   and extd CIGARs; no strips kernel may launch; a batch's band buckets
   go out as one score launch and ceil(bytes / LAUNCH_BYTES) CIGAR
   launches, asserted against the planner), the mixed workload
   at -w751 (strips and band in one batch) and the batched route on the
   seeded short-banded workload (seed 780, 4096 pairs of 150-512 bp at
   -w100 -z100: extz, extd and approx scores, extz and extd CIGARs; EQX
   CIGARs and two-piece end_bonus scores on the mixed workload's pairs
   of 1536 bp or less; only kernels E, E2 and D may launch; a batch's
   register-form buckets go out as one launch: one score launch a
   short-banded batch and ceil(bytes / LAUNCH_BYTES) CIGAR launches,
   asserted against the planner), and the
   splice path on the JAX bench's spliced workload (seed 1234, 256 pairs
   of 290 x 512 bp with a GT..AG intron, tiled 4x; minimap2 -x splice
   costs A1 B2 -O2,32 -E1,0 -C9 -z200): CIGARs, scores and 4 async
   handles on the strips route (only kernels A and B may launch), and
   the same pairs annotated (a junction track at the intron, junc_bonus
   9) on the batched exts route (only kernels 6 and D); splice-wide
   (seed 788, 256 annotated reads of 871 bp, exons t[120:600] and
   t[1049:1440] of 1536 bp windows, GT..AG at 600 / 1047, the junction
   track at 600 / 1048, junc_bonus 9: CIGARs and scores, every bucket
   asserted to take kernel 6's wide form at ncol 896; only kernels 6 and
   D, pins ``SPLICE_WIDE_PINS``); the single-pair
   engine (only kernels 12 and 17): a seeded 50 kb pair (seed 781)
   through ``Aligner.extend`` (exact score, ``-sg``, CIGAR) and
   ``extend_batch`` (scores, the any-device route), a seeded pair of the
   MT length (seed 782, 16,569 bp; CIGAR and EXTZ_ONLY CIGAR at -z100)
   and sr-extension: the short-banded workload as EXTZ_ONLY CIGARs at
   -w100 -z100 --end-bonus 10 (minimap2 -x sr's extension call); the
   paths of kernels 13 and 14 (single_extd, sr_extension_extd,
   splice_ends, splice_long); the single-pair paths launch each kernel
   once for each ``LAUNCH_BYTES`` of a batch's buffers, whatever its
   buckets (asserted for sr_extension(_extd), splice_ends and
   splice_long: one score launch a batch, CIGARs in
   ceil(bytes / LAUNCH_BYTES)); and the
   paths of kernels 7, 8, 15 and 16 (pins ``LG_PINS``, only those four
   and band_walk may launch): "single_extf" (the 50 kb pair through
   ``extf2_device`` at A2 B4 E2, xdrop -1), "single_gg2_mt" (the MT pair
   through ``Aligner.global_align``) and "cli_batch" (the mixed workload
   as FASTA through ``cli.main(["--backend", "batch", ...])`` at -t
   gg2_sse -w 100 and -t extf2_sse -z 40); and the local paths through
   ``local_batch_device`` at A2 B4 q4 e2 (only kernel 18 may launch):
   "local_512" (the JAX bench's local_batch_512x128 row, seed 99, its
   anchor (97230, 129138)), "local_64k" (that set tiled 128x, 65,536
   pairs, the anchor x128) and "local_mixed" (seed 784, 4096 targets of
   8-128 bp in queries of 8-512 bp; pin ``LOCAL_MIXED_PIN``).  Each
   anchor or spec pin is asserted,
   each path must have launched its kernels, and sampled pairs are held
   against the port's plain CPU route;
7. times: every kernel and its plain version at main-path shapes (CUDA
   events; the batched kernels on the main path's own launches of the
   short-banded workload, kernels 12 and 17 on the 50 kb pair, the MT
   pair and the sr-extension launch, with microseconds a diagonal on the
   long pairs) beside its bound, the main paths' walls
   and Gcells/s (band cells on the band and batched routes), kernel 18
   on each local set beside its bound and plain time (held to the plain
   version exactly on local-64k, which phase 5h leaves out), and a
   profile of the long-banded, short-banded, splice, sr-extension,
   mixed-512 / mixed-2048 score, whale CIGAR and local-64k batches with
   the device's idle share;
7b. mesh times, alone: the halo kernel's round against its plain twin on
   the 50 kb pair's widest block of 256 diagonals (one shard) beside its
   bound, the pair's halo at 1 and 4 logical shards beside its bound,
   and ``scaling_efficiency`` on 4 logical shards.

It exits non-zero, before any result line, when there is no CUDA card or
any phase fails.  The last line is the ``{"ok": true, ...}`` record.

    python3 chip_smoke.py --breakdown [extz|band|lg|strips|walk|batch|exts|
                                       local|gg2|extf|rows]
    python3 chip_smoke.py --lg-times
    python3 chip_smoke.py --strips-times
    python3 chip_smoke.py --walk-times
    python3 chip_smoke.py --batch-times
    python3 chip_smoke.py --rows-times
    python3 chip_smoke.py --exts-times
    python3 chip_smoke.py --local-times
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --sass-diff PARENT

print clock64 breakdowns of a tile-diagonal of kernels 12-14, 9-10 and
15-16, of a strip-row of kernel A, of a step of kernels 17, D and B
(its wait for a staged window, asking for one, the rest; a block's
loads, steps and hand-over; the stager's copies a window), of a
diagonal of kernels E / E2's register form (head, cells, argmax,
store; a group's replay and staging) and of a tile-diagonal of their
wide form (the band kernel's parts), phase
7's times of kernels 7, 8, 15 and 16 alone (which also run on a tree
before the tiled kernels 15 and 16, to compare two trees in one call),
phase 7's times of kernel A alone (which also run on a tree whose
kernel A takes no layout), and the times of kernels 17, D and B alone
at every launch shape of the main path (``WALK_CASES``; they also run
on the tree before the windowed walkers), and the times of kernels E /
E2 alone at the main path's launch shapes (``BATCH_TIME_CASES``) with
kernels 9 / 10 on the long-banded score launch (they also run on the
tree before the register form or the wide form's redesign), the rows
kernel and kernel A alone on the short pairs' launch, kernel 6 alone on
the annotated splice launches and splice-wide's in the form each takes
and in the wide form, with the band walker on its bytes (and E / E2's
register form), kernel 18 alone on each local set (all three also run
on the parent's tree), phases 5j and 7b alone (``--mesh``), cycles of
kernel 6's two forms (a tile-diagonal
of the wide form, a diagonal of the register form), a query row of
kernel 18, a step of the rows kernel and a diagonal of kernels 8 and
7's two forms (strip: head, chunk steps, walk; register:
head, score fill, cells, walk, staging, replay) on the CLI run's batched
launches by part, and the SASS of E / E2's and kernel 6's register form and of the band
forward's kernel (9 / 10, the wide forms) against a parent tree's
library.  ``--sass-diff`` is a developer's check of a change to
``csrc/batch_fwd.cu``, ``csrc/band_fwd.cu`` or ``csrc/reg_window.cuh``:
PARENT is
a checkout of the parent commit (an unpacked ``git archive`` inside
this one, in a folder ``.gitignore`` lists) whose own run built its
library first.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import io
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

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

BAND_W = 751                  # minimap2's -r / the bench band row's -w751
LONG_PREFIX, MIXED_PREFIX = 4, 64
# the band route's pins, computed with the byte-parity spec
# ksw2_tpu.spec.diagdiff.extz2 / extd2 at w = 751 (no reference-binary
# anchors of a long banded workload exist in the tree): name -> (the
# whole workload's, the first LONG_PREFIX long-banded or MIXED_PREFIX
# mixed pairs'); sums of max for scores, (sum of max, CIGAR ops) for
# CIGARs.  tests/test_torch_band_pins.py recomputes them.
BAND_PINS = {
    "long_score": (800036, 20158),
    "long_extd_score": (802266, 20215),
    "long_approx_score": (800020, 20158),
    "long_cigar": ((800036, 145681), (20158, 3791)),
    "long_extd_cigar": ((802266, 144653), (20215, 3755)),
    "mixed751_score": (165978, 20406),
    "mixed751_cigar": ((165978, 29596), (20406, 3560)),
}

SHORT_BANDED_W = 100          # minimap2 -x sr's -r100
SHORT_BANDED_PREFIX = 64
# the batched route's pins on short_banded_jobs() at w = 100, z100,
# computed with the byte-parity spec ksw2_tpu.spec.diagdiff.extz2 / extd2:
# name -> (the whole workload's, the first SHORT_BANDED_PREFIX pairs');
# sums of max for scores, (sum of max, CIGAR ops) for CIGARs.
# tests/test_torch_batch_pins.py recomputes them.
BATCH_PINS = {
    "short_banded_score": (891388, 13632),
    "short_banded_extd_score": (893688, 13675),
    "short_banded_approx_score": (890466, 13622),
    "short_banded_cigar": ((891388, 160448), (13632, 2451)),
    "short_banded_extd_cigar": ((893688, 159256), (13675, 2429)),
}
END_BONUS = 10

# the spliced workload (splice_jobs(), the JAX bench's 256 pairs tiled 4x)
# at minimap2 -x splice costs: A1 B2 -O2,32 -E1,0 -C9 -z200, SPLICE_FOR
SPLICE = (2, 1, 32, 9)        # q, e, q2 (intron open), noncan
SPLICE_ZDROP = 200
SPLICE_TILES = 4
# (sum of max, CIGAR ops) of the 256 pairs: the spec exts2 checksum that
# bench/regen_checksums.py holds (the spec is byte-validated against the
# reference binary)
SPLICE_ANCHOR = (47059, 1431)
SPLICE_JUNC_BONUS = 9         # minimap2's --junc-bonus
SPLICE_PREFIX = 16
# the annotated run's pins (each pair with splice_junc(), junc_bonus 9),
# computed with the spec exts2: name -> (the 256 pairs', the first
# SPLICE_PREFIX pairs'); tests/test_torch_splice_pins.py recomputes them
SPLICE_PINS = {
    "splice_junc_cigar": ((51667, 1431), (3202, 87)),
    "splice_junc_score": (51667, 3202),
}

# splice-wide (splice_wide_jobs): 256 annotated reads of 871 bp with
# exons of several hundred bases against 1536 bp windows, at -x splice
# costs with junc_bonus 9: every bucket takes kernel 6 at ncol 896
SPLICE_WIDE_SEED, SPLICE_WIDE_N, SPLICE_WIDE_NCOL = 788, 256, 896
# its pins, computed with the spec exts2: name -> (the 256 pairs', the
# first SPLICE_PREFIX pairs'); tests/test_torch_splice_pins.py recomputes
# the prefixes
SPLICE_WIDE_PINS = {
    "splice_wide_junc_cigar": ((178118, 1693), (11111, 107)),
    "splice_wide_junc_score": (178118, 11111),
}
# pairs of a splice-wide launch phase 5d holds to the plain forward and
# walker, spread over the launch (its pairs share one shape)
SPLICE_WIDE_PLAIN_PAIRS = 8

# the single-pair engine's workloads (the JAX bench's extz rows,
# bench/suite.py:130-193, on seeded pairs: its 50 kb and MT files are not
# in the tree): one 50 kb pair unbanded, one pair of the MT length
# (16,569 bp) at -z100, and the short-banded workload as minimap2 -x sr's
# extension call, EXTZ_ONLY CIGARs at -r100 --end-bonus 10 -z100
SINGLE_SEED, SINGLE_LEN = 781, 50000
MT_SEED, MT_LEN, MT_PREFIX = 782, 16569, 2000
SR_PREFIX = 64
# their pins, computed with the byte-parity spec ksw2_tpu.spec.diagdiff.
# extz2 at A2 B4 O4 E2: (max, max_t, max_q, score, zdropped) for scores;
# CIGARs add (reach_end, CIGAR ops, cigar_hash); single-mt pins are (the
# whole pair's, its first MT_PREFIX bp's); sr_extension (sum of max, sum
# of score, pairs that reach the end, CIGAR ops) over the 4096 pairs and
# the first SR_PREFIX.  tests/test_torch_extz_pins.py recomputes them.
SINGLE_PINS = {
    "single_score": (31128, 49979, 50134, 31106, 0),
    "single_sg": (31128, 49979, 50134, 31106, 0),
    "single_cigar": (31128, 49979, 50134, 31106, 0, 0, 5973,
                     "4bb9d5fe8cca8af3"),
    "single_mt_cigar": ((11298, 16561, 16650, 11282, 0, 0, 1877,
                         "b729f92d22fccd63"),
                        (1290, 1982, 1952, 1220, 0, 0, 257,
                         "b9c8d4968c448d4a")),
    "single_mt_extz_cigar": ((11298, 16561, 16650, 11282, 0, 0, 1873,
                              "3faf0a964ab4e45f"),
                             (1290, 1982, 1952, 1220, 0, 0, 247,
                              "6c176dae2f8e2c34")),
    "sr_extension": ((891388, 862006, 3166, 152676), (13632, 13216, 52, 2355)),
}

# the single-pair two-piece and splice engines' workloads (kernels 13 and
# 14): the JAX bench's extd_50k_exact_score row (bench/suite.py:139-177)
# on the seeded 50 kb pair at A2 B4 -O4,13 -E2,1 (exact score, -sg,
# CIGAR); minimap2 -x sr's extension call on the short-banded workload
# (-A2 -B8 -O12,24 -E2,1 -r100 --end-bonus 10 -z100, EXTZ_ONLY CIGARs and
# scores); minimap2 -x splice's end extensions on the splice workload
# (EXTZ_ONLY for the right end, EXTZ_ONLY|RIGHT|REV_CIGAR for the left)
# and 64 seeded spliced pairs of 2-12 kb, each annotated at its own intron
# (--junc-bonus 9)
SR_EXTD_MAT = (2, 8)          # -A2 -B8
SR_EXTD = (12, 2, 24, 1)      # -O12,24 -E2,1
SINGLE2_PREFIX = 2000
SPLICE_ENDS_PREFIX = 64
SPLICE_LONG_SEED, SPLICE_LONG_N = 783, 64
SPLICE_LONG_T = (2048, 12288)
SPLICE_LONG_CUT, SPLICE_LONG_PREFIX = 2048, 16
# their pins, computed with the byte-parity spec ksw2_tpu.spec.diagdiff.
# extd2 / exts2: single_extd_* (single_pin of the 50 kb pair, of its first
# SINGLE2_PREFIX bp); sr_extd_* (sr_pin of the 4096 pairs, of the first
# SR_PREFIX); splice_ends_* (sr_pin of the 256 splice pairs, of the first
# SPLICE_ENDS_PREFIX); splice_long_* (sr_pin of the 64 pairs, of the
# first SPLICE_LONG_PREFIX cut to SPLICE_LONG_CUT bp).
# tests/test_torch_single2_pins.py
# recomputes them.
SINGLE2_PINS = {
    "single_extd_score": ((31236, 49979, 50134, 31214, 0),
                          (969, 1981, 1997, 935, 0)),
    "single_extd_sg": ((31236, 49979, 50134, 31214, 0),
                       (969, 1981, 1997, 935, 0)),
    "single_extd_cigar": ((31236, 49979, 50134, 31214, 0, 0, 5911,
                           "68dea1b121b48922"),
                          (969, 1981, 1997, 935, 0, 0, 290,
                           "116cce44c5942a68")),
    "sr_extd_cigar": ((171891, -2725156727963, 227, 30461),
                      (2818, -41875930863, 2, 456)),
    "sr_extd_score": ((171891, -2725156727963, 0, 0),
                      (2818, -41875930863, 0, 0)),
    "splice_ends_cigar": ((47059, 38363, 0, 1032), (11648, 9475, 0, 256)),
    "splice_ends_left_cigar": ((43603, 34907, 0, 1457),
                               (10790, 8617, 0, 339)),
    "splice_long_cigar": ((289991, 289983, 0, 302),
                          (19723, -12884896811, 0, 226)),
    "splice_long_score": ((289991, 289983, 0, 0),
                          (19723, -12884896811, 0, 0)),
}

# the linear-gap and global engines' workloads (kernels 7, 8, 15 and 16):
# the JAX bench's extf_50k_score row (bench/suite.py:197-201: the seeded
# 50 kb pair at A2 B4 E2, xdrop -1, unbanded, through extf2_device), its
# gg2_mt_cigar row (bench/suite.py:203-209: the seeded MT-length pair at
# A2 B4 O4 E2, unbanded, through Aligner.global_align) and the ksw2-test
# CLI on the mixed-512 workload written as FASTA (--backend batch, -t
# gg2_sse -w 100 and -t extf2_sse -z 40: pairs of targets up to 1024
# take kernels 7 and 8, the rest kernels 15 and 16)
LG_PREFIX = 2000
CLI_BATCH_PREFIX = 16
CLI_BATCH_ARGS = {"cli_batch_gg2": ["-t", "gg2_sse", "-w", "100"],
                  "cli_batch_extf": ["-t", "extf2_sse", "-z", "40"]}
# the TSV column a CLI pin sums: gg2's score, and extf's max (at -z 40
# every extf pair X-drops, and an X-dropped pair's score is NEG_INF)
CLI_PIN_COL = {"cli_batch_gg2": 2, "cli_batch_extf": 3}
# their pins, computed with the byte-parity spec (ksw2_tpu.spec.diagdiff
# extf2 / gg2_sse, and the JAX CLI's --backend spec for the CLI runs):
# single_extf (max, max_t, max_q, score, zdropped) of the 50 kb pair and
# of its first LG_PREFIX bp; single_gg2_mt (score, CIGAR ops, cigar_hash)
# of the MT pair and of its first LG_PREFIX bp; cli_batch_* (the sum of
# the TSV column CLI_PIN_COL, the first 16 hex digits of the SHA-256 of
# the TSV) of the 512 pairs and of the first CLI_BATCH_PREFIX.
# tests/test_torch_linear_global_pins.py recomputes them.
LG_PINS = {
    "single_extf": ((45594, 49999, 50142, 45594, 0),
                    (1576, 1999, 1999, 1576, 0)),
    "single_gg2_mt": ((11282, 1877, "b729f92d22fccd63"),
                      (1220, 257, "b9c8d4968c448d4a")),
    "cli_batch_gg2": ((162416, "3a8803206ef60436"),
                      (5584, "2dd92cbc5054134e")),
    "cli_batch_extf": ((6296, "ea7d6baa9402b8cc"),
                       (202, "e46ba17769c358ec")),
}

# the local path's sets (kernel 18): the JAX bench's local_batch_512x128
# row (bench/suite.py:812-833: seed 99, 512 pairs of 128 x 128, 12%
# substitutions, A2 B4 q4 e2) with its anchor (sum of score, sum of te +
# qe); the same set tiled LOCAL_TILES times; and local-mixed (seed 784,
# 4096 pairs, targets 8-128 bp in queries of 8-512 bp)
LOCAL_SEED, LOCAL_TILES = 99, 128
LOCAL_MIXED_SEED = 784
LOCAL_COSTS = (2, 4, 4, 2)    # A, B, q, e
LOCAL_ANCHOR = (97230, 129138)
# local-mixed's pin (local_pin of the 4096 pairs), computed with the JAX
# package's local_batch_device; tests/test_torch_local.py recomputes it
LOCAL_MIXED_PIN = (140064, 840715)

EXTD = (4, 2, 13, 1)          # minimap2's -O4,13 -E2,1: no swap
SWAPPED = (24, 1, 4, 2)       # swaps the pieces: off0 = -19

FWD_SRC = "ksw2_tpu_torch/csrc/strips_fwd.cu"
WALK_SRC = "ksw2_tpu_torch/csrc/strips_walk.cu"
ROWS_SRC = "ksw2_tpu_torch/csrc/rows_fwd.cu"
BAND_SRC = "ksw2_tpu_torch/csrc/band_fwd.cu"
BAND_WALK_SRC = "ksw2_tpu_torch/csrc/band_walk.cu"
BATCH_SRC = "ksw2_tpu_torch/csrc/batch_fwd.cu"
FWD_REPLACES = "ksw2_tpu/ops/wavefront_strips.py:110"
WALK_REPLACES = "ksw2_tpu/ops/strips_walker.py:72"
ROWS_REPLACES = "ksw2_tpu/ops/wavefront_rows.py:84"
BAND_REPLACES = "ksw2_tpu/ops/wavefront_band.py:93"
BAND_EXTD_REPLACES = "ksw2_tpu/ops/wavefront_band_extd.py:60"
BAND_WALK_REPLACES = "ksw2_tpu/ops/traceback_band.py:56"
BATCH_REPLACES = "ksw2_tpu/ops/wavefront_batch.py:108"
BATCH_EXTD_REPLACES = "ksw2_tpu/ops/wavefront_batch_extd.py:56"
# kernel 6 runs the 1024 annotated pairs in its register form
# (batch_fwd.cu, SPL), the line's row; its wide form (band_fwd.cu, SPL)
# takes splice-wide and every launch past ncol 464
BATCH_EXTS_SRC = "ksw2_tpu_torch/csrc/batch_fwd.cu"
BATCH_EXTS_REPLACES = "ksw2_tpu/ops/wavefront_batch_exts.py:55"
EXTZ_SRC = "ksw2_tpu_torch/csrc/extz_fwd.cu"
EXTZ_WALK_SRC = "ksw2_tpu_torch/csrc/extz_walk.cu"
EXTZ_REPLACES = "ksw2_tpu/ops/wavefront.py:175"
EXTD_REPLACES = "ksw2_tpu/ops/wavefront_extd.py:68"
EXTS_REPLACES = "ksw2_tpu/ops/wavefront_exts.py:54"
EXTZ_WALK_REPLACES = "ksw2_tpu/ops/traceback_device.py:50"
EXTF_SRC = "ksw2_tpu_torch/csrc/batch_extf_fwd.cu"
GG2_SRC = "ksw2_tpu_torch/csrc/gg2_fwd.cu"
LG_SRC = "ksw2_tpu_torch/csrc/lg_fwd.cu"
BATCH_EXTF_REPLACES = "ksw2_tpu/ops/wavefront_batch_extf.py:42"
EXTF_REPLACES = "ksw2_tpu/ops/wavefront_extf.py:41"
BATCH_GG2_REPLACES = "ksw2_tpu/ops/wavefront_batch_gg2.py:42"
GG2_REPLACES = "ksw2_tpu/ops/wavefront_gg2.py:50"
LOCAL_SRC = "ksw2_tpu_torch/csrc/batch_local.cu"
LOCAL_REPLACES = "ksw2_tpu/ops/batch_local.py:49"

# integer operations per cell (per step for the walkers) that the
# function needs: one cell's update of the recurrence and its share of
# the argmax (OPS), and, only where a forward writes direction bytes, the
# cell's byte (BYTE_OPS: a code's compare and select 2, a bit's compare,
# shift and or 3, the store 1); not a kernel's own overhead (its score
# fill, neighbour shuffles or state loads).  The bound of a kernel is the
# larger of ops / the card's int32 rate and bytes / HBM rate.  The band
# and batched forwards compute the same anti-diagonal recurrence (one
# plain version serves both), so they share one count a cell.
OPS = {"strips_fwd": 22, "strips_walk": 15, "rows_fwd": 25,
       "band_fwd": 34, "band_extd_fwd": 44, "band_walk": 20}
# codes 1-2 and bits 0x08 / 0x10 one-piece; codes 1-4 and four bits
# two-piece
BYTE_OPS = {"strips_fwd": 2 * 2 + 2 * 3 + 1, "band_fwd": 2 * 2 + 2 * 3 + 1,
            "band_extd_fwd": 4 * 2 + 4 * 3 + 1}
OPS["batch_fwd"], OPS["batch_extd_fwd"] = OPS["band_fwd"], OPS["band_extd_fwd"]
BYTE_OPS["batch_fwd"] = BYTE_OPS["band_fwd"]
BYTE_OPS["batch_extd_fwd"] = BYTE_OPS["band_extd_fwd"]
# splice: strips_fwd's less the clamp (1) plus the intron state: cand3 =
# NI + acceptor and its max into H (2), NI' = max(NI, H + donor - q2)
# (3); the exts diagonals: band_fwd's plus the intron delta: a2 = x2 + v
# and a2 + acceptor (2), its max into z (1), a2' = a2 - (z - q2) (2),
# x2' = max(a2', donor) - q2 (2).  Their bytes add code 3 and bit 0x20.
OPS["strips_spl_fwd"] = OPS["strips_fwd"] - 1 + 5
OPS["batch_exts_fwd"] = OPS["band_fwd"] + 7
BYTE_OPS["strips_spl_fwd"] = BYTE_OPS["strips_fwd"] + 2 + 3
BYTE_OPS["batch_exts_fwd"] = BYTE_OPS["band_fwd"] + 2 + 3
# the single-pair forward and walker compute the band route's recurrence
# and walk
OPS["extz_fwd"], BYTE_OPS["extz_fwd"] = OPS["band_fwd"], BYTE_OPS["band_fwd"]
OPS["extz_walk"] = OPS["band_walk"]
# ... and in its two-piece and splice forms the band route's two-piece and
# the batched exts recurrences
OPS["extd_fwd"] = OPS["band_extd_fwd"]
BYTE_OPS["extd_fwd"] = BYTE_OPS["band_extd_fwd"]
OPS["exts_fwd"] = OPS["batch_exts_fwd"]
BYTE_OPS["exts_fwd"] = BYTE_OPS["batch_exts_fwd"]
# linear gap (extf2): the score byte's compare and select (2), z = s +
# 2e (1), the signed max with v[t - 1] (1), the unsigned max with u[t]
# (1), u' = z - v[t - 1] and v' = z - u[t] (2); no argmax, no bytes
OPS["batch_extf_fwd"] = OPS["extf_fwd"] = 7
# global (gg2_sse): the matrix gather (1), zz = s + 2(q + e) (1), a = x +
# v and b = y + u (2), z = max(zz, a) (1), the unsigned max with b (1),
# u' and v' (2), z2 = z - q (1), a - z2 and b - z2 (2), x' and y' clamped
# at 0 (2); the byte as band_fwd's (the compares and selects of codes 1-2,
# bits 0x08 / 0x10, the store), counted there and not here
OPS["batch_gg2_fwd"] = OPS["gg2_fwd"] = 13
BYTE_OPS["batch_gg2_fwd"] = BYTE_OPS["gg2_fwd"] = BYTE_OPS["band_fwd"]
# local (Smith-Waterman, kernel 18): the score, a gather from the m x m
# table of its match, mismatch and N entries (1, as gg2's), H(r-1) - q
# once a cell (E at t reads it at t - 1, F at t) (1), E = max(., E) - e
# and F likewise (2 + 2), H = max(H2 + s, E, F, 0) (4), the per-position
# best (compare, two selects: 3)
OPS["batch_local_fwd"] = 13
HBM_BYTES_PER_S = 3.35e12     # H100 SXM (NVIDIA's data sheet)


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


def long_banded_jobs(seed: int = 779, n: int = 128):
    """The seeded long-banded workload: ``n`` ``random_pair`` draws with
    targets uniform in 4,000-16,000 bp, 15% divergence and 6% indels,
    the long-read extension pairs a mapper bands at ``-w751``."""
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(seed)
    lens = rng.integers(4000, 16001, n)
    jobs = []
    for L in lens:
        t, q = random_pair(rng, int(L), divergence=0.15, indel=0.06)
        jobs.append((encode_dna(q), encode_dna(t)))
    return jobs


def short_banded_jobs(seed: int = 780, n: int = 4096):
    """The seeded short-banded workload: ``n`` ``random_pair`` draws with
    targets uniform in 150-512 bp, 15% divergence and 6% indels, the
    short-read extensions a mapper bands at ``-r100`` (minimap2 ``-x
    sr``); every pair's band clips at ``w = 100``."""
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(seed)
    lens = rng.integers(150, 513, n)
    jobs = []
    for L in lens:
        t, q = random_pair(rng, int(L), divergence=0.15, indel=0.06)
        jobs.append((encode_dna(q), encode_dna(t)))
    return jobs


def single_pair(seed: int, tlen: int):
    """One ``random_pair`` draw of ``tlen`` bp, 15% divergence and 6%
    indels, as (query, target) nt4 arrays: the single-pair workloads."""
    from ksw2_tpu_torch.core.matrix import encode_dna

    t, q = random_pair(np.random.default_rng(seed), tlen, divergence=0.15,
                       indel=0.06)
    return encode_dna(q), encode_dna(t)


def local_512_jobs(seed: int = LOCAL_SEED, n: int = 512):
    """The JAX bench's local set (``bench/suite.py:817-825``): ``n``
    random 128 bp queries, each target a copy with 12% of its positions
    redrawn, as (query, target, qlen, tlen) int32 arrays."""
    rng = np.random.default_rng(seed)
    Q = np.zeros((n, 128), np.int32)
    T = np.zeros((n, 128), np.int32)
    for i in range(n):
        Q[i] = rng.integers(0, 4, 128)
        T[i] = np.where(rng.random(128) < 0.12, rng.integers(0, 4, 128),
                        Q[i])
    ln = np.full(n, 128, np.int32)
    return Q, T, ln, ln.copy()


def local_mixed_jobs(seed: int = LOCAL_MIXED_SEED, n: int = 4096):
    """The seeded local-mixed set: ``n`` targets of 8-128 bp, each mutated
    by ``random_pair`` as ``tests/test_local.py`` draws it (divergence
    0-0.5, indels 0-0.25, N in half the pairs), the copy set at a random
    offset in random ACGT flanks so that the query takes 8-512 bp, as
    (query, target, qlen, tlen) arrays padded to (n, 512) and (n, 128)."""
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(seed)
    Q = np.zeros((n, 512), np.int32)
    T = np.zeros((n, 128), np.int32)
    qlen = np.zeros(n, np.int32)
    tlen = np.zeros(n, np.int32)
    for i in range(n):
        t, q = random_pair(rng, int(rng.integers(8, 129)),
                           divergence=float(rng.uniform(0, 0.5)),
                           indel=float(rng.uniform(0, 0.25)),
                           with_n=bool(rng.integers(0, 2)))
        core = encode_dna(q)[:512]
        L = int(rng.integers(max(8, len(core)), 513))
        pad = rng.integers(0, 4, L - len(core))
        at = int(rng.integers(0, len(pad) + 1))
        Q[i, :L] = np.concatenate([pad[:at], core, pad[at:]])
        T[i, :len(t)] = encode_dna(t)
        qlen[i], tlen[i] = L, len(t)
    return Q, T, qlen, tlen


def local_edge_jobs(seed: int = 785):
    """Edge pairs of the local kernel, as (query, target, qlen, tlen)
    arrays padded to (n, 512) and (n, 128): empty queries and targets,
    an all-N and an all-mismatch pair (both (0, -1, -1)), repeats with
    tied maxima, one-base pairs, targets of exactly 128 and queries of
    129-512 bp."""
    rng = np.random.default_rng(seed)
    acac = np.tile([0, 1], 256)
    core = rng.integers(0, 4, 12)
    gap = np.full(5, 4)
    twice = np.concatenate([core, gap, core])
    pairs = [(rng.integers(0, 4, 0), rng.integers(0, 4, 50)),
             (rng.integers(0, 4, 50), rng.integers(0, 4, 0)),
             (rng.integers(0, 4, 0), rng.integers(0, 4, 0)),
             (np.full(90, 4), rng.integers(0, 4, 128)),
             (np.zeros(70, np.int64), np.full(128, 2)),
             (acac[:60], acac[:40]), (acac[:41], acac[1:128]),
             (np.concatenate([twice, gap, core]), core), (core, twice),
             (np.tile([0, 1, 2], 40), np.tile([2, 0, 1], 30)),
             (np.array([3]), np.array([3])),
             (np.array([2]), rng.integers(0, 4, 128))]
    for L in (129, 200, 400, 512):
        t = rng.integers(0, 5, 128)
        pairs.append((np.concatenate([rng.integers(0, 4, L - 100),
                                      t[10:110]]), t))
    Q = np.zeros((len(pairs), 512), np.int32)
    T = np.zeros((len(pairs), 128), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)] = q
        T[i, :len(t)] = t
    return (Q, T, np.array([len(q) for q, _ in pairs], np.int32),
            np.array([len(t) for _, t in pairs], np.int32))


def local_pin(out):
    """(sum of score, sum of te + qe) of a local result."""
    return [int(out["score"].sum()),
            int(out["te"].sum() + out["qe"].sum())]


def cigar_hash(cigar) -> str:
    """The first 16 hex digits of the SHA-256 of the BAM words (uint32)."""
    import hashlib

    return hashlib.sha256(np.asarray(cigar, np.uint32).tobytes()
                          ).hexdigest()[:16]


def single_pin(ez, cigar: bool):
    """A single-pair run's pin: (max, max_t, max_q, score, zdropped) and,
    for CIGARs, (reach_end, CIGAR ops, cigar_hash)."""
    out = (ez.max, ez.max_t, ez.max_q, ez.score, int(ez.zdropped))
    if cigar:
        out += (int(ez.reach_end), len(ez.cigar), cigar_hash(ez.cigar))
    return out


def sr_pin(ezs):
    """(sum of max, sum of score, pairs that reach the end, CIGAR ops)."""
    return (sum(ez.max for ez in ezs), sum(ez.score for ez in ezs),
            sum(int(ez.reach_end) for ez in ezs),
            sum(len(ez.cigar) for ez in ezs))


def spliced_pair(rng: np.random.Generator, tlen: int, with_n: bool = False,
                 sites: bool = False):
    """A (query, target) nt4 pair with one GT..AG intron: a random
    target with a donor GT and an acceptor AG, and as query the two
    flanking exons with 5% substitutions (and 1% N bases); ``sites``
    adds the positions (a, b) of the donor's G and the acceptor's G."""
    t = rng.integers(0, 4, tlen).astype(np.uint8)
    a = int(rng.integers(tlen // 5, tlen // 2))
    b = min(int(rng.integers(a + 20, max(a + 21, tlen - tlen // 5))),
            tlen - 2)
    t[a:a + 2] = (2, 3)
    t[b - 1:b + 1] = (0, 2)
    s = int(rng.integers(0, max(1, a // 4)))
    q = np.concatenate([t[s:a], t[b + 1:]])
    mut = rng.random(q.shape) < 0.05
    q = np.where(mut, (q + rng.integers(1, 4, q.shape)) % 4, q)
    if with_n:
        q = np.where(rng.random(q.shape) < 0.01, 4, q)
    if sites:
        return q.astype(np.uint8), t, (a, b)
    return q.astype(np.uint8), t


def splice_jobs(seed: int = 1234, n: int = 256):
    """The JAX bench's spliced workload (``bench/suite.py:757-776``):
    ``n`` two-exon reads of ~290 bp against 512 bp genomic windows with a
    canonical GT..AG intron at 200..349, 5% substitutions."""
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n):
        tt = rng.integers(0, 4, 512).astype(np.int32)
        tt[200:202] = (2, 3)
        tt[348:350] = (0, 2)
        qq = np.concatenate([tt[40:200], tt[350:480]])
        mut = rng.random(qq.shape) < 0.05
        qq = np.where(mut, (qq + rng.integers(1, 4, qq.shape)) % 4, qq)
        jobs.append((qq.astype(np.uint8), tt.astype(np.uint8)))
    return jobs


def splice_long_jobs(seed: int = SPLICE_LONG_SEED, n: int = SPLICE_LONG_N):
    """``n`` spliced pairs (:func:`spliced_pair`) with targets of 2-12 kb
    and their junction tracks: the forward donor bit at each pair's donor
    G and the acceptor bit at its acceptor G.  Returns (pairs, juncs)."""
    rng = np.random.default_rng(seed)
    pairs, juncs = [], []
    for _ in range(n):
        tlen = int(rng.integers(SPLICE_LONG_T[0], SPLICE_LONG_T[1] + 1))
        q, t, (a, b) = spliced_pair(rng, tlen, sites=True)
        j = np.zeros(tlen, np.uint8)
        j[a], j[b] = 1, 2
        pairs.append((q, t))
        juncs.append(j)
    return pairs, juncs


def cut_jobs(pairs, juncs, n: int):
    """Each pair and track cut to its first ``n`` bases."""
    return ([(q[:n], t[:n]) for q, t in pairs],
            None if juncs is None else [j[:n] for j in juncs])


def splice_junc(tlen: int = 512):
    """The annotated run's junction track (``--junc-bed``): the forward
    donor bit at t = 200 and the acceptor bit at t = 349."""
    j = np.zeros(tlen, np.uint8)
    j[200] = 1
    j[349] = 2
    return j


def splice_wide_jobs(seed: int = SPLICE_WIDE_SEED, n: int = SPLICE_WIDE_N):
    """``n`` annotated mRNA reads with exons of several hundred bases
    (:func:`splice_jobs` at three times its scale): random 1536 bp
    genomic windows with a GT at 600-601 and an AG at 1047-1048, each
    query the two exons t[120:600] + t[1049:1440] (871 bp) with 5%
    substitutions."""
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n):
        tt = rng.integers(0, 4, 1536).astype(np.int32)
        tt[600:602] = (2, 3)
        tt[1047:1049] = (0, 2)
        qq = np.concatenate([tt[120:600], tt[1049:1440]])
        mut = rng.random(qq.shape) < 0.05
        qq = np.where(mut, (qq + rng.integers(1, 4, qq.shape)) % 4, qq)
        jobs.append((qq.astype(np.uint8), tt.astype(np.uint8)))
    return jobs


def splice_wide_junc():
    """splice-wide's junction track: the forward donor bit at t = 600 and
    the acceptor bit at t = 1048."""
    j = np.zeros(1536, np.uint8)
    j[600] = 1
    j[1048] = 2
    return j


def nt4_str(a) -> str:
    """nt4 codes back to an ACGTN string."""
    return "".join("ACGTN"[int(c)] for c in a)


def write_pairs_fasta(pairs, d):
    """(query, target) nt4 pairs as the FASTA files ``t.fa`` and ``q.fa``
    in directory ``d``, records ``t<k>`` / ``q<k>``; returns their paths."""
    import os

    tp, qp = os.path.join(d, "t.fa"), os.path.join(d, "q.fa")
    with open(tp, "w") as ft, open(qp, "w") as fq:
        for k, (q, t) in enumerate(pairs):
            ft.write(f">t{k}\n{nt4_str(t)}\n")
            fq.write(f">q{k}\n{nt4_str(q)}\n")
    return tp, qp


def tsv_pin(lines, col=2):
    """A CLI run's pin: [the sum of TSV column ``col`` (2 the score, 3
    the max), the first 16 hex digits of the SHA-256 of its TSV lines]."""
    import hashlib

    text = "".join(ln + "\n" for ln in lines)
    return [sum(int(ln.split("\t")[col]) for ln in lines),
            hashlib.sha256(text.encode()).hexdigest()[:16]]


def gg2_pin(score, cigar):
    """A global alignment's pin: (score, CIGAR ops, cigar_hash)."""
    return (int(score), len(cigar), cigar_hash(cigar))


def merge_eqx(cigar):
    """A CIGAR with its =/X runs merged back into M runs (BAM words
    ``len << 4 | op``): the M-op CIGAR the reference's extz2 prints."""
    out = []
    for word in cigar:
        op, n = word & 0xF, word >> 4
        op = 0 if op in (7, 8) else op
        if out and out[-1] & 0xF == op:
            out[-1] += n << 4
        else:
            out.append(n << 4 | op)
    return out


def band_cells(pairs, w: int) -> int:
    """Cells inside the true band [st0, en0] over every diagonal of each
    pair (``bench/suite.py:266-269``): the work Gcells/s counts on the
    band route."""
    from ksw2_tpu_torch.ops.bands import band_bounds

    total = 0
    for q, t in pairs:
        st0, en0 = band_bounds(len(q) + len(t) - 1, len(q), len(t), w)
        total += int(np.maximum(0, en0 - st0 + 1).sum())
    return total


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ~50 ms of GPU sleep, long enough for the host to enqueue a timed run
SLEEP_CYCLES = 10 ** 8

# milliseconds of each plain-version run in the kernel phases, by (case,
# "fwd" / "walk" / "rows"); phase 7 reports them beside the kernels'
# times on the same launches instead of running the plain versions again
PLAIN_MS = {}


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls after one
    warm-up, by CUDA events on the current stream.  The stream first
    sleeps while the host enqueues the calls, so a kernel shorter than
    its wrapper's host work is timed on the device, not at the host's
    enqueue rate (a plain version's host work is its cost: it is timed
    by ``plain_run``)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def plain_run(key, fn, *args):
    """``fn(*args)`` once, its milliseconds recorded in ``PLAIN_MS[key]``
    (host clock with the device drained before and after: a plain
    version's host work is its cost)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    PLAIN_MS[key] = (time.perf_counter() - t0) * 1e3
    return out


def phase_device():
    """The card's name and power limit, and its int32 rate: 132 SMs x 64
    int32 lanes x the SM clock nvidia-smi reports as its maximum."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the port's "
                           "smoke run needs a CUDA card")

    def smi(query):
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.strip().splitlines()[0]

    name_power = smi("name,power.limit")
    print(name_power, flush=True)
    mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "device", "nvidia_smi": name_power,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "clocks_max_sm_mhz": mhz, "sms": sms,
          "int32_ops_per_s": sms * 64 * mhz * 1e6})
    return sms * 64 * mhz * 1e6


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
    ] + strips_layout_cases(jobs)


# kernel A's layout of a phase-3 case, where it is not the default one
# (ops/strips.py:strips_layout's keywords): short pairs packed into
# blocks of 8 warps, no clusters
FWD_LAYOUT = {"sample_packed_score_z100": dict(cl=1, nw=8),
              "sample_packed_extd_cig_z100": dict(cl=1, nw=8)}


def strip_edge_pairs(seed: int = 786):
    """Seeded pairs whose queries end at a strip edge (128 k - 1, 128 k,
    128 k + 1 bp, up to 4608), targets of 1-400 bp."""
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(seed)
    out = []
    for k, ql in enumerate((127, 128, 129, 255, 256, 257, 383, 385, 1023,
                            1025, 4095, 4097, 4607, 4608)):
        tl = int((1, 40, 129, 3, 400, 77, 260, 1, 200, 31, 150, 64, 97,
                  300)[k])
        t, q = random_pair(rng, max(ql, tl), divergence=0.12, indel=0.05)
        out.append((np.resize(encode_dna(q), ql).astype(np.uint8),
                    encode_dna(t)[:tl]))
    return out


def merged_strips_launch(jobs, costs=None):
    """The one strips launch the scheduler makes of a score batch of
    ``jobs`` at A2 B4 O4 E2 -z100 (or the two-piece ``costs``): the
    batch's strips buckets merged (batch/scheduler.py:_merged_strips)."""
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.strips import canonical_costs, strips_prep

    mat = simple_mat(5, 2, -4)
    two = costs is not None
    q, e, q2, e2 = costs if two else (4, 2, 0, 0)
    SO = Flag.SCORE_ONLY
    jl = [sched.AlignJob(qq, t, -1) for qq, t in jobs]
    choose = sched._score_chooser(SO, 5, mat, 100, q, e, two, q2, e2)
    # the buckets' pairs longest first, as _merged orders them (built
    # here, so that a tree whose scheduler does not merge them times the
    # same launch)
    bks = [bk for bk in sched._route(jl, mat, q + e, [None] * len(jl),
                                     choose) if bk.route == "strips"]
    idxs = [i for bk in bks for i in bk.idxs]
    ql = np.concatenate([bk.qlen for bk in bks])
    tl = np.concatenate([bk.tlen for bk in bks])
    order = np.argsort(-(ql.astype(np.int64) + tl), kind="stable")
    idxs = [idxs[k] for k in order]
    if "strips_costs" in inspect.signature(sched._route).parameters:
        got = [bk.idxs for bk in sched._route(
            jl, mat, q + e, [None] * len(jl), choose,
            strips_costs=canonical_costs(q, e, q2, e2)[:2])
            if bk.route == "strips"]
        assert got == [idxs], "the scheduler merges another launch"
    lns = strips_prep([jl[i].query for i in idxs],
                      [jl[i].target for i in idxs], ql[order], tl[order], 5,
                      mat, q, e, 100, SO, two=two, q2=q2, e2=e2)
    assert len(lns) == 1, len(lns)
    return lns[0]


def strips_layout_cases(jobs):
    """Kernel A's layout cases: queries at strip edges (one- and
    two-piece, score and bytes, RIGHT), short pairs packed several to a
    block (FWD_LAYOUT), one 4608 bp query over a cluster of 8 blocks, and
    the one score launch the scheduler makes of the mixed-512 batch, one-
    and two-piece (whose times phase 7 reports)."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import encode_dna
    from ksw2_tpu_torch.ops import strips as S

    SO = Flag.SCORE_ONLY
    edge = strip_edge_pairs()
    short = [p for p in jobs if len(p[0]) <= 256][:64]
    rng = np.random.default_rng(787)
    t, q = random_pair(rng, 4608, divergence=0.1, indel=0.04)
    big = [(np.resize(encode_dna(q), 4608).astype(np.uint8),
            encode_dna(t)[:900])]
    assert not hasattr(S, "strips_layout") or \
        S.strips_layout([4608]).cl == 8
    return [
        ("sample_edge_score_z100", _launch(edge, SO, 100, False)),
        ("sample_edge_cig_right_z30", _launch(edge, Flag.RIGHT, 30, True)),
        ("sample_edge_extd_score_zm1",
         _launch(edge, SO, -1, False, costs=EXTD)),
        ("sample_edge_extd_cig_z100",
         _launch(edge, Flag.NONE, 100, True, costs=EXTD)),
        ("sample_packed_score_z100", _launch(short, SO, 100, False)),
        ("sample_packed_extd_cig_z100",
         _launch(short, Flag.NONE, 100, True, costs=EXTD)),
        ("sample_cluster_cig_z100", _launch(big, Flag.NONE, 100, True)),
        ("sample_cluster_extd_score_z100",
         _launch(big, SO, 100, False, costs=EXTD)),
        ("mixed512_merged_score", merged_strips_launch(jobs)),
        ("mixed512_merged_extd_score", merged_strips_launch(jobs, EXTD)),
    ]


def fwd_layout(name, ln, device="cuda"):
    """Kernel A's layout of case ``name`` on ``device``: FWD_LAYOUT's, else
    the default one (None on a tree without ops/strips.py:strips_layout,
    whose wrapper takes none)."""
    from ksw2_tpu_torch.ops import strips as S

    if not hasattr(S, "strips_layout"):
        return None
    return S.layout_on(S.strips_layout(ln.qlen, **FWD_LAYOUT.get(name, {})),
                       device)


def fwd_call(name, ln, args, sites=None):
    """A zero-argument launch of kernel A on case ``name``'s uploaded
    ``args`` with its layout made once (so a timed loop neither reads
    qlen back nor uploads a table)."""
    from ksw2_tpu_torch.ops import strips as S

    lay = fwd_layout(name, ln)
    if lay is None:
        return lambda: S.strips_forward_cuda(*args, ln.prm, sites)
    return lambda: S.strips_forward_cuda(*args, ln.prm, sites, lay)


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
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def phase_kernel_a(cases):
    import torch
    from ksw2_tpu_torch.ops import strips as S

    worst = 0
    out = {}
    for name, ln in cases:
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        lay = fwd_layout(name, ln)
        kd = S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm, None, lay)
        pd = plain_run((name, "fwd"), S.strips_forward_plain, qs, ts, ql, tl,
                       tab, ln.prm)
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
                     "off0": ln.prm.off0, "nw": lay.nw, "cl": lay.cl,
                     "blocks": lay.blocks, "max_abs_err": errs}
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
        pr, pruns = plain_run((name, "walk"), W.strips_walk_plain, d8,
                              starts)
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
        pd = plain_run((name, "rows"), R.rows_forward_plain, qs, ts, ql, tl,
                       tab, ln.prm)
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


def band_launch(pairs, w, flag, zdrop, costs=None, mat=None, m=5):
    """One band (or batched) launch of ``pairs`` at bands ``w`` (an int
    or one per pair): A2 B4 (or ``mat``, an ``m`` x ``m`` matrix) with O4
    E2, or the two-piece ``costs``."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.band import band_prep

    mat = simple_mat(5, 2, -4) if mat is None else mat
    q, e, q2, e2 = (4, 2, 0, 0) if costs is None else costs
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    wv = np.broadcast_to(np.asarray(w, np.int32), ql.shape)
    (ln,) = band_prep([a for a, _ in pairs], [t for _, t in pairs], ql, tl,
                      wv, m, mat, q, e, zdrop, flag,
                      cig=not int(flag) & int(Flag.SCORE_ONLY),
                      two=costs is not None, q2=q2, e2=e2)
    return ln


def short_banded_launches(sb, flag, costs=None, choose=None):
    """The launches the scheduler makes of the short-banded workload
    (-w100 -z100) in one form: its buckets as ``scheduler._route`` makes
    them (the bucket ladder, longest pairs first, routed by ``choose``;
    by default every bucket takes the batched route, as phase 6 checks;
    the batched route's register-form buckets merged into one), each
    split by ``band_prep`` as the scheduler splits it.  Returns the
    launches and the host seconds of the routing and of the prep."""
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.band import band_prep

    mat = simple_mat(5, 2, -4)
    q, e, q2, e2 = (4, 2, 0, 0) if costs is None else costs
    jobs = [sched.AlignJob(a, b, SHORT_BANDED_W) for a, b in sb]
    t0 = time.perf_counter()
    buckets = sched._merged_batch(sched._route(
        jobs, mat, q + e, [None] * len(jobs), choose or (lambda *_: "batch")),
        5)
    t1 = time.perf_counter()
    launches = [ln for bk in buckets for ln in band_prep(
        [jobs[i].query for i in bk.idxs], [jobs[i].target for i in bk.idxs],
        bk.qlen, bk.tlen, bk.w, 5, mat, q, e, 100, flag,
        cig=not int(flag) & int(Flag.SCORE_ONLY), two=costs is not None,
        q2=q2, e2=e2)]
    return launches, t1 - t0, time.perf_counter() - t1


def batch_route_launches(aln, pairs):
    """The batched route's launches the scheduler makes of ``pairs``
    under the aligner ``aln`` (host only): the route table of its path
    (scores, two-piece scores with end_bonus or EXTZ_ONLY on the CIGAR
    path's table, CIGARs), the buckets merged as ``_route`` merges them,
    then ``band_prep``."""
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops.band import band_prep
    from ksw2_tpu_torch.ops.strips import canonical_costs

    two = aln.q2 is not None
    q2, e2 = (aln.q2, aln.e2) if two else (0, 0)
    flag = Flag(int(aln.flag))
    mat = np.asarray(aln.mat, np.int8).reshape(-1)
    cig = not flag & Flag.SCORE_ONLY
    qc, ec = canonical_costs(aln.q, aln.e, q2, e2)[:2] if two else \
        (aln.q, aln.e)
    args = (flag, aln.m, mat, aln.zdrop, aln.q, aln.e, two, q2, e2)
    kw = {}
    if cig:
        choose, qe = sched._cigar_chooser(*args), qc + ec
    else:
        kw["strips_costs"] = (qc, ec)
        qe = aln.q + aln.e
        choose = sched._cigar_path_score_chooser(flag, mat) if two and (
            aln.end_bonus or flag & Flag.EXTZ_ONLY) else \
            sched._score_chooser(*args)
    jl = [sched.AlignJob(q, t, aln.w) for q, t in pairs]
    bks = sched._merged_batch(
        sched._route(jl, mat, qe, [None] * len(jl), choose, **kw), aln.m)
    return [ln for bk in bks if bk.route == "batch" for ln in band_prep(
        [jl[i].query for i in bk.idxs], [jl[i].target for i in bk.idxs],
        bk.qlen, bk.tlen, bk.w, aln.m, mat, aln.q, aln.e, aln.zdrop, flag,
        cig=cig, two=two, q2=q2, e2=e2)]


def batch_wide_aligners():
    """The batched route's wide-form runs of phase 6 (its aligners by
    run name, on the mixed workload's pairs of 1536 bp or less): EQX
    CIGARs and two-piece end_bonus scores, unbanded."""
    from ksw2_tpu_torch import Aligner
    from ksw2_tpu_torch.core.flags import Flag

    q, e, q2, e2 = EXTD
    return {"short1536_eqx_cigar": Aligner(zdrop=100, flag=Flag.EQX),
            "short1536_extd_end_bonus_score": Aligner(
                q=q, e=e, q2=q2, e2=e2, zdrop=100, end_bonus=END_BONUS,
                flag=Flag.SCORE_ONLY)}


LONG1_CUT = 2000


def long1_pair(long):
    """The long-banded workload's shortest pair cut to its first
    LONG1_CUT bp: the band kernels' case beside their plain version."""
    q, t = min(long, key=lambda p: len(p[1]))
    return [(q[:LONG1_CUT], t[:LONG1_CUT])]


def band_cases(long, jobs):
    """(name, launch) cases for kernels C and C2: small seeded launches
    of 60-900 bp with bands from 1 to 1472 (N bases, one clipped query)
    in score, CIG and APPROX forms, zdrop -1/100/400, RIGHT and
    GENERIC_SC, one-piece, two-piece and swapped costs; the shortest
    pair of the long-banded workload cut to LONG1_CUT bp at its settings
    (the plain forward takes milliseconds a diagonal); the kernel's edges
    (``band_edge_pairs`` at both tile widths) and one merged launch of
    several buckets of the mixed workload (``merged_band_launch``)."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(9)
    small = []
    for L in (700, 300, 900, 500, 60):
        t, q = random_pair(rng, L, divergence=0.2, indel=0.08, with_n=True)
        small.append((encode_dna(q), encode_dna(t)))
    small[1] = (small[1][0][:150], small[1][1])
    w_small = [1, 37, 1472, 200, 16]
    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    forms = [
        ("extz_score_z100", Flag.SCORE_ONLY, 100, None),
        ("extz_cig_right_zm1", Flag.RIGHT, -1, None),
        ("extz_approx_score_zm1", Flag.SCORE_ONLY | Flag.APPROX_MAX, -1,
         None),
        ("extz_approxdrop_cig_z400", approx, 400, None),
        ("extz_generic_cig_z100", Flag.GENERIC_SC, 100, None),
        ("extd_cig_z100", Flag.NONE, 100, EXTD),
        ("extd_approxdrop_score_z100", Flag.SCORE_ONLY | approx, 100, EXTD),
        ("extd_generic_cig_right_z400", Flag.GENERIC_SC | Flag.RIGHT, 400,
         EXTD),
        ("swapped_cig_z100", Flag.NONE, 100, SWAPPED),
    ]
    cases = [(f"small_{name}",
              band_launch(small, w_small, flag, zdrop, costs,
                          _generic_mat() if flag & Flag.GENERIC_SC
                          else None))
             for name, flag, zdrop, costs in forms]
    long1 = long1_pair(long)
    cases += [
        ("long1_extz_cig_z400", band_launch(long1, BAND_W, Flag.NONE, 400)),
        ("long1_extd_score_z400",
         band_launch(long1, BAND_W, Flag.SCORE_ONLY, 400, EXTD)),
    ]
    # the kernel's edges: tiles of 32 (widest band 751, 25 warps) and of
    # 64 positions (752); targets one short of, on and past a tile edge;
    # a pair shorter than a tile; a Z-drop the compute warps run past; the
    # H0 walk across tiles; w = 1
    edge = band_edge_pairs(np.random.default_rng(10))
    w32 = [751, 751, 300, 1, 751, 64]
    w64 = [752, 751, 300, 1, 1472, 64]
    cases += [
        ("edge32_extz_cig_z100", band_launch(edge, w32, Flag.NONE, 100)),
        ("edge32_extd_approxdrop_score_z100",
         band_launch(edge, w32, Flag.SCORE_ONLY | approx, 100, EXTD)),
        ("edge64_extz_generic_cig_right_z100",
         band_launch(edge, w64, Flag.GENERIC_SC | Flag.RIGHT, 100,
                     mat=_generic_mat())),
        ("edge64_extd_cig_z100", band_launch(edge, w64, Flag.NONE, 100,
                                             EXTD)),
        ("edge64_extz_approx_cig_zm1",
         band_launch(edge, w64, Flag.APPROX_MAX, -1)),
        ("merged_mixed_extz_cig_z100", merged_band_launch(jobs, Flag.NONE)),
    ]
    return cases


def band_edge_pairs(rng):
    """Pairs at the band kernel's edges: one that aligns for 600 bp and
    then runs into unrelated sequence (it Z-drops at -z100), targets of
    639, 640 and 641 bp (one short of, on and past a tile edge), one
    shorter than a tile (20 bp) and a query much shorter than its target
    (its band ends on the query's length, not on w)."""
    from ksw2_tpu_torch.core.matrix import encode_dna

    out = []
    t, q = random_pair(rng, 600, divergence=0.05, indel=0.02)
    tail = "".join(rng.choice(list("ACGT"), size=300))
    tail2 = "".join(rng.choice(list("ACGT"), size=300))
    out.append((encode_dna(q + tail), encode_dna(t + tail2)))
    for L in (639, 640, 641, 20):
        t, q = random_pair(rng, L, divergence=0.12, indel=0.05)
        out.append((encode_dna(q), encode_dna(t)))
    t, q = random_pair(rng, 900, divergence=0.1, indel=0.04)
    out.append((encode_dna(q[:200]), encode_dna(t)))
    return out


def merged_band_launch(jobs, flag):
    """The band launch the scheduler makes of the mixed workload's first
    six band pairs of 1500 bp or less at -w751 -z100 (CIGAR path): its
    buckets merged into one, longest first."""
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.band import band_prep

    mat = simple_mat(5, 2, -4)
    pick = [p for p in jobs if 760 < len(p[1]) <= 1500][:6]
    jl = [sched.AlignJob(q, t, BAND_W) for q, t in pick]
    bks = sched._route(jl, mat, 6, [None] * len(jl),
                       sched._cigar_chooser(flag, 5, mat, 100, 4, 2))
    assert len({sched._bucket_key(len(q), len(t)) for q, t in pick}) > 1
    (bk,) = bks
    assert bk.route == "band"
    (ln,) = band_prep([jl[i].query for i in bk.idxs],
                      [jl[i].target for i in bk.idxs], bk.qlen, bk.tlen,
                      bk.w, 5, mat, 4, 2, 100, flag, cig=True)
    return ln


def phase_band(cases):
    """Kernels C / C2 (band_fwd, band_extd_fwd) against the plain forward
    on every case, records and direction bytes exactly; kernel D
    (band_walk) against the plain walker on the kernel's bytes."""
    import torch
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import strips_walker as W

    worst = {"band_fwd": 0, "band_extd_fwd": 0, "band_walk": 0}
    out = {}
    for name, ln in cases:
        args = BD.band_upload(ln, "cuda")
        krec, kp = BD.band_forward_cuda(*args, ln.prm, ln.nd, ln.ncol)
        prec, pp = plain_run((name, "fwd"), BD.band_forward_plain, *args,
                             ln.prm, ln.nd, ln.ncol)
        errs = {"records": _max_err(krec, prec)}
        if ln.prm.cig:
            errs["bytes"] = _max_err(kp, pp)
            _, _, ql, tl, w, _ = args
            starts = W.start_cells(krec, ql, tl, ln.prm.flag, 0)
            kres, kruns = BW.band_walk_cuda(kp, starts, ql, tl, w)
            pres, pruns = plain_run((name, "walk"), BW.band_walk_plain, kp,
                                    starts, ql, tl, w)
            werr = _max_err(kres, pres)
            for b in range(len(ln.qlen)):
                n = int(kres[b, 2])
                werr = max(werr, _max_err(kruns[b, :n], pruns[b, :n]))
            errs["walk"] = werr
            worst["band_walk"] = max(worst["band_walk"], werr)
        kname = "band_extd_fwd" if ln.prm.two else "band_fwd"
        worst[kname] = max(worst[kname], errs["records"],
                           errs.get("bytes", 0))
        out[name] = {"pairs": len(ln.qlen), "nd": ln.nd, "ncol": ln.ncol,
                     "w": [int(x) for x in ln.w], "max_abs_err": errs}
        if any(errs.values()):
            emit({"phase": "band", "case": name, "FAIL": errs})
            raise AssertionError(f"the band kernels differ on {name}")
    emit({"phase": "band", "max_abs_err": worst, "cases": out})
    return worst


def batch_cases(sb):
    """(name, launch) cases for kernels E and E2: seeded launches on
    targets up to 512 (N bases, one clipped query) with w 0, 1, 16, 100
    and unbanded in one launch (the wide form: its unbanded pairs set
    the launch's ncol) in score, CIG and APPROX forms, zdrop -1/100,
    RIGHT and GENERIC_SC, one-piece, two-piece and swapped costs; two
    wide launches on targets of 1000 to 1700 (score; CIG on the same
    pairs cut to 1536, the route's widest); the wide form's layout at its
    edges (``wide_edge_cases``); the register form at its edges
    (``reg_cases``); and the main path's launch shapes: the one launch a
    form of the short-banded workload's 4096 pairs (one- and two-piece
    scores, two-piece CIG) and the wide form's merged launches of its EQX
    CIGARs and end_bonus scores (``batch_main_wide``)."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(10)
    small, wide = [], []
    for L in (60, 150, 300, 500, 240):
        t, q = random_pair(rng, L, divergence=0.2, indel=0.08, with_n=True)
        small.append((encode_dna(q), encode_dna(t)))
    small[2] = (small[2][0][:120], small[2][1])
    for L in (1000, 1200, 1700):
        t, q = random_pair(rng, L, divergence=0.15, indel=0.06)
        wide.append((encode_dna(q), encode_dna(t)))
    w_small = [0, 1, 16, 100, 600]          # 600: unbanded
    w_wide = [100, 1300, 1800]              # the last two unbanded
    cases = [(f"small_{name}",
              band_launch(small, w_small, flag, zdrop, costs,
                          _generic_mat() if flag & Flag.GENERIC_SC
                          else None))
             for name, flag, zdrop, costs in batch_forms()]
    cases += [
        ("wide_extz_score_z100",
         band_launch(wide, w_wide, Flag.SCORE_ONLY, 100)),
        ("wide_extd_cig_right_zm1",
         band_launch([(q[:1536], t[:1536]) for q, t in wide], w_wide,
                     Flag.RIGHT, -1, EXTD)),
    ]
    cases += wide_edge_cases()
    cases += reg_cases(small, rng)
    for name, flag, costs in (("sb_extz_score_z100", Flag.SCORE_ONLY, None),
                              ("sb_extd_score_z100", Flag.SCORE_ONLY, EXTD),
                              ("sb_extd_cig_z100", Flag.NONE, EXTD)):
        launches, _, _ = short_banded_launches(sb, flag, costs)
        cases += [(f"{name}_launch{k}", ln) for k, ln in enumerate(launches)]
    return cases + batch_main_wide()


def batch_forms():
    """The batched cases' forms: (name, flag, zdrop, two-piece costs)."""
    from ksw2_tpu_torch.core.flags import Flag

    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    return [
        ("extz_score_z100", Flag.SCORE_ONLY, 100, None),
        ("extz_cig_right_zm1", Flag.RIGHT, -1, None),
        ("extz_approx_score_zm1", Flag.SCORE_ONLY | Flag.APPROX_MAX, -1,
         None),
        ("extz_approxdrop_cig_z100", approx, 100, None),
        ("extz_generic_cig_z100", Flag.GENERIC_SC, 100, None),
        ("extd_cig_z100", Flag.NONE, 100, EXTD),
        ("extd_approxdrop_score_zm1", Flag.SCORE_ONLY | approx, -1, EXTD),
        ("extd_generic_cig_right_z100", Flag.GENERIC_SC | Flag.RIGHT, 100,
         EXTD),
        ("swapped_cig_z100", Flag.NONE, 100, SWAPPED),
        ("swapped_score_right_zm1", Flag.SCORE_ONLY | Flag.RIGHT, -1,
         SWAPPED),
    ]


def reg_cases(small, rng):
    """Kernel E / E2's register form at its edges: launches at w 100 in
    every form, and at w 16, at the widest band the window takes (w 191,
    ncol 208) and the narrowest of the wide form (w 192), one- and
    two-piece CIG, the small pairs plus a one-base pair (the plain twin
    takes milliseconds a diagonal, so the sweep keeps the fewest launches
    that cover each form and edge); long pairs at w 30 whose window
    slides dozens of times, clipped on the query and on the target; and
    a sweep of pairs that align for 10-89 bp and then run into unrelated
    sequence at -z20, so that Z-drops fall on every diagonal of a group
    (its first and last among them), score, CIG and APPROX."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import encode_dna

    pairs = small + [(small[0][0][:1], small[0][1][:1])]
    out = []
    for w in (16, 100, 191, 192):
        for name, flag, zdrop, costs in batch_forms():
            if w != 100 and name not in ("extz_cig_right_zm1",
                                         "extd_cig_z100"):
                continue
            out.append((f"reg_w{w}_{name}", band_launch(
                pairs, w, flag, zdrop, costs,
                _generic_mat() if flag & Flag.GENERIC_SC else None)))
    longp = []
    for L in (1400, 900, 1500):
        t, q = random_pair(rng, L, divergence=0.12, indel=0.05)
        longp.append((encode_dna(q), encode_dna(t)))
    longp[1] = (longp[1][0][:100], longp[1][1])
    longp.append((longp[0][0], longp[0][1][:200]))
    drop = []
    for A in range(10, 90):
        t, q = random_pair(rng, A, divergence=0.04, indel=0.01)
        tails = ["".join(rng.choice(list("ACGT"), size=140)) for _ in "ab"]
        drop.append((encode_dna(q + tails[0]), encode_dna(t + tails[1])))
    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    for name, flag, zdrop, costs in (
            ("extz_cig_zm1", Flag.NONE, -1, None),
            ("extd_score_zm1", Flag.SCORE_ONLY, -1, EXTD),
            ("extz_approxdrop_cig_z100", approx, 100, None)):
        out.append((f"reg_slides_{name}", band_launch(longp, 30, flag, zdrop,
                                                      costs)))
    for name, flag, costs in (("extz_cig", Flag.NONE, None),
                              ("extd_score", Flag.SCORE_ONLY, EXTD),
                              ("extz_approxdrop_score",
                               Flag.SCORE_ONLY | approx, None),
                              ("extd_cig_right", Flag.RIGHT, EXTD)):
        out.append((f"reg_drops_{name}_z20", band_launch(drop, 40, flag, 20,
                                                         costs)))
    return out


def symbol_pairs(rng, m, lens, div=0.12, indel=0.05):
    """Seeded pairs over an alphabet of ``m`` symbols (``m - 1`` the
    wildcard): a random target of each length and a copy with
    substitutions (the wildcard among them) and indels as query."""
    out = []
    for L in lens:
        t = rng.integers(0, m - 1, L).astype(np.uint8)
        q = []
        i = 0
        while i < L:
            r = rng.random()
            if r < indel / 2:
                i += int(rng.integers(1, 8))
                continue
            if r < indel:
                q.extend(rng.integers(0, m, int(rng.integers(1, 8))))
            q.append(int(rng.integers(0, m)) if rng.random() < div
                     else int(t[i]))
            i += 1
        out.append((np.array(q or [0], np.uint8), t))
    return out


def wide_edge_cases():
    """(name, launch) cases of kernels E / E2's wide form (band_fwd.cu in
    ``ops.batch.wide_layout``) at its layout's edges: unbanded CIGARs
    at ncol 1552, the widest the route sends them (tiles of 64 positions,
    26 compute warps; the two-piece RIGHT form is ``batch_cases``'
    ``wide_extd_cig_right_zm1``); scores on both sides of the tile switch
    (ncol 1600: tiles of 64, 26 warps; 1616: 128, 14); a score launch of
    3072-bp targets (ncol 3088: 128, 26); and alphabets past 8 symbols,
    scored from the matrix in shared memory: m 12 (generic CIG, a score
    launch at tiles of 128 and a band of 16 at the fewest warps) and m 20
    (simple two-piece CIG with RIGHT, generic scores)."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import encode_dna, simple_mat

    rng = np.random.default_rng(12)

    def pairs(lens, qlen=None):
        out = []
        for L in lens:
            t, q = random_pair(rng, L, divergence=0.12, indel=0.05,
                               with_n=True)
            q = encode_dna(q)
            out.append((np.resize(q, qlen or len(q)).astype(np.uint8),
                        encode_dna(t)))
        return out

    def gen(m):
        g = rng.integers(-4, 1, (m, m)).astype(np.int8)
        np.fill_diagonal(g, rng.integers(1, 4, m))
        g[m - 1, :] = g[:, m - 1] = -1
        return g.reshape(-1)

    SO, R = Flag.SCORE_ONLY, Flag.RIGHT
    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    U = 4000                                   # unbanded: w past any pair
    p1552 = pairs((1536,), 1536) + pairs((900, 1200))
    out = [("wide_ncol1552_extz_cig_z100",
            band_launch(p1552, U, Flag.NONE, 100))]
    for M, ncol in ((1580, 1600), (1590, 1616)):
        out.append((f"wide_ncol{ncol}_extz_score_z100", band_launch(
            pairs((M,), M) + pairs((700,)), U, SO, 100)))
    out.append(("wide_t3072_extz_score_z100", band_launch(
        pairs((3072,), 3072) + pairs((2500, 1000)), U, SO, 100)))
    g12, g20 = gen(12), gen(20)
    s12 = symbol_pairs(rng, 12, (700, 400, 260))
    out += [("wide_m12_generic_cig_z100", band_launch(
                s12, U, Flag.GENERIC_SC, 100, mat=g12, m=12)),
            ("wide_m12_score_t1700_z100", band_launch(
                symbol_pairs(rng, 12, (1700, 900)), U, SO, 100,
                mat=simple_mat(12, 2, -4), m=12)),
            ("wide_m12_w16_approxdrop_cig_z100", band_launch(
                s12, 16, approx, 100, mat=simple_mat(12, 2, -4), m=12))]
    s20 = symbol_pairs(rng, 20, (600, 300, 90))
    out += [("wide_m20_extd_cig_right_z100", band_launch(
                s20, U, R, 100, EXTD, simple_mat(20, 2, -4), 20)),
            ("wide_m20_generic_score_zm1", band_launch(
                s20, U, Flag.GENERIC_SC | SO, -1, mat=g20, m=20))]
    return out


def batch_main_wide():
    """The wide form's launches of each wide run of phase 6's batched
    path (its buckets merged: one score launch, the CIGARs split by
    ``LAUNCH_BYTES``), as the scheduler plans them."""
    jobs = mixed_jobs()
    short1536 = [p for p in jobs if len(p[1]) <= 1536]
    out = []
    for name, aln in batch_wide_aligners().items():
        lns = batch_route_launches(aln, short1536)
        out += [(f"main_{name}_launch{k}", ln) for k, ln in enumerate(lns)]
    return out


# pairs of a large CIGAR launch phase 5c holds to the plain forward
BATCH_PLAIN_PAIRS = 512


def phase_batch(cases):
    """Kernels E / E2 (batch_fwd, batch_extd_fwd) against the plain
    forward on every case, records and direction bytes exactly; kernel D
    (band_walk) against the plain walker on the kernels' bytes (the
    first 256 pairs of a launch).  The kernel runs every launch whole; a
    CIGAR launch of more than ``BATCH_PLAIN_PAIRS`` pairs is held to the
    plain forward on that many of its pairs, spread from its longest to
    its shortest (a pair's result does not depend on its launch; the
    score launches, whose plain times phase 7 reports, run whole)."""
    import torch
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch as BT
    from ksw2_tpu_torch.ops import strips_walker as W

    worst = {"batch_fwd": 0, "batch_extd_fwd": 0, "band_walk": 0}
    out = {}
    for name, ln in cases:
        args = BD.band_upload(ln, "cuda")
        krec, kp = BT.batch_forward_cuda(*args, ln.prm, ln.nd, ln.ncol)
        B = len(ln.qlen)
        pick = slice(None)
        if ln.prm.cig and B > BATCH_PLAIN_PAIRS:
            pick = torch.from_numpy(np.unique(np.linspace(
                0, B - 1, BATCH_PLAIN_PAIRS).round().astype(np.int64))).cuda()
        pargs = [a[pick] for a in args[:5]] + list(args[5:])
        prec, pp = plain_run((name, "fwd"), BD.band_forward_plain, *pargs,
                             ln.prm, ln.nd, ln.ncol)
        errs = {"records": _max_err(krec[pick], prec)}
        if ln.prm.cig:
            errs["bytes"] = _max_err(kp[pick], pp)
            del pp
            _, _, ql, tl, w, _ = args
            n = min(256, len(ln.qlen))
            starts = W.start_cells(krec, ql, tl, ln.prm.flag, 0)[:n]
            sub = (kp[:n].contiguous(), starts, ql[:n], tl[:n], w[:n])
            kres, kruns = BW.band_walk_cuda(*sub)
            pres, pruns = BW.band_walk_plain(*sub)
            werr = _max_err(kres, pres)
            for b in range(n):
                k = int(kres[b, 2])
                werr = max(werr, _max_err(kruns[b, :k], pruns[b, :k]))
            errs["walk"] = werr
            worst["band_walk"] = max(worst["band_walk"], werr)
        kname = "batch_extd_fwd" if ln.prm.two else "batch_fwd"
        worst[kname] = max(worst[kname], errs["records"],
                           errs.get("bytes", 0))
        out[name] = {"pairs": B, "plain_pairs": len(prec), "nd": ln.nd,
                     "ncol": ln.ncol, "Lt": int(ln.target.shape[1]),
                     "w": sorted({int(x) for x in ln.w})[:8],
                     "max_abs_err": errs}
        del kp
        torch.cuda.empty_cache()
        if any(errs.values()):
            emit({"phase": "batch", "case": name, "FAIL": errs})
            raise AssertionError(f"the batched kernels differ on {name}")
    emit({"phase": "batch", "max_abs_err": worst, "cases": out})
    return worst


def splice_aligner(flag, junc_bonus=0):
    """An Aligner at minimap2 -x splice costs (A1 B2 -O2,32 -E1,0 -C9
    -z200)."""
    from ksw2_tpu_torch import Aligner

    q, e, q2, noncan = SPLICE
    return Aligner(a=1, b=2, q=q, e=e, q2=q2, splice=True, noncan=noncan,
                   junc_bonus=junc_bonus, zdrop=SPLICE_ZDROP, flag=flag)


def splice_launches(pairs, flag, juncs=None, junc_bonus=0, zdrop=None,
                    mat=None):
    """The launches the scheduler makes of ``pairs`` at -x splice costs
    (or ``zdrop`` / ``mat``): ``scheduler.plan_splice``'s, as
    ``align_batch_splice_async`` enqueues them.  Returns (route, launch)
    pairs, route "strips" or "batch"."""
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat

    mat = simple_mat(5, 1, 2) if mat is None else mat
    zdrop = SPLICE_ZDROP if zdrop is None else zdrop
    q, e, q2, noncan = SPLICE
    jobs = [sched.AlignJob(a, b) for a, b in pairs]
    plan = sched.plan_splice(jobs, 5, np.asarray(mat, np.int8).reshape(-1),
                             q, e, q2, noncan, zdrop, junc_bonus,
                             Flag(int(flag)), juncs, [None] * len(jobs))
    return [(route, ln) for _, route, lns in plan for ln in lns]


def splice_cases(spl):
    """(name, route, launch) cases for the splice kernels: the strips
    forward's spl form (and the nop walker on its bytes) and kernel 6
    (and the band walker with min_intron on its bytes) on seeded spliced
    pairs of 30-900 bp (N bases, edge shapes) in score, CIG and APPROX
    forms, zdrop -1/30/100/200, RIGHT, SPLICE_REV with SPLICE_FLANK,
    GENERIC_SC and junction tracks with junc_bonus 9; and the one launch
    of each form the scheduler makes of the 1024-pair splice workload,
    unannotated (strips) and annotated (kernel 6)."""
    from ksw2_tpu_torch.core.flags import Flag

    rng = np.random.default_rng(11)
    small = [spliced_pair(rng, L, with_n=True)
             for L in (30, 120, 512, 700, 900)]
    small += [(rng.integers(0, 5, ql).astype(np.uint8),
               rng.integers(0, 5, tl).astype(np.uint8))
              for ql, tl in ((1, 1), (1, 129), (129, 1), (128, 129))]
    tracks = []
    for _, t in small:
        j = np.zeros(len(t), np.uint8)
        j[len(t) // 3], j[2 * len(t) // 3] = 1, 2
        tracks.append(j)
    SPL, SO = Flag.SPLICE_FOR, Flag.SCORE_ONLY
    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    gen = _generic_mat()
    forms = [
        ("score_z200", SPL | SO, 200, False, None),
        ("cig_z200", SPL, 200, False, None),
        ("cig_right_zm1", SPL | Flag.RIGHT, -1, False, None),
        ("rev_flank_cig_z30", Flag.SPLICE_REV | Flag.SPLICE_FLANK, 30, False,
         None),
        ("generic_cig_z200", SPL | Flag.GENERIC_SC, 200, False, gen),
        ("junc_cig_z200", SPL, 200, True, None),
        ("junc_score_right_zm1", SPL | SO | Flag.RIGHT, -1, True, None),
        ("approx_score_zm1", SPL | SO | Flag.APPROX_MAX, -1, False, None),
        ("approxdrop_cig_z100", SPL | approx, 100, False, None),
    ]
    cases = []
    for name, flag, zdrop, junc, mat in forms:
        for route, ln in splice_launches(small, flag, tracks if junc else
                                         None, SPLICE_JUNC_BONUS if junc
                                         else 0, zdrop, mat):
            k = sum(1 for c in cases if c[0].startswith(f"small_{name}"))
            cases.append((f"small_{name}_{k}", route, ln))
    # kernel 6 on the same pairs with empty tracks (no bonus), which the
    # strips route declines
    empty = [np.zeros(len(t), np.uint8) for _, t in small]
    for name, flag, zdrop, mat in (("x_cig_z200", SPL, 200, None),
                                   ("x_score_rev_z30",
                                    Flag.SPLICE_REV | SO, 30, None),
                                   ("x_generic_cig_right_z200",
                                    SPL | Flag.GENERIC_SC | Flag.RIGHT, 200,
                                    gen)):
        for k, (route, ln) in enumerate(splice_launches(
                small, flag, empty, 0, zdrop, mat)):
            cases.append((f"small_{name}_{k}", route, ln))
    # kernel A's spl form on queries at strip edges (128 k +- 1 bp)
    edge = [(rng.integers(0, 5, ql).astype(np.uint8),
             rng.integers(0, 5, tl).astype(np.uint8))
            for ql, tl in ((127, 60), (128, 1), (129, 129), (255, 40),
                           (257, 257), (385, 30), (1025, 90))]
    for name, flag, zdrop in (("edge_score_z200", SPL | SO, 200),
                              ("edge_cig_right_zm1", SPL | Flag.RIGHT, -1)):
        for k, (route, ln) in enumerate(splice_launches(edge, flag, None, 0,
                                                        zdrop)):
            cases.append((f"small_{name}_{k}", route, ln))
    # kernel 6 at its windows' edges, on a pair whose window slides many
    # times and on pairs that Z-drop on and between group edges
    for name, pairs, flag, zdrop in exts_edge_sets(rng):
        for k, (route, ln) in enumerate(splice_launches(
                pairs, flag, [np.zeros(len(t), np.uint8) for _, t in pairs],
                0, zdrop)):
            cases.append((f"exts_{name}_{k}", route, ln))
    spl4 = spl * SPLICE_TILES
    junc = [splice_junc()] * len(spl4)
    for name, flag, tr in (("main_cig", SPL, None), ("main_score", SPL | SO,
                                                     None),
                           ("main_junc_cig", SPL, junc),
                           ("main_junc_score", SPL | SO, junc)):
        lns = splice_launches(spl4, flag, tr,
                              SPLICE_JUNC_BONUS if tr else 0)
        assert len(lns) == 1, name
        cases.append((name, *lns[0]))
    # splice-wide's one launch of each form (kernel 6's wide form)
    for name in ("wide_junc_cig", "wide_junc_score"):
        cases.append((name, "batch", splice_main_launch(name)))
    return cases


def exts_edge_sets(rng):
    """(name, pairs, flag, zdrop) of kernel 6's edge launches: shorter
    sides of 192, 193, 448 and 449 bp (ncol 208 and 224: the register
    form's window three parts idle; 464: its window less 48; 480: the
    strip form past it), each with the query and
    then the target the shorter; a 150 bp query on a 1400 bp target (its
    window slides ~40 times); 80 pairs aligned for 10-89 bp and then
    unrelated, which Z-drop at -z20 on and between group edges."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import encode_dna

    SPL = Flag.SPLICE_FOR
    out = []
    for M in (192, 193, 448, 449):
        (ta, qa), (tb, qb) = (random_pair(rng, M + 160, 0.1, 0.03)
                              for _ in range(2))
        out.append((f"edge{M}", [(encode_dna(qa)[:M], encode_dna(ta)),
                                 (encode_dna(qb), encode_dna(tb)[:M])],
                    SPL | Flag.RIGHT, 200))
    t, q = random_pair(rng, 1400, 0.08, 0.02)
    slide = [(encode_dna(q[600:750]), encode_dna(t))]
    out.append(("slide_cig", slide, SPL, 200))
    out.append(("slide_approx_score", slide, SPL | Flag.SCORE_ONLY |
                Flag.APPROX_MAX | Flag.APPROX_DROP, 100))
    sweep = []
    for A in range(10, 90):
        t, q = random_pair(rng, A, 0.04, 0.01)
        tail_t, tail_q = ("".join(rng.choice(list("ACGT"), size=140))
                          for _ in range(2))
        sweep.append((encode_dna(q + tail_q), encode_dna(t + tail_t)))
    out.append(("drops_cig", sweep, SPL, 20))
    out.append(("drops_score", sweep, SPL | Flag.SCORE_ONLY, 20))
    return out


def phase_splice(cases):
    """The splice kernels against their plain versions, exactly: the
    strips forward's spl form (D, Dq, hl, records, bytes) and the nop
    walker on its bytes; kernel 6 (records, bytes) and the band walker
    with min_intron = long_thres on its bytes (the first 256 pairs of a
    launch for the walkers' plain versions; on splice-wide's launches,
    which the kernel runs whole, ``SPLICE_WIDE_PLAIN_PAIRS`` of its
    pairs, spread over it, for the plain forward and walker)."""
    import torch
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch_exts as BE
    from ksw2_tpu_torch.ops import strips as S
    from ksw2_tpu_torch.ops import strips_walker as W

    worst = {"strips_fwd": 0, "strips_walk": 0, "batch_exts_fwd": 0,
             "band_walk": 0}
    out = {}
    for name, route, ln in cases:
        errs = {}
        if route == "strips":
            qs, ts, ql, tl, tab = S.upload(ln, "cuda")
            sites = S.site_rows(ln, "cuda")
            kd = S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm, sites)
            pd = plain_run((name, "fwd"), S.strips_forward_plain, qs, ts,
                           ql, tl, tab, ln.prm, sites)
            errs = {k: _max_err(a, b)
                    for k, a, b in zip(("D", "Dq", "hl"), kd[:3], pd[:3])}
            rec = S.replay_records(ln.prm, *kd[:3], ql, tl)
            errs["records"] = _max_err(
                rec, S.replay_records(ln.prm, *pd[:3], ql, tl))
            if ln.prm.cig:
                ii = torch.arange(ln.prm.tv, device="cuda")[None, :, None]
                jj = torch.arange(qs.shape[1], device="cuda")[None, None, :]
                live = (ii < tl[:, None, None]) & (jj < ql[:, None, None])
                diff = (kd[3].int() - pd[3].int()).abs()
                errs["d8"] = int(torch.where(live, diff, 0).max())
                del pd, diff, live
                n = min(256, len(ln.qlen))
                starts = W.start_cells(rec, ql, tl, ln.prm.flag, 0)[:n]
                d8 = kd[3][:n].contiguous()
                mi = W.walk_min_intron(ln.prm.lt, ln.prm.spl)
                kres, kruns = W.strips_walk_cuda(d8, starts, mi)
                pres, pruns = plain_run((name, "walk"), W.strips_walk_plain,
                                        d8, starts, mi)
                werr = _max_err(kres, pres)
                for b in range(n):
                    k = int(kres[b, 2])
                    werr = max(werr, _max_err(kruns[b, :k], pruns[b, :k]))
                errs["walk"] = werr
                worst["strips_walk"] = max(worst["strips_walk"], werr)
            worst["strips_fwd"] = max(worst["strips_fwd"],
                                      *(v for k, v in errs.items()
                                        if k != "walk"))
            out[name] = {"route": route, "pairs": int(qs.shape[0]),
                         "Lq": int(qs.shape[1]), "tv": ln.prm.tv,
                         "lt": ln.prm.lt, "max_abs_err": errs}
        else:
            args = BD.band_upload(ln, "cuda")
            krec, kp = BE.batch_exts_forward_cuda(*args, ln.prm, ln.nd,
                                                  ln.ncol)
            # the wide form on the same launch, whichever form it takes
            srec, sp = BE.batch_exts_wide_cuda(*args, ln.prm, ln.nd, ln.ncol)
            if name.startswith("wide"):
                B = len(ln.qlen)
                pick = torch.from_numpy(np.unique(np.linspace(
                    0, B - 1, SPLICE_WIDE_PLAIN_PAIRS).round().astype(
                        np.int64))).cuda()
                args = ([a[pick] for a in args[:5]] + [args[5]] +
                        [a[pick] for a in args[6:]])
                krec, srec = krec[pick], srec[pick]
                if ln.prm.cig:
                    kp, sp = kp[pick], sp[pick]
            _, _, ql, tl, w = args[:5]
            prec, pp = plain_run((name, "fwd"), BE.batch_exts_forward_plain,
                                 *args, ln.prm, ln.nd, ln.ncol)
            errs["records"] = _max_err(krec, prec)
            errs["wide_records"] = _max_err(srec, prec)
            if ln.prm.cig:
                errs["bytes"] = _max_err(kp, pp)
                errs["wide_bytes"] = _max_err(sp, pp)
                del pp, sp
                n = min(256, len(krec))
                starts = W.start_cells(krec, ql, tl, ln.prm.flag, 0)[:n]
                sub = (kp[:n].contiguous(), starts, ql[:n], tl[:n], w[:n],
                       W.walk_min_intron(ln.prm.lt, True))
                kres, kruns = BW.band_walk_cuda(*sub)
                pres, pruns = plain_run((name, "walk"), BW.band_walk_plain,
                                        *sub)
                werr = _max_err(kres, pres)
                for b in range(n):
                    k = int(kres[b, 2])
                    werr = max(werr, _max_err(kruns[b, :k], pruns[b, :k]))
                errs["walk"] = werr
                worst["band_walk"] = max(worst["band_walk"], werr)
                del kp
            worst["batch_exts_fwd"] = max(
                worst["batch_exts_fwd"], errs["records"],
                errs["wide_records"], errs.get("bytes", 0),
                errs.get("wide_bytes", 0))
            out[name] = {"route": route, "pairs": len(ln.qlen),
                         "plain_pairs": len(krec), "nd": ln.nd,
                         "ncol": ln.ncol,
                         "cpl": BE.exts_form(ln.ncol, ln.prm.m),
                         "Lt": int(ln.target.shape[1]), "lt": ln.prm.lt,
                         "fwd_plain_ms": PLAIN_MS[(name, "fwd")],
                         "max_abs_err": errs}
        torch.cuda.empty_cache()
        if any(errs.values()):
            emit({"phase": "splice", "case": name, "FAIL": errs})
            raise AssertionError(f"the splice kernels differ on {name}")
    emit({"phase": "splice", "max_abs_err": worst, "cases": out})
    return worst


def extz_launch(pairs, w, flag, zdrop):
    """One single-pair-engine launch of ``pairs`` at bands ``w`` (one per
    pair, -1 resolved to max(qlen, tlen)), A2 B4 (GENERIC_SC: the generic
    matrix) with O4 E2."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.extz import extz_prep

    mat = _generic_mat() if flag & Flag.GENERIC_SC else simple_mat(5, 2, -4)
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    w = np.asarray(w, np.int32)
    w = np.where(w < 0, np.maximum(ql, tl), w).astype(np.int32)
    (ln,) = extz_prep([q for q, _ in pairs], [t for _, t in pairs], ql, tl,
                      w, 5, mat, 4, 2, zdrop, flag,
                      cig=not int(flag) & int(Flag.SCORE_ONLY))
    return ln


def sr_launches(sb):
    """The launches the scheduler makes of the short-banded workload as
    sr-extension (EXTZ_ONLY CIGARs, -w100 -z100): its buckets as
    ``scheduler._route`` makes them, each split by ``extz_prep``."""
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.extz import extz_prep

    mat = simple_mat(5, 2, -4)
    jobs = [sched.AlignJob(a, b, SHORT_BANDED_W) for a, b in sb]
    buckets = sched._route(jobs, mat, 6, [None] * len(jobs),
                           lambda *_: "single")
    return [ln for bk in buckets for ln in extz_prep(
        [jobs[i].query for i in bk.idxs], [jobs[i].target for i in bk.idxs],
        bk.qlen, bk.tlen, bk.w, 5, mat, 4, 2, 100, Flag.EXTZ_ONLY, cig=True)]


def single_cases(sb):
    """(name, launch, end_bonus) cases for kernels 12 and 17: seeded
    launches of few pairs, so tiles of 32 positions (pairs of 30-1500 bp
    over 1-48 tiles; N bases; the 900 bp pair diverges after 450 bp, so
    z100 stops it mid-matrix) with w -1, 0, 1, 16, 751 and 2000, zdrop -1
    / 100, in score, CIG and APPROX forms, RIGHT, GENERIC_SC and EXTZ_ONLY
    with end_bonus; the hand-off pairs (:func:`handoff_pairs`) at each
    tile width; and the launch the main path makes of the sr-extension
    workload (the scheduler's own tile).  About 25,000 diagonals of the
    plain forward in all."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(12)
    mix = []
    for L in (30, 300, 600, 900):
        t, q = random_pair(rng, L, divergence=0.2, indel=0.08, with_n=True)
        mix.append((encode_dna(q), encode_dna(t)))
    q, t = mix[3]
    mix[3] = (np.concatenate([q[:450], rng.integers(0, 4, len(q) - 450)
                              .astype(np.uint8)]), t)
    t, q = random_pair(rng, 1500, divergence=0.15, indel=0.06)
    long1 = [(encode_dna(q), encode_dna(t))]
    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    forms = [
        ("score_zm1", Flag.SCORE_ONLY, -1, [-1, 0, 16, 2000], 0),
        ("cig_z100", Flag.NONE, 100, [1, 16, 751, -1], 0),
        ("cig_right_generic_zm1", Flag.RIGHT | Flag.GENERIC_SC, -1,
         [-1, 1, 2000, 751], 0),
        ("approxdrop_cig_z100", approx, 100, [16, -1, 751, 2000], 0),
        ("extz_only_cig_z100", Flag.EXTZ_ONLY, 100, [-1, 16, 2000, -1],
         END_BONUS),
    ]
    cases = [(f"mix_{name}", extz_launch(mix, w, flag, z), eb)
             for name, flag, z, w, eb in forms]
    cases.append(("long1500_cig_zm1",
                  extz_launch(long1, [-1], Flag.NONE, -1), 0))
    # the hand-off: diagonals that end on a group and one past it (rlim
    # 832 = 26 x 32 and 833), targets shorter than a tile, tiles
    # that start mid-group in a band, the H0 walk across 32-position
    # tiles, at each tile width
    hand = handoff_pairs(rng)
    for name, flag, z, w, tp in (
            ("cig_zm1_tp32", Flag.NONE, -1, [-1, -1, -1, -1, 60], 32),
            ("score_z100_tp64", Flag.SCORE_ONLY, 100, [-1, 100, -1, 0, 16],
             64),
            ("banded_cig_tp32", Flag.NONE, 100, [16, 1, 40, 10, 100], 32),
            ("approxdrop_cig_tp32", approx, 100, [-1, 16, -1, -1, 100], 32),
            ("approx_cig_tp64", Flag.APPROX_MAX, -1, [-1, -1, 8, -1, -1],
             64)):
        cases.append((f"handoff_{name}",
                      at_tp(extz_launch(hand, w, flag, z), tp), 0))
    cases += [(f"sr_launch{k}", ln, END_BONUS)
              for k, ln in enumerate(sr_launches(sb))]
    return cases


def at_tp(ln, tp):
    """The launch ``ln`` laid out for tiles of ``tp`` positions."""
    from ksw2_tpu_torch.ops.extz_fwd import make_layout

    return ln._replace(lay=make_layout(ln.qlen, ln.tlen, ln.w, tp,
                                       ln.prm.cig))


def handoff_pairs(rng):
    """Pairs that stress the single-pair forward's hand-off every
    ``extz_fwd.KD`` diagonals (32): a pair whose diagonals end exactly on a
    group and one past it, targets shorter than a tile, and a long banded
    pair whose tiles start mid-group."""
    from ksw2_tpu_torch.core.matrix import encode_dna

    out = []
    for L, qn in ((400, 433), (400, 434), (20, 24), (90, 60), (640, 600)):
        t, q = random_pair(rng, L, divergence=0.12, indel=0.05)
        q = np.resize(encode_dna(q), qn)
        out.append((q, encode_dna(t)))
    return out


def _store_err(kp, pp, ln, stop) -> int:
    """Largest byte difference over the rows each pair computed (the
    kernel also computes the rows past a Z-drop stop; the plain version
    leaves them 0)."""
    from ksw2_tpu_torch.ops.extz_fwd import row_off

    ends = row_off(stop.cpu().numpy(), ln.qlen, ln.tlen, ln.w)
    err = 0
    for b, n in enumerate(ends):
        s = int(ln.lay.pbase[b])
        err = max(err, _max_err(kp[s:s + int(n)], pp[s:s + int(n)]))
    return err


def phase_single(cases):
    """Kernel 12 (extz_fwd) against its plain version on every case:
    records, stops and direction bytes exactly; kernel 17 (extz_walk)
    against its plain version on the kernel's bytes, in the main path's
    mode (upper_force 1, min_intron 0) and, on the mixed launches, with
    upper_force 0 (escape flag) and min_intron 5."""
    import torch
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import extz_fwd as F
    from ksw2_tpu_torch.ops import strips_walker as W
    from ksw2_tpu_torch.ops import traceback_device as TB

    worst = {"extz_fwd": 0, "extz_walk": 0}
    out = {}
    for name, ln, eb in cases:
        args = BD.band_upload(ln, "cuda")
        krec, kp, kstop = F.extz_forward_cuda(*args, ln.prm, ln.lay)
        prec, pp, pstop = plain_run((name, "fwd"), F.extz_forward_plain,
                                    *args, ln.prm, ln.lay)
        errs = {"records": _max_err(krec, prec),
                "stop": _max_err(kstop, pstop)}
        if ln.prm.cig:
            errs["bytes"] = _store_err(kp, pp, ln, kstop)
            del pp
            _, _, ql, tl, w = args[:5]
            starts = W.start_cells(krec, ql, tl, ln.prm.flag, eb)
            pbase = torch.from_numpy(ln.lay.pbase).cuda()
            wr = ln.query.shape[1] + ln.target.shape[1] + 2
            werr = 0
            modes = [(1, 0)] if name.startswith("sr") else \
                [(1, 0), (0, 0), (1, 5)]
            for uf, mi in modes:
                sub = (kp, pbase, starts, ql, tl, w, wr, mi, uf)
                kres, kruns = TB.extz_walk_cuda(*sub)
                key = (name, "walk") if (uf, mi) == (1, 0) else \
                    (name, f"walk_uf{uf}_mi{mi}")
                pres, pruns = plain_run(key, TB.extz_walk_plain, *sub)
                werr = max(werr, _max_err(kres, pres))
                for b in range(len(ln.qlen)):
                    k = int(kres[b, 2])
                    werr = max(werr, _max_err(kruns[b, :k], pruns[b, :k]))
            errs["walk"] = werr
            worst["extz_walk"] = max(worst["extz_walk"], werr)
        worst["extz_fwd"] = max(worst["extz_fwd"], errs["records"],
                                errs["stop"], errs.get("bytes", 0))
        out[name] = {"pairs": len(ln.qlen), "tp": ln.lay.tp,
                     "tiles": int(ln.lay.tbase[-1]),
                     "rows": int(ln.lay.n_diag), "bytes": ln.lay.n_bytes,
                     "w": sorted({int(x) for x in ln.w})[:8],
                     "zdropped": int(krec[:, 8].sum()),
                     "max_abs_err": errs}
        del kp
        torch.cuda.empty_cache()
        if any(errs.values()):
            emit({"phase": "single", "case": name, "FAIL": errs})
            raise AssertionError(f"the single-pair kernels differ on {name}")
    emit({"phase": "single", "max_abs_err": worst, "cases": out})
    return worst


def extd_launch(pairs, w, flag, zdrop, costs=EXTD, mat=None):
    """One single-pair two-piece launch of ``pairs`` at bands ``w`` (one
    per pair, -1 resolved to max(qlen, tlen)), A2 B4 (GENERIC_SC: the
    generic matrix, or ``mat``) with the PRE-swap ``costs``."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.extd import extd_prep

    if mat is None:
        mat = _generic_mat() if flag & Flag.GENERIC_SC else \
            simple_mat(5, 2, -4)
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    w = np.asarray(w, np.int32)
    w = np.where(w < 0, np.maximum(ql, tl), w).astype(np.int32)
    (ln,) = extd_prep([q for q, _ in pairs], [t for _, t in pairs], ql, tl,
                      w, 5, mat, *costs, zdrop, flag,
                      cig=not int(flag) & int(Flag.SCORE_ONLY))
    return ln


def exts_launch(pairs, flag, zdrop, juncs=None, junc_bonus=0):
    """One single-pair splice launch of ``pairs`` at -x splice costs (A1
    B2, GENERIC_SC: the generic matrix), with junction tracks."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.exts import exts_prep

    mat = _generic_mat() if flag & Flag.GENERIC_SC else simple_mat(5, 1, -2)
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    (ln,) = exts_prep([q for q, _ in pairs], [t for _, t in pairs], ql, tl,
                      5, mat, *SPLICE, zdrop, flag, juncs, junc_bonus,
                      cig=not int(flag) & int(Flag.SCORE_ONLY))
    return ln


def sr_extd_aligner(flag):
    """An Aligner at minimap2 -x sr's extension costs (-A2 -B8 -O12,24
    -E2,1 -r100 --end-bonus 10 -z100)."""
    from ksw2_tpu_torch import Aligner

    a, b = SR_EXTD_MAT
    q, e, q2, e2 = SR_EXTD
    return Aligner(a=a, b=b, q=q, e=e, q2=q2, e2=e2, w=SHORT_BANDED_W,
                   zdrop=100, end_bonus=END_BONUS, flag=flag)


def sr_extd_launches(sb, flag):
    """The launches the scheduler makes of the short-banded workload as
    sr-extension-extd: its buckets as ``scheduler._route`` makes them,
    each split by ``extd_prep``."""
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.extd import extd_prep

    mat = simple_mat(5, SR_EXTD_MAT[0], -SR_EXTD_MAT[1])
    jobs = [sched.AlignJob(a, b, SHORT_BANDED_W) for a, b in sb]
    buckets = sched._route(jobs, mat, SR_EXTD[0] + SR_EXTD[1],
                           [None] * len(jobs), lambda *_: "single")
    return [ln for bk in buckets for ln in extd_prep(
        [jobs[i].query for i in bk.idxs], [jobs[i].target for i in bk.idxs],
        bk.qlen, bk.tlen, bk.w, 5, mat, *SR_EXTD, 100, Flag(int(flag)),
        cig=not int(flag) & int(Flag.SCORE_ONLY))]


def splice_single_launches(pairs, flag, juncs=None, junc_bonus=0):
    """The single-pair launches the scheduler makes of ``pairs`` at -x
    splice costs (``scheduler.plan_splice``'s "single" buckets)."""
    return [ln for route, ln in splice_launches(pairs, flag, juncs,
                                                 junc_bonus)
            if route == "single"]


def _first(ln, n):
    """The launch's first ``n`` pairs, re-prepped as a launch of their
    own (its own tile choice and layout)."""
    from ksw2_tpu_torch.ops.extz import single_prep

    ql, tl, w = ln.qlen[:n], ln.tlen[:n], ln.w[:n]
    qs = [ln.query[k, :ql[k]] for k in range(n)]
    ts = [ln.target[k, :tl[k]] for k in range(n)]
    sites = None
    if ln.sites:
        def sites(i0, tpad, _tl):
            return tuple(np.ascontiguousarray(s[:n, :tpad.shape[1]])
                         for s in ln.sites)
    (out,) = single_prep(ln.prm, qs, ts, ql, tl, w, sites)
    return out


def single2_cases(sb, spl):
    """(name, kind, launch, end_bonus) cases for kernels 13 ("extd") and
    14 ("exts"): seeded launches of few pairs, so tiles of 32 positions
    (pairs of 30-1500 bp over 1-48 tiles; N bases; the 900 bp pair
    diverges after 450 bp, so z100 stops it mid-matrix) in score, CIG and
    APPROX forms; kernel 13 with w -1, 0, 1, 16 and 751, zdrop -1 / 100,
    RIGHT, GENERIC_SC, EXTZ_ONLY with end_bonus, default and swapped
    costs; kernel 14 with SPLICE_FOR / SPLICE_REV, FLANK, junction tracks
    (junc_bonus 9), GENERIC_SC, EXTZ_ONLY and RIGHT|REV_CIGAR; both on
    hand-off pairs at each tile width (:func:`handoff_pairs`; spliced
    pairs of 25-1100 bp); kernel 14 on one launch of mixed lengths (16
    annotated 2 kb pairs with 64 unannotated 512 bp ones); and the first
    256 pairs of the launches the main path makes of sr-extension-extd
    and splice-ends.  No plain version runs on a pair over 2 kb."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(13)
    mix = []
    for L in (30, 300, 600, 900):
        t, q = random_pair(rng, L, divergence=0.2, indel=0.08, with_n=True)
        mix.append((encode_dna(q), encode_dna(t)))
    q, t = mix[3]
    mix[3] = (np.concatenate([q[:450], rng.integers(0, 4, len(q) - 450)
                              .astype(np.uint8)]), t)
    t, q = random_pair(rng, 1500, divergence=0.15, indel=0.06)
    long1 = [(encode_dna(q), encode_dna(t))]
    SO, X = Flag.SCORE_ONLY, Flag.EXTZ_ONLY
    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    cases = []
    for name, flag, z, w, costs, eb in (
            ("score_zm1", SO, -1, [-1, 0, 16, 751], EXTD, 0),
            ("cig_z100", Flag.NONE, 100, [1, 16, 751, -1], EXTD, 0),
            ("cig_right_generic_zm1_swapped", Flag.RIGHT | Flag.GENERIC_SC,
             -1, [-1, 1, 751, 16], SWAPPED, 0),
            ("approxdrop_cig_z100", approx, 100, [16, -1, 751, 0], EXTD, 0),
            ("extz_only_cig_z100_swapped", X, 100, [-1, 16, 751, -1],
             SWAPPED, END_BONUS),
            ("extz_only_score_z100", SO | X, 100, [-1, 1, 751, -1], EXTD,
             END_BONUS)):
        cases.append((f"extd_mix_{name}", "extd",
                      extd_launch(mix, w, flag, z, costs), eb))
    cases.append(("extd_long1500_cig_zm1", "extd",
                  extd_launch(long1, [-1], Flag.NONE, -1), 0))
    # the hand-off pairs at each tile width (see single_cases)
    hand = handoff_pairs(rng)
    for name, flag, z, w, costs, tp in (
            ("cig_zm1_tp32", Flag.NONE, -1, [-1, -1, -1, -1, 60], EXTD, 32),
            ("approxdrop_cig_tp32", approx, 100, [-1, 16, -1, -1, 100],
             SWAPPED, 32),
            ("score_z100_tp64", SO | X, 100, [-1, 100, -1, 0, 16], EXTD,
             64),
            ("banded_cig_tp64", X, 100, [16, 1, 40, 10, 100], SWAPPED, 64)):
        cases.append((f"extd_handoff_{name}", "extd",
                      at_tp(extd_launch(hand, w, flag, z, costs), tp),
                      END_BONUS))
    sr = sr_extd_launches(sb, Flag.EXTZ_ONLY)
    cases.append(("sr_extd_256", "extd", _first(sr[0], 256), END_BONUS))

    small = [spliced_pair(rng, L, with_n=True) for L in (30, 300, 700)]
    long2 = [spliced_pair(rng, 1500)]
    tracks = []
    for _, t in small + long2:
        j = np.zeros(len(t), np.uint8)
        j[len(t) // 3], j[2 * len(t) // 3] = 1, 2
        tracks.append(j)
    SPL = Flag.SPLICE_FOR
    for name, pairs, flag, z, junc in (
            ("score_z200", small, SPL | SO, 200, False),
            ("junc_cig_z200", small, SPL, 200, True),
            ("rev_flank_cig_zm1", small,
             Flag.SPLICE_REV | Flag.SPLICE_FLANK, -1, False),
            ("generic_cig_right_z200", small,
             SPL | Flag.GENERIC_SC | Flag.RIGHT, 200, False),
            ("extz_only_cig_z200", small, SPL | X, 200, False),
            ("left_junc_cig_z200", small,
             SPL | X | Flag.RIGHT | Flag.REV_CIGAR, 200, True),
            ("approxdrop_cig_z100", small, SPL | approx, 100, True),
            ("long1500_junc_cig_z200", long2, SPL, 200, True),
            ("long1500_extz_only_score_zm1", long2, SPL | SO | X, -1,
             False)):
        tr = (tracks[len(small):] if pairs is long2 else
              tracks[:len(small)]) if junc else None
        cases.append((f"exts_{name}", "exts",
                      exts_launch(pairs, flag, z, tr,
                                  SPLICE_JUNC_BONUS if junc else 0), 0))
    hand = [spliced_pair(rng, L) for L in (25, 90, 433, 1100)]
    for name, flag, z, tp in (("approxdrop_cig_tp32", SPL | approx, 100, 32),
                              ("cig_z200_tp64", SPL, 200, 64),
                              ("score_zm1_tp32", SPL | SO, -1, 32)):
        cases.append((f"exts_handoff_{name}", "exts",
                      at_tp(exts_launch(hand, flag, z), tp), 0))
    # one launch of mixed lengths, as the scheduler merges a batch's
    # buckets: splice-long's first pairs cut to 2 kb, annotated, with the
    # splice workload's first 64 pairs of 512 bp, unannotated
    lp, lj = splice_long_jobs()
    cp, cj = cut_jobs(lp[:SPLICE_LONG_PREFIX], lj[:SPLICE_LONG_PREFIX],
                      SPLICE_LONG_CUT)
    cases.append(("exts_merged_2kb_and_512", "exts",
                  exts_launch(cp + spl[:64], SPL, SPLICE_ZDROP,
                              cj + [None] * 64, SPLICE_JUNC_BONUS), 0))
    ends = splice_single_launches(spl * SPLICE_TILES, SPL | X)
    cases.append(("splice_ends_256", "exts", _first(ends[0], 256), 0))
    return cases


def phase_single2(cases):
    """Kernels 13 (extd_fwd) and 14 (exts_fwd) against their plain
    versions on every case: records, stops and direction bytes exactly;
    kernel 17 (extz_walk) against its plain version on the kernels'
    bytes, with min_intron 0 (extd) and long_thres (exts)."""
    import torch
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import extd as ED
    from ksw2_tpu_torch.ops import exts as ES
    from ksw2_tpu_torch.ops import strips_walker as W
    from ksw2_tpu_torch.ops import traceback_device as TB

    fwd = {"extd": (ED.extd_forward_cuda, ED.extd_forward_plain),
           "exts": (ES.exts_forward_cuda, ES.exts_forward_plain)}
    worst = {"extd_fwd": 0, "exts_fwd": 0, "extz_walk": 0}
    out = {}
    for name, kind, ln, eb in cases:
        args = BD.band_upload(ln, "cuda")
        kfn, pfn = fwd[kind]
        krec, kp, kstop = kfn(*args, ln.prm, ln.lay)
        prec, pp, pstop = plain_run((name, "fwd"), pfn, *args, ln.prm,
                                    ln.lay)
        errs = {"records": _max_err(krec, prec),
                "stop": _max_err(kstop, pstop)}
        if ln.prm.cig:
            errs["bytes"] = _store_err(kp, pp, ln, kstop)
            del pp
            _, _, ql, tl, w = args[:5]
            starts = W.start_cells(krec, ql, tl, ln.prm.flag, eb)
            pbase = torch.from_numpy(ln.lay.pbase).cuda()
            wr = ln.query.shape[1] + ln.target.shape[1] + 2
            mi = ln.prm.lt if kind == "exts" else 0
            sub = (kp, pbase, starts, ql, tl, w, wr, mi)
            kres, kruns = TB.extz_walk_cuda(*sub)
            pres, pruns = plain_run((name, "walk"), TB.extz_walk_plain, *sub)
            werr = _max_err(kres, pres)
            for b in range(len(ln.qlen)):
                k = int(kres[b, 2])
                werr = max(werr, _max_err(kruns[b, :k], pruns[b, :k]))
            errs["walk"] = werr
            worst["extz_walk"] = max(worst["extz_walk"], werr)
        kname = f"{kind}_fwd"
        worst[kname] = max(worst[kname], errs["records"], errs["stop"],
                           errs.get("bytes", 0))
        out[name] = {"pairs": len(ln.qlen), "tp": ln.lay.tp,
                     "tiles": int(ln.lay.tbase[-1]),
                     "rows": int(ln.lay.n_diag), "bytes": ln.lay.n_bytes,
                     "w": sorted({int(x) for x in ln.w})[:8],
                     "zdropped": int(krec[:, 8].sum()),
                     "max_abs_err": errs}
        del kp
        torch.cuda.empty_cache()
        if any(errs.values()):
            emit({"phase": "single2", "case": name, "FAIL": errs})
            raise AssertionError(f"the single-pair kernels differ on {name}")
    emit({"phase": "single2", "max_abs_err": worst, "cases": out})
    return worst


def _resolve(pairs, w):
    """Bands ``w`` resolved as the engines resolve them."""
    from ksw2_tpu_torch.ops.bands import resolve_bands
    return resolve_bands(pairs, w)


def cli_split(jobs, algo):
    """The CLI's whole-file dispatch of ``jobs`` for ``algo`` at its
    CLI_BATCH_ARGS band (gg2_sse -w 100, extf2_sse unbanded): the pairs
    the batched kernels take and the rest, in file order."""
    from ksw2_tpu_torch.cli import batch_eligible

    w = _resolve(jobs, 100 if algo == "gg2_sse" else -1)
    ok = [batch_eligible(algo, len(q), len(t), wk)
          for (q, t), wk in zip(jobs, w)]
    return ([p for p, k in zip(jobs, ok) if k],
            [p for p, k in zip(jobs, ok) if not k])


def lg_edge_cases():
    """The tiled kernels' edge cases (kernels 15 and 16, and 7 and 8 where
    their route takes the pairs): (name, kind, pairs, resolved bands,
    xdrop) of extf pairs that X-drop at diagonal 1 (every first cell
    mismatches, xdrop 5), extf pairs that X-drop where the walk crosses a
    tile edge (a shared prefix of 4-60 bases, then tails that mismatch
    everywhere, xdrop 40: the walk's lt at the drop sweeps 31 / 32 and 63
    / 64), extf pairs whose first empty band comes before qlen + tlen - 1
    (xdrop -1), and
    gg2 pairs with qlen > tlen + w whose walk runs off u into the
    reference's block (targets not a multiple of 16, bands 0-16) with an
    empty query."""
    rng = np.random.default_rng(15)

    def seq(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    r1 = [(np.zeros(L, np.uint8), np.ones(L, np.uint8)) for L in (40, 300)]
    edges = []
    for L0 in range(4, 61):
        pre = seq(L0)
        edges.append((np.concatenate([pre, np.zeros(60, np.uint8)]),
                      np.concatenate([pre, np.ones(60, np.uint8)])))
    rl, w_rl = [], [16, 30, 100]
    for tl, ql in ((100, 300), (500, 90), (40, 700)):
        t = seq(tl)
        rl.append((np.concatenate([t, seq(ql - tl)]) if ql > tl else t[:ql],
                   t))
    ov, w_ov = [], []
    for tl, ql, w in ((20, 60, 0), (20, 90, 1), (17, 41, 0), (33, 200, 1),
                      (100, 300, 8), (300, 700, 16), (45, 0, 3)):
        t = seq(tl)
        q = np.concatenate([t, seq(ql - tl)]) if ql >= tl else seq(ql)
        ov.append((q.astype(np.uint8), t))
        w_ov.append(w)
    return [("extf_xdrop_r1", "extf", r1, _resolve(r1, -1), 5),
            ("extf_xdrop_edges", "extf", edges, _resolve(edges, -1), 40),
            ("extf_first_empty", "extf", rl, w_rl, -1),
            ("gg2_run_off", "gg2", ov, w_ov, None)]


def lg_window_cases():
    """Kernels 7 and 8's register-form edges, (name, kind, pairs, resolved
    bands, xdrop) a launch each: the widest row at W - 48 and W - 32 of
    each window (kernel 7: n_col 976 register, 992 strip, and bands that
    end at a slot's edge, n_col 208 / 224 / 464 / 480; kernel 8: 208
    register, 224 strip), the band min(qlen, tlen, w + 1) = n_col - 31
    and no X-drop; and gg2 pairs whose bands round to empty (a target
    longer than query plus band) beside one at qlen = tlen + w."""
    rng = np.random.default_rng(18)

    def seq(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    out = []
    for kind, cols in (("extf", (208, 224, 464, 480, 976, 992)),
                       ("gg2", (208, 224))):
        for ncol in cols:
            m = ncol - 31
            t = seq(m + 20)
            pairs = [(np.concatenate([t[:m] if kind == "gg2" else t,
                                      seq(20)]), t)]
            out.append((f"{kind}_window_{ncol}", kind, pairs, [m - 1],
                        -1 if kind == "extf" else None))
    t = seq(600)
    eb = [(t[:40], t), (np.concatenate([t[:150], seq(50)]), t[:150])]
    return out + [("gg2_empty_bands", "gg2", eb, [12, 50], None)]


def lg_cases(jobs):
    """(name, kind, pairs, resolved bands, xdrop, forms) cases for kernels
    7 and 15 (kind "extf") and 8 and 16 (kind "gg2"): seeded pairs of
    30-1500 bp (N bases) with w 0, 16, 100 and unbanded, xdrop -1 and
    40; two pairs with qlen > tlen + w for kernel 16's block overrun;
    the first 64 pairs of each launch the CLI run makes of the
    mixed-512 workload (-t extf2_sse -z 40, -t gg2_sse -w 100: the
    batched launch and the single-pair one); the tiled kernels' edge
    cases (:func:`lg_edge_cases`); and the batched register forms' window
    edges (:func:`lg_window_cases`).  ``forms`` names the kernels a case
    holds: "batch" (7 / 8), "single" (15 / 16, at tiles of 32 and 64
    positions)."""
    from ksw2_tpu_torch.core.matrix import encode_dna

    rng = np.random.default_rng(14)
    mix = []
    for L in (30, 300, 700, 1100, 1500):
        t, q = random_pair(rng, L, divergence=0.2, indel=0.08, with_n=True)
        mix.append((encode_dna(q), encode_dna(t)))
    w_mix = _resolve(mix, [-1, 0, 16, 100, -1])
    over, w_over = [], [8, 30]
    for L in (200, 600):
        t, q = random_pair(rng, L, divergence=0.2, indel=0.08)
        q = encode_dna(q)
        over.append((np.concatenate([q, q[:int(0.6 * len(q))]]),
                     encode_dna(t)))
    eb, es = (ps[:64] for ps in cli_split(jobs, "extf2_sse"))
    gb, gs = (ps[:64] for ps in cli_split(jobs, "gg2_sse"))
    # kernel 8 takes only what its route gives it: qlen <= tlen + w
    ok = [k for k, (q, t) in enumerate(mix) if len(q) <= len(t) + w_mix[k]]
    mixb, w_mixb = [mix[k] for k in ok], [w_mix[k] for k in ok]
    both = ("batch", "single")
    return [
        ("extf_mix_xm1", "extf", mix, w_mix, -1, both),
        ("extf_mix_x40", "extf", mix, w_mix, 40, both),
        ("cli64_extf_batch", "extf", eb, _resolve(eb, -1), 40, both),
        ("cli64_extf_single", "extf", es, _resolve(es, -1), 40,
         ("single",)),
        ("gg2_mix_single", "gg2", mix + over, w_mix + w_over, None,
         ("single",)),
        ("gg2_mix_batch", "gg2", mixb, w_mixb, None, ("batch",)),
        ("cli64_gg2_batch", "gg2", gb, [100] * len(gb), None, ("batch",)),
        ("cli64_gg2_single", "gg2", gs, [100] * len(gs), None,
         ("single",)),
    ] + [(name, kind, pairs, w, xdrop, both if kind == "extf" else
          ("single",)) for name, kind, pairs, w, xdrop in lg_edge_cases()
         ] + [(name, kind, pairs, w, xdrop, ("batch",))
              for name, kind, pairs, w, xdrop in lg_window_cases()]


def lg_ncol(kind, pairs, w):
    """The widest row of a launch of kernel 7 (``kind`` "extf" or
    "batch_extf_fwd") or 8 on ``pairs`` at bands ``w``, as its main path
    computes it on the host."""
    from ksw2_tpu_torch.ops import batch_extf as BF
    from ksw2_tpu_torch.ops import batch_gg2 as BG

    tl = [len(b) for _, b in pairs]
    if "extf" in kind:
        return int(BF.extf_ncol([len(a) for a, _ in pairs], tl, w).max())
    return int(BG.gg2_ncol(tl, w).max())


def lg_batch_forms(kind, qlen, tlen, w):
    """Kernel 7's (``kind`` "extf") or 8's ("gg2") launchers of the forms
    that hold a launch of these pairs, (form, launcher) with the strip
    launcher's arguments: the strip form, which holds every launch the
    routes send, then the register form where the host's rule gives it
    the launch (the wrapper at the launch's widest row)."""
    from ksw2_tpu_torch.ops import batch_extf as BF
    from ksw2_tpu_torch.ops import batch_gg2 as BG

    if kind == "extf":
        ncol = int(BF.extf_ncol(qlen, tlen, w).max())
        reg = BF.extf_form(ncol)
        strip, pick = BF.batch_extf_strip_cuda, BF.batch_extf_forward_cuda
    else:
        ncol = int(BG.gg2_ncol(tlen, w).max())
        reg = BG.gg2_form(ncol, 5)
        strip, pick = BG.batch_gg2_strip_cuda, BG.batch_gg2_forward_cuda
    return [("strip", strip)] + (
        [("register", functools.partial(pick, ncol=ncol))] if reg else [])


def phase_linear_global(cases):
    """Kernels 7 and 15 (batch_extf_fwd, extf_fwd) against their plain
    version's records, kernels 8 and 16 (batch_gg2_fwd, gg2_fwd) against
    theirs (without and with the block overrun) on scores and every byte
    of the flat store, kernels 15 and 16 at tiles of 32 and of 64
    positions, and band_walk's flat form against its plain version on the
    kernels' bytes (end cells and runs), exactly."""
    import torch
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch_extf as BF
    from ksw2_tpu_torch.ops import batch_gg2 as BG
    from ksw2_tpu_torch.ops import extf as XF
    from ksw2_tpu_torch.ops import gg2 as G1
    from ksw2_tpu_torch.ops import lg_tiles as LT

    table = torch.from_numpy(simple_mat(5, 2, -4).astype(np.int32)).cuda()
    worst = dict.fromkeys(("batch_extf_fwd", "extf_fwd", "batch_gg2_fwd",
                           "gg2_fwd", "band_walk"), 0)
    out = {}
    for name, kind, pairs, w, xdrop, forms in cases:
        args = BF.pack_pairs(pairs, w, "cuda")
        errs = {}
        row = {"pairs": len(pairs), "forms": list(forms),
               "Lt": int(args[1].shape[1])}
        ql_np = [len(a) for a, _ in pairs]
        tl_np = [len(b) for _, b in pairs]
        if kind == "extf":
            want = plain_run((name, "fwd"), BF.extf_forward_plain, *args,
                             2, -4, 2, xdrop)
            if "batch" in forms:
                bforms = lg_batch_forms(kind, ql_np, tl_np, w)
                row["batch_forms"] = [f for f, _ in bforms]
                errs["batch_extf_fwd"] = max(
                    _max_err(fn(*args, 2, -4, 2, xdrop), want)
                    for _, fn in bforms)
            errs["extf_fwd"] = max(_max_err(XF.extf_single_forward_cuda(
                *args, 2, -4, 2, xdrop,
                lay=LT.lg_layout("extf_fwd", ql_np, tl_np, w, tp)), want)
                for tp in LT.TILES)
            row["zdropped"] = int(want[:, 8].sum())
        else:
            single = "single" in forms
            pb_np, total = BG.flat_layout(ql_np, tl_np, w)
            pb = torch.from_numpy(pb_np).cuda()
            ws, wp = plain_run((name, "fwd"), BG.gg2_forward_plain, *args,
                               table, 5, 4, 2, pb, total, single)
            kname = "gg2_fwd" if single else "batch_gg2_fwd"
            if single:
                errs[kname] = 0
                for tp in LT.TILES:
                    ks, kp = G1.gg2_single_forward_cuda(
                        *args, table, 5, 4, 2, pb, total,
                        lay=LT.lg_layout("gg2_fwd", ql_np, tl_np, w, tp))
                    errs[kname] = max(errs[kname], _max_err(ks, ws),
                                      _max_err(kp, wp))
            else:
                # every form that holds the launch; the walk below reads
                # the bytes of the form the rule picks, which comes last
                bforms = lg_batch_forms(kind, ql_np, tl_np, w)
                row["batch_forms"] = [f for f, _ in bforms]
                errs[kname] = 0
                for _, fn in bforms:
                    ks, kp = fn(*args, table, 5, 4, 2, pb, total)
                    errs[kname] = max(errs[kname], _max_err(ks, ws),
                                      _max_err(kp, wp))
            del wp
            _, _, ql, tl, wt = args
            kres, kruns = BW.flat_walk_cuda(kp, pb, ql, tl, wt)
            pres, pruns = plain_run((name, "walk"), BW.flat_walk_plain, kp,
                                    pb, ql, tl, wt)
            werr = _max_err(kres, pres)
            for b in range(len(pairs)):
                n = int(kres[b, 2])
                werr = max(werr, _max_err(kruns[b, :n], pruns[b, :n]))
            errs["band_walk"] = werr
            row["store_bytes"] = total
            row["overrun"] = sum(a > b + x for a, b, x in
                                 zip(ql_np, tl_np, w))
            del kp
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
        row["max_abs_err"] = errs
        out[name] = row
        torch.cuda.empty_cache()
        if any(errs.values()):
            emit({"phase": "linear_global", "case": name, "FAIL": errs})
            raise AssertionError(f"the linear-gap / global kernels differ "
                                 f"on {name}")
    emit({"phase": "linear_global", "max_abs_err": worst, "cases": out})
    return worst


def local_upload(Q, T, ql, tl):
    """The launch tensors of a local set on the card."""
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a, dt)).cuda()
            for a, dt in ((Q, np.uint8), (T, np.uint8), (ql, np.int32),
                          (tl, np.int32))]


# kernel 18's cost sweep (phase 5h): gap opens of both signs, so that
# its row scan's decay max(-q, 0) - e is negative, zero and positive
LOCAL_SWEEP = tuple((q, e) for q in (-2, 0, 4, 11) for e in (0, 1, 2))
LOCAL_SWEEP_PAIRS = 256


def phase_local():
    """Kernel 18 (batch_local_fwd) against its plain version, exactly:
    (score, te, qe) on the JAX bench's local set, on local-mixed and on
    the edge pairs, with A2 B4 q4 e2 and, on local-mixed and the edge
    pairs, with a generic matrix (the kernel reads its match, mismatch
    and N entries, as the JAX kernel does); and on the edge pairs with
    the first LOCAL_SWEEP_PAIRS of local-mixed at each (q, e) of
    LOCAL_SWEEP."""
    import torch
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import batch_local as BL

    a, b, q, e = LOCAL_COSTS
    prm = BL.local_params(5, simple_mat(5, a, -b), q, e)
    gen = BL.local_params(5, _generic_mat(), q, e)
    sets = local_sets()
    edge = local_edge_jobs()
    cases = [("local_512", sets["local_512"], prm),
             ("local_mixed", sets["local_mixed"], prm),
             ("local_edge", edge, prm),
             ("local_mixed_generic", sets["local_mixed"], gen),
             ("local_edge_generic", edge, gen)]
    sweep = tuple(np.concatenate([x[:LOCAL_SWEEP_PAIRS], y]) for x, y in
                  zip(sets["local_mixed"], edge))
    cases += [(f"local_sweep_q{sq}_e{se}", sweep,
               BL.local_params(5, simple_mat(5, a, -b), sq, se))
              for sq, se in LOCAL_SWEEP]
    worst = 0
    out = {}
    for name, arrays, p in cases:
        args = local_upload(*arrays)
        want = plain_run((name, "fwd"), BL.local_forward_plain, *args, p)
        got = BL.local_forward_cuda(*args, p)
        torch.cuda.synchronize()
        err = _max_err(got, want)
        worst = max(worst, err)
        out[name] = {"pairs": len(arrays[2]), "max_abs_err": err,
                     "pin": local_pin({"score": want[:, 0].cpu().numpy(),
                                       "te": want[:, 1].cpu().numpy(),
                                       "qe": want[:, 2].cpu().numpy()})}
        if err:
            emit({"phase": "local", "case": name, "FAIL": err})
            raise AssertionError(f"the local kernel differs on {name}")
    emit({"phase": "local", "max_abs_err": worst, "cases": out})
    return worst


def local_times(int_rate, plain=True):
    """Kernel 18 on each local set beside its bound and its plain
    version's time there (phase 5h's; on local-64k the plain version runs
    here, once, and the kernel is held to it exactly; ``plain=False``
    leaves the plain version out and gives each set's pin instead).  The
    cells are the matrix's, qlen x tlen; the bytes are the sequences, the
    lengths and the results, each once."""
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import batch_local as BL

    a, b, q, e = LOCAL_COSTS
    prm = BL.local_params(5, simple_mat(5, a, -b), q, e)
    out = {}
    for name, (Q, T, ql, tl) in local_sets().items():
        args = local_upload(Q, T, ql, tl)
        row = {"kernel": "batch_local_fwd", "pairs": len(ql),
               "Lq": int(Q.shape[1]), "Lt": int(T.shape[1])}
        row["fwd_ms"] = cuda_ms(
            lambda: BL.local_forward_cuda(*args, prm), 20)
        if not plain:
            res = BL.local_forward_cuda(*args, prm).cpu().numpy()
            row["pin"] = local_pin({"score": res[:, 0], "te": res[:, 1],
                                    "qe": res[:, 2]})
        elif (name, "fwd") not in PLAIN_MS:
            # phase 5h held the other sets: this one is held here, exactly
            want = plain_run((name, "fwd"), BL.local_forward_plain, *args,
                             prm)
            row["max_abs_err"] = err = _max_err(
                BL.local_forward_cuda(*args, prm), want)
            if err:
                emit({"phase": "times", "case": name, "FAIL": err})
                raise AssertionError(f"the local kernel differs on {name}")
        if plain:
            row["fwd_plain_ms"] = PLAIN_MS[(name, "fwd")]
        cells = int((ql.astype(np.int64) * tl).sum())
        nbytes = int(ql.sum() + tl.sum()) + len(ql) * (8 + 12)
        row["cells"] = cells
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
            "batch_local_fwd", cells, nbytes, int_rate)
        row["fwd_gcells_per_s"] = cells / row["fwd_ms"] / 1e6
        out[name] = row
        del args
    return out


def run_module(argv, timeout=600):
    """``python -m`` a module of the port in a child process from the
    checkout's root: (exit code, stdout, stderr, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", *argv], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr, time.perf_counter() - t0


def phase_operations():
    """The deployment steps in child processes: ``python -m
    ksw2_tpu_torch.precompile --quick`` must exit 0 and print the
    km_stat report with kernel 18 among its launches; one small ``python
    -m ksw2_tpu_torch.cli --stats`` run must print its alignment and, on
    stderr, non-zero launches and the card's allocator counters."""
    rc, _, err, secs = run_module(["ksw2_tpu_torch.precompile", "--quick"])
    report = [ln for ln in err.splitlines() if ln.startswith(
        ("[ksw2_tpu_torch]", "  batch_local_fwd", "  device:", "warmed"))]
    pre = {"rc": rc, "seconds": secs, "report": report}
    t, q = random_pair(np.random.default_rng(786), 300, divergence=0.1)
    rc2, out2, err2, secs2 = run_module(
        ["ksw2_tpu_torch.cli", "--stats", "-t", "extz2_sse", t, q])
    launches = [ln for ln in err2.splitlines()
                if ln.startswith("[ksw2_tpu_torch] kernel launches")]
    cli = {"rc": rc2, "seconds": secs2, "tsv": out2.strip(),
           "report": err2.strip().splitlines()}
    emit({"phase": "operations", "precompile": pre, "cli_stats": cli})
    if rc or not any(ln.startswith("  batch_local_fwd") for ln in report) \
            or "allocated_bytes.all.peak" not in err:
        raise AssertionError(f"precompile failed ({rc}):\n{err[-4000:]}")
    if rc2 or not out2.startswith("first\tsecond") or not launches or \
            launches[0].split(": ")[1].startswith("0 ") or \
            "allocated_bytes.all.current" not in err2:
        raise AssertionError(f"cli --stats failed ({rc2}):\n{err2[-4000:]}")
    return pre, cli


def lg_work(pairs, w, rec=None, store=False):
    """(cells, bytes) of one linear-gap or global forward on this run's
    data: the true band cells of the diagonals each pair computed (an
    extf pair that stopped early counts to its best cell's diagonal, a
    lower bound, or, when its best is the origin, to its first empty
    band) and the bytes read and written once: the sequences, lengths
    and record, and with ``store`` the flat store's rows of 16-rounded
    band a diagonal."""
    from ksw2_tpu_torch.ops.bands import band_bounds, first_empty_diag

    rec = None if rec is None else rec.cpu().numpy()
    cells = nbytes = 0
    for b, ((q, t), x) in enumerate(zip(pairs, w)):
        ql, tl = len(q), len(t)
        stop = ql + tl - 1
        if rec is not None:
            stop = int(first_empty_diag(ql, tl, x))
            if rec[b, 8] and rec[b, 1] >= 0:
                stop = min(stop, int(rec[b, 1] + rec[b, 2]) + 1)
        st0, en0 = band_bounds(stop, ql, tl, x)
        cells += int(np.maximum(0, en0 - st0 + 1).sum())
        nbytes += ql + tl + 12 + 36
        if store:
            st, en = st0 // 16 * 16, (en0 + 16) // 16 * 16 - 1
            nbytes += int(np.maximum(0, en - st + 1).sum())
    return cells, nbytes


def linear_global_times(lcases, single, mt, jobs, int_rate):
    """Kernels 7, 8, 15 and 16 and the flat walk at the main path's
    shapes: each on the first 64 pairs of the CLI run's launches beside
    its plain version's time there (phase 5g), on the CLI run's whole
    launches, kernel 15 on the 50 kb pair and its first LG_PREFIX bp and
    kernel 16 on the MT pair (no plain version runs there: it takes
    milliseconds a diagonal)."""
    import torch
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch_extf as BF
    from ksw2_tpu_torch.ops import batch_gg2 as BG
    from ksw2_tpu_torch.ops import extf as XF
    from ksw2_tpu_torch.ops import gg2 as G1
    try:    # a tree before the tiled kernels 15 and 16 (--lg-times)
        from ksw2_tpu_torch.ops import lg_tiles as LT
    except ImportError:
        LT = None

    table = torch.from_numpy(simple_mat(5, 2, -4).astype(np.int32)).cuda()
    by_name = {c[0]: c for c in lcases}
    cut = (single[0][:LG_PREFIX], single[1][:LG_PREFIX])
    eb, es = cli_split(jobs, "extf2_sse")
    gb, gs = cli_split(jobs, "gg2_sse")
    runs = [
        ("cli64_extf_batch", "batch_extf_fwd", None, 5),
        ("cli64_extf_single", "extf_fwd", None, 5),
        ("cli64_gg2_batch", "batch_gg2_fwd", None, 5),
        ("cli64_gg2_single", "gg2_fwd", None, 5),
        ("cli_extf_batch", "batch_extf_fwd", (eb, _resolve(eb, -1), 40), 3),
        ("cli_extf_batch_xm1", "batch_extf_fwd", (eb, _resolve(eb, -1), -1),
         3),
        ("cli_extf_single", "extf_fwd", (es, _resolve(es, -1), 40), 3),
        ("cli_gg2_batch", "batch_gg2_fwd", (gb, [100] * len(gb), None), 3),
        ("cli_gg2_single", "gg2_fwd", (gs, [100] * len(gs), None), 3),
        ("single50k_extf", "extf_fwd", ([single], _resolve([single], -1), -1),
         2),
        ("single2k_extf", "extf_fwd", ([cut], _resolve([cut], -1), -1), 5),
        ("mt_gg2", "gg2_fwd", ([mt], _resolve([mt], -1), None), 2)]
    fwds = {"batch_extf_fwd": BF.batch_extf_forward_cuda,
            "extf_fwd": XF.extf_single_forward_cuda,
            "batch_gg2_fwd": BG.batch_gg2_forward_cuda,
            "gg2_fwd": G1.gg2_single_forward_cuda}
    out = {}
    for name, kname, spec, reps in runs:
        pairs, w, xdrop = (spec if spec is not None else
                           (by_name[name][2], by_name[name][3],
                            by_name[name][4]))
        args = BF.pack_pairs(pairs, w, "cuda")
        fn = fwds[kname]
        row = {"kernel": kname, "pairs": len(pairs),
               "Lt": int(args[1].shape[1])}
        # kernels 15 and 16 on the layout their main path makes on the
        # host, kernels 7 and 8 on its widest row (no read-back)
        kw = {}
        if "ncol" in inspect.signature(fn).parameters:
            kw["ncol"] = lg_ncol(kname, pairs, w)
        if LT is not None and kname in LT.KINDS:
            kw["lay"] = LT.lg_layout(kname, [len(a) for a, _ in pairs],
                                     [len(b) for _, b in pairs], w)
            row["tp"] = kw["lay"].tp
        if kname.endswith("extf_fwd"):
            def fwd(args=args, fn=fn, xdrop=xdrop, kw=kw):
                return fn(*args, 2, -4, 2, xdrop, **kw)
            row["fwd_ms"] = cuda_ms(fwd, reps)
            cells, nbytes = lg_work(pairs, w, fwd())
            row["zdropped"] = int(fwd()[:, 8].sum())
        else:
            pb_np, total = BG.flat_layout([len(a) for a, _ in pairs],
                                          [len(b) for _, b in pairs], w)
            pb = torch.from_numpy(pb_np).cuda()

            def fwd(args=args, fn=fn, pb=pb, total=total, kw=kw):
                return fn(*args, table, 5, 4, 2, pb, total, **kw)
            row["fwd_ms"] = cuda_ms(fwd, reps)
            cells, nbytes = lg_work(pairs, w, store=True)
            row["store_bytes"] = total
            _, p = fwd()
            _, _, ql, tl, wt = args
            row["walk_ms"] = cuda_ms(
                lambda: BW.flat_walk_cuda(p, pb, ql, tl, wt), reps)
            steps, wbytes = walk_work(*BW.flat_walk_cuda(p, pb, ql, tl, wt),
                                      20)
            row["walk_steps"] = steps
            row["walk_bound_ms"], row["walk_bound_by"] = bound(
                "band_walk", steps, wbytes, int_rate)
            if (name, "walk") in PLAIN_MS:
                row["walk_plain_ms"] = PLAIN_MS[(name, "walk")]
            del p
        row["computed_cells"] = cells
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
            kname, cells, nbytes, int_rate, kname.endswith("gg2_fwd"))
        row["fwd_gcells_per_s"] = cells / row["fwd_ms"] / 1e6
        if len(pairs) == 1 and kname in ("extf_fwd", "gg2_fwd"):
            row["us_per_diag"] = 1e3 * row["fwd_ms"] / (
                len(pairs[0][0]) + len(pairs[0][1]) - 1)
        if (name, "fwd") in PLAIN_MS:
            row["fwd_plain_ms"] = PLAIN_MS[(name, "fwd")]
        out[name] = row
        del args
        torch.cuda.empty_cache()
    return out


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


def _got(out, kind):
    if callable(kind):
        return kind(out)
    if kind == "stream":
        return out
    if kind == "cigar":
        return [sum(ez.max for ez in out), sum(len(ez.cigar) for ez in out)]
    return sum(ez.max for ez in out)


def run(name, fn, pairs, anchor, kind="score", aln=None, batches=1,
        cells=None, prefix=None, sample=None, juncs=None):
    """One run of a main path: ``kind`` "score" sums max, "stream" gives
    a list of per-batch sums, "cigar" gives [sum max, CIGAR ops], a
    callable gives what it returns for the results;
    ``prefix`` = (n, anchor) also pins the first n results; a run with an
    ``aln`` has the pairs ``sample`` (8 random ones by default, none for
    ``[]``) held against the CPU route; ``cells`` (qlen x tlen by default) feed
    Gcells/s; ``juncs`` are the pairs' junction tracks (splice)."""
    return dict(name=name, fn=fn, pairs=pairs, anchor=anchor, kind=kind,
                aln=aln, batches=batches,
                cells=_cells(pairs) if cells is None else cells,
                prefix=prefix, sample=sample, juncs=juncs)


def _path(path, runs_spec, needs, never=()):
    """Drive one main path: the launch counters are set to 0 just before
    it and read just after.  Fails when an anchor is missed, when a
    kernel in ``needs`` never launched or one in ``never`` did.  Returns
    the counts, the runs and the (pairs, results, aligner, sample) of the
    runs to sample."""
    from ksw2_tpu_torch import _build

    runs = {}
    results = {}
    _build.LAUNCHES.clear()
    for rs in runs_spec:
        out, w0, walls = _timed(rs["fn"])
        got = _got(out, rs["kind"])
        if rs["aln"] is not None:
            results[rs["name"]] = (rs["pairs"], out, rs["aln"], rs["sample"],
                                   rs["juncs"])
        med = float(np.median(walls))
        row = {"got": got, "anchor": rs["anchor"],
               "pairs": rs["batches"] * len(rs["pairs"]), "first_wall_s": w0,
               "walls_s": walls,
               "gcells_per_s": rs["batches"] * rs["cells"] / med / 1e9,
               "pairs_per_s": rs["batches"] * len(rs["pairs"]) / med}
        if rs["aln"] is not None and rs["kind"] != "stream":
            # host submit against the wait in result(), one more call
            t0 = time.perf_counter()
            h = rs["aln"].extend_batch_async(rs["pairs"], juncs=rs["juncs"])
            t1 = time.perf_counter()
            h.result()
            row["submit_ms"] = (t1 - t0) * 1e3
            row["wait_ms"] = (time.perf_counter() - t1) * 1e3
        if rs["prefix"] is not None:
            n, want = rs["prefix"]
            row["prefix"] = {"n": n, "got": _got(out[:n], rs["kind"]),
                             "anchor": want}
        runs[rs["name"]] = row
    counts = dict(_build.LAUNCHES)
    emit({"phase": "main_path", "path": path, "launches": counts,
          "runs": runs})
    bad = [name for name, r in runs.items() if r["got"] != r["anchor"] or
           ("prefix" in r and r["prefix"]["got"] != r["prefix"]["anchor"])]
    if bad:
        raise AssertionError(f"{path}: anchors missed: {bad}")
    for k in needs:
        if counts.get(k, 0) < 1:
            raise AssertionError(f"the {path} path never launched {k}")
    for k in never:
        if counts.get(k, 0):
            raise AssertionError(f"the {path} path launched {k}")
    return counts, runs, results


def _fields9(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, ez.zdropped)


def _eqx_merged(out):
    """[sum of max, CIGAR ops once =/X runs merge into M, M ops left]:
    the batched route converts, so no M op may remain."""
    return [sum(ez.max for ez in out),
            sum(len(merge_eqx(ez.cigar)) for ez in out),
            sum(1 for ez in out for c in ez.cigar if c & 0xF == 0)]


def cli_files(jobs):
    """The mixed workload written as FASTA in ``build/cli_batch/`` of the
    checkout (``t.fa``, ``q.fa``)."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "cli_batch")
    os.makedirs(d, exist_ok=True)
    return write_pairs_fasta(jobs, d)


def cli_lines(name, files):
    """A function that runs the CLI run ``name`` (its CLI_BATCH_ARGS,
    ``--backend batch``) on ``files`` in-process and returns its TSV
    lines."""
    from ksw2_tpu_torch import cli as kcli

    def go():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if kcli.main(["--backend", "batch"] + CLI_BATCH_ARGS[name]
                         + list(files)):
                raise AssertionError(f"{name}: the CLI failed")
        return buf.getvalue().splitlines()
    return go


def lg_paths(jobs, single, mt, kernels):
    """The main paths of the linear-gap and global engines (kernels 7, 8,
    15 and 16, walked by band_walk's flat form): the 50 kb pair through
    extf2_device (the JAX bench's extf_50k_score row), the MT-length pair
    through Aligner.global_align (its gg2_mt_cigar row) and the ksw2-test
    CLI's whole-file dispatch (--backend batch) on the mixed-512
    workload as FASTA; each launches only its kernels of these and
    band_walk (``kernels``: every kernel's counter name)."""
    from ksw2_tpu_torch import Aligner
    from ksw2_tpu_torch.ops.extf import extf2_device

    def only(*names):
        return names, tuple(k for k in kernels if k not in names)
    glob = Aligner()
    files = cli_files(jobs)
    return [
        ("single_extf", [
            run("single_extf",
                lambda: [extf2_device(*single, 2, 4, 2, xdrop=-1)],
                [single], list(LG_PINS["single_extf"][0]),
                lambda out: list(single_pin(out[0], False)))],
         *only("extf_fwd")),
        ("single_gg2_mt", [
            run("single_gg2_mt", lambda: [glob.global_align(*mt)], [mt],
                list(LG_PINS["single_gg2_mt"][0]),
                lambda out: list(gg2_pin(out[0].score, out[0].cigar)))],
         *only("gg2_fwd", "band_walk")),
        ("cli_batch", [
            run(name, cli_lines(name, files), jobs,
                list(LG_PINS[name][0]),
                functools.partial(tsv_pin, col=CLI_PIN_COL[name]),
                prefix=(CLI_BATCH_PREFIX, list(LG_PINS[name][1])))
            for name in CLI_BATCH_ARGS],
         *only("batch_extf_fwd", "batch_gg2_fwd", "extf_fwd", "gg2_fwd",
               "band_walk")),
    ]


@functools.lru_cache(maxsize=1)
def local_sets():
    """name -> (query, target, qlen, tlen) of the local paths: the JAX
    bench's set, the same tiled LOCAL_TILES times, and local-mixed."""
    l512 = local_512_jobs()
    tiles = [(LOCAL_TILES,) + (1,) * (a.ndim - 1) for a in l512]
    return {"local_512": l512,
            "local_64k": tuple(np.tile(a, k) for a, k in zip(l512, tiles)),
            "local_mixed": local_mixed_jobs()}


def local_paths(kernels):
    """The main paths of batched local alignment (kernel 18) through
    ``local_batch_device`` at A2 B4 q4 e2: the JAX bench's local set
    (its anchor), the set tiled LOCAL_TILES times (the anchor times
    LOCAL_TILES) and local-mixed (its pin); each launches kernel 18 and
    nothing else of ``kernels``."""
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.batch_local import local_batch_device

    a, b, q, e = LOCAL_COSTS
    mat = simple_mat(5, a, -b)
    pins = {"local_512": LOCAL_ANCHOR,
            "local_64k": tuple(LOCAL_TILES * v for v in LOCAL_ANCHOR),
            "local_mixed": LOCAL_MIXED_PIN}
    out = []
    for name, (Q, T, ql, tl) in local_sets().items():
        out.append((name, [
            run(name, lambda Q=Q, T=T, ql=ql, tl=tl: local_batch_device(
                Q, T, ql, tl, 5, mat, q, e), range(len(ql)),
                list(pins[name]), local_pin,
                cells=int((ql.astype(np.int64) * tl).sum()))],
            ("batch_local_fwd",), tuple(kernels)))
    return out


def single_launch_plan(sb, spl4, slong):
    """The single-pair launches a batch of each path makes, by kernel, as
    the scheduler plans them (host only): every bucket of a batch that
    the route table sends to the single-pair engine in one set of
    launches, split only by ``ops.strips.LAUNCH_BYTES``.  Splice-long's
    scores are one launch a batch and its CIGARs ceil(bytes /
    LAUNCH_BYTES), the bytes its launches' device buffers (store,
    boundary history, per-diagonal records); asserted here."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops import strips

    X, SO, SPL = Flag.EXTZ_ONLY, Flag.SCORE_ONLY, Flag.SPLICE_FOR
    sr = len(sr_launches(sb))
    sr2 = (len(sr_extd_launches(sb, X)), len(sr_extd_launches(sb, X | SO)))
    ends = sum(len(splice_single_launches(spl4, SPL | X | f))
               for f in (Flag.NONE, Flag.RIGHT | Flag.REV_CIGAR))
    lpairs, ljuncs = slong
    lcig = splice_single_launches(lpairs, SPL, ljuncs, SPLICE_JUNC_BONUS)
    lscore = splice_single_launches(lpairs, SPL | SO, ljuncs,
                                    SPLICE_JUNC_BONUS)
    cpairs, cjuncs = cut_jobs(lpairs[:SPLICE_LONG_PREFIX],
                              ljuncs[:SPLICE_LONG_PREFIX], SPLICE_LONG_CUT)
    lcut = splice_single_launches(cpairs, SPL, cjuncs, SPLICE_JUNC_BONUS)
    nbytes = sum(ln.lay.device_bytes() for ln in lcig)
    if len(lscore) != 1 or \
            len(lcig) != -(-nbytes // strips.LAUNCH_BYTES):
        raise AssertionError(f"splice_long: {len(lscore)} score and "
                             f"{len(lcig)} CIGAR launches for {nbytes} "
                             "bytes")
    return {"sr_extension": {"extz_fwd": sr, "extz_walk": sr},
            "sr_extension_extd": {"extd_fwd": sum(sr2),
                                  "extz_walk": sr2[0]},
            "splice_ends": {"exts_fwd": ends, "extz_walk": ends},
            "splice_long": {"exts_fwd": len(lcig) + len(lscore) + len(lcut),
                            "extz_walk": len(lcig) + len(lcut)}}


def strips_launch_plan(runs):
    """Kernel A's launches on the extz and extd paths, as the scheduler
    plans them (host only): a score batch's strips buckets merged into
    one launch (asserted: one a score batch), a CIGAR batch's one a
    bucket.  ``runs`` are (path, aligner, pairs, batches): the batches
    a run makes in ``_path`` (its function four times, and one more with
    an aligner; a stream of 8 handles is 8 batches a call).  Returns
    {path: strips_fwd launches}."""
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops.strips import canonical_costs, strips_prep

    want = {}
    for path, aln, pairs, nb in runs:
        two = aln.q2 is not None
        q2, e2 = (aln.q2, aln.e2) if two else (0, 0)
        qc, ec = canonical_costs(aln.q, aln.e, q2, e2)[:2] if two else \
            (aln.q, aln.e)
        flag = Flag(int(aln.flag))
        mat = np.asarray(aln.mat, np.int8).reshape(-1)
        cig = not flag & Flag.SCORE_ONLY
        jl = [sched.AlignJob(q, t, aln.w) for q, t in pairs]
        args = (flag, aln.m, mat, aln.zdrop, aln.q, aln.e, two, q2, e2)
        if cig:
            bks = sched._route(jl, mat, qc + ec, [None] * len(jl),
                               sched._cigar_chooser(*args))
        else:
            bks = sched._route(jl, mat, aln.q + aln.e, [None] * len(jl),
                               sched._score_chooser(*args),
                               strips_costs=(qc, ec))
        n = sum(len(strips_prep(
            [jl[i].query for i in bk.idxs], [jl[i].target for i in bk.idxs],
            bk.qlen, bk.tlen, aln.m, mat, aln.q, aln.e, aln.zdrop, flag,
            cig=cig, two=two, q2=q2, e2=e2)) for bk in bks
            if bk.route == "strips")
        if not cig and n != 1:
            raise AssertionError(f"{path}: {n} strips launches a score "
                                 "batch, planned one")
        want[path] = want.get(path, 0) + nb * n
    return want


def band_launch_plan(alns, long, jobs):
    """The band launches a batch of each band path makes, by kernel, as
    the scheduler plans them (host only): a batch's band buckets merged
    into one, one score launch a batch and ceil(bytes / LAUNCH_BYTES)
    CIGAR launches, the bytes their rotated stores (B x nd x ncol), each
    walked once; asserted here.  ``alns`` are the band paths' aligners by
    run name ("long_*" on the long-banded workload, "mixed751_*" on the
    mixed one)."""
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops import strips
    from ksw2_tpu_torch.ops.band import band_prep

    plan = {}
    for name, aln in alns.items():
        pairs, path = (long, "band") if name.startswith("long") else \
            (jobs, "mixed751")
        two = aln.q2 is not None
        q2, e2 = (aln.q2, aln.e2) if two else (0, 0)
        flag = Flag(int(aln.flag))
        mat = np.asarray(aln.mat, np.int8).reshape(-1)
        cig = not flag & Flag.SCORE_ONLY
        chooser = sched._cigar_chooser if cig else sched._score_chooser
        jl = [sched.AlignJob(q, t, aln.w) for q, t in pairs]
        band = [bk for bk in sched._route(
            jl, mat, aln.q + aln.e, [None] * len(jl),
            chooser(flag, aln.m, mat, aln.zdrop, aln.q, aln.e, two, q2, e2))
            if bk.route == "band"]
        lns = [ln for bk in band for ln in band_prep(
            [jl[i].query for i in bk.idxs], [jl[i].target for i in bk.idxs],
            bk.qlen, bk.tlen, bk.w, aln.m, mat, aln.q, aln.e, aln.zdrop,
            flag, cig=cig, two=two, q2=q2, e2=e2)]
        nbytes = sum(len(ln.qlen) * ln.nd * ln.ncol for ln in lns)
        want = -(-nbytes // strips.LAUNCH_BYTES) if cig else 1
        if len(band) != 1 or len(lns) != want:
            raise AssertionError(f"{name}: {len(band)} band buckets and "
                                 f"{len(lns)} launches, planned {want}")
        counts = plan.setdefault(path, {})
        kern = "band_extd_fwd" if two else "band_fwd"
        counts[kern] = counts.get(kern, 0) + len(lns)
        if cig:
            counts["band_walk"] = counts.get("band_walk", 0) + len(lns)
    return plan


def batch_launch_plan(runs):
    """The batched launches a batch of the batched path makes, by kernel,
    as the scheduler plans them (host only): a batch's buckets merged by
    form, so one score launch a short-banded batch and ceil(bytes /
    LAUNCH_BYTES) CIGAR launches, the bytes their rotated stores (B x nd
    x ncol), each in the register form and walked once; and the wide
    runs' buckets (unbanded pairs of up to 1536 bp) as one score launch,
    or CIGAR launches each as full as LAUNCH_BYTES lets it be, all in the
    wide form (asserted here).  ``runs`` are the path's (aligner, pairs)
    by run name."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops import strips
    from ksw2_tpu_torch.ops.bands import n_col_bytes
    from ksw2_tpu_torch.ops.batch import batch_form

    counts = {}
    for name, (aln, pairs) in runs.items():
        lns = batch_route_launches(aln, pairs)
        cig = not Flag(int(aln.flag)) & Flag.SCORE_ONLY
        if name.startswith("short_banded"):
            nbytes = sum(len(ln.qlen) * ln.nd * ln.ncol for ln in lns)
            want = -(-nbytes // strips.LAUNCH_BYTES) if cig else 1
            if len(lns) != want or \
                    not all(batch_form(ln.ncol, aln.m) for ln in lns):
                raise AssertionError(
                    f"{name}: {len(lns)} batched launches (forms "
                    f"{[batch_form(ln.ncol, aln.m) for ln in lns]}), "
                    f"planned {want} in the register form")
        if name.startswith("short1536"):
            full = all(
                (len(a.qlen) + 1) * max(a.nd, int(b.qlen[0] + b.tlen[0]) - 1)
                * max(a.ncol, n_col_bytes(int(b.qlen[0]), int(b.tlen[0]),
                                          int(b.w[0])))
                > strips.LAUNCH_BYTES for a, b in zip(lns, lns[1:]))
            if any(batch_form(ln.ncol, aln.m) for ln in lns) or not full \
                    or (not cig and len(lns) != 1):
                raise AssertionError(
                    f"{name}: {len(lns)} batched launches of "
                    f"{[len(ln.qlen) for ln in lns]} pairs (forms "
                    f"{[batch_form(ln.ncol, aln.m) for ln in lns]}), "
                    "planned merged wide-form launches")
        kern = "batch_extd_fwd" if aln.q2 is not None else "batch_fwd"
        counts[kern] = counts.get(kern, 0) + len(lns)
        if cig:
            counts["band_walk"] = counts.get("band_walk", 0) + len(lns)
    return {"batch": counts}


def phase_main_path(jobs, short, long, sb, spl, single, mt, slong):
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
    W, approx = BAND_W, Flag.APPROX_MAX | Flag.APPROX_DROP
    band = {
        "long_score": Aligner(w=W, zdrop=400, flag=Flag.SCORE_ONLY),
        "long_extd_score": Aligner(q2=q2, e2=e2, w=W, zdrop=400,
                                   flag=Flag.SCORE_ONLY),
        "long_approx_score": Aligner(w=W, zdrop=400,
                                     flag=Flag.SCORE_ONLY | approx),
        "long_cigar": Aligner(w=W, zdrop=400),
        "long_extd_cigar": Aligner(q2=q2, e2=e2, w=W, zdrop=400),
        "mixed751_score": Aligner(w=W, zdrop=100, flag=Flag.SCORE_ONLY),
        "mixed751_cigar": Aligner(w=W, zdrop=100),
    }

    def stream8(aln):
        def go():
            hs = [aln.extend_batch_async(jobs) for _ in range(8)]
            return [sum(ez.max for ez in h.result()) for h in hs]
        return go

    def band_run(name, pairs, kind, sample=None):
        aln = band[name]
        n = LONG_PREFIX if name.startswith("long") else MIXED_PREFIX
        full, pre = BAND_PINS[name]
        return run(name, lambda: aln.extend_batch(pairs), pairs,
                   list(full) if kind == "cigar" else full, kind, aln,
                   cells=band_cells(pairs, W),
                   prefix=(n, list(pre) if kind == "cigar" else pre),
                   sample=sample)

    # the CPU route takes seconds a long pair: sample the shortest one,
    # in the CIGAR runs (whose forward gives the score runs' records too)
    # and the approx run
    shortest = [int(np.argmin([len(t) for _, t in long]))]

    # the batched route on the short-banded workload (-w100 -z100), EQX
    # CIGARs and two-piece end_bonus scores on the mixed pairs <= 1536 bp;
    # the end_bonus run is held against the same pairs' two-piece scores
    # without end_bonus on the strips route, taken here, before the path
    SW = SHORT_BANDED_W
    sbat = {
        "short_banded_score": Aligner(w=SW, zdrop=100, flag=Flag.SCORE_ONLY),
        "short_banded_extd_score": Aligner(q2=q2, e2=e2, w=SW, zdrop=100,
                                           flag=Flag.SCORE_ONLY),
        "short_banded_approx_score": Aligner(w=SW, zdrop=100,
                                             flag=Flag.SCORE_ONLY | approx),
        "short_banded_cigar": Aligner(w=SW, zdrop=100),
        "short_banded_extd_cigar": Aligner(q2=q2, e2=e2, w=SW, zdrop=100),
    }
    wide = batch_wide_aligners()
    eqx = wide["short1536_eqx_cigar"]
    bonus = wide["short1536_extd_end_bonus_score"]
    ref_bonus = [_fields9(ez) for ez in scorer2.extend_batch(short1536)]

    def same9(out):
        return sum(_fields9(a) == b for a, b in zip(out, ref_bonus))

    def sb_run(name, kind):
        aln = sbat[name]
        full, pre = BATCH_PINS[name]
        cig = kind == "cigar"
        return run(name, lambda: aln.extend_batch(sb), sb,
                   list(full) if cig else full, kind, aln,
                   cells=band_cells(sb, SW),
                   prefix=(SHORT_BANDED_PREFIX, list(pre) if cig else pre))
    # the splice path on the 1024-pair workload at -x splice costs:
    # unannotated on the strips route (the bench's anchor, CIGARs, scores
    # and 4 async handles in flight), annotated (every pair with its
    # junction track, junc_bonus 9) on the batched exts route (spec pins)
    T, SPL, SO = SPLICE_TILES, Flag.SPLICE_FOR, Flag.SCORE_ONLY
    spl4 = spl * T
    junc4 = [splice_junc()] * len(spl4)
    s_cig, s_score = splice_aligner(SPL), splice_aligner(SPL | SO)
    j_cig = splice_aligner(SPL, SPLICE_JUNC_BONUS)
    j_score = splice_aligner(SPL | SO, SPLICE_JUNC_BONUS)
    s_anchor = [T * SPLICE_ANCHOR[0], T * SPLICE_ANCHOR[1]]
    (jc_full, jc_pre), (js_full, js_pre) = (SPLICE_PINS["splice_junc_cigar"],
                                            SPLICE_PINS["splice_junc_score"])

    def stream4():
        hs = [s_cig.extend_batch_async(spl4) for _ in range(4)]
        return [_got(h.result(), "cigar") for h in hs]
    # splice-wide (annotated reads of 871 bp with exons of several hundred
    # bases, at -x splice costs, junc_bonus 9): the route sends every
    # bucket to kernel 6's wide form at ncol 896, one launch a batch
    from ksw2_tpu_torch.ops.batch_exts import exts_form
    swide = splice_wide_jobs()
    wjunc = [splice_wide_junc()] * len(swide)
    for flag in (SPL, SPL | SO):
        got = [(route, ln.ncol, exts_form(ln.ncol, ln.prm.m))
               for route, ln in splice_launches(swide, flag, wjunc,
                                                SPLICE_JUNC_BONUS)]
        if got != [("batch", SPLICE_WIDE_NCOL, 0)]:
            raise AssertionError(f"splice-wide's launches (route, ncol, "
                                 f"form): {got}")
    (wc_full, wc_pre), (ws_full, ws_pre) = (
        SPLICE_WIDE_PINS["splice_wide_junc_cigar"],
        SPLICE_WIDE_PINS["splice_wide_junc_score"])
    not_splice = ("rows_fwd", "band_fwd", "band_extd_fwd", "batch_fwd",
                  "batch_extd_fwd")

    # the single-pair engine: the 50 kb pair through Aligner.extend (exact
    # score, -sg, CIGAR) and extend_batch (scores: the any-device route),
    # the MT-length pair (CIGAR and EXTZ_ONLY CIGAR at -z100, whole and
    # cut to MT_PREFIX bp) and the sr-extension batch (EXTZ_ONLY CIGARs
    # at -w100 -z100 --end-bonus 10 on the short-banded workload); none
    # is sampled against the CPU route but sr-extension (the plain
    # forward takes minutes on a long pair; the pins are the spec's)
    SO = Flag.SCORE_ONLY
    only_extz = ("strips_fwd", "strips_walk", "rows_fwd", "band_fwd",
                 "band_extd_fwd", "band_walk", "batch_fwd", "batch_extd_fwd",
                 "batch_exts_fwd")
    s_alns = {"single_score": Aligner(flag=SO),
              "single_sg": Aligner(flag=SO | approx),
              "single_cigar": Aligner(),
              "single_mt_cigar": Aligner(zdrop=100),
              "single_mt_extz_cigar": Aligner(zdrop=100, end_bonus=END_BONUS,
                                              flag=Flag.EXTZ_ONLY)}
    mt_cut = (mt[0][:MT_PREFIX], mt[1][:MT_PREFIX])

    def single_run(name, pair, pin, run_name=None):
        # no aln: extend_batch, which the run would time besides, takes
        # the strips route for the cut MT pair
        aln = s_alns[name]
        cig = not aln.flag & SO
        return run(run_name or name, lambda: [aln.extend(*pair)], [pair],
                   list(pin), lambda out: list(single_pin(out[0], cig)))
    sr_aln = Aligner(w=SW, zdrop=100, end_bonus=END_BONUS,
                     flag=Flag.EXTZ_ONLY)
    sr_full, sr_pre = SINGLE_PINS["sr_extension"]

    # the single-pair two-piece and splice engines (kernels 13 and 14,
    # walked by 17): the 50 kb pair at -O4,13 -E2,1 through Aligner.extend
    # (exact score, -sg, CIGAR) and extend_batch (scores over 3072), the
    # sr extension at -x sr's costs (EXTZ_ONLY CIGARs and scores), the
    # splice workload's end extensions (EXTZ_ONLY; EXTZ_ONLY|RIGHT|
    # REV_CIGAR) and the 64 annotated 2-12 kb spliced pairs (CIGARs,
    # scores, and the first 16 pairs' CIGARs cut to 2 kb)
    X = Flag.EXTZ_ONLY
    single_kernels = ("extz_fwd", "extd_fwd", "exts_fwd")
    kernels = ("strips_fwd", "strips_walk", "rows_fwd", "band_fwd",
               "band_extd_fwd", "band_walk", "batch_fwd", "batch_extd_fwd",
               "batch_exts_fwd") + single_kernels + ("extz_walk",)
    only_extz += ("extd_fwd", "exts_fwd")

    def only(*names):
        return names, tuple(k for k in kernels if k not in names)
    d_alns = {"single_extd_score": Aligner(q=q, e=e, q2=q2, e2=e2, flag=SO),
              "single_extd_sg": Aligner(q=q, e=e, q2=q2, e2=e2,
                                        flag=SO | approx),
              "single_extd_cigar": Aligner(q=q, e=e, q2=q2, e2=e2)}

    def single2_run(name):
        aln = d_alns[name]
        cig = not aln.flag & SO
        return run(name, lambda: [aln.extend(*single)], [single],
                   list(SINGLE2_PINS[name][0]),
                   lambda out: list(single_pin(out[0], cig)))

    def pin_run(name, aln, pairs, n=None, juncs=None, tiles=1, sample=None,
                cells=None):
        # the pin's whole (times ``tiles`` for a tiled workload) and, with
        # ``n``, its first ``n`` pairs'
        full, pre = SINGLE2_PINS[name]
        return run(name, lambda: aln.extend_batch(pairs, juncs=juncs), pairs,
                   [tiles * v for v in full], lambda out: list(sr_pin(out)),
                   aln, cells=cells, prefix=n and (n, list(pre)),
                   sample=sample, juncs=juncs)
    srd = {"sr_extd_cigar": sr_extd_aligner(X),
           "sr_extd_score": sr_extd_aligner(X | SO)}
    ends = {"splice_ends_cigar": splice_aligner(Flag.SPLICE_FOR | X),
            "splice_ends_left_cigar": splice_aligner(
                Flag.SPLICE_FOR | X | Flag.RIGHT | Flag.REV_CIGAR)}
    lpairs, ljuncs = slong
    cpairs, cjuncs = cut_jobs(lpairs[:SPLICE_LONG_PREFIX],
                              ljuncs[:SPLICE_LONG_PREFIX], SPLICE_LONG_CUT)
    lal = {"splice_long_cigar": splice_aligner(Flag.SPLICE_FOR,
                                               SPLICE_JUNC_BONUS),
           "splice_long_score": splice_aligner(Flag.SPLICE_FOR | SO,
                                               SPLICE_JUNC_BONUS)}
    # the CPU route takes seconds a 2 kb spliced pair: sample the two
    # shortest (of the cut pairs, the first two)
    lshort = [int(i) for i in np.argsort([len(t) for _, t in lpairs])[:2]]
    paths = [
        ("splice", [
            run("splice1024_cigar", lambda: s_cig.extend_batch(spl4), spl4,
                s_anchor, "cigar", s_cig,
                prefix=(len(spl), list(SPLICE_ANCHOR))),
            run("splice1024_score", lambda: s_score.extend_batch(spl4), spl4,
                T * SPLICE_ANCHOR[0], aln=s_score),
            run("stream4_splice1024_cigar", stream4, spl4, [s_anchor] * 4,
                "stream", batches=4)],
         ("strips_fwd", "strips_walk"),
         not_splice + ("batch_exts_fwd", "band_walk")),
        ("splice_annotated", [
            run("splice1024_junc_cigar",
                lambda: j_cig.extend_batch(spl4, juncs=junc4), spl4,
                [T * jc_full[0], T * jc_full[1]], "cigar", j_cig,
                prefix=(SPLICE_PREFIX, list(jc_pre)), juncs=junc4),
            run("splice1024_junc_score",
                lambda: j_score.extend_batch(spl4, juncs=junc4), spl4,
                T * js_full, aln=j_score, prefix=(SPLICE_PREFIX, js_pre),
                juncs=junc4)],
         ("batch_exts_fwd", "band_walk"),
         not_splice + ("strips_fwd", "strips_walk")),
        ("splice_wide", [
            run("splice_wide_junc_cigar",
                lambda: j_cig.extend_batch(swide, juncs=wjunc), swide,
                list(wc_full), "cigar", j_cig,
                prefix=(SPLICE_PREFIX, list(wc_pre)), sample=[0, 255],
                juncs=wjunc),
            run("splice_wide_junc_score",
                lambda: j_score.extend_batch(swide, juncs=wjunc), swide,
                ws_full, aln=j_score, prefix=(SPLICE_PREFIX, ws_pre),
                sample=[], juncs=wjunc)],
         ("batch_exts_fwd", "band_walk"),
         not_splice + ("strips_fwd", "strips_walk")),
        ("extz", [
            run("mixed512_score", lambda: scorer.extend_batch(jobs), jobs,
                MIXED_SCORE, aln=scorer),
            run("mixed2048_score", lambda: scorer.extend_batch(prod), prod,
                4 * MIXED_SCORE),
            run("stream8_mixed512_score", stream8(scorer), jobs,
                [MIXED_SCORE] * 8, "stream", batches=8),
            run("short1536_cigar", lambda: cigar.extend_batch(short1536),
                short1536, list(SHORT_CIGAR), "cigar", cigar),
            run("whale_cigar", lambda: cigar.extend_batch(whale), whale,
                list(WHALE_CIGAR), "cigar", cigar)],
         ("strips_fwd", "strips_walk"), ("band_fwd", "band_walk")),
        ("extd", [
            run("mixed512_extd_score", lambda: scorer2.extend_batch(jobs),
                jobs, MIXED_EXTD_SCORE, aln=scorer2),
            run("stream8_mixed512_extd_score", stream8(scorer2), jobs,
                [MIXED_EXTD_SCORE] * 8, "stream", batches=8),
            run("whale_extd_cigar", lambda: cigar2.extend_batch(whale),
                whale, list(WHALE_EXTD_CIGAR), "cigar", cigar2)],
         ("strips_fwd", "strips_walk"), ("band_extd_fwd", "band_walk")),
        ("rows", [
            run("short_rows_score", lambda: scorer.extend_batch(short),
                short, SHORT_ROWS_SCORE, aln=scorer)],
         ("rows_fwd",), ("strips_fwd",)),
        ("band", [
            band_run("long_score", long, "score", []),
            band_run("long_extd_score", long, "score", []),
            band_run("long_approx_score", long, "score", shortest),
            band_run("long_cigar", long, "cigar", shortest),
            band_run("long_extd_cigar", long, "cigar", shortest)],
         ("band_fwd", "band_extd_fwd", "band_walk"),
         ("strips_fwd", "strips_walk", "rows_fwd")),
        ("mixed751", [
            band_run("mixed751_score", jobs, "score"),
            band_run("mixed751_cigar", jobs, "cigar")],
         ("strips_fwd", "strips_walk", "band_fwd", "band_walk"), ()),
        ("batch", [
            sb_run("short_banded_score", "score"),
            sb_run("short_banded_extd_score", "score"),
            sb_run("short_banded_approx_score", "score"),
            sb_run("short_banded_cigar", "cigar"),
            sb_run("short_banded_extd_cigar", "cigar"),
            run("short1536_eqx_cigar", lambda: eqx.extend_batch(short1536),
                short1536, list(SHORT_CIGAR) + [0], _eqx_merged, eqx),
            run("short1536_extd_end_bonus_score",
                lambda: bonus.extend_batch(short1536), short1536,
                len(short1536), same9, bonus)],
         ("batch_fwd", "batch_extd_fwd", "band_walk"),
         ("strips_fwd", "strips_walk", "rows_fwd", "band_fwd",
          "band_extd_fwd")),
        ("single", [
            single_run("single_score", single, SINGLE_PINS["single_score"]),
            single_run("single_sg", single, SINGLE_PINS["single_sg"]),
            single_run("single_cigar", single, SINGLE_PINS["single_cigar"]),
            run("single_batch_score",
                lambda: s_alns["single_score"].extend_batch([single]),
                [single], list(SINGLE_PINS["single_score"]),
                lambda out: list(single_pin(out[0], False)),
                s_alns["single_score"], sample=[])],
         ("extz_fwd", "extz_walk"), only_extz),
        ("single_mt", [
            single_run(name, pair, SINGLE_PINS[name][k], name + suffix)
            for name in ("single_mt_cigar", "single_mt_extz_cigar")
            for k, pair, suffix in ((0, mt, ""), (1, mt_cut, "_2kb"))],
         ("extz_fwd", "extz_walk"), only_extz),
        ("sr_extension", [
            run("sr_extension_cigar", lambda: sr_aln.extend_batch(sb), sb,
                list(sr_full), lambda out: list(sr_pin(out)), sr_aln,
                cells=band_cells(sb, SW),
                prefix=(SR_PREFIX, list(sr_pre)))],
         ("extz_fwd", "extz_walk"), only_extz),
        ("single_extd", [
            single2_run("single_extd_score"),
            single2_run("single_extd_sg"),
            single2_run("single_extd_cigar"),
            run("single_extd_batch_score",
                lambda: d_alns["single_extd_score"].extend_batch([single]),
                [single], list(SINGLE2_PINS["single_extd_score"][0]),
                lambda out: list(single_pin(out[0], False)),
                d_alns["single_extd_score"], sample=[])],
         *only("extd_fwd", "extz_walk")),
        ("sr_extension_extd", [
            pin_run(name, aln, sb, SR_PREFIX, cells=band_cells(sb, SW))
            for name, aln in srd.items()],
         *only("extd_fwd", "extz_walk")),
        ("splice_ends", [
            pin_run(name, aln, spl4, SPLICE_ENDS_PREFIX, tiles=T)
            for name, aln in ends.items()],
         *only("exts_fwd", "extz_walk")),
        ("splice_long", [
            pin_run(name, aln, lpairs, juncs=ljuncs, sample=lshort)
            for name, aln in lal.items()] + [
            run("splice_long_cigar_2kb",
                lambda: lal["splice_long_cigar"].extend_batch(
                    cpairs, juncs=cjuncs), cpairs,
                list(SINGLE2_PINS["splice_long_cigar"][1]),
                lambda out: list(sr_pin(out)), lal["splice_long_cigar"],
                sample=[0, 1], juncs=cjuncs)],
         *only("exts_fwd", "extz_walk")),
    ]
    # the earlier paths launch none of the new forms
    for k, (path, spec, needs, never) in enumerate(paths):
        if not set(needs) & {"extd_fwd", "exts_fwd"}:
            paths[k] = (path, spec, needs,
                        tuple(never) + ("extd_fwd", "exts_fwd"))

    # the linear-gap and global engines' paths; no earlier path launches
    # their kernels
    lg_kernels = ("batch_extf_fwd", "extf_fwd", "batch_gg2_fwd", "gg2_fwd")
    paths = [(path, spec, needs, tuple(never) + lg_kernels)
             for path, spec, needs, never in paths]
    paths += lg_paths(jobs, single, mt, kernels + lg_kernels)
    # the local paths; no earlier path launches kernel 18
    paths = [(path, spec, needs, tuple(never) + ("batch_local_fwd",))
             for path, spec, needs, never in paths]
    paths += local_paths(kernels + lg_kernels)
    plan = single_launch_plan(sb, spl4, slong)
    # splice-wide: one kernel-6 launch a batch in each run, one walk in
    # the CIGAR run's
    plan["splice_wide"] = {"batch_exts_fwd": 2, "band_walk": 1}
    plan.update(band_launch_plan(band, long, jobs))
    plan.update(batch_launch_plan({
        **{name: (aln, sb) for name, aln in sbat.items()},
        **{name: (aln, short1536) for name, aln in wide.items()}}))
    # kernel A: one launch a score batch (the batch's strips buckets
    # merged), one a bucket for CIGARs
    strips_plan = strips_launch_plan([
        ("extz", scorer, jobs, 5), ("extz", scorer, prod, 4),
        ("extz", scorer, jobs, 32), ("extz", cigar, short1536, 5),
        ("extz", cigar, whale, 5), ("extd", scorer2, jobs, 5),
        ("extd", scorer2, jobs, 32), ("extd", cigar2, whale, 5)])
    emit({"phase": "launch_plan", "per_batch": plan,
          "strips_fwd_per_path": strips_plan})
    counts = {}
    runs = {}
    results = {}
    for path, spec, needs, never in paths:
        c, r, res = _path(path, spec, needs, never)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        runs[path] = r
        results.update(res)
        # each run's 5 batches (the first, 3 timed, the submit/wait one)
        # launch each kernel once for each LAUNCH_BYTES of the batch's
        # single-pair buffers or band stores, whatever their buckets
        if path in plan:
            want = {k: 5 * v for k, v in plan[path].items()}
            got = {k: c.get(k, 0) for k in want}
            if got != want:
                raise AssertionError(f"{path}: {got} launches, planned "
                                     f"{want}")
        if path in strips_plan and \
                c.get("strips_fwd", 0) != strips_plan[path]:
            raise AssertionError(f"{path}: {c.get('strips_fwd', 0)} "
                                 f"strips_fwd launches, planned "
                                 f"{strips_plan[path]}")

    return counts, runs, results


def oracle_tasks(results):
    """The main path's sampled pairs, one pool task a run (see
    :func:`oracle_refs`): ``sample`` or 8 random pairs of the run."""
    rng = np.random.default_rng(16)
    tasks = []
    for name, (pairs, ezs, aln, sample, juncs) in results.items():
        idx = sample if sample is not None else \
            rng.choice(len(pairs), min(8, len(pairs)), replace=False)
        if len(idx) == 0:
            continue
        idx = [int(i) for i in idx]
        kw = dict(q=aln.q, e=aln.e, q2=aln.q2, e2=aln.e2, w=aln.w,
                  zdrop=aln.zdrop, end_bonus=aln.end_bonus, flag=aln.flag,
                  m=aln.m, mat=aln.mat, splice=aln.splice,
                  noncan=aln.noncan, junc_bonus=aln.junc_bonus,
                  device="cpu")
        tasks.append(("oracle", name, kw, idx, [pairs[i] for i in idx],
                      None if juncs is None else [juncs[i] for i in idx]))
    return tasks


def _oracle_fields(ez):
    return _fields9(ez) + (list(ez.cigar),)


def oracle_refs(kw, pairs, juncs):
    """The pairs through the port's plain CPU route (which the CPU test
    suite holds against the JAX package and the NumPy spec)."""
    from ksw2_tpu_torch import Aligner

    return [_oracle_fields(r)
            for r in Aligner(**kw).extend_batch(pairs, juncs=juncs)]


def oracle_check(results, tasks, refs):
    """Each sampled pair's card result against its CPU reference."""
    checked = 0
    for _, name, _, idx, _, _ in tasks:
        ezs = results[name][1]
        for i, b in zip(idx, refs[name]):
            a = _oracle_fields(ezs[i])
            if a != b:
                raise AssertionError(f"{name} pair {i}: GPU {a[:9]} vs "
                                     f"CPU {b[:9]}")
            checked += 1
    emit({"phase": "oracle", "pairs_checked": checked,
          "runs": sorted(results),
          "against": "Aligner(device='cpu') plain route"})


def phase_profile(long, sb, spl, jobs, mt):
    """Device time by kernel over one score batch and one CIGAR batch of
    the long-banded (-w751 -z400) and of the short-banded (-w100 -z100)
    workloads, one CIGAR batch of the splice workload unannotated and
    annotated, the sr-extension CIGAR batch (one- and two-piece), the
    splice-ends CIGAR batch, the mixed-512 and mixed-2048 score batches
    (one- and two-piece mixed-512) and the whale CIGAR batch, the MT
    pair's global alignment and the two CLI runs (torch.profiler),
    beside the run's host wall and the device's idle share of it."""
    from ksw2_tpu_torch import Aligner
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.batch_local import local_batch_device

    runs = []
    for name, aln, pairs in (
            ("long_score", Aligner(w=BAND_W, zdrop=400,
                                   flag=Flag.SCORE_ONLY), long),
            ("long_cigar", Aligner(w=BAND_W, zdrop=400), long),
            ("short_banded_score", Aligner(w=SHORT_BANDED_W, zdrop=100,
                                           flag=Flag.SCORE_ONLY), sb),
            ("short_banded_cigar", Aligner(w=SHORT_BANDED_W, zdrop=100),
             sb),
            ("splice_cigar", splice_aligner(Flag.SPLICE_FOR),
             spl * SPLICE_TILES),
            ("splice_junc_cigar", splice_aligner(Flag.SPLICE_FOR,
                                                 SPLICE_JUNC_BONUS),
             spl * SPLICE_TILES),
            ("sr_extension_cigar", Aligner(w=SHORT_BANDED_W, zdrop=100,
                                           end_bonus=END_BONUS,
                                           flag=Flag.EXTZ_ONLY), sb),
            ("sr_extension_extd_cigar", sr_extd_aligner(Flag.EXTZ_ONLY),
             sb),
            ("splice_ends_cigar",
             splice_aligner(Flag.SPLICE_FOR | Flag.EXTZ_ONLY),
             spl * SPLICE_TILES)):
        juncs = [splice_junc()] * len(pairs) if "junc" in name else None
        runs.append((name, lambda aln=aln, pairs=pairs, juncs=juncs:
                     aln.extend_batch(pairs, juncs=juncs)))
    # kernel A's score batches (one strips launch each) and the whale
    # CIGAR batch: is a batch bound by kernel A?
    q, e, q2, e2 = EXTD
    scorer = Aligner(a=2, b=4, q=4, e=2, zdrop=100, flag=Flag.SCORE_ONLY)
    scorer2 = Aligner(a=2, b=4, q=q, e=e, q2=q2, e2=e2, zdrop=100,
                      flag=Flag.SCORE_ONLY)
    cigar = Aligner(a=2, b=4, q=4, e=2, zdrop=100)
    whale = [p for p in jobs if len(p[1]) > 2048]
    prod = jobs * 4
    runs += [("mixed512_score", lambda: scorer.extend_batch(jobs)),
             ("mixed2048_score", lambda: scorer.extend_batch(prod)),
             ("mixed512_extd_score", lambda: scorer2.extend_batch(jobs)),
             ("whale_cigar", lambda: cigar.extend_batch(whale))]
    glob = Aligner()
    runs.append(("single_gg2_mt", lambda: glob.global_align(*mt)))
    files = cli_files(jobs)
    runs += [(name, cli_lines(name, files)) for name in CLI_BATCH_ARGS]
    a, b, q, e = LOCAL_COSTS
    lmat = simple_mat(5, a, -b)
    l64k = local_sets()["local_64k"]
    runs.append(("local_64k", lambda: local_batch_device(*l64k, 5, lmat, q,
                                                         e)))
    out = profile_runs(runs)
    emit({"phase": "profile", "runs": out})
    return out


def profile_runs(runs):
    """Each (name, fn) of ``runs`` once warm and once under
    torch.profiler: its host wall, its device time by kernel and in all,
    and the device's idle share of the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in runs:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
        rows = {}
        busy = 0.0
        for ev in prof.key_averages():
            dev = getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0))
            if dev > 0:
                rows[ev.key[:60]] = round(dev / 1e3, 3)
                # busy time is the card's own activities (kernels, copies,
                # fills): an operator's device time (aten::copy_) repeats
                # its copy's, and the profiler's buffer requests are its
                # own overhead
                if ev.device_type == DeviceType.CUDA and \
                        not ev.key.startswith("Activity Buffer"):
                    busy += dev / 1e3
        out[name] = {"wall_ms": wall * 1e3,
                     "device_ms_by_name": dict(sorted(
                         rows.items(), key=lambda kv: -kv[1])[:8]),
                     "device_ms": round(busy, 3),
                     "idle_share": round(1 - busy / (wall * 1e3), 4)}
    return out


def bound(name, ops_units, nbytes, int_rate, cig=False):
    """(bound_ms, bound_by): the larger of the operations over the card's
    int32 rate and the bytes over its memory rate; ``cig`` counts the
    direction byte of a forward that writes bytes."""
    ops = OPS[name] + (BYTE_OPS.get(name, 0) if cig else 0)
    t_ops = ops * ops_units / int_rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pair_steps(res, runs):
    """Each pair's steps in one walk's ``(res, runs)``: the summed
    lengths of the runs it wrote (``res[:, 2]`` of them)."""
    n = res[:, 2].cpu().numpy().astype(np.int64)
    r = runs.cpu().numpy()
    return np.array([(r[b, :n[b]].astype(np.int64) >> 4).sum()
                     for b in range(len(n))], np.int64)


def walk_work(res, runs, per_pair):
    """(steps, bytes) of one walk on this run's data: the steps are the
    summed lengths of its runs, each reading one direction byte; the
    bytes add one int32 for each run written (``res[:, 2]``, the runs a
    pair wrote) and ``per_pair`` bytes of start cell and result."""
    n = res[:, 2].cpu().numpy().astype(np.int64)
    steps = int(pair_steps(res, runs).sum())
    return steps, steps + 4 * int(n.sum()) + per_pair * len(n)


def walks_work(outs, per_pair):
    """:func:`walk_work` summed over several walks' ``(res, runs)``."""
    work = [walk_work(res, runs, per_pair) for res, runs in outs]
    return sum(s for s, _ in work), sum(b for _, b in work)


def band_work(ln, rec):
    """(cells, bytes) of one band forward on this run's data: the true
    band cells of the diagonals each pair computed (a pair that Z-dropped
    counts to its best cell's diagonal, a lower bound) and the bytes read
    and written once, the stored direction rows included."""
    from ksw2_tpu_torch.ops.bands import band_bounds, first_empty_diag

    rec = rec.cpu().numpy()
    cells = nbytes = 0
    for b in range(len(ln.qlen)):
        ql, tl, w = int(ln.qlen[b]), int(ln.tlen[b]), int(ln.w[b])
        stop = int(first_empty_diag(ql, tl, w))
        if rec[b, 8] and rec[b, 1] >= 0:
            stop = min(stop, int(rec[b, 1] + rec[b, 2]) + 1)
        st0, en0 = band_bounds(stop, ql, tl, w)
        cells += int(np.maximum(0, en0 - st0 + 1).sum())
        nbytes += ql + tl + 12 + 36 + (stop * ln.ncol if ln.prm.cig else 0)
    return cells, nbytes


def exts_work(ln, rec):
    """(cells, bytes) of one batched exts forward on this run's data: the
    matrix cells of the diagonals each pair computed (a pair that
    Z-dropped counts to its best cell's diagonal, a lower bound) and the
    bytes read and written once: query, target, donor and acceptor rows,
    the records and the stored direction rows."""
    rec = rec.cpu().numpy()
    cells = nbytes = 0
    for b in range(len(ln.qlen)):
        ql, tl = int(ln.qlen[b]), int(ln.tlen[b])
        stop = ql + tl - 1
        if rec[b, 8] and rec[b, 1] >= 0:
            stop = min(stop, int(rec[b, 1] + rec[b, 2]) + 1)
        r = np.arange(stop)
        cells += int((np.minimum(tl - 1, r) - np.maximum(0, r - ql + 1)
                      + 1).sum())
        nbytes += ql + 3 * tl + 36 + (stop * ln.ncol if ln.prm.cig else 0)
    return cells, nbytes


def splice_times(scases, int_rate):
    """The splice kernels at the main path's shape: the one launch of each
    form the scheduler makes of the 1024-pair workload (strips spl
    forward and nop walker unannotated, kernel 6 and the band walker with
    min_intron annotated) and of splice-wide (kernel 6's wide form and
    the band walker) beside their bounds and the plain versions' times
    from phase 5d (the walkers' on a launch's first 256 pairs, where the
    kernel is timed on the same 256; splice-wide's ran in the pool, on
    ``SPLICE_WIDE_PLAIN_PAIRS`` of its pairs, and phase 5d's line has
    them)."""
    import torch
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch_exts as BE
    from ksw2_tpu_torch.ops import strips as S
    from ksw2_tpu_torch.ops import strips_walker as W

    out = {}
    for name, route, ln in scases:
        if not name.startswith(("main", "wide")):
            continue
        row = {"route": route, "pairs": len(ln.qlen)}
        if route == "strips":
            qs, ts, ql, tl, tab = S.upload(ln, "cuda")
            sites = S.site_rows(ln, "cuda")
            B = qs.shape[0]
            row.update(kernel="strips_fwd (spl)",
                       **kernel_a_row(name, ln, int_rate))
            if ln.prm.cig:
                D, Dq, hl, d8 = fwd_call(name, ln, (qs, ts, ql, tl, tab),
                                         sites)()
                rec = S.replay_records(ln.prm, D, Dq, hl, ql, tl)
                n = min(256, B)
                starts = W.start_cells(rec, ql, tl, ln.prm.flag, 0)[:n]
                d8 = d8[:n].contiguous()
                mi = W.walk_min_intron(ln.prm.lt, ln.prm.spl)
                row["walk_pairs"] = n
                row["walk_ms"] = cuda_ms(
                    lambda: W.strips_walk_cuda(d8, starts, mi), 5)
                row["walk_plain_ms"] = PLAIN_MS[(name, "walk")]
                steps, nbytes = walk_work(
                    *W.strips_walk_cuda(d8, starts, mi), 20)
                row["walk_steps"] = steps
                row["walk_bound_ms"], row["walk_bound_by"] = bound(
                    "strips_walk", steps, nbytes, int_rate)
                del d8, D, Dq, hl
        else:
            args = BD.band_upload(ln, "cuda")
            _, _, ql, tl, w = args[:5]
            row.update(kernel="batch_exts_fwd", nd=ln.nd, ncol=ln.ncol,
                       Lt=int(ln.target.shape[1]),
                       form=BE.exts_form(ln.ncol, ln.prm.m) or "wide")

            def fwd():
                return BE.batch_exts_forward_cuda(*args, ln.prm, ln.nd,
                                                  ln.ncol)
            row["fwd_ms"] = cuda_ms(fwd, 5)
            row["fwd_plain_ms"] = PLAIN_MS.get((name, "fwd"))
            rec, p = fwd()
            cells, nbytes = exts_work(ln, rec)
            row["computed_cells"] = cells
            row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
                "batch_exts_fwd", cells, nbytes, int_rate, ln.prm.cig)
            if ln.prm.cig:
                n = min(256, len(ln.qlen))
                sub = (p[:n].contiguous(),
                       W.start_cells(rec, ql, tl, ln.prm.flag, 0)[:n],
                       ql[:n], tl[:n], w[:n],
                       W.walk_min_intron(ln.prm.lt, True))
                row["walk_pairs"] = n
                row["walk_ms"] = cuda_ms(lambda: BW.band_walk_cuda(*sub), 5)
                row["walk_plain_ms"] = PLAIN_MS.get((name, "walk"))
                steps, nbytes = walk_work(*BW.band_walk_cuda(*sub), 20)
                row["walk_steps"] = steps
                row["walk_bound_ms"], row["walk_bound_by"] = bound(
                    "band_walk", steps, nbytes, int_rate)
                del sub
            del p
        row["fwd_gcells_per_s"] = row.get("cells", row.get(
            "computed_cells")) / row["fwd_ms"] / 1e6
        out[name] = row
        torch.cuda.empty_cache()
    return out


def extz_work(ln, stop, cig, sites=False):
    """(cells, bytes) of one single-pair forward on this run's data: the
    true band cells of the diagonals each pair computed up to its stop,
    and the bytes read and written once (sequences, ``sites``' donor and
    acceptor rows, records, the store's rows)."""
    from ksw2_tpu_torch.ops.bands import band_bounds
    from ksw2_tpu_torch.ops.extz_fwd import row_off

    stop = stop.cpu().numpy()
    cells = nbytes = 0
    for b in range(len(ln.qlen)):
        ql, tl, w = int(ln.qlen[b]), int(ln.tlen[b]), int(ln.w[b])
        st0, en0 = band_bounds(int(stop[b]), ql, tl, w)
        cells += int(np.maximum(0, en0 - st0 + 1).sum())
        nbytes += ql + tl + 12 + 36 + (2 * tl if sites else 0)
        if cig:
            nbytes += int(row_off(int(stop[b]), ql, tl, w)[0])
    return cells, nbytes


def single_times(single, mt, sb, int_rate):
    """Kernels 12 and 17 at the main path's shapes: the 50 kb pair's one
    launch in each form (score, -sg, CIG; walker on the CIG bytes), the
    MT pair's (CIG and EXTZ_ONLY CIG at -z100, as ``Aligner.extend`` makes
    them) and the launches the scheduler makes of the sr-extension
    workload, timed together as the path runs them, beside their bounds,
    with microseconds a diagonal on the long pairs; the plain versions'
    times on the sr-extension launches come from phase 5e (on the long
    pairs the plain forward would take minutes)."""
    import torch
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import extz_fwd as F
    from ksw2_tpu_torch.ops import strips_walker as W
    from ksw2_tpu_torch.ops import traceback_device as TB

    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    out = {}
    for name, lns, eb, reps in (
            ("single50k_score",
             [extz_launch([single], [-1], Flag.SCORE_ONLY, -1)], 0, 3),
            ("single50k_sg", [extz_launch([single], [-1],
                                          Flag.SCORE_ONLY | approx, -1)],
             0, 3),
            ("single50k_cig", [extz_launch([single], [-1], Flag.NONE, -1)],
             0, 2),
            ("mt_cig", [extz_launch([mt], [-1], Flag.NONE, 100)], 0, 3),
            ("mt_extz_cig", [extz_launch([mt], [-1], Flag.EXTZ_ONLY, 100)],
             END_BONUS, 3),
            ("sr_extz_cig", sr_launches(sb), END_BONUS, 5)):
        args = [BD.band_upload(ln, "cuda") for ln in lns]
        cig = bool(lns[0].prm.cig)
        row = {"pairs": sum(len(ln.qlen) for ln in lns),
               "launches": [{"pairs": len(ln.qlen), "tp": ln.lay.tp,
                             "tiles": int(ln.lay.tbase[-1]),
                             "rows": ln.lay.n_diag, "bytes": ln.lay.n_bytes}
                            for ln in lns]}

        def fwd(lns=lns, args=args):
            return [F.extz_forward_cuda(*a, ln.prm, ln.lay)
                    for a, ln in zip(args, lns)]
        row["fwd_ms"] = cuda_ms(fwd, reps)
        outs = fwd()
        work = [extz_work(ln, stop, cig)
                for ln, (_, _, stop) in zip(lns, outs)]
        row["computed_cells"] = sum(c for c, _ in work)
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
            "extz_fwd", row["computed_cells"], sum(b for _, b in work),
            int_rate, cig)
        row["fwd_gcells_per_s"] = row["computed_cells"] / row["fwd_ms"] / 1e6
        if not name.startswith("sr"):
            row["us_per_diag"] = row["fwd_ms"] * 1e3 / int(lns[0].lay.rlim[0])
        if name.startswith("sr"):
            row["fwd_plain_ms"] = sum(PLAIN_MS[(f"sr_launch{k}", "fwd")]
                                      for k in range(len(lns)))
        if cig:
            walks = []
            for (rec, p, _), a, ln in zip(outs, args, lns):
                _, _, ql, tl, w = a[:5]
                walks.append((p, torch.from_numpy(ln.lay.pbase).cuda(),
                              W.start_cells(rec, ql, tl, ln.prm.flag, eb),
                              ql, tl, w,
                              ln.query.shape[1] + ln.target.shape[1] + 2))
            row["walk_ms"] = cuda_ms(
                lambda: [TB.extz_walk_cuda(*a) for a in walks], reps)
            steps, nbytes = walks_work(
                [TB.extz_walk_cuda(*a) for a in walks], 24)
            row["walk_steps"] = steps
            row["walk_bound_ms"], row["walk_bound_by"] = bound(
                "extz_walk", steps, nbytes, int_rate)
            if name.startswith("sr"):
                row["walk_plain_ms"] = sum(
                    PLAIN_MS[(f"sr_launch{k}", "walk")]
                    for k in range(len(lns)))
            del walks
        del outs, args
        out[name] = row
        torch.cuda.empty_cache()
    return out


def single2_times(single, sb, spl, slong, int_rate):
    """Kernels 13 and 14, and kernel 17 on their stores, at the main
    path's shapes: kernel 13 on the 50 kb pair's one launch in each form
    (score, -sg, CIG) and on the launches the scheduler makes of
    sr-extension-extd, kernel 14 on those of splice-ends and splice-long
    (whose cells and store bytes it prints), each timed together as the
    path runs them beside its bound; and both on the first 256 pairs of
    sr-extension-extd and splice-ends, beside their plain versions'
    times there from phase 5f."""
    import torch
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import extd as ED
    from ksw2_tpu_torch.ops import exts as ES
    from ksw2_tpu_torch.ops import strips_walker as W
    from ksw2_tpu_torch.ops import traceback_device as TB

    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    SO, X, SPL = Flag.SCORE_ONLY, Flag.EXTZ_ONLY, Flag.SPLICE_FOR
    sr = sr_extd_launches(sb, X)
    ends = splice_single_launches(spl * SPLICE_TILES, SPL | X)
    lpairs, ljuncs = slong
    longs = {f: splice_single_launches(lpairs, SPL | f, ljuncs,
                                       SPLICE_JUNC_BONUS)
             for f in (Flag.NONE, SO)}
    out = {}
    for name, kind, lns, eb, reps in (
            ("single50k_extd_score", "extd",
             [extd_launch([single], [-1], SO, -1)], 0, 3),
            ("single50k_extd_sg", "extd",
             [extd_launch([single], [-1], SO | approx, -1)], 0, 3),
            ("single50k_extd_cig", "extd",
             [extd_launch([single], [-1], Flag.NONE, -1)], 0, 2),
            ("sr_extd_cig", "extd", sr, END_BONUS, 5),
            ("sr_extd_256", "extd", [_first(sr[0], 256)], END_BONUS, 5),
            ("splice_ends_cig", "exts", ends, 0, 5),
            ("splice_ends_256", "exts", [_first(ends[0], 256)], 0, 5),
            ("splice_long_cig", "exts", longs[Flag.NONE], 0, 2),
            ("splice_long_score", "exts", longs[SO], 0, 3)):
        fn = ED.extd_forward_cuda if kind == "extd" else \
            ES.exts_forward_cuda
        args = [BD.band_upload(ln, "cuda") for ln in lns]
        cig = bool(lns[0].prm.cig)
        row = {"kernel": f"{kind}_fwd",
               "pairs": sum(len(ln.qlen) for ln in lns),
               "launches": [{"pairs": len(ln.qlen), "tp": ln.lay.tp,
                             "tiles": int(ln.lay.tbase[-1]),
                             "rows": ln.lay.n_diag, "bytes": ln.lay.n_bytes,
                             "device_bytes": ln.lay.device_bytes()}
                            for ln in lns]}

        def fwd(lns=lns, args=args, fn=fn):
            return [fn(*a, ln.prm, ln.lay) for a, ln in zip(args, lns)]
        row["fwd_ms"] = cuda_ms(fwd, reps)
        outs = fwd()
        work = [extz_work(ln, stop, cig, kind == "exts")
                for ln, (_, _, stop) in zip(lns, outs)]
        row["computed_cells"] = sum(c for c, _ in work)
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
            f"{kind}_fwd", row["computed_cells"], sum(b for _, b in work),
            int_rate, cig)
        row["fwd_gcells_per_s"] = row["computed_cells"] / row["fwd_ms"] / 1e6
        if name.startswith("single50k"):
            row["us_per_diag"] = row["fwd_ms"] * 1e3 / int(lns[0].lay.rlim[0])
        if name.endswith("_256"):
            row["fwd_plain_ms"] = PLAIN_MS[(name, "fwd")]
        if cig:
            mi = lns[0].prm.lt if kind == "exts" else 0
            walks = []
            for (rec, p, _), a, ln in zip(outs, args, lns):
                _, _, ql, tl, w = a[:5]
                walks.append((p, torch.from_numpy(ln.lay.pbase).cuda(),
                              W.start_cells(rec, ql, tl, ln.prm.flag, eb),
                              ql, tl, w,
                              ln.query.shape[1] + ln.target.shape[1] + 2,
                              mi))
            row["walk_ms"] = cuda_ms(
                lambda: [TB.extz_walk_cuda(*a) for a in walks], reps)
            steps, nbytes = walks_work(
                [TB.extz_walk_cuda(*a) for a in walks], 24)
            row["walk_steps"] = steps
            row["walk_bound_ms"], row["walk_bound_by"] = bound(
                "extz_walk", steps, nbytes, int_rate)
            if name.endswith("_256"):
                row["walk_plain_ms"] = PLAIN_MS[(name, "walk")]
            del walks
        del outs, args
        out[name] = row
        torch.cuda.empty_cache()
    return out


def kernel_a_row(name, ln, int_rate, plain=True):
    """Kernel A on case ``name``'s launch: its ms (CUDA events, the
    layout made once), cells, Gcells/s and bound, its layout, and with
    ``plain`` the plain version's ms from its kernel phase."""
    from ksw2_tpu_torch.ops import strips as S

    qs, ts, ql, tl, tab = S.upload(ln, "cuda")
    sites = S.site_rows(ln, "cuda")
    B, Lq = qs.shape
    tv = ln.prm.tv
    row = {"pairs": int(B), "Lq": int(Lq), "tv": tv}
    lay = fwd_layout(name, ln)
    if lay is not None:
        row.update(nw=lay.nw, cl=lay.cl, blocks=lay.blocks)
    row["fwd_ms"] = cuda_ms(fwd_call(name, ln, (qs, ts, ql, tl, tab),
                                     sites), 5)
    if plain:
        row["fwd_plain_ms"] = PLAIN_MS[(name, "fwd")]
    row["cells"] = int((ql.long() * tl.long()).sum())
    # inputs (symbols, lengths) and outputs (D, Dq, hl, d8) once each,
    # and a splice launch's site rows
    nbytes = B * (Lq + tv + 8 + 4 * Lq + 8 * (Lq + tv)
                  + (4 * tv if ln.prm.spl else 0)
                  + (tv * Lq if ln.prm.cig else 0))
    row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
        "strips_spl_fwd" if ln.prm.spl else "strips_fwd", row["cells"],
        nbytes, int_rate, ln.prm.cig)
    row["fwd_gcells_per_s"] = row["cells"] / row["fwd_ms"] / 1e6
    return row


def rows_times(rcases, int_rate):
    """The rows kernel (kernel 3) and kernel A alone on the rows route's
    main-path launch (the sampled cases are left out): their ms, by CUDA
    events in one process, and kernel 3's bound."""
    from ksw2_tpu_torch.ops import rows as R
    from ksw2_tpu_torch.ops import strips as S

    out = {}
    for name, ln in rcases:
        if name.startswith("short_sample"):
            continue
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        B, Lq = qs.shape
        row = {"pairs": int(B), "Lq": int(Lq), "tv": ln.prm.tv}
        row["rows_ms"] = cuda_ms(
            lambda: R.rows_forward_cuda(qs, ts, ql, tl, tab, ln.prm), 20)
        row["fwd_ms"] = cuda_ms(fwd_call(name, ln, (qs, ts, ql, tl, tab)),
                                20)
        row["cells"] = int((ql.long() * tl.long()).sum())
        row["rows_bound_ms"], row["rows_bound_by"] = bound(
            "rows_fwd", row["cells"],
            B * (Lq + ln.prm.tv + 8 + 4 * Lq + 8 * (Lq + ln.prm.tv)),
            int_rate)
        row["rows_gcells_per_s"] = row["cells"] / row["rows_ms"] / 1e6
        out[name] = row
    return out


def phase_rows_times() -> int:
    """``--rows-times``: the rows kernel and kernel A alone on the short
    pairs' launch (:func:`rows_times`); it also runs on the parent's
    tree, to compare two trees in one call."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the times need a CUDA card")
    int_rate = phase_device()
    phase_build()
    emit({"phase": "rows_times",
          "cases": rows_times(rows_cases(short_jobs()), int_rate)})
    return 0


def phase_times(cases, rcases, long, sb, scases, single, spl, slong,
                int_rate, lcases, mt, jobs):
    import torch
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import strips as S
    from ksw2_tpu_torch.ops import strips_walker as W

    out = {}
    for name, ln in cases:
        if name.startswith("sample"):
            continue
        row = kernel_a_row(name, ln, int_rate)
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        if ln.prm.cig:
            D, Dq, hl, d8 = fwd_call(name, ln, (qs, ts, ql, tl, tab))()
            rec = S.replay_records(ln.prm, D, Dq, hl, ql, tl)
            starts = W.start_cells(rec, ql, tl, ln.prm.flag, 0)
            row["walk_ms"] = cuda_ms(lambda: W.strips_walk_cuda(d8, starts),
                                     5)
            row["walk_plain_ms"] = PLAIN_MS[(name, "walk")]
            steps, nbytes = walk_work(*W.strips_walk_cuda(d8, starts), 20)
            row["walk_bound_ms"], row["walk_bound_by"] = bound(
                "strips_walk", steps, nbytes, int_rate)
        out[name] = row
    for name, row in rows_times(rcases, int_rate).items():
        row["rows_plain_ms"] = PLAIN_MS[(name, "rows")]
        out[name] = row

    # the band kernels at the long-banded shapes: the workload's shortest
    # pair cut to LONG1_CUT bp for kernel against plain (the plain forward takes milliseconds
    # a diagonal; phase 5b ran it on the same launches: case ``plain``),
    # the whole workload's one score launch for the kernels alone
    sub = long1_pair(long)
    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    for name, pairs, flag, costs, plain in (
            ("long1_extz_score", sub, Flag.SCORE_ONLY, None, None),
            ("long1_extd_score", sub, Flag.SCORE_ONLY, EXTD,
             "long1_extd_score_z400"),
            ("long1_extz_cig", sub, Flag.NONE, None, "long1_extz_cig_z400"),
            ("long128_extz_score", long, Flag.SCORE_ONLY, None, None),
            ("long128_extd_score", long, Flag.SCORE_ONLY, EXTD, None),
            ("long128_approx_score", long, Flag.SCORE_ONLY | approx, None,
             None)):
        ln = band_launch(pairs, BAND_W, flag, 400, costs)
        args = BD.band_upload(ln, "cuda")
        kname = "band_extd_fwd" if costs else "band_fwd"
        row = {"pairs": len(pairs), "nd": ln.nd, "ncol": ln.ncol,
               "kernel": kname}
        row["fwd_ms"] = cuda_ms(
            lambda: BD.band_forward_cuda(*args, ln.prm, ln.nd, ln.ncol), 3)
        rec, p = BD.band_forward_cuda(*args, ln.prm, ln.nd, ln.ncol)
        cells, nbytes = band_work(ln, rec)
        row["computed_cells"] = cells
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
            kname, cells, nbytes, int_rate, ln.prm.cig)
        row["band_cells"] = band_cells(pairs, BAND_W)
        # the launch waits on its longest pair's chain of ln.nd diagonals
        row["us_per_diagonal"] = row["fwd_ms"] * 1e3 / ln.nd
        row["fwd_band_gcells_per_s"] = row["band_cells"] / row["fwd_ms"] / 1e6
        if plain:
            row["fwd_plain_ms"] = PLAIN_MS[(plain, "fwd")]
        if ln.prm.cig:
            _, _, ql, tl, w, _ = args
            starts = W.start_cells(rec, ql, tl, ln.prm.flag, 0)
            row["walk_ms"] = cuda_ms(
                lambda: BW.band_walk_cuda(p, starts, ql, tl, w), 3)
            row["walk_plain_ms"] = PLAIN_MS[(plain, "walk")]
            steps, nbytes = walk_work(
                *BW.band_walk_cuda(p, starts, ql, tl, w), 20)
            row["walk_steps"] = steps
            row["walk_bound_ms"], row["walk_bound_by"] = bound(
                "band_walk", steps, nbytes, int_rate)
        del p
        out[name] = row
        torch.cuda.empty_cache()

    # the batched kernels at the main path's shapes (batch_times), with
    # the plain forward's time on the same launches (phase 5c) for the
    # score forms, and the host's work before the score batch's launch
    from ksw2_tpu_torch.batch import scheduler as sched
    for name, row in batch_times(int_rate).items():
        plain = {"sb_extz_score": "sb_extz_score_z100",
                 "sb_extd_score": "sb_extd_score_z100"}.get(name)
        if plain:
            row["fwd_plain_ms"] = sum(
                PLAIN_MS[(f"{plain}_launch{k}", "fwd")]
                for k in range(len(row["launches"])))
        if name == "sb_extz_score":
            # the route table on every bucket (rows, strips and band refuse
            # them), and the buckets' padding (host clock)
            _, route_s, prep_s = short_banded_launches(
                sb, Flag.SCORE_ONLY, None,
                sched._score_chooser(Flag.SCORE_ONLY, 5,
                                     simple_mat(5, 2, -4), 100, 4, 2))
            row["host_route_ms"] = route_s * 1e3
            row["host_prep_ms"] = prep_s * 1e3
        out[name] = row
    out.update(splice_times(scases, int_rate))
    out.update(single_times(single, mt, sb, int_rate))
    out.update(single2_times(single, sb, spl, slong, int_rate))
    out.update(linear_global_times(lcases, single, mt, jobs, int_rate))
    out.update(local_times(int_rate))
    emit({"phase": "times", "cases": out})
    return out


# Kernels E / E2 at the main path's launch shapes: the short-banded
# workload's launches in five forms (one launch a form since the merge)
# and the wide form's EQX CIGAR and end_bonus score launches of the mixed
# pairs of 1536 bp or less; timed alone by ``--batch-times`` (which also
# runs on the parent's tree) and in phase 7.
BATCH_TIME_CASES = ("sb_extz_score", "sb_extd_score", "sb_approx_score",
                    "sb_extz_cig", "sb_extd_cig", "short1536_eqx_cigar",
                    "short1536_extd_end_bonus_score")


def batch_time_launches(name):
    """Batched time case ``name``: (its kernel's counter, its launches as
    the scheduler makes them)."""
    from ksw2_tpu_torch.core.flags import Flag

    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    if name.startswith("sb_"):
        flag, costs = {
            "sb_extz_score": (Flag.SCORE_ONLY, None),
            "sb_extd_score": (Flag.SCORE_ONLY, EXTD),
            "sb_approx_score": (Flag.SCORE_ONLY | approx, None),
            "sb_extz_cig": (Flag.NONE, None),
            "sb_extd_cig": (Flag.NONE, EXTD)}[name]
        lns, _, _ = short_banded_launches(_workload("sb"), flag, costs)
    else:
        jobs = _workload("jobs")
        lns = batch_route_launches(batch_wide_aligners()[name],
                                   [p for p in jobs if len(p[1]) <= 1536])
    return ("batch_extd_fwd" if lns[0].prm.two else "batch_fwd"), lns


def batch_times(int_rate, names=BATCH_TIME_CASES):
    """Kernels E / E2 on each batched time case (CUDA events, a case's
    launches timed together as the path runs them) beside their bound:
    the true band cells each pair computed (to its Z-drop) at ``OPS``
    (+ ``BYTE_OPS`` with bytes) over the card's int32 rate, and the
    longest pair's diagonals with the microseconds a diagonal of it (a
    launch waits on its longest pair)."""
    import torch
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import batch as BT

    out = {}
    for name in names:
        kname, lns = batch_time_launches(name)
        args = [BD.band_upload(ln, "cuda") for ln in lns]
        row = {"kernel": kname, "pairs": sum(len(ln.qlen) for ln in lns),
               "launches": [{"pairs": len(ln.qlen), "nd": ln.nd,
                             "ncol": ln.ncol, "Lt": int(ln.target.shape[1]),
                             "cpl": BT.batch_form(ln.ncol, ln.prm.m)}
                            for ln in lns]}

        def fwd(lns=lns, args=args):
            return [BT.batch_forward_cuda(*a, ln.prm, ln.nd, ln.ncol)
                    for a, ln in zip(args, lns)]
        row["fwd_ms"] = cuda_ms(fwd, 5)
        outs = fwd()
        work = [band_work(ln, rec) for ln, (rec, _) in zip(lns, outs)]
        row["computed_cells"] = sum(c for c, _ in work)
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
            kname, row["computed_cells"], sum(b for _, b in work), int_rate,
            lns[0].prm.cig)
        longest = max(ln.nd for ln in lns)
        row["longest_pair_diagonals"] = longest
        row["us_per_diagonal_longest"] = row["fwd_ms"] * 1e3 / longest
        if name.startswith("sb_"):
            row["band_cells"] = band_cells(_workload("sb"), SHORT_BANDED_W)
            row["fwd_band_gcells_per_s"] = \
                row["band_cells"] / row["fwd_ms"] / 1e6
        if lns[0].prm.cig and name.startswith("sb_"):
            from ksw2_tpu_torch.ops import band_walker as BW
            from ksw2_tpu_torch.ops import strips_walker as W
            walks = [(p, W.start_cells(rec, ql, tl, ln.prm.flag, 0), ql, tl,
                      w) for (rec, p), (_, _, ql, tl, w, _), ln in
                     zip(outs, args, lns)]
            row["walk_ms"] = cuda_ms(
                lambda: [BW.band_walk_cuda(*a) for a in walks], 5)
            steps, nbytes = walks_work(
                [BW.band_walk_cuda(*a) for a in walks], 20)
            row["walk_steps"] = steps
            row["walk_bound_ms"], row["walk_bound_by"] = bound(
                "band_walk", steps, nbytes, int_rate)
            del walks
        del outs, args
        out[name] = row
        torch.cuda.empty_cache()
    return out


# Kernels 17, D and B, the walkers, at the main path's launch shapes: each
# case's stores come from the forward kernels on the card, then only the
# walks are timed (``--walk-times``, which also runs on the parent's tree),
# broken down (``--breakdown walk``) or held to the plain walkers (phase
# "walk"; kernel B's main-path shapes in phases 4 and 5d).  name -> the
# kernel's counter.
WALK_CASES = {
    "single50k_cig": "extz_walk",       # the 50 kb pair's compact store
    "single50k_extd_cig": "extz_walk",  # kernel 13's
    "mt_cig": "extz_walk",              # the MT pair, -z100
    "mt_extz_cig": "extz_walk",         # EXTZ_ONLY, --end-bonus 10
    "sr_extz_cig": "extz_walk",         # sr-extension: 4096 pairs
    "sr_extd_cig": "extz_walk",         # sr-extension-extd
    "splice_ends_cig": "extz_walk",     # 1024 splice ends, min_intron
    "splice_long_cig": "extz_walk",     # 64 pairs of 2-12 kb, 4 launches
    "long1_extz_cig": "band_walk",      # the 2 kb cut long-banded pair
    "long128_cig": "band_walk",         # the long-banded CIGAR launches
    "sb_extz_cig": "band_walk",         # the batched route's 4096 pairs
    "main_junc_cig": "band_walk",       # kernel 6's bytes, min_intron
    "mt_gg2": "band_walk",              # flat: the MT pair (kernel 16)
    "cli64_gg2_batch": "band_walk",     # flat: the CLI's kernel 8 pairs
    "cli64_gg2_single": "band_walk",    # flat: its kernel 16 pairs
    "whale_cig": "strips_walk",         # kernel A's whale CIG launch
    "whale_extd_cig": "strips_walk",    # ... two-piece (7-bit bytes)
    "mixed700_cig": "strips_walk",      # the mixed pairs of 600-768 bp
    "nop256_cig": "strips_walk",        # 256 splice pairs, min_intron
}
# the launch shapes phase "walk" holds to the plain walkers (the 4096-pair
# launches are held in phases 5c and 5e, the 1024-pair ones in 5d and 5f)
WALK_CHECKED = ("single50k_cig", "single50k_extd_cig", "mt_cig",
                "mt_extz_cig", "splice_long_cig", "long128_cig", "mt_gg2")
_WORKLOADS = {}


def _workload(key):
    """The seeded workloads, built once a process."""
    if key not in _WORKLOADS:
        _WORKLOADS[key] = {
            "single": lambda: single_pair(SINGLE_SEED, SINGLE_LEN),
            "mt": lambda: single_pair(MT_SEED, MT_LEN),
            "sb": short_banded_jobs, "spl": splice_jobs,
            "slong": splice_long_jobs, "long": long_banded_jobs,
            "jobs": mixed_jobs}[key]()
    return _WORKLOADS[key]


def walk_launches(name):
    """Walk case ``name`` on the card: (the kernel's wrapper, its plain
    version, one argument tuple a launch as the main path makes them,
    the bytes of start cell and result a pair); the forwards' stores are
    made here by the forward kernels."""
    import torch
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch as BT
    from ksw2_tpu_torch.ops import batch_exts as BE
    from ksw2_tpu_torch.ops import extd as ED
    from ksw2_tpu_torch.ops import exts as ES
    from ksw2_tpu_torch.ops import extz_fwd as F
    from ksw2_tpu_torch.ops import strips_walker as W
    from ksw2_tpu_torch.ops import traceback_device as TB

    X, SPL, N = Flag.EXTZ_ONLY, Flag.SPLICE_FOR, Flag.NONE
    single = lambda: [_workload("single")]        # noqa: E731
    mt = lambda: [_workload("mt")]                # noqa: E731
    compact = {
        "single50k_cig": ("extz", lambda: [extz_launch(single(), [-1], N,
                                                       -1)], 0),
        "single50k_extd_cig": ("extd", lambda: [extd_launch(single(), [-1],
                                                            N, -1)], 0),
        "mt_cig": ("extz", lambda: [extz_launch(mt(), [-1], N, 100)], 0),
        "mt_extz_cig": ("extz", lambda: [extz_launch(mt(), [-1], X, 100)],
                        END_BONUS),
        "sr_extz_cig": ("extz", lambda: sr_launches(_workload("sb")),
                        END_BONUS),
        "sr_extd_cig": ("extd", lambda: sr_extd_launches(_workload("sb"), X),
                        END_BONUS),
        "splice_ends_cig": ("exts", lambda: splice_single_launches(
            _workload("spl") * SPLICE_TILES, SPL | X), 0),
        "splice_long_cig": ("exts", lambda: splice_single_launches(
            _workload("slong")[0], SPL, _workload("slong")[1],
            SPLICE_JUNC_BONUS), 0),
    }
    strips = {
        "whale_cig": lambda: (_launch([p for p in _workload("jobs")
                                       if len(p[1]) > 2048], N, 100, True),),
        "whale_extd_cig": lambda: (_launch([p for p in _workload("jobs")
                                            if len(p[1]) > 2048], N, 100,
                                           True, costs=EXTD),),
        "mixed700_cig": lambda: (_launch([p for p in _workload("jobs")
                                          if 600 < len(p[1]) <= 768], N,
                                         100, True),),
        "nop256_cig": lambda: (splice_launches(
            _workload("spl") * SPLICE_TILES, SPL)[0][1], 256),
    }
    if name in strips:
        from ksw2_tpu_torch.ops import strips as S
        ln, *cut = strips[name]()
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        _, Dq, hl, d8 = D4 = S.strips_forward_cuda(
            qs, ts, ql, tl, tab, ln.prm, S.site_rows(ln, "cuda"))
        rec = S.replay_records(ln.prm, D4[0], Dq, hl, ql, tl)
        starts = W.start_cells(rec, ql, tl, ln.prm.flag, 0)
        n = cut[0] if cut else len(ql)
        walks = [(d8[:n].contiguous(), starts[:n].contiguous(),
                  W.walk_min_intron(ln.prm.lt, ln.prm.spl))]
        del D4, Dq, hl, d8
        return W.strips_walk_cuda, W.strips_walk_plain, walks, 20
    if name in compact:
        kind, make, eb = compact[name]
        fwd = {"extz": F.extz_forward_cuda, "extd": ED.extd_forward_cuda,
               "exts": ES.exts_forward_cuda}[kind]
        walks = []
        for ln in make():
            a = BD.band_upload(ln, "cuda")
            rec, p, _ = fwd(*a, ln.prm, ln.lay)
            _, _, ql, tl, w = a[:5]
            walks.append((p, torch.from_numpy(ln.lay.pbase).cuda(),
                          W.start_cells(rec, ql, tl, ln.prm.flag, eb),
                          ql, tl, w,
                          ln.query.shape[1] + ln.target.shape[1] + 2,
                          ln.prm.lt if kind == "exts" else 0))
            del a, rec
        return TB.extz_walk_cuda, TB.extz_walk_plain, walks, 24
    if name in ("long1_extz_cig", "long128_cig", "sb_extz_cig",
                "main_junc_cig"):
        mi = 0
        fwd = BD.band_forward_cuda
        if name == "long1_extz_cig":
            lns = [band_launch(long1_pair(_workload("long")), BAND_W, N,
                               400)]
        elif name == "long128_cig":
            # one merged CIGAR bucket, longest first, split by its bytes
            long = _workload("long")
            order = np.argsort([-(len(q) + len(t)) for q, t in long],
                               kind="stable")
            ps = [long[k] for k in order]
            lns = BD.band_prep([q for q, _ in ps], [t for _, t in ps],
                               np.array([len(q) for q, _ in ps], np.int32),
                               np.array([len(t) for _, t in ps], np.int32),
                               np.full(len(ps), BAND_W, np.int32), 5,
                               simple_mat(5, 2, -4), 4, 2, 400, N, cig=True)
        elif name == "sb_extz_cig":
            lns, _, _ = short_banded_launches(_workload("sb"), N)
            fwd = BT.batch_forward_cuda
        else:
            spl4 = _workload("spl") * SPLICE_TILES
            ((_, ln),) = splice_launches(spl4, SPL, [splice_junc()] *
                                         len(spl4), SPLICE_JUNC_BONUS)
            lns = [ln]
            fwd = BE.batch_exts_forward_cuda
            mi = W.walk_min_intron(ln.prm.lt, True)
        walks = []
        for ln in lns:
            a = BD.band_upload(ln, "cuda")
            rec, p = fwd(*a, ln.prm, ln.nd, ln.ncol)
            _, _, ql, tl, w = a[:5]
            walks.append((p, W.start_cells(rec, ql, tl, ln.prm.flag, 0), ql,
                          tl, w, mi))
            del a, rec
        return BW.band_walk_cuda, BW.band_walk_plain, walks, 20
    # flat: kernel 16 (single) or 8 (batch) on the MT pair or the CLI's
    from ksw2_tpu_torch.ops import batch_extf as BF
    from ksw2_tpu_torch.ops import batch_gg2 as BG
    from ksw2_tpu_torch.ops import gg2 as G1
    try:    # a tree before the tiled kernel 16 takes no layout
        from ksw2_tpu_torch.ops import lg_tiles as LT
    except ImportError:
        LT = None
    if name == "mt_gg2":
        pairs, w, kname = mt(), _resolve(mt(), -1), "gg2_fwd"
    else:
        case = {c[0]: c for c in lg_cases(_workload("jobs"))}[name]
        pairs, w = case[2], case[3]
        kname = "batch_gg2_fwd" if name.endswith("batch") else "gg2_fwd"
    table = torch.from_numpy(simple_mat(5, 2, -4).astype(np.int32)).cuda()
    args = BF.pack_pairs(pairs, w, "cuda")
    kw = {}
    if LT is not None and kname in LT.KINDS:
        kw["lay"] = LT.lg_layout(kname, [len(a) for a, _ in pairs],
                                 [len(b) for _, b in pairs], w)
    fn = G1.gg2_single_forward_cuda if kname == "gg2_fwd" else \
        BG.batch_gg2_forward_cuda
    if "ncol" in inspect.signature(fn).parameters:
        kw["ncol"] = lg_ncol(kname, pairs, w)
    pb_np, total = BG.flat_layout([len(a) for a, _ in pairs],
                                  [len(b) for _, b in pairs], w)
    pb = torch.from_numpy(pb_np).cuda()
    _, p = fn(*args, table, 5, 4, 2, pb, total, **kw)
    _, _, ql, tl, wt = args
    return BW.flat_walk_cuda, BW.flat_walk_plain, [(p, pb, ql, tl, wt)], 20


def walk_steps(outs):
    """(all steps, the longest walk's steps) of walks' ``(res, runs)``."""
    steps = np.concatenate([pair_steps(res, runs) for res, runs in outs])
    return int(steps.sum()), int(steps.max(initial=0))


def walk_times(int_rate, names=None):
    """Kernels 17, D and B on each walk case (CUDA events, the launches as
    the main path makes them, timed together), beside their bounds: the
    walks' steps, the longest walk's, and ns a step of the longest walk
    (a launch waits on it)."""
    import torch

    out = {}
    for name in names or WALK_CASES:
        fn, _, walks, per_pair = walk_launches(name)
        outs = [fn(*a) for a in walks]
        steps, longest = walk_steps(outs)
        _, nbytes = walks_work(outs, per_pair)
        row = {"kernel": WALK_CASES[name], "launches": len(walks),
               "pairs": sum(len(res) for res, _ in outs), "steps": steps,
               "longest_walk_steps": longest}
        del outs
        row["ms"] = cuda_ms(lambda: [fn(*a) for a in walks],
                            3 if longest > 10000 else 10)
        row["ns_per_step_longest"] = row["ms"] * 1e6 / max(longest, 1)
        row["bound_ms"], row["bound_by"] = bound(WALK_CASES[name], steps,
                                                 nbytes, int_rate)
        out[name] = row
        del walks
        torch.cuda.empty_cache()
    return out


def walk_window_rows():
    """The walkers' rows a window (``R`` in csrc/walk.cuh)."""
    import re

    from ksw2_tpu_torch import _build

    src = (_build.CSRC / "walk.cuh").read_text()
    return int(re.search(r"constexpr int R = (\d+);", src).group(1))


def walk_random_cases(seed=787, device="cuda"):
    """(name, wrapper, plain version, args) walks of random direction
    bytes (mostly state 0, continuation bits at random) that the forwards'
    stores do not give: compact and rotated stores walked across hundreds
    of windows from their last stored cell and from inner cells at the
    window's edges (r0 = R - 2 .. R + 1, 2R - 1, 3.5 R), min_intron and
    upper_force 0; flat stores whose narrow bands the walk leaves upward
    (reads into the next rows); one-base pairs; row-major (strips) stores
    of three- and five-state bytes walked from the corner and from inner
    cells at the window's edges, min_intron; and launches of 1, 16, 128,
    1024 and 4096 pairs."""
    import torch
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch_gg2 as BG
    from ksw2_tpu_torch.ops import strips_walker as SW
    from ksw2_tpu_torch.ops import traceback_device as TB
    from ksw2_tpu_torch.ops.bands import first_empty_diag
    from ksw2_tpu_torch.ops.extz_fwd import row_off

    rng = np.random.default_rng(seed)
    R = walk_window_rows()

    def rand_bytes(n, states=3):
        st = rng.choice(states, n, p=[0.6] + [0.4 / (states - 1)] *
                        (states - 1))
        return (st | (rng.integers(0, 16, n) << 3)).astype(np.uint8)

    def cell(r, tl, w):
        i = min(tl - 1, (r + w) // 2, r)
        return i, r - i

    def t(a, dt=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    cases = []
    for qlen, tlen, w, B in ((9000, 8990, 3, 8), (9000, 8990, 24, 8),
                             (700, 650, 700, 8), (2000, 2100, 50, 1),
                             (600, 610, 16, 4096)):
        rows = int(first_empty_diag(qlen, tlen, w))
        p = t(rand_bytes(int(row_off(rows, qlen, tlen, w)[0]) + 32, 4),
              torch.uint8)
        ends = [rows - 1] + [r for r in (R - 2, R - 1, R, R + 1, 2 * R - 1,
                                         7 * R // 2) if r < rows - 1]
        sts = [cell(int(rng.choice(ends)) if k >= len(ends) else ends[k],
                    tlen, w) for k in range(B)]
        args = (p, t(np.zeros(B), torch.int64), t(sts), t([qlen] * B),
                t([tlen] * B), t([w] * B), qlen + tlen + 2)
        for mi, uf in ((0, 1), (5, 1), (0, 0)):
            cases.append((f"compact_{qlen}x{tlen}_w{w}_B{B}_mi{mi}_uf{uf}",
                          TB.extz_walk_cuda, TB.extz_walk_plain,
                          args + (mi, uf)))
    for qlen, tlen, w, B in ((3000, 3020, 5, 4), (3000, 3020, 40, 16),
                             (300, 290, 1, 128), (200, 210, 0, 16)):
        nd = qlen + tlen - 1
        ncol = max((min(tlen - 1, r, (r + w) >> 1) | 15) -
                   (max(0, r - qlen + 1, (r - w + 1) >> 1) & ~15) + 1
                   for r in range(nd))
        p = t(rand_bytes(B * nd * ncol, 4).reshape(B, nd, ncol), torch.uint8)
        ends = [R - 1, R, 2 * R + 1]
        sts = [(tlen - 1, qlen - 1) if k % 4 == 0 else
               cell(ends[k % 4 - 1], tlen, w) for k in range(B)]
        for mi in (0, 4):
            cases.append((f"rotated_{qlen}x{tlen}_w{w}_B{B}_mi{mi}",
                          BW.band_walk_cuda, BW.band_walk_plain,
                          (p, t(sts), t([qlen] * B), t([tlen] * B),
                           t([w] * B), mi)))
    dims = [(2000, 2100, 30), (1500, 1500, 1), (1, 1, 0), (3, 1, 0),
            (700, 400, 8), (400, 900, 0), (500, 1400, 3)]
    ql, tl, wt = (np.array(c, np.int32) for c in zip(*dims))
    pb, total = BG.flat_layout(ql, tl, wt)
    pf = rand_bytes(total)
    ncol = BG.gg2_ncol(tl, wt)
    for b in range(len(dims)):         # the zero row after each pair's rows
        end = int(pb[b] + (ql[b] + tl[b]) * ncol[b])
        pf[end - int(ncol[b]):end] = 0
    cases.append(("flat_random", BW.flat_walk_cuda, BW.flat_walk_plain,
                  (t(pf, torch.uint8), t(pb, torch.int64), t(ql), t(tl),
                   t(wt))))
    for tv, Lq, B, states, mi in ((1500, 1216, 8, 3, 0),
                                  (1500, 1216, 8, 5, 4),
                                  (200, 224, 1024, 3, 0)):
        d8 = t(rand_bytes(B * tv * Lq, states).reshape(B, tv, Lq),
               torch.uint8)
        ends = [(tv - 1, Lq - 17), (tv - 1, Lq - 1)] + [
            (min(r0, tv - 1) - 3, r0 - min(r0, tv - 1) + 3)
            for r0 in (R - 2, R - 1, R, R + 1, 2 * R - 1)]
        sts = [ends[k % len(ends)] for k in range(B)]
        cases.append((f"rowmajor_{tv}x{Lq}_B{B}_mi{mi}", SW.strips_walk_cuda,
                      SW.strips_walk_plain, (d8, t(sts), mi)))
    return cases


def _walk_err(kout, pout):
    """Largest difference between a kernel's and a plain walker's
    ``(res, runs)``: res exactly, the runs each pair wrote."""
    kres, kruns = kout
    pres, pruns = pout
    err = _max_err(kres, pres)
    for b in range(len(kres)):
        k = int(kres[b, 2])
        err = max(err, _max_err(kruns[b, :k], pruns[b, :k]))
    return err


def phase_walk(names):
    """Kernels 17, D and B against their plain walkers, exactly (end
    cells, run counts, escapes and runs), on the launch shapes of
    ``WALK_CHECKED`` (the 50 kb and MT compact stores, splice-long's 4
    launches, the long-banded CIGAR launches, the MT flat store) and on
    :func:`walk_random_cases`."""
    import torch

    worst = {"extz_walk": 0, "band_walk": 0, "strips_walk": 0}
    out = {}
    for name in names:
        if name == "random":
            for cname, fn, plain, args in walk_random_cases():
                err = _walk_err(fn(*args), plain(*args))
                kname = {"extz": "extz_walk", "stri": "strips_walk"}.get(
                    fn.__name__[:4], "band_walk")
                worst[kname] = max(worst[kname], err)
                out[cname] = {"kernel": kname, "max_abs_err": err}
                if err:
                    emit({"phase": "walk", "case": cname, "FAIL": err})
                    raise AssertionError(f"the walkers differ on {cname}")
            continue
        fn, plain, walks, _ = walk_launches(name)
        err = 0
        for a in walks:
            err = max(err, _walk_err(fn(*a), plain(*a)))
        kname = WALK_CASES[name]
        worst[kname] = max(worst[kname], err)
        out[name] = {"kernel": kname, "launches": len(walks),
                     "max_abs_err": err}
        del walks
        torch.cuda.empty_cache()
        if err:
            emit({"phase": "walk", "case": name, "FAIL": err})
            raise AssertionError(f"the walkers differ on {name}")
    emit({"phase": "walk", "max_abs_err": worst, "cases": out})
    return worst


def _kernel(name, src, replaces, launches, err, row, prefix):
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": row[f"{prefix}_ms"], "plain_ms": row[f"{prefix}_plain_ms"],
            "bound_ms": row[f"{prefix}_bound_ms"],
            "bound_by": row[f"{prefix}_bound_by"], "library_ms": None}


# ``--breakdown``: where a diagonal of kernels 12-14 (``extz``) and of
# kernels 9 and 10 (``band``) spends its cycles.  A copy of the kernel's
# source with clock64 stamps around its parts (each anchor below must
# occur once in the source) is built on its own into
# build/diag_breakdown/ and launched through the wrappers in place of the
# library's kernel; the package never uses the copy.
BREAKDOWN_PARTS = ("wait", "group_loads", "chunks", "diag_tail", "release",
                   "fold_atomics", "total", "diags", "first_wait")
BREAKDOWN_STAMPS = (
    ("constexpr unsigned FULL = 0xffffffffu;\n",
     "constexpr unsigned FULL = 0xffffffffu;\n"
     "__device__ unsigned long long g_prof[16];\n"),
    ("  for (int r_lo = rA; r_lo <= rB;) {\n",
     "  long long P[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  const long long tT = clock64();\n  bool firstg = true;\n"
     "  long long tq;\n  for (int r_lo = rA; r_lo <= rB;) {\n"
     "    tq = clock64();\n"),
    ("        seen = __shfl_sync(FULL, pv, 0);\n      }\n",
     "        seen = __shfl_sync(FULL, pv, 0);\n      }\n"
     "      P[firstg ? 8 : 0] += clock64() - tq;\n      tq = clock64();\n"),
    ("    // unrolled: a diagonal's loads and score bytes overlap the chain of\n",
     "    P[1] += clock64() - tq;\n    firstg = false;\n"
     "    // unrolled: a diagonal's loads and score bytes overlap the chain of\n"),
    ("      const int r = r_lo + rr;\n      const int4 dg = sdiag[rr];\n",
     "      long long td = clock64();\n      const int r = r_lo + rr;\n"
     "      const int4 dg = sdiag[rr];\n"),
    ("      if (!APPROX) skey[rr][lane] = best;\n",
     "      P[2] += clock64() - td;\n      td = clock64();\n"
     "      if (!APPROX) skey[rr][lane] = best;\n"),
    ("                              H[NC - 1]);\n    }\n",
     "                              H[NC - 1]);\n"
     "      P[3] += clock64() - td;\n      P[7] += 1;\n    }\n"),
    ("    // the group's hand-off: its edge entries, one release, then the\n",
     "    tq = clock64();\n"
     "    // the group's hand-off: its edge entries, one release, then the\n"),
    ("      if (lane == 0) st_release(A.progress + g, r_hi);\n    }\n",
     "      if (lane == 0) st_release(A.progress + g, r_hi);\n    }\n"
     "    __syncwarp();\n    P[4] += clock64() - tq;\n    tq = clock64();\n"),
    ("    __syncwarp();\n    r_lo = r_hi + 1;\n  }\n}\n",
     "    __syncwarp();\n    P[5] += clock64() - tq;\n    r_lo = r_hi + 1;\n"
     "  }\n  P[6] = clock64() - tT;\n  if (lane == 0)\n"
     "    for (int i = 0; i < 10; ++i)\n"
     "      atomicAdd(&g_prof[i], (unsigned long long)P[i]);\n}\n"),
)
# band_fwd.cu: each compute warp's lane 0 adds the cycles since the last
# stamp to the part a stamp closes, a group of diagonals at a time
# (summed over the warps' tile-diagonals: a block's warps run side by
# side); the replay warp's lane 0 counts its waits and its work a group
# (counters 0-5 the parts, 7 the tile-diagonals, 8 the total; 10-12 the
# replay's wait, work and groups)
BAND_BREAKDOWN_PARTS = ("ring_wait", "tile_before", "group_prep", "diagonals",
                        "handoff", "fold_settle")
BAND_BREAKDOWN_STAMPS = (
    ("constexpr unsigned FULL = 0xffffffffu;\n",
     "constexpr unsigned FULL = 0xffffffffu;\n"
     "__device__ unsigned long long g_prof[16];\n"
     "#define STAMP(i) { const long long t_ = clock64(); P[i] += t_ - tq; "
     "tq = t_; }\n"),
    ("    bool quit = false;\n",
     "    bool quit = false;\n"
     "    long long P[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "    const long long tT = clock64();\n    long long tq = tT;\n"),
    ("      for (int r_lo = rA; r_lo <= rB;) {\n",
     "      for (int r_lo = rA; r_lo <= rB;) {\n        tq = clock64();\n"),
    ("        // the tile before's entries [cb, ce]: e0 = min(r - 1, pB) and,\n",
     "        STAMP(0);\n"
     "        // the tile before's entries [cb, ce]: e0 = min(r - 1, pB) and,\n"),
    ("        // the query bases the group's cells read (r - t for r in the\n",
     "        STAMP(1);\n"
     "        // the query bases the group's cells read (r - t for r in the\n"),
    ("#pragma unroll 4\n        for (int rr = 0; rr < nr; ++rr) {\n",
     "        STAMP(2);\n"
     "#pragma unroll 4\n        for (int rr = 0; rr < nr; ++rr) {\n"),
    ("        myhi = r_hi;\n",
     "        STAMP(3);\n        P[7] += nr;\n        myhi = r_hi;\n"),
    ("        // the keys into the pair's ring, then no more below r_hi\n",
     "        STAMP(4);\n"
     "        // the keys into the pair's ring, then no more below r_hi\n"),
    ("        r_lo = r_hi + 1;\n      }\n    }\n",
     "        STAMP(5);\n        r_lo = r_hi + 1;\n      }\n    }\n"),
    ("    // no more tiles: nothing to wait for from this warp\n",
     "    P[8] = clock64() - tT;\n    if (lane == 0)\n"
     "      for (int i = 0; i < 10; ++i)\n"
     "        atomicAdd(&g_prof[i], (unsigned long long)P[i]);\n"
     "    // no more tiles: nothing to wait for from this warp\n"),
    ("    const long long t_start = clock64();\n    bool done = false;\n",
     "    const long long t_start = clock64();\n    bool done = false;\n"
     "    long long RP[3] = {0, 0, 0};\n    long long tr = clock64();\n"),
    ("      long long dv = 0;\n",
     "      RP[0] += clock64() - tr;\n      tr = clock64();\n"
     "      long long dv = 0;\n"),
    ("      __syncwarp();\n      if (lane == 0) st_release(done ? stopp : "
     "replayed, done ? stop : hi);\n",
     "      RP[1] += clock64() - tr;\n      RP[2] += 1;\n"
     "      __syncwarp();\n      if (lane == 0) st_release(done ? stopp : "
     "replayed, done ? stop : hi);\n      tr = clock64();\n"),
    ("    if (rlim < ndb) zd = 1;\n",
     "    if (lane == 0)\n      for (int i = 0; i < 3; ++i)\n"
     "        atomicAdd(&g_prof[10 + i], (unsigned long long)RP[i]);\n"
     "    if (rlim < ndb) zd = 1;\n"),
)
# lg_fwd.cu (kernels 15 and 16): each tile's lane 0 adds the cycles of
# its parts: the group's prep (band rows, query loads), the wait, the
# loads after it, a diagonal's chunk steps and its tail (the walk's step
# or read and the edge entry), the hand-off and the group's byte flush
# (gg2);
# counter 10 is the longest tile's cycles, 11 and 12 the nanoseconds
# (%globaltimer, one clock for every SM) from a release to the end of a
# wait that it ended, and the number of such waits; per (tile, group) the
# release time, and the cycles before the diagonals and from them to the
# release
LG_BREAKDOWN_PARTS = ("wait", "group_loads", "chunks", "diag_tail",
                      "release", "group_prep", "total", "diags",
                      "first_wait", "byte_flush")
LG_BREAKDOWN_STAMPS = (
    ("constexpr unsigned FULL = 0xffffffffu;\n",
     "constexpr unsigned FULL = 0xffffffffu;\n"
     "__device__ unsigned long long g_prof[16];\n"
     "__device__ unsigned long long g_relts[1 << 22];\n"
     "__device__ unsigned long long g_work[1 << 22];\n"
     "__device__ unsigned long long g_pre[1 << 22];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("          while ((pv = ld_acquire(pg)) < need) {\n",
     "          bool spun_ = false;\n"
     "          while ((pv = ld_acquire(pg)) < need) {\n"
     "            spun_ = true;\n"),
    ("            nap = min(2 * nap, SPIN_SLEEP_MAX);\n          }\n",
     "            nap = min(2 * nap, SPIN_SLEEP_MAX);\n          }\n"
     "          if (spun_ && pv >= need) {\n"
     "            atomicAdd(&g_prof[11], gtime() - g_relts[(size_t)(g - 1) * "
     "2048 + need / 32]);\n"
     "            atomicAdd(&g_prof[12], 1ull);\n          }\n"),
    ("  for (int r_lo = rA; r_lo <= rB;) {\n",
     "  long long P[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  const long long tT = clock64();\n  bool firstg = true;\n"
     "  long long tq, tw = 0, tgs = 0;\n"
     "  for (int r_lo = rA; r_lo <= rB;) {\n"
     "    tq = clock64();\n    tgs = tq;\n"),
    ("    int cb = 0, wl = -1;\n",
     "    P[5] += clock64() - tq;\n    tq = clock64();\n"
     "    int cb = 0, wl = -1;\n"),
    ("        seen = __shfl_sync(FULL, pv, 0);\n      }\n",
     "        seen = __shfl_sync(FULL, pv, 0);\n      }\n"
     "      P[firstg ? 8 : 0] += clock64() - tq;\n      tq = clock64();\n"),
    ("    // the group's diagonals; WALK: the walk's step (EXTF) or one of its\n",
     "    P[1] += clock64() - tq;\n    firstg = false;\n    tw = clock64();\n"
     "    if (lane == 0) g_pre[(size_t)g * 2048 + r_hi / 32] = tw - tgs;\n"
     "    // the group's diagonals; WALK: the walk's step (EXTF) or one of its\n"),
    ("        const int r = r_lo + rr;\n        const int4 dg = sdiag[rr];\n",
     "        long long td = clock64();\n        const int r = r_lo + rr;\n"
     "        const int4 dg = sdiag[rr];\n"),
    ("        // the walk's step (EXTF) or read (GG2), when it may fall here\n",
     "        P[2] += clock64() - td;\n        td = clock64();\n"
     "        // the walk's step (EXTF) or read (GG2), when it may fall here\n"),
    ("                         : (Ent)u8(V[NC - 1]);\n      }\n",
     "                         : (Ent)u8(V[NC - 1]);\n"
     "        P[3] += clock64() - td;\n        P[7] += 1;\n      }\n"),
    ("    // the group's hand-off: its edge entries, then one release\n",
     "    tq = clock64();\n"
     "    // the group's hand-off: its edge entries, then one release\n"),
    ("      if (lane == 0) st_release(A.progress + g, r_hi);\n    }\n",
     "      if (lane == 0) g_relts[(size_t)g * 2048 + r_hi / 32] = gtime();\n"
     "      if (lane == 0) g_work[(size_t)g * 2048 + r_hi / 32] =\n"
     "          clock64() - tw;\n"
     "      if (lane == 0) st_release(A.progress + g, r_hi);\n    }\n"
     "    __syncwarp();\n    P[4] += clock64() - tq;\n    tq = clock64();\n"),
    ("    __syncwarp();\n    r_lo = r_hi + 1;\n  }\n",
     "    __syncwarp();\n    P[9] += clock64() - tq;\n    r_lo = r_hi + 1;\n"
     "  }\n  P[6] = clock64() - tT;\n  if (lane == 0) {\n"
     "    for (int i = 0; i < 10; ++i)\n"
     "      atomicAdd(&g_prof[i], (unsigned long long)P[i]);\n"
     "    atomicMax(&g_prof[10], (unsigned long long)P[6]);\n  }\n"),
)
PROF_READ = """
extern "C" int ksw2t_prof_read(void* out) {
  cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  return (int)cudaGetLastError();
}
"""
# the readers of a source that does not define ksw2t_error_string
BREAKDOWN_READ = PROF_READ + """
extern "C" const char* ksw2t_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
"""


def breakdown_library(name, stamps, entry, read=BREAKDOWN_READ):
    """Build the stamped copy of ``csrc/<name>.cu`` with the readers
    ``read``; returns it loaded, with the argument types of its entry
    point (or points) set."""
    import ctypes

    from ksw2_tpu_torch import _build

    src = (_build.CSRC / f"{name}.cu").read_text()
    for anchor, stamped in stamps:
        if src.count(anchor) != 1:
            raise RuntimeError(f"breakdown: anchor not found once in "
                               f"{name}.cu: {anchor!r}")
        src = src.replace(anchor, stamped)
    out = _build.BUILD_DIR.parent / "diag_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}_stamped.cu").write_text(src + read)
    lib_path = out / f"lib{name}_stamped.so"
    nvcc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), str(out / f"{name}_stamped.cu"), "-o",
         str(lib_path)], capture_output=True, text=True)
    if nvcc.returncode:
        raise RuntimeError(f"breakdown: nvcc failed on {name}_stamped.cu:\n"
                           f"{nvcc.stdout[-4000:]}{nvcc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for fn in (entry,) if isinstance(entry, str) else entry:
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.ksw2t_prof_read.argtypes = [ctypes.c_void_p]
    lib.ksw2t_error_string.argtypes = [ctypes.c_int]
    lib.ksw2t_error_string.restype = ctypes.c_char_p
    return lib


def _stamped_run(lib, launches, call):
    """(stamped ms, the 16 counters) of ``call(args, launch)`` over
    ``launches`` on the card."""
    import torch
    from ksw2_tpu_torch.ops import band as BD

    prof = np.zeros(16, np.uint64)
    args = [BD.band_upload(ln, "cuda") for ln in launches]
    lib.ksw2t_prof_read(prof.ctypes.data)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for a, ln in zip(args, launches):
        call(a, ln)
    t1.record()
    t1.synchronize()
    lib.ksw2t_prof_read(prof.ctypes.data)
    del args
    torch.cuda.empty_cache()
    return t0.elapsed_time(t1), prof


def breakdown_extz():
    """Cycles a tile-diagonal of each part of kernels 12-14 (CUDA clock64
    sums over the tiles' lane 0, over the tile-diagonals computed), at
    each tile width on the long pairs and at the scheduler's tile on the
    splice-long scores and the sr-extension launch.  ``first_wait`` is a
    tile's wait before its first group (the pipeline's fill), ``wait``
    the later ones; the stamps themselves cost cycles."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops import extd as ED
    from ksw2_tpu_torch.ops import exts as ES
    from ksw2_tpu_torch.ops import extz_fwd as F

    lib = breakdown_library("extz_fwd", BREAKDOWN_STAMPS, "ksw2t_extz_fwd")
    saved = F.library
    F.library = lambda: lib
    SO = Flag.SCORE_ONLY
    single = single_pair(SINGLE_SEED, SINGLE_LEN)
    mt = single_pair(MT_SEED, MT_LEN)
    lpairs, ljuncs = splice_long_jobs()
    cases = [
        ("single50k_score", F.extz_forward_cuda,
         [extz_launch([single], [-1], SO, -1)], F.TILES),
        ("single50k_cig", F.extz_forward_cuda,
         [extz_launch([single], [-1], Flag.NONE, -1)], F.TILES),
        ("single50k_extd_score", ED.extd_forward_cuda,
         [extd_launch([single], [-1], SO, -1)], F.TILES),
        ("mt_score", F.extz_forward_cuda, [extz_launch([mt], [-1], SO, -1)],
         F.TILES),
        ("splice_long_score", ES.exts_forward_cuda,
         splice_single_launches(lpairs, Flag.SPLICE_FOR | SO, ljuncs,
                                SPLICE_JUNC_BONUS), (None,)),
        ("sr_extz_cig", F.extz_forward_cuda,
         sr_launches(short_banded_jobs()), (None,))]
    try:
        for name, fn, lns, tps in cases:
            for tp in tps:
                run = [at_tp(ln, tp) if tp else ln for ln in lns]
                ms, prof = _stamped_run(
                    lib, run, lambda a, ln: fn(*a, ln.prm, ln.lay))
                nd = float(prof[7])
                emit({"phase": "breakdown", "case": name,
                      "tp": [ln.lay.tp for ln in run],
                      "tiles": sum(int(ln.lay.tbase[-1]) for ln in run),
                      "ms_stamped": ms, "tile_diagonals": int(nd),
                      "cycles_per_tile_diagonal": {
                          k: float(prof[i]) / nd
                          for i, k in enumerate(BREAKDOWN_PARTS)
                          if k != "diags"}})
    finally:
        F.library = saved


def breakdown_band():
    """Cycles a tile-diagonal of each part of kernels 9 and 10 (CUDA
    clock64 sums over each compute warp's lane 0, over the tile-diagonals
    computed), and the replay warp's cycles a group, on the long-banded
    workload's 128 pairs in one score launch (one- and two-piece) and on
    its shortest pair cut to 2 kb with CIG; then kernel 12 (and 13) on
    the same 128 pairs at the layout ``extz.single_prep`` makes (its
    launches), beside the band kernel unstamped."""
    import torch
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import extd as ED
    from ksw2_tpu_torch.ops import extz_fwd as F

    long = long_banded_jobs()
    SO = Flag.SCORE_ONLY
    cases = [
        ("long128_extz_score", band_launch(long, BAND_W, SO, 400)),
        ("long1_extz_cig", band_launch(long1_pair(long), BAND_W, Flag.NONE,
                                       400)),
        ("long128_extd_score", band_launch(long, BAND_W, SO, 400, EXTD))]
    lib = breakdown_library("band_fwd", BAND_BREAKDOWN_STAMPS,
                            "ksw2t_band_fwd")
    saved = BD.library
    BD.library = lambda: lib
    try:
        for name, ln in cases:
            ms, prof = _stamped_run(
                lib, [ln], lambda a, ln: BD.band_forward_cuda(
                    *a, ln.prm, ln.nd, ln.ncol))
            nd = float(prof[7])
            parts = {k: float(prof[i]) / nd
                     for i, k in enumerate(BAND_BREAKDOWN_PARTS)}
            parts["total"] = float(prof[8]) / nd
            groups = max(float(prof[12]), 1.0)
            emit({"phase": "breakdown", "case": name, "kernel": "band",
                  "pairs": len(ln.qlen), "layout": BD.band_layout(ln.ncol),
                  "ms_stamped": ms, "tile_diagonals": int(nd),
                  "cycles_per_tile_diagonal": parts,
                  "replay_groups": int(prof[12]),
                  "replay_cycles_per_group": {
                      "wait": float(prof[10]) / groups,
                      "work": float(prof[11]) / groups}})
    finally:
        BD.library = saved
    # kernel 12 / 13 on the same pairs beside the band kernel: the
    # launches single_prep makes of them (their boundary history splits
    # the set by LAUNCH_BYTES), timed together
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.extd import extd_prep
    from ksw2_tpu_torch.ops.extz import extz_prep

    ql = np.array([len(q) for q, _ in long], np.int32)
    tl = np.array([len(t) for _, t in long], np.int32)
    wv = np.full(len(long), BAND_W, np.int32)
    qs, ts = [q for q, _ in long], [t for _, t in long]
    mat = simple_mat(5, 2, -4)
    ez = extz_prep(qs, ts, ql, tl, wv, 5, mat, 4, 2, 400, SO, cig=False)
    ed = extd_prep(qs, ts, ql, tl, wv, 5, mat, *EXTD, 400, SO, cig=False)
    rows = {}
    for name, lns, call in (
            ("band_fwd", [cases[0][1]],
             lambda a, ln: BD.band_forward_cuda(*a, ln.prm, ln.nd, ln.ncol)),
            ("extz_fwd", ez, lambda a, ln: F.extz_forward_cuda(
                *a, ln.prm, ln.lay)),
            ("band_extd_fwd", [cases[2][1]],
             lambda a, ln: BD.band_forward_cuda(*a, ln.prm, ln.nd, ln.ncol)),
            ("extd_fwd", ed, lambda a, ln: ED.extd_forward_cuda(
                *a, ln.prm, ln.lay))):
        args = [BD.band_upload(ln, "cuda") for ln in lns]

        def go():
            return [call(a, ln)[0] for a, ln in zip(args, lns)]
        ms = [cuda_ms(go, 2) for _ in range(2)]
        rec = torch.cat(go()).cpu().numpy()
        rows[name] = {"ms": ms, "launches": len(lns),
                      "zdropped": int(rec[:, 8].sum()),
                      "sum_max": int(rec[:, 0].sum()),
                      "tp": [getattr(getattr(ln, "lay", None), "tp", None)
                             for ln in lns]}
        del args
        torch.cuda.empty_cache()
    emit({"phase": "breakdown", "case": "long128_score_launch",
          "kernels": rows})


# lg_fwd.cu's stamped copy also reads out each (tile, group)'s release time
LG_BREAKDOWN_READ = BREAKDOWN_READ + """
extern "C" int ksw2t_relts_read(void* out, void* work, void* pre) {
  cudaMemcpyFromSymbol(out, g_relts, sizeof(g_relts));
  cudaMemcpyFromSymbol(work, g_work, sizeof(g_work));
  cudaMemcpyFromSymbol(pre, g_pre, sizeof(g_pre));
  return (int)cudaGetLastError();
}
"""


def release_lags(relts, lay, kind, ql, tl, w):
    """Medians (ns) of a tile's time from one group's release to its
    next (its period) and of the time from a tile's release of a group to
    the next tile's release of the same group (the lag a tile adds), over
    the stamped launch's release times ``relts`` (tile x 2048 groups)."""
    from ksw2_tpu_torch.ops import lg_tiles as LT

    n = int(LT.n_diags(kind, ql, tl, w)[0])
    tiles = lay.tiles
    period, lag = [], []
    for k in range(tiles - 1):
        first, last = (int(x) for x in LT.tile_range(k * lay.tp, lay.tp,
                                                     ql[0], w[0], n))
        if last < first:
            continue
        row = relts[k, first // 32:last // 32 + 1].astype(np.int64)
        period += list(np.diff(row))
        if k + 1 < tiles - 1:
            f1, l1 = (int(x) for x in LT.tile_range(
                (k + 1) * lay.tp, lay.tp, ql[0], w[0], n))
            lo, hi = max(first, f1) // 32, min(last, l1) // 32
            if lo <= hi:
                lag += list(relts[k + 1, lo:hi + 1].astype(np.int64)
                            - relts[k, lo:hi + 1].astype(np.int64))
    return (float(np.median(period)) if period else None,
            float(np.median(lag)) if lag else None)


def breakdown_lg():
    """Cycles a tile-diagonal of each part of kernels 15 and 16 (CUDA
    clock64 sums over the tiles' lane 0, over the tile-diagonals
    computed) at each tile width: kernels 15 and 16 on the 50 kb pair's
    first LG_PREFIX bp (unbanded, xdrop -1) and kernel 16 on the MT pair
    (unbanded), each one launch as its main path makes it; with the
    time a tile takes from one release to the next and the lag from a
    tile's release of a group to the next tile's (up to 2,048 groups a
    tile), and, for the first 4 tiles' first 6 groups, the cycles before
    the group's diagonals (prep, wait, loads) and from them to the
    release."""
    import ctypes

    import torch
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import batch_extf as BF
    from ksw2_tpu_torch.ops import batch_gg2 as BG
    from ksw2_tpu_torch.ops import extf as XF
    from ksw2_tpu_torch.ops import gg2 as G1
    from ksw2_tpu_torch.ops import lg_tiles as LT

    lib = breakdown_library("lg_fwd", LG_BREAKDOWN_STAMPS,
                            ("ksw2t_extf_fwd", "ksw2t_gg2_fwd"),
                            LG_BREAKDOWN_READ)
    lib.ksw2t_relts_read.argtypes = [ctypes.c_void_p] * 3
    saved = XF.library, G1.library
    XF.library = G1.library = lambda: lib
    single = single_pair(SINGLE_SEED, SINGLE_LEN)
    cut = (single[0][:LG_PREFIX], single[1][:LG_PREFIX])
    mt = single_pair(MT_SEED, MT_LEN)
    table = torch.from_numpy(simple_mat(5, 2, -4).astype(np.int32)).cuda()
    try:
        for name, kind, pair in (("single2k_extf", "extf_fwd", cut),
                                 ("single2k_gg2", "gg2_fwd", cut),
                                 ("mt_gg2", "gg2_fwd", mt)):
            w = _resolve([pair], -1)
            args = BF.pack_pairs([pair], w, "cuda")
            ql, tl = [len(pair[0])], [len(pair[1])]
            pb_np, total = BG.flat_layout(ql, tl, w)
            pb = torch.from_numpy(pb_np).cuda()
            for tp in LT.TILES:
                lay = LT.lg_layout(kind, ql, tl, w, tp)
                if kind == "extf_fwd":
                    def call(lay=lay):
                        return XF.extf_single_forward_cuda(
                            *args, 2, -4, 2, -1, lay=lay)
                else:
                    def call(lay=lay):
                        return G1.gg2_single_forward_cuda(
                            *args, table, 5, 4, 2, pb, total, lay=lay)
                call()
                torch.cuda.synchronize()
                prof = np.zeros(16, np.uint64)
                lib.ksw2t_prof_read(prof.ctypes.data)
                # the stream sleeps while the host enqueues the call, so
                # the events time the device alone
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(SLEEP_CYCLES)
                t0.record()
                call()
                t1.record()
                t1.synchronize()
                ms = t0.elapsed_time(t1)
                lib.ksw2t_prof_read(prof.ctypes.data)
                relts = np.zeros(((1 << 22) // 2048, 2048), np.uint64)
                work, pre = np.zeros_like(relts), np.zeros_like(relts)
                lib.ksw2t_relts_read(relts.ctypes.data, work.ctypes.data,
                                     pre.ctypes.data)
                # the first tiles' first groups: cycles before the
                # diagonals (prep, wait, loads) and from them to the
                # release
                g0 = LT.tile_range(np.arange(4) * tp, tp, ql[0], w[0],
                                   ql[0] + tl[0] - 1)[0] // 32
                first_groups = [[(int(pre[k, G]), int(work[k, G]))
                                 for G in range(g0[k], g0[k] + 6)]
                                for k in range(4)]
                period, lag = release_lags(relts, lay, kind, ql, tl, w)
                nd = float(prof[7])
                emit({"phase": "breakdown", "case": name, "kernel": kind,
                      "tp": tp, "tiles": lay.tiles, "ms_stamped": ms,
                      "tile_diagonals": int(nd),
                      "longest_tile_cycles": int(prof[10]),
                      "sm_ghz": float(prof[10]) / ms / 1e6,
                      "handoff_waits": int(prof[12]),
                      "handoff_ns": float(prof[11]) / max(int(prof[12]), 1),
                      "group_period_ns": period, "tile_lag_ns": lag,
                      "first_groups_cycles": first_groups,
                      "cycles_per_tile_diagonal": {
                          k: float(prof[i]) / nd
                          for i, k in enumerate(LG_BREAKDOWN_PARTS)
                          if k != "diags"}})
            del args
            torch.cuda.empty_cache()
    finally:
        XF.library, G1.library = saved


# strips_fwd.cu: per strip-row, lane 0's wait for the edge (acquire and
# ring read), its scans (1-3 warp scans) and the whole row, lane 31's
# hand-on (the ring's free entry, the entry and its release) and the
# strip-rows (counters 0-4)
STRIPS_BREAKDOWN_PARTS = ("wait", "scan", "row", "publish", "strip_rows")
STRIPS_BREAKDOWN_STAMPS = (
    ("constexpr unsigned FULL = 0xffffffffu;\n",
     "constexpr unsigned FULL = 0xffffffffu;\n"
     "__device__ unsigned long long g_prof[16];\n"),
    ("    for (int i = 0; i < tlen; ++i) {\n      if ((i & 31) == 0) {\n",
     "    long long P[5] = {0, 0, 0, 0, 0};\n"
     "    for (int i = 0; i < tlen; ++i) {\n"
     "      const long long tr = clock64();\n      if ((i & 31) == 0) {\n"),
    ("      // the edge: H(i, j0s - 1) and each chain's run through it\n",
     "      const long long tw = clock64();\n"
     "      // the edge: H(i, j0s - 1) and each chain's run through it\n"),
    ("      const int hup = __shfl_up_sync(FULL, H[3], 1);\n",
     "      P[0] += clock64() - tw;\n"
     "      const int hup = __shfl_up_sync(FULL, H[3], 1);\n"),
    ("      int run = chain_in(lmax, er1, lane, out1);\n",
     "      long long tsc = clock64();\n"
     "      int run = chain_in(lmax, er1, lane, out1);\n"
     "      P[1] += clock64() - tsc;\n"),
    ("        int run2 = chain_in(lmax2, er2, lane, out2);\n",
     "        tsc = clock64();\n"
     "        int run2 = chain_in(lmax2, er2, lane, out2);\n"
     "        P[1] += clock64() - tsc;\n"),
    ("          int run3 = chain_in(lmax3, er3, lane, out3);\n",
     "          tsc = clock64();\n"
     "          int run3 = chain_in(lmax3, er3, lane, out3);\n"
     "          P[1] += clock64() - tsc;\n"),
    ("      if (has_out && lane == 31) {\n",
     "      if (has_out && lane == 31) {\n"
     "        const long long tp = clock64();\n"),
    ("          st_rel(prog_out, i + 1, out_remote);\n      }\n",
     "          st_rel(prog_out, i + 1, out_remote);\n"
     "        P[3] += clock64() - tp;\n      }\n"),
    ("j0 + 3 < qlen ? H[3] : SENT);\n      }\n    }\n",
     "j0 + 3 < qlen ? H[3] : SENT);\n      }\n"
     "      P[2] += clock64() - tr;\n      P[4] += 1;\n    }\n"
     "    if (lane == 0)\n      for (int k = 0; k < 5; ++k)\n"
     "        if (k != 3) atomicAdd(&g_prof[k], (unsigned long long)P[k]);\n"
     "    if (lane == 31) atomicAdd(&g_prof[3], (unsigned long long)P[3]);\n"),
)
STRIPS_BREAKDOWN_CASES = ("whale_cig_z100", "whale_extd_cig_z100",
                          "mixed700_score_z100", "mixed700_extd_score_z100",
                          "mixed512_merged_score",
                          "mixed512_merged_extd_score")


def breakdown_strips():
    """Cycles a strip-row of kernel A by part (CUDA clock64 sums over the
    strips' lanes 0 and 31, over the strip-rows computed) on the whale
    CIGAR launches, the mixed700 score launches and the merged mixed-512
    score launches: ``wait`` is the wait for the edge of the strip before,
    ``scan`` the warp scans, ``cells`` the rest of the row (the cells'
    passes, the bytes, the diagonal maxima), ``publish`` lane 31's hand-on
    (its wait for a free ring entry included; strips with no strip after
    count 0); the stamps themselves cost cycles."""
    import torch
    from ksw2_tpu_torch.ops import strips as S

    lib = breakdown_library("strips_fwd", STRIPS_BREAKDOWN_STAMPS,
                            "ksw2t_strips_fwd", PROF_READ)
    saved = S.library
    S.library = lambda: lib
    try:
        for name, ln in fwd_cases(mixed_jobs()):
            if name not in STRIPS_BREAKDOWN_CASES:
                continue
            call = fwd_call(name, ln, S.upload(ln, "cuda"))
            lay = fwd_layout(name, ln)
            call()
            torch.cuda.synchronize()
            prof = np.zeros(16, np.uint64)
            lib.ksw2t_prof_read(prof.ctypes.data)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            call()
            t1.record()
            t1.synchronize()
            lib.ksw2t_prof_read(prof.ctypes.data)
            rows = float(prof[4])
            part = {k: float(prof[i]) / rows
                    for i, k in enumerate(STRIPS_BREAKDOWN_PARTS[:4])}
            part["cells"] = part["row"] - part["wait"] - part["scan"]
            emit({"phase": "breakdown", "case": name, "kernel": "strips",
                  "nw": lay.nw, "cl": lay.cl, "blocks": lay.blocks,
                  "ms_stamped": t0.elapsed_time(t1),
                  "strip_rows": int(rows), "cycles_per_strip_row": part})
    finally:
        S.library = saved


# walk.cuh: the walker warp's lane 0 sums the cycles of its walk (0 its
# waits for staged windows: the first and each switch, 1 asking the
# stager for one, 2 the whole walk) and counts its steps (3), windows (4)
# and blocks of steps (5); the stager warp's lane 0 sums the cycles of
# issuing a window's copies (6) and of waiting for them to land (7)
WALK_BREAKDOWN_STAMPS = (
    ('#include "common.cuh"\n',
     '#include "common.cuh"\n'
     "__device__ unsigned long long g_prof[16];\n"),
    ("    stage<FORM>(P, W, S.buf[k], S.row[k], S.rel[k], lane);\n"
     "    cp_wait();\n",
     "    const long long t0 = clock64();\n"
     "    stage<FORM>(P, W, S.buf[k], S.row[k], S.rel[k], lane);\n"
     "    const long long t1 = clock64();\n    cp_wait();\n"
     "    if (lane == 0) {\n"
     "      atomicAdd(&g_prof[6], (unsigned long long)(t1 - t0));\n"
     "      atomicAdd(&g_prof[7], (unsigned long long)(clock64() - t1));\n"
     "    }\n"),
    ("    S.req = W;\n    S.req_buf = 0;\n    bar_arrive(BAR_REQ);\n"
     "    bar_sync(BAR_DONE);\n",
     "    long long PF[6] = {0, 0, 0, 0, 1, 0};\n"
     "    const long long tT = clock64();\n"
     "    S.req = W;\n    S.req_buf = 0;\n    bar_arrive(BAR_REQ);\n"
     "    bar_sync(BAR_DONE);\n    PF[0] += clock64() - tT;\n"
     "    long long t1;\n"),
    ("          bar_sync(BAR_DONE);\n          W = N;\n",
     "          t1 = clock64();\n          bar_sync(BAR_DONE);\n"
     "          PF[0] += clock64() - t1;\n          W = N;\n"),
    ("          bar_arrive(BAR_REQ);\n          pending = true;\n",
     "          t1 = clock64();\n          bar_arrive(BAR_REQ);\n"
     "          PF[1] += clock64() - t1;\n          PF[4] += 1;\n"
     "          pending = true;\n"),
    ("        ++t;\n        step_back(o, i, j);\n",
     "        ++t;\n        PF[3] += 1;\n        step_back(o, i, j);\n"),
    # a block's parts, each stamp after an add that waits on its inputs:
    # its loads (8), its steps (9) and the hand-over to all lanes (10)
    ("      const int d1 = d + dd1, d2 = d + dd2, d3 = d + dd3;\n",
     "      const long long tb0 = clock64();\n"
     "      const int d1 = d + dd1, d2 = d + dd2, d3 = d + dd3;\n"),
    ("      const int f3 = cell_code<FORM>(i3, e3, up);\n",
     "      const int f3 = cell_code<FORM>(i3, e3, up);\n"
     "      int sink_;\n"
     "      asm volatile(\"add.s32 %0, %1, %2;\" : \"=r\"(sink_)"
     " : \"r\"(b0 + b1 + f1), \"r\"(b2 + b3 + f2 + f3));\n"
     "      const long long tb1 = clock64();\n"),
    ("      const int best = __reduce_max_sync(FULL, (n << 5) | lane);\n",
     "      asm volatile(\"add.s32 %0, %1, %2;\" : \"=r\"(sink_)"
     " : \"r\"(n + s + sink_), \"r\"(ci + cj + got));\n"
     "      const long long tb2 = clock64();\n"
     "      const int best = __reduce_max_sync(FULL, (n << 5) | lane);\n"),
    ("      t += n;\n",
     "      t += n;\n"
     "      asm volatile(\"add.s32 %0, %1, %2;\" : \"=r\"(sink_)"
     " : \"r\"(state + i + sink_), \"r\"(j + got));\n"
     "      if (lane == 0) {\n"
     "        const long long tb3 = clock64();\n"
     "        atomicAdd(&g_prof[8], (unsigned long long)(tb1 - tb0));\n"
     "        atomicAdd(&g_prof[9], (unsigned long long)(tb2 - tb1));\n"
     "        atomicAdd(&g_prof[10], (unsigned long long)(tb3 - tb2));\n"
     "      }\n"),
    ("      if ((i | j) < 0) break;\n    }\n  }\n",
     "      PF[3] += n;\n      PF[5] += 1;\n"
     "      if ((i | j) < 0) break;\n    }\n"
     "    PF[2] += clock64() - tT;\n    if (lane == 0)\n"
     "      for (int k = 0; k < 6; ++k)\n"
     "        atomicAdd(&g_prof[k], (unsigned long long)PF[k]);\n  }\n"),
)
WALK_BREAKDOWN_CASES = ("single50k_cig", "mt_cig", "splice_long_cig",
                        "sr_extz_cig", "long1_extz_cig", "long128_cig",
                        "sb_extz_cig", "mt_gg2", "whale_cig", "nop256_cig")


def walk_breakdown_library():
    """The three walkers' sources built as one file with a clock64-stamped
    copy of walk.cuh in build/diag_breakdown/walk/; returns it loaded with
    its four entry points' argument types set."""
    import ctypes

    from ksw2_tpu_torch import _build

    hdr = (_build.CSRC / "walk.cuh").read_text()
    for anchor, stamped in WALK_BREAKDOWN_STAMPS:
        if hdr.count(anchor) != 1:
            raise RuntimeError(f"breakdown: anchor not found once in "
                               f"walk.cuh: {anchor!r}")
        hdr = hdr.replace(anchor, stamped)
    out = _build.BUILD_DIR.parent / "diag_breakdown" / "walk"
    out.mkdir(parents=True, exist_ok=True)
    (out / "walk.cuh").write_text(hdr)
    src = "".join((_build.CSRC / f).read_text()
                  for f in ("extz_walk.cu", "band_walk.cu", "strips_walk.cu"))
    (out / "walks_stamped.cu").write_text(src + BREAKDOWN_READ)
    lib_path = out / "libwalks_stamped.so"
    nvcc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
         str(_build.CSRC), str(out / "walks_stamped.cu"), "-o",
         str(lib_path)], capture_output=True, text=True)
    if nvcc.returncode:
        raise RuntimeError("breakdown: nvcc failed on walks_stamped.cu:\n"
                           f"{nvcc.stdout[-4000:]}{nvcc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("ksw2t_extz_walk", "ksw2t_band_walk", "ksw2t_flat_walk",
               "ksw2t_strips_walk"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.ksw2t_prof_read.argtypes = [ctypes.c_void_p]
    return lib


def breakdown_walk():
    """Cycles a step of kernels 17, D and B by part (CUDA clock64 sums over
    each walker warp's lane 0, over all its launches' steps): ``wait`` for
    a staged window (the first, and each switch to one asked for at the
    half), ``ask`` asking the stager for one, ``step`` the rest; and the
    stager warp's cycles a window, issuing its copies and waiting for
    them to land.  The cycles a step of the longest walk bound a launch's
    time from below (the stamps cost cycles themselves)."""
    import torch
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import strips_walker as SW
    from ksw2_tpu_torch.ops import traceback_device as TB

    lib = walk_breakdown_library()
    saved = TB.library, BW.library, SW.library
    TB.library = BW.library = SW.library = lambda: lib
    try:
        for name in WALK_BREAKDOWN_CASES:
            fn, _, walks, _ = walk_launches(name)
            [fn(*a) for a in walks]
            torch.cuda.synchronize()
            prof = np.zeros(16, np.uint64)
            lib.ksw2t_prof_read(prof.ctypes.data)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            outs = [fn(*a) for a in walks]
            t1.record()
            t1.synchronize()
            lib.ksw2t_prof_read(prof.ctypes.data)
            steps, longest = walk_steps(outs)
            n = max(float(prof[3]), 1.0)
            part = {"wait": float(prof[0]) / n, "ask": float(prof[1]) / n,
                    "walk": float(prof[2]) / n}
            part["step"] = part["walk"] - part["wait"] - part["ask"]
            blocks = max(float(prof[5]), 1.0)
            block = {k: float(prof[8 + q]) / blocks for q, k in enumerate(
                ("loads", "steps", "hand_over"))}
            wins = max(float(prof[4]), 1.0)
            stager = {"issue": float(prof[6]) / wins,
                      "land": float(prof[7]) / wins}
            emit({"phase": "breakdown", "case": name, "kernel":
                  WALK_CASES[name], "launches": len(walks),
                  "ms_stamped": t0.elapsed_time(t1), "steps": int(prof[3]),
                  "walk_steps": steps, "longest_walk_steps": longest,
                  "windows": int(prof[4]), "blocks": int(prof[5]),
                  "steps_per_block": n / max(float(prof[5]), 1.0),
                  "cycles_per_step": part, "cycles_per_block": block,
                  "stager_cycles_per_window": stager})
            del walks, outs
            torch.cuda.empty_cache()
    finally:
        TB.library, BW.library, SW.library = saved


def phase_walk_times() -> int:
    """``--walk-times``: kernels 17, D and B on every walk case
    (:func:`walk_times`), with no plain version and no check; it also
    runs on the parent's tree, to compare two trees in one call."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the times need a CUDA card")
    int_rate = phase_device()
    phase_build()
    emit({"phase": "walk_times", "cases": walk_times(int_rate)})
    return 0


def batch_walls(reps=5):
    """The short-banded score and CIGAR batches and the wide runs (the
    mixed pairs of 1536 bp or less as EQX CIGARs and two-piece end_bonus
    scores) end to end through ``Aligner.extend_batch_async``, after a
    warm one: each run's host submit (until the call returns) and wall
    (until ``result()``), the device memory allocated before the batch
    and its peak during one run (``torch.cuda.max_memory_allocated``),
    the route's launches with their direction-byte stores (B x nd x ncol
    bytes a CIGAR launch, :func:`batch_route_launches`), and one profiled
    run's device time and idle share (:func:`profile_runs`); and apart
    from them, ``reps`` times, the host's part that the batched route's
    merge touches on the short-banded batches: its routing (the buckets
    and their merge, every bucket on the batched route) and ``band_prep``
    of its launches (:func:`short_banded_launches`)."""
    import torch
    from ksw2_tpu_torch import Aligner
    from ksw2_tpu_torch.core.flags import Flag

    sb = _workload("sb")
    flags = {"short_banded_score": Flag.SCORE_ONLY,
             "short_banded_cigar": Flag.NONE}
    runs = {name: (Aligner(w=SHORT_BANDED_W, zdrop=100, flag=flag), sb)
            for name, flag in flags.items()}
    short1536 = [p for p in mixed_jobs() if len(p[1]) <= 1536]
    runs.update({name: (aln, short1536)
                 for name, aln in batch_wide_aligners().items()})
    out = {}
    for name, (aln, pairs) in runs.items():
        aln.extend_batch(pairs)
        row = out[name] = {"pairs": len(pairs), "submit_ms": [],
                           "wall_ms": []}
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = aln.extend_batch_async(pairs)
            t1 = time.perf_counter()
            h.result()
            row["submit_ms"].append((t1 - t0) * 1e3)
            row["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row["allocated_before_mb"] = torch.cuda.memory_allocated() / 2**20
        aln.extend_batch(pairs)
        torch.cuda.synchronize()
        row["peak_allocated_mb"] = torch.cuda.max_memory_allocated() / 2**20
        lns = batch_route_launches(aln, pairs)
        row["batch_launches"] = [
            {"pairs": len(ln.qlen), "nd": int(ln.nd), "ncol": int(ln.ncol),
             "store_bytes": len(ln.qlen) * int(ln.nd) * int(ln.ncol)
             if ln.prm.cig else 0} for ln in lns]
        if name in flags:
            host = [short_banded_launches(sb, flags[name])[1:]
                    for _ in range(reps)]
            row["host_route_ms"] = [r * 1e3 for r, _ in host]
            row["host_prep_ms"] = [p * 1e3 for _, p in host]
    prof = profile_runs([(name, lambda r=r: r[0].extend_batch(r[1]))
                         for name, r in runs.items()])
    for name, row in out.items():
        row["profiled"] = prof[name]
    return out


def band_times(names=("long128_extz_score", "long128_extd_score")):
    """Kernels 9 / 10 alone (CUDA events) on the long-banded workload's
    one score launch, one- and two-piece: the band forward's kernel,
    which the batched wide form launches too."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops import band as BD

    out = {}
    for name in names:
        ln = band_launch(_workload("long"), BAND_W, Flag.SCORE_ONLY, 400,
                         EXTD if "extd" in name else None)
        args = BD.band_upload(ln, "cuda")
        ms = cuda_ms(lambda: BD.band_forward_cuda(*args, ln.prm, ln.nd,
                                                  ln.ncol), 3)
        out[name] = {"kernel": "band_extd_fwd" if ln.prm.two else
                     "band_fwd", "pairs": len(ln.qlen), "fwd_ms": ms,
                     "us_per_diagonal": ms * 1e3 / ln.nd}
        del args
    return out


def phase_batch_times() -> int:
    """``--batch-times``: kernels E / E2 on every batched time case
    (:func:`batch_times`) and kernels 9 / 10 on the long-banded score
    launch (:func:`band_times`), with no plain version and no check, and
    the short-banded and wide batches' walls and peak memory
    (:func:`batch_walls`).  It also runs on the parent's tree, to compare two trees in one call: a scheduler with
    no ``_merged_batch`` keeps the batched route's buckets apart, and a
    kernel with no ``batch_form`` has one form."""
    import torch
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.ops import batch as BT

    if not torch.cuda.is_available():
        raise RuntimeError("the times need a CUDA card")
    if not hasattr(sched, "_merged_batch"):
        sched._merged_batch = lambda buckets, m: buckets
    if not hasattr(BT, "batch_form"):
        BT.batch_form = lambda ncol, m: None
    int_rate = phase_device()
    phase_build()
    emit({"phase": "batch_times", "cases": batch_times(int_rate)})
    emit({"phase": "band_times", "cases": band_times()})
    emit({"phase": "batch_walls", "runs": batch_walls()})
    return 0


# csrc/batch_fwd.cu's register form with its BATCH_STAMP hooks defined
# (32-bit clock() stamps: a pair's sums fit, and 64-bit ones spill the CIG
# forms): each warp's lane 0 sums the cycles of a diagonal's parts (0 the
# head:
# band row, slide, query shift, score fill, first column, neighbour
# shuffles; 1 the cells; 2 the argmax (or the H0 walk) and the group
# capture; 3 the store) and of a group's (4 the replay, 5 the staging),
# and counts its diagonals (8) and pairs (9)
BATCH_STAMPS = """#define BATCH_STAMPS 1
__device__ unsigned long long g_prof[16];
#define BATCH_STAMP_INIT() unsigned pf_[6] = {0, 0, 0, 0, 0, 0}; \\
  unsigned pt_ = (unsigned)clock();
#define BATCH_STAMP(part) { const unsigned pn_ = (unsigned)clock(); \\
  pf_[part] += pn_ - pt_; pt_ = pn_; }
#define BATCH_STAMP_FLUSH(diags) if (lane == 0) { \\
  for (int i_ = 0; i_ < 6; ++i_) \\
    atomicAdd(&g_prof[i_], (unsigned long long)pf_[i_]); \\
  atomicAdd(&g_prof[8], (unsigned long long)(diags)); \\
  atomicAdd(&g_prof[9], 1ull); }
"""
BATCH_BREAKDOWN_PARTS = ("head", "cells", "argmax", "store", "replay",
                         "staging")
# the score forms: the CIG forms sit at the compiler's 128 registers, and
# the stamps' registers spill their cells (a stamped run 4-7x slower)
BATCH_BREAKDOWN_CASES = ("sb_extz_score", "sb_extd_score", "sb_approx_score")


def breakdown_batch_wide():
    """Cycles a tile-diagonal of each part of kernels E / E2's wide form
    (band_fwd.cu stamped as ``--breakdown band`` stamps it) and the
    replay warp's cycles a group, on the wide runs' merged main-path
    launches (EQX CIGARs, two-piece end_bonus scores), with the stamped
    run's milliseconds."""
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import batch as BT

    lib = breakdown_library("band_fwd", BAND_BREAKDOWN_STAMPS,
                            "ksw2t_band_fwd")
    saved = BD.library
    BD.library = lambda: lib
    try:
        for name in ("short1536_eqx_cigar", "short1536_extd_end_bonus_score"):
            kname, lns = batch_time_launches(name)
            ms, prof = _stamped_run(lib, lns, lambda a, ln: BT.
                                    batch_forward_cuda(*a, ln.prm, ln.nd,
                                                       ln.ncol))
            nd = max(float(prof[7]), 1.0)
            parts = {k: float(prof[i]) / nd
                     for i, k in enumerate(BAND_BREAKDOWN_PARTS)}
            parts["total"] = float(prof[8]) / nd
            groups = max(float(prof[12]), 1.0)
            emit({"phase": "breakdown", "case": name, "kernel": kname,
                  "form": "wide", "launches": len(lns),
                  "layouts": [BT.wide_layout(ln.ncol, bool(ln.prm.cig))
                              for ln in lns],
                  "ms_stamped": ms, "tile_diagonals": int(prof[7]),
                  "cycles_per_tile_diagonal": parts,
                  "replay_groups": int(prof[12]),
                  "replay_cycles_per_group": {
                      "wait": float(prof[10]) / groups,
                      "work": float(prof[11]) / groups}})
    finally:
        BD.library = saved


def batch_stamped_library():
    """``csrc/batch_fwd.cu`` built with the BATCH_STAMPS prelude (its
    register kernel's hooks defined), loaded, with the argument types of
    its entry points (E / E2's and kernel 6's register form) set.  The
    stamped source and its library are named by the source's hash, so a
    library is reused only for the text it was built from."""
    import ctypes
    import hashlib

    from ksw2_tpu_torch import _build

    text = (BATCH_STAMPS + (_build.CSRC / "batch_fwd.cu").read_text() +
            BREAKDOWN_READ)
    key = hashlib.sha256(text.encode()).hexdigest()[:16]
    out = _build.BUILD_DIR.parent / "diag_breakdown"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"batch_fwd_stamped_{key}.cu"
    lib_path = out / f"libbatch_fwd_stamped_{key}.so"
    if not lib_path.exists():
        cu.write_text(text)
        nvcc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
             str(_build.CSRC), str(cu), "-o", str(lib_path)],
            capture_output=True, text=True)
        if nvcc.returncode:
            raise RuntimeError(f"breakdown: nvcc failed on {cu.name}:\n"
                               f"{nvcc.stdout[-4000:]}{nvcc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("ksw2t_batch_fwd", "ksw2t_batch_exts_reg_fwd"):
        getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.ksw2t_prof_read.argtypes = [ctypes.c_void_p]
    lib.ksw2t_error_string.argtypes = [ctypes.c_int]
    lib.ksw2t_error_string.restype = ctypes.c_char_p
    return lib


def breakdown_batch():
    """Cycles a diagonal of kernels E / E2's register form by part (CUDA
    clock sums over each warp's lane 0, over the diagonals its pair
    computed) on the short-banded workload's score launches, and the
    stamped run's milliseconds (the stamps cost cycles themselves); then
    the wide form's (:func:`breakdown_batch_wide`)."""
    from ksw2_tpu_torch.ops import batch as BT

    lib = batch_stamped_library()
    saved = BT.library
    BT.library = lambda: lib
    try:
        for name in BATCH_BREAKDOWN_CASES:
            _, lns = batch_time_launches(name)
            ms, prof = _stamped_run(lib, lns, lambda a, ln: BT.
                                    batch_forward_cuda(*a, ln.prm, ln.nd,
                                                       ln.ncol))
            diags = max(float(prof[8]), 1.0)
            groups = sum(-(-int(ln.nd) // 32) for ln in lns)
            emit({"phase": "breakdown", "case": name,
                  "kernel": "batch_extd_fwd" if lns[0].prm.two
                  else "batch_fwd", "launches": len(lns),
                  "cpl": [BT.batch_form(ln.ncol, ln.prm.m) for ln in lns],
                  "ms_stamped": ms, "pairs": int(prof[9]),
                  "diagonals": int(prof[8]),
                  "cycles_per_diagonal": {
                      k: float(prof[i]) / diags
                      for i, k in enumerate(BATCH_BREAKDOWN_PARTS)},
                  "cycles_per_diagonal_total": float(
                      sum(int(prof[i]) for i in range(6))) / diags,
                  "longest_pair_groups": groups})
    finally:
        BT.library = saved
    breakdown_batch_wide()


# a stamp of the 32-bit clock() sums a warp's lane 0 keeps (pf_[i] the
# cycles since the last stamp), and the sums' device array
STAMP_NOW = ("{ const unsigned pn_ = (unsigned)clock(); "
             "pf_[%d] += pn_ - pt_; pt_ = pn_; }")
G_PROF = (
    "constexpr unsigned FULL = 0xffffffffu;\n",
    "constexpr unsigned FULL = 0xffffffffu;\n"
    "__device__ unsigned long long g_prof[16];\n")
EXTS_BREAKDOWN_CASES = ("main_junc_score", "main_junc_cig",
                        "wide_junc_score", "wide_junc_cig")


def splice_main_launch(name):
    """The scheduler's one launch of an annotated splice workload (kernel
    6): the 1024-pair one's (``main_junc_score``, ``main_junc_cig``) or
    splice-wide's (``wide_junc_score``, ``wide_junc_cig``)."""
    from ksw2_tpu_torch.core.flags import Flag

    if name.startswith("wide"):
        pairs, junc = splice_wide_jobs(), splice_wide_junc()
    else:
        pairs, junc = splice_jobs() * SPLICE_TILES, splice_junc()
    flag = Flag.SPLICE_FOR | (Flag.SCORE_ONLY if name.endswith("score")
                              else Flag.NONE)
    (route, ln), = splice_launches(pairs, flag, [junc] * len(pairs),
                                   SPLICE_JUNC_BONUS)
    assert route == "batch", route
    return ln


def breakdown_exts():
    """Cycles of kernel 6 by part on the annotated splice launches (score,
    CIG): its wide form (``band_fwd.cu`` stamped as ``--breakdown band``
    stamps it, a tile-diagonal's parts and the replay warp's group,
    launched on every case whatever its form) and its register form
    (``batch_fwd.cu`` with its ``BATCH_STAMP`` hooks, a diagonal's parts
    as ``--breakdown batch`` gives them) on the cases that take it."""
    from ksw2_tpu_torch.ops import batch_exts as BE

    lib = breakdown_library("band_fwd", BAND_BREAKDOWN_STAMPS,
                            "ksw2t_band_exts_fwd")
    saved = BE.library
    BE.library = lambda: lib
    try:
        for name in EXTS_BREAKDOWN_CASES:
            ln = splice_main_launch(name)
            ms, prof = _stamped_run(lib, [ln], lambda a, ln: BE.
                                    batch_exts_wide_cuda(*a, ln.prm, ln.nd,
                                                         ln.ncol))
            nd = max(float(prof[7]), 1.0)
            parts = {k: float(prof[i]) / nd
                     for i, k in enumerate(BAND_BREAKDOWN_PARTS)}
            parts["total"] = float(prof[8]) / nd
            groups = max(float(prof[12]), 1.0)
            emit({"phase": "breakdown", "case": name,
                  "kernel": "batch_exts_fwd", "form": "wide",
                  "layout": BE.exts_wide_layout(ln.ncol), "ms_stamped": ms,
                  "pairs": len(ln.qlen), "tile_diagonals": int(nd),
                  "cycles_per_tile_diagonal": parts,
                  "replay_cycles_per_group": {
                      "wait": float(prof[10]) / groups,
                      "work": float(prof[11]) / groups}})
    finally:
        BE.library = saved
    breakdown_exts_register()


def breakdown_exts_register():
    """Cycles a diagonal of kernel 6's register form by part (the parts of
    ``--breakdown batch``) on the annotated splice launches, with the
    stamped run's milliseconds."""
    from ksw2_tpu_torch.ops import batch_exts as BE

    lib = batch_stamped_library()
    saved = BE.library
    BE.library = lambda: lib
    try:
        for name in EXTS_BREAKDOWN_CASES:
            ln = splice_main_launch(name)
            if not BE.exts_form(ln.ncol, ln.prm.m):
                continue
            ms, prof = _stamped_run(lib, [ln], lambda a, ln: BE.
                                    batch_exts_forward_cuda(*a, ln.prm,
                                                            ln.nd, ln.ncol))
            diags = max(float(prof[8]), 1.0)
            emit({"phase": "breakdown", "case": name,
                  "kernel": "batch_exts_fwd", "form": "register",
                  "cpl": BE.exts_form(ln.ncol, ln.prm.m),
                  "ms_stamped": ms, "pairs": int(prof[9]),
                  "diagonals": int(prof[8]),
                  "cycles_per_diagonal": {
                      k: float(prof[i]) / diags
                      for i, k in enumerate(BATCH_BREAKDOWN_PARTS)},
                  "cycles_per_diagonal_total": float(
                      sum(int(prof[i]) for i in range(6))) / diags})
    finally:
        BE.library = saved


# kernel 18 (csrc/batch_local.cu) stamped at anchors the same way, a
# query row at a time: 0 its head (the query symbol's broadcast, the
# diagonal neighbour's shuffle, the scores), 1 F and H', 2 E's lane pass
# and the lanes' 5-round scan, 3 its tail (the carry in, E, H, the best,
# the next query chunk); 4 the end (the argmax butterfly, once a pair);
# 8 rows, 10 pairs
LOCAL_STAMPS = (
    G_PROF,
    ("  int qcur = qload(0), qnxt = qload(1);\n",
     "  int qcur = qload(0), qnxt = qload(1);\n  unsigned pf_[5] = {0, 0, 0, "
     "0, 0}, nd_ = 0;\n  unsigned pt_ = (unsigned)clock();\n"),
    ("    int Hq[CELLS];                   // H' = max(0, diagonal + s, F)\n",
     "    " + STAMP_NOW % 0 + "\n"
     "    int Hq[CELLS];                   // H' = max(0, diagonal + s, F)\n"),
    ("    // E: the lane's cells with no carry in, then its carry out\n",
     "    " + STAMP_NOW % 1 + "\n"
     "    // E: the lane's cells with no carry in, then its carry out\n"),
    ("    int Ein = __shfl_up_sync(FULL, X, 1);    // E(t0)\n",
     "    " + STAMP_NOW % 2 + "\n"
     "    int Ein = __shfl_up_sync(FULL, X, 1);    // E(t0)\n"),
    ("      qnxt = qload((i >> 5) + 2);\n    }\n  }\n",
     "      qnxt = qload((i >> 5) + 2);\n    }\n"
     "    " + STAMP_NOW % 3 + "\n    ++nd_;\n  }\n"),
    ("  if (lane == 0) {\n    int* out = A.res + (size_t)b * 3;",
     "  " + STAMP_NOW % 4 + "\n  if (lane == 0) {\n"
     "    for (int i_ = 0; i_ < 5; ++i_)\n"
     "      atomicAdd(&g_prof[i_], (unsigned long long)pf_[i_]);\n"
     "    atomicAdd(&g_prof[8], (unsigned long long)nd_);\n"
     "    atomicAdd(&g_prof[10], 1ull);\n  }\n"
     "  if (lane == 0) {\n    int* out = A.res + (size_t)b * 3;"),
)
LOCAL_PARTS = ("head", "cells", "scan", "tail", "end")


def breakdown_local():
    """Cycles a query row of kernel 18 by part (and its end, a pair) on
    each local set at A2 B4 q4 e2, with the stamped run's
    milliseconds."""
    import torch
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import batch_local as BL

    lib = breakdown_library("batch_local", LOCAL_STAMPS,
                            "ksw2t_batch_local_fwd")
    a, b, q, e = LOCAL_COSTS
    prm = BL.local_params(5, simple_mat(5, a, -b), q, e)
    saved = BL.library
    BL.library = lambda: lib
    try:
        for name, arrays in local_sets().items():
            args = local_upload(*arrays)
            prof = np.zeros(16, np.uint64)
            lib.ksw2t_prof_read(prof.ctypes.data)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            BL.local_forward_cuda(*args, prm)
            t1.record()
            t1.synchronize()
            lib.ksw2t_prof_read(prof.ctypes.data)
            steps = max(float(prof[8]), 1.0)
            pairs = max(float(prof[10]), 1.0)
            parts = {k: float(prof[i]) / steps
                     for i, k in enumerate(LOCAL_PARTS[:4])}
            emit({"phase": "breakdown", "case": name,
                  "kernel": "batch_local_fwd",
                  "ms_stamped": t0.elapsed_time(t1),
                  "pairs": int(prof[10]), "rows": int(prof[8]),
                  "rows_per_pair": steps / pairs,
                  "cycles_per_row": parts,
                  "cycles_per_row_total": sum(parts.values()),
                  "end_cycles_per_pair": float(prof[4]) / pairs})
            del args
    finally:
        BL.library = saved


# the rows kernel (csrc/rows_fwd.cu) through its ROWS_STAMP hooks, which
# this prelude defines, summed over each warp's lane 0: 0 a step's head
# (the three shuffles, lane 0's boundary), 1 the last step's cells into D
# (the finished diagonal's atomic, the keys, Dq), 2 the step's cells;
# 8 steps, 9 pairs
ROWS_BREAKDOWN_STAMPS = (
    ("#ifndef ROWS_STAMPS\n",
     """#define ROWS_STAMPS 1
__device__ unsigned long long g_prof[16];
#define ROWS_STAMP_INIT() unsigned pf_[3] = {0, 0, 0}; \\
  unsigned pt_ = (unsigned)clock();
#define ROWS_STAMP(part) { const unsigned pn_ = (unsigned)clock(); \\
  pf_[part] += pn_ - pt_; pt_ = pn_; }
#define ROWS_STAMP_FLUSH(steps) if (lane == 0) { \\
  for (int i_ = 0; i_ < 3; ++i_) \\
    atomicAdd(&g_prof[i_], (unsigned long long)pf_[i_]); \\
  atomicAdd(&g_prof[8], (unsigned long long)(steps)); \\
  atomicAdd(&g_prof[9], 1ull); }
#ifndef ROWS_STAMPS\n"""),
)
ROWS_BREAKDOWN_PARTS = ("head", "keys", "cells")


def breakdown_rows():
    """Cycles a step of the rows kernel by part (:data:`ROWS_BREAKDOWN_
    STAMPS`) on the rows cases, with the stamped run's milliseconds."""
    import torch
    from ksw2_tpu_torch.ops import rows as R
    from ksw2_tpu_torch.ops import strips as S

    lib = breakdown_library("rows_fwd", ROWS_BREAKDOWN_STAMPS,
                            "ksw2t_rows_fwd")
    saved = R.library
    R.library = lambda: lib
    try:
        for name, ln in rows_cases(short_jobs()):
            args = S.upload(ln, "cuda")
            prof = np.zeros(16, np.uint64)
            lib.ksw2t_prof_read(prof.ctypes.data)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            R.rows_forward_cuda(*args, ln.prm)
            t1.record()
            t1.synchronize()
            lib.ksw2t_prof_read(prof.ctypes.data)
            steps = max(float(prof[8]), 1.0)
            parts = {k: float(prof[i]) / steps
                     for i, k in enumerate(ROWS_BREAKDOWN_PARTS)}
            emit({"phase": "breakdown", "case": name, "kernel": "rows_fwd",
                  "ms_stamped": t0.elapsed_time(t1), "pairs": int(prof[9]),
                  "steps": int(prof[8]),
                  "steps_per_pair": steps / max(float(prof[9]), 1.0),
                  "cycles_per_step": parts,
                  "cycles_per_step_total": sum(parts.values())})
            del args
    finally:
        R.library = saved


# kernels 8 and 7's register form (gg2_fwd.cu, batch_extf_fwd.cu) through
# its REG_STAMP hooks, which this prelude defines: 0 a diagonal's head
# (band row, slide, query), 1 the score fill, first column and boundary,
# 2 the cells (kernel 8: and the store), 3 the walk, 4 a group's staging,
# 5 kernel 7's group replay; 8 diagonals, 9 pairs
REG_STAMPS = """#define REG_STAMPS 1
__device__ unsigned long long g_prof[16];
#define REG_STAMP_INIT() unsigned rf_[6] = {0, 0, 0, 0, 0, 0}; \\
  unsigned rt_ = (unsigned)clock();
#define REG_STAMP(part) { const unsigned rn_ = (unsigned)clock(); \\
  rf_[part] += rn_ - rt_; rt_ = rn_; }
#define REG_STAMP_FLUSH(diags) if (lane == 0) { \\
  for (int i_ = 0; i_ < 6; ++i_) \\
    atomicAdd(&g_prof[i_], (unsigned long long)rf_[i_]); \\
  atomicAdd(&g_prof[8], (unsigned long long)(diags)); \\
  atomicAdd(&g_prof[9], 1ull); }
"""
REG_PARTS = ("head", "fill", "cells", "walk", "staging", "replay")
# and their strip form (a warp's u, v, x, y, s strips in shared memory),
# stamped at anchors the same way,
# a diagonal at a time: 0 its head (band row, the boundary read, the
# first barrier), 1 its chunk steps (32 positions each: the score, the
# strips' loads, shuffles, the cells, stores), 2 the walk (the second
# barrier, the H0 walk; extf its X-drop test); 8 diagonals, 9 chunk
# steps, 10 pairs
def _indent(line):
    return line[:len(line) - len(line.lstrip())]


def _strip_stamps(init, chunk_loop, after_chunks, loop_end, flush_at):
    return (
        ("#include <climits>\n", REG_STAMPS + "#include <climits>\n"),
        (init, init + "  unsigned pf_[3] = {0, 0, 0}, nc_ = 0, nd_ = 0;\n"
         "  unsigned pt_ = (unsigned)clock();\n"),
        (chunk_loop, _indent(chunk_loop) + STAMP_NOW % 0 + "\n" +
         chunk_loop + _indent(chunk_loop) + "  ++nc_;\n"),
        (after_chunks, "    " + STAMP_NOW % 1 + "\n" + after_chunks),
        (loop_end, loop_end.replace(
            "  }\n", "    " + STAMP_NOW % 2 + "\n    ++nd_;\n  }\n", 1)),
        (flush_at, "  if (lane == 0) {\n    for (int i_ = 0; i_ < 3; ++i_)\n"
         "      atomicAdd(&g_prof[i_], (unsigned long long)pf_[i_]);\n"
         "    atomicAdd(&g_prof[8], (unsigned long long)nd_);\n"
         "    atomicAdd(&g_prof[9], (unsigned long long)nc_);\n"
         "    atomicAdd(&g_prof[10], 1ull);\n  }\n" + flush_at))


GG2_STRIP_STAMPS = _strip_stamps(
    "  int last_st = -1, last_en = -1, H0 = 0, lt = 0;\n",
    "      for (int c0 = st; c0 <= en; c0 += 32) {\n",
    "    // the O(1) H0 walk along the band (ksw2_gg2_sse.c:102-106); the "
    "next\n",
    "    last_st = st;\n    last_en = en;\n  }\n  if (lane == 0) A.score[b]",
    "  if (lane == 0) A.score[b] = H0;\n")
EXTF_STRIP_STAMPS = _strip_stamps(
    "  int mx = 0, mt = -1, mq = -1, zd = rlim < ndb ? 1 : 0;\n",
    "    for (int c0 = st; c0 <= top; c0 += 32) {\n",
    "    // the O(1) H0 walk and the X-drop (ksw2_extf2_sse.c:80-91)\n",
    "    last_st = st;\n    last_en = en;\n  }\n  if (lane == 0) {\n"
    "    out[0] = mx;",
    "  if (lane == 0) {\n    out[0] = mx; out[1] = mt;")
STRIP_PARTS = ("head", "chunks", "walk")


def lg_breakdown_launches(kind):
    """(name, pairs, bands, xdrop) of the CLI run's batched launches of
    ``kind`` ("gg2" at -w 100, "extf" unbanded at -z 40 and without an
    X-drop): its first 64 pairs and all of them."""
    jobs = _workload("jobs")
    if kind == "gg2":
        gb, _ = cli_split(jobs, "gg2_sse")
        return [("cli64_gg2_batch", gb[:64], [100] * len(gb[:64]), None),
                ("cli_gg2_batch", gb, [100] * len(gb), None)]
    eb, _ = cli_split(jobs, "extf2_sse")
    return [("cli64_extf_batch", eb[:64], _resolve(eb[:64], -1), 40),
            ("cli_extf_batch", eb, _resolve(eb, -1), 40),
            ("cli_extf_batch_xm1", eb, _resolve(eb, -1), -1)]


def _lg_stamped(lib, call, launches, parts, nparts):
    """One breakdown line a launch of ``launches``: ``call(args, w, xdrop,
    pairs)`` under the stamped library ``lib``."""
    import torch
    from ksw2_tpu_torch.ops import batch_extf as BF

    for name, pairs, w, xdrop in launches:
        args = BF.pack_pairs(pairs, w, "cuda")
        call(args, w, xdrop, pairs)
        torch.cuda.synchronize()
        prof = np.zeros(16, np.uint64)
        lib.ksw2t_prof_read(prof.ctypes.data)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        call(args, w, xdrop, pairs)
        t1.record()
        t1.synchronize()
        lib.ksw2t_prof_read(prof.ctypes.data)
        nd = max(float(prof[8]), 1.0)
        cyc = {k: float(prof[i]) / nd for i, k in enumerate(parts[:nparts])}
        yield name, {"ms_stamped": t0.elapsed_time(t1),
                     "pairs": len(pairs), "diagonals": int(prof[8]),
                     "cycles_per_diagonal": cyc,
                     "cycles_per_diagonal_total": sum(cyc.values()),
                     "prof": [int(x) for x in prof]}
        del args


def breakdown_linear_global(kind):
    """``--breakdown gg2`` / ``--breakdown extf``: cycles a diagonal of
    kernel 8 / 7 by part on the CLI run's batched launches (CUDA clock
    sums of each warp's lane 0 over the diagonals its pair computed),
    with the stamped run's milliseconds: the strip form (the source
    stamped at anchors) and the register form (its REG_STAMP hooks) on
    every launch."""
    import torch
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import batch_extf as BF
    from ksw2_tpu_torch.ops import batch_gg2 as BG

    mod, src, stamps = (
        (BG, "gg2_fwd", GG2_STRIP_STAMPS) if kind == "gg2" else
        (BF, "batch_extf_fwd", EXTF_STRIP_STAMPS))
    lib = breakdown_library(src, stamps, (f"ksw2t_batch_{kind}_fwd",
                                          f"ksw2t_batch_{kind}_reg_fwd"))
    table = torch.from_numpy(simple_mat(5, 2, -4).astype(np.int32)).cuda()
    saved = mod.library
    mod.library = lambda: lib
    try:
        for form in ("strip", "register"):
            def call(args, w, xdrop, pairs, form=form):
                fn = dict(lg_batch_forms(kind, [len(a) for a, _ in pairs],
                                         [len(b) for _, b in pairs], w)
                          )[form]
                if kind == "extf":
                    return fn(*args, 2, -4, 2, xdrop)
                pb_np, total = BG.flat_layout([len(a) for a, _ in pairs],
                                              [len(b) for _, b in pairs], w)
                return fn(*args, table, 5, 4, 2,
                          torch.from_numpy(pb_np).cuda(), total)
            parts = STRIP_PARTS if form == "strip" else REG_PARTS
            for name, row in _lg_stamped(lib, call,
                                         lg_breakdown_launches(kind), parts,
                                         len(parts)):
                prof = row.pop("prof")
                if form == "strip":
                    row["chunk_steps_per_diagonal"] = prof[9] / max(prof[8],
                                                                    1)
                emit({"phase": "breakdown", "case": name,
                      "kernel": f"batch_{kind}_fwd",
                      "form": form, **row})
    finally:
        mod.library = saved


def phase_breakdown(which=("extz", "band", "lg", "strips", "walk",
                           "batch", "exts", "local", "gg2", "extf",
                           "rows")) -> int:
    """``--breakdown [extz|band|lg|strips|walk|batch|exts|local|gg2|
    extf|rows]``: the clock64 breakdowns."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the breakdown needs a CUDA card")
    emit({"phase": "device", "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()})
    if "band" in which:
        breakdown_band()
    if "extz" in which:
        breakdown_extz()
    if "lg" in which:
        breakdown_lg()
    if "strips" in which:
        breakdown_strips()
    if "walk" in which:
        breakdown_walk()
    if "batch" in which:
        breakdown_batch()
    if "exts" in which:
        breakdown_exts()
    if "local" in which:
        breakdown_local()
    if "rows" in which:
        breakdown_rows()
    for kind in ("gg2", "extf"):
        if kind in which:
            breakdown_linear_global(kind)
    return 0


def phase_lg_times() -> int:
    """``--lg-times``: the times of kernels 7, 8, 15 and 16 of phase 7
    alone (linear_global_times), with no plain version and no check; it
    also runs on a tree whose kernels 15 and 16 are not tiled, for
    comparing two trees in one call."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the times need a CUDA card")
    int_rate = phase_device()
    phase_build()
    jobs = mixed_jobs()
    times = linear_global_times(lg_cases(jobs),
                                single_pair(SINGLE_SEED, SINGLE_LEN),
                                single_pair(MT_SEED, MT_LEN), jobs, int_rate)
    emit({"phase": "lg_times", "cases": times})
    return 0


def phase_strips_times() -> int:
    """``--strips-times``: kernel A's times of phase 7 alone (its ALONE
    cases: the whale and mixed700 launches and the merged mixed-512 score
    launches, and the splice path's strips launches), with no plain
    version and no check; it also runs on a tree whose kernel A takes no
    layout, for comparing two trees in one call."""
    import re

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the times need a CUDA card")
    int_rate = phase_device()
    phase_build()
    times = {}
    for name, ln in fwd_cases(mixed_jobs()):
        if re.fullmatch(ALONE["kernel_a"], name):
            times[name] = kernel_a_row(name, ln, int_rate, plain=False)
    for name, route, ln in splice_cases(splice_jobs()):
        if route == "strips" and re.fullmatch(ALONE["splice"], name):
            times[name] = kernel_a_row(name, ln, int_rate, plain=False)
    emit({"phase": "strips_times", "cases": times})
    return 0


def _digest(*tensors) -> str:
    """The first 16 hex digits of the SHA-256 of tensors' bytes: equal
    outputs of two trees in one call show as equal digests."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def exts_times(int_rate, exts_form, wide):
    """Kernel 6 alone (CUDA events) on the annotated splice workloads'
    launches (the 1024 pairs' and splice-wide's, score and CIG) in the
    form the route takes (``exts_form`` of the launch) and in the form
    past the register window (launched by ``wide``: the wide form, or on
    a parent tree before it the strip form), beside its bound, with
    digests of its records and bytes; the band walker on all of the CIG launch's bytes, its time,
    steps and the digest of its output."""
    import torch
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch_exts as BE
    from ksw2_tpu_torch.ops import strips_walker as W

    out = {}
    for name in EXTS_BREAKDOWN_CASES:
        ln = splice_main_launch(name)
        args = BD.band_upload(ln, "cuda")
        _, _, ql, tl, w = args[:5]
        form = exts_form(ln.ncol, ln.prm.m)
        row = {"kernel": "batch_exts_fwd", "pairs": len(ln.qlen),
               "nd": ln.nd, "ncol": ln.ncol, "Lt": int(ln.target.shape[1]),
               "cpl": form}
        for key, fn in (("fwd", BE.batch_exts_forward_cuda),
                        ("wide", wide)):
            row[f"{key}_ms"] = cuda_ms(
                lambda fn=fn: fn(*args, ln.prm, ln.nd, ln.ncol), 10)
        rec, p = BE.batch_exts_forward_cuda(*args, ln.prm, ln.nd, ln.ncol)
        row["digest"] = _digest(rec) if p is None else _digest(rec, p)
        cells, nbytes = exts_work(ln, rec)
        row["computed_cells"] = cells
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
            "batch_exts_fwd", cells, nbytes, int_rate, ln.prm.cig)
        row["fwd_gcells_per_s"] = cells / row["fwd_ms"] / 1e6
        if p is not None:
            walk = (p, W.start_cells(rec, ql, tl, ln.prm.flag, 0), ql, tl, w,
                    W.walk_min_intron(ln.prm.lt, True))
            row["walk_ms"] = cuda_ms(lambda: BW.band_walk_cuda(*walk), 10)
            res, runs = BW.band_walk_cuda(*walk)
            row["walk_digest"] = _digest(res, runs)
            steps, nbytes = walk_work(res, runs, 20)
            row["walk_steps"] = steps
            row["walk_bound_ms"], row["walk_bound_by"] = bound(
                "band_walk", steps, nbytes, int_rate)
            del walk
        del args, rec, p
        out[name] = row
        torch.cuda.empty_cache()
    return out


def phase_exts_times() -> int:
    """``--exts-times``: kernel 6 alone at the main path's launches
    (:func:`exts_times`) and kernels E / E2's register form at theirs
    (the short-banded launches of :func:`batch_times`), with no plain
    version; it also runs on the parent's tree, to compare two trees in
    one call."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the times need a CUDA card")
    from ksw2_tpu_torch.ops import batch_exts as BE

    int_rate = phase_device()
    phase_build()
    # the parent's tree has the strip form alone, as its forward
    emit({"phase": "exts_times", "cases": exts_times(
        int_rate, getattr(BE, "exts_form", lambda ncol, m: 0),
        getattr(BE, "batch_exts_wide_cuda", BE.batch_exts_forward_cuda))})
    emit({"phase": "batch_times", "cases": batch_times(
        int_rate, [n for n in BATCH_TIME_CASES if n.startswith("sb_")])})
    return 0


def phase_local_times() -> int:
    """``--local-times``: kernel 18 alone on each local set
    (:func:`local_times` with no plain version) and each set's pin; it
    also runs on the parent's tree."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the times need a CUDA card")
    int_rate = phase_device()
    phase_build()
    emit({"phase": "local_times", "cases": local_times(int_rate,
                                                       plain=False)})
    return 0


def sass_functions(lib):
    """{name: its SASS instructions with addresses and encodings
    stripped} of every kernel in the shared library ``lib``
    (``cuobjdump -sass``)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if m and name:
            out[name].append(m.group(1))
    return out


def batch_reg_forms(funcs):
    """{(CPL, TWO, SPL, CIG, APPROX, RIGHT): SASS} of the register kernel
    of ``csrc/batch_fwd.cu`` among ``funcs``: kernels E / E2 (CPL 8) and
    kernel 6's register form (SPL, CPL 16); a tree whose kernel had only
    (TWO, CIG, APPROX, RIGHT) gives E / E2's as CPL 8, SPL false."""
    import re

    out = {}
    for name, code in funcs.items():
        m = re.search(r"batch_reg_kernelI((?:L[bi]\d+E)+)E", name)
        if not m:
            continue
        args = [int(a) for a in re.findall(r"L[bi](\d+)E", m.group(1))]
        if len(args) == 4:
            two, cig, approx, right = args
            args = [8, two, 0, cig, approx, right]
        out[tuple(args)] = code
    return out


def band_forms(funcs):
    """{(MODE, CIG, APPROX, NC, RIGHT, SC): SASS} of the kernel of
    ``csrc/band_fwd.cu`` among ``funcs``: kernels 9 / 10 and E / E2's wide
    form (MODE 0 one-piece, 1 two-piece) and kernel 6's wide form (MODE
    2); a tree whose kernel took a bool TWO gives MODE 0 or 1."""
    import re

    out = {}
    for name, code in funcs.items():
        m = re.search(r"band_fwd_kernelI((?:L[bi]\d+E)+)E", name)
        if m:
            out[tuple(int(a) for a in re.findall(r"L[bi](\d+)E",
                                                 m.group(1)))] = code
    return out


def phase_sass_diff(parent_root) -> int:
    """``--sass-diff PARENT``: the SASS of kernels E / E2's and kernel 6's
    register form, and of the band forward's kernel (9 / 10, E / E2's
    and kernel 6's wide form), in this tree's library against the library
    a run of the tree at ``PARENT`` built (its ``build/ksw2_tpu_torch/``),
    instantiation by instantiation: the instructions and whether they are
    the same (an instantiation the parent lacks is new)."""
    from pathlib import Path

    from ksw2_tpu_torch import _build

    mine_f = sass_functions(_build.build())
    theirs_lib = max((Path(parent_root) / "build" / "ksw2_tpu_torch").glob(
        "libksw2t_*.so"), key=lambda p: p.stat().st_mtime)
    theirs_f = sass_functions(theirs_lib)
    for what, key, forms in (("batch_reg", "CPL-TWO-SPL-CIG-APPROX-RIGHT",
                              batch_reg_forms),
                             ("band", "MODE-CIG-APPROX-NC-RIGHT-SC",
                              band_forms)):
        mine, theirs = forms(mine_f), forms(theirs_f)
        rows = {"-".join(map(str, k)): {
            "instructions": len(mine.get(k, [])),
            "parent_instructions": len(theirs.get(k, [])),
            "same": mine.get(k) == theirs.get(k)}
            for k in sorted(set(mine) | set(theirs))}
        emit({"phase": "sass_diff", "kernel": what, "key": key,
              "forms": rows, "all_same_in_parent": all(
                  r["same"] for r in rows.values()
                  if r["parent_instructions"])})
    return 0


# ---------------------------------------------------------------------------
# The mesh (ksw2_tpu_torch/parallel/): the pair batch sharded over logical
# shards of the card (every card when there are more), one pair split over
# them by the halo wavefront, and two processes of the dry-run worker.

MESH_SHARDS = 4               # logical shards of cuda:0 on a one-card host
HALO_K = 256                  # halo_extz_score's block_diagonals
HALO_SRC = "ksw2_tpu_torch/csrc/halo_fwd.cu"
# no pallas_call: the round is parallel/halo.py's fori_loop body
HALO_REPLACES = "ksw2_tpu/parallel/halo.py:53"
# the halo round computes the band route's one-piece recurrence, score
# form (no bytes)
OPS["halo_fwd"] = OPS["band_fwd"]


def mesh_devices():
    """The mesh phase's devices: every card when there are several, else
    MESH_SHARDS logical shards of cuda:0 (one stream each)."""
    import torch

    n = torch.cuda.device_count()
    return ([f"cuda:{i}" for i in range(n)] if n > 1
            else ["cuda:0"] * MESH_SHARDS)


def _padded(pairs):
    """(Q, T, qlen, tlen) of (query, target) pairs, uint8, zero-padded."""
    from ksw2_tpu_torch.batch.scheduler import pad_rows

    return (pad_rows([q for q, _ in pairs]), pad_rows([t for _, t in pairs]),
            np.array([len(q) for q, _ in pairs], np.int32),
            np.array([len(t) for _, t in pairs], np.int32))


def _digest(out, keys=None):
    """A result in a comparable form: ExtzResults as (9 fields, reach_end,
    CIGAR), or, with ``keys`` (a sharded field dict's), as that dict;
    field dicts as lists."""
    def ez(e):
        return (e.max, e.max_t, e.max_q, e.mqe, e.mqe_t, e.mte, e.mte_q,
                e.score, int(e.zdropped), int(e.reach_end), list(e.cigar))
    if isinstance(out, dict):
        return {k: np.asarray(v).tolist() for k, v in out.items()}
    if keys is not None:
        return {k: [int(getattr(e, k)) for e in out] for k in keys}
    if isinstance(out, list):
        return [ez(e) for e in out]
    return ez(out)


def _pin_of(out):
    """sum of max (and CIGAR ops) of a result, as phase 6's anchors."""
    if isinstance(out, dict):
        return int(np.asarray(out["max"]).astype(np.int64).sum())
    if any(e.cigar for e in out):
        return [sum(e.max for e in out), sum(len(e.cigar) for e in out)]
    return sum(e.max for e in out)


class MeshCase(NamedTuple):
    """A case of the mesh phase: the sharded call, the port's unsharded
    route on the same input, the anchor (None: none), and the launches
    the sharded call must make: ``per_shard`` kernels at least once a
    shard, ``local`` ones at least once (the Aligner's local part), no
    other kernel, and ``exact`` counts where the schedule fixes them."""
    name: str
    sharded: Callable
    unsharded: Callable
    anchor: object
    per_shard: Tuple[str, ...]
    local: Tuple[str, ...] = ()
    exact: Optional[Dict[str, int]] = None


def mesh_cases(shards: int):
    """The mesh phase's cases on a mesh of ``shards``: the mixed-512
    scores through make_sharded_run_fn and extend_batch(mesh=) (every
    bucket effectively unbanded: the strips route) and its CIGARs through
    extend_batch(mesh=) (targets up to 1536 on kernel E's CIG form and
    walker D, the whale on the local strips route), the whale through
    sharded_strips_cigar, the short-banded 4096 through kernels E, E2 and
    the batched CIGAR route, the 1024 annotated splice pairs through
    kernel 6, the CLI's batched extf pairs through kernel 7 and the 50 kb
    pair through the halo; each beside the port's unsharded route
    (``Aligner.extend_batch`` on the card, ``extf_batch_device`` for
    kernel 7, kernel 12 for the halo's pair)."""
    from ksw2_tpu_torch import Aligner
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.batch_extf import extf_batch_device
    from ksw2_tpu_torch.parallel import halo as HL
    from ksw2_tpu_torch.parallel import mesh as PM

    jobs = mixed_jobs()
    whale = [p for p in jobs if len(p[1]) > 2048]
    sbj = short_banded_jobs()
    sb = _padded(sbj)
    wsb = np.full(len(sb[2]), SHORT_BANDED_W, np.int32)
    spl4 = splice_jobs() * SPLICE_TILES
    junc4 = [splice_junc()] * len(spl4)
    extf = _padded(cli_split(jobs, "extf2_sse")[0])
    single = single_pair(SINGLE_SEED, SINGLE_LEN)
    mat, smat = simple_mat(5, 2, 4), simple_mat(5, 1, 2)
    q, e, q2, noncan = SPLICE
    SO = Flag.SCORE_ONLY
    scorer = Aligner(a=2, b=4, q=4, e=2, zdrop=100, flag=SO)
    cigar = Aligner(a=2, b=4, q=4, e=2, zdrop=100)
    SW = SHORT_BANDED_W
    sb_score = Aligner(w=SW, zdrop=100, flag=SO)
    sb_extd = Aligner(q2=EXTD[2], e2=EXTD[3], w=SW, zdrop=100, flag=SO)
    sb_cigar = Aligner(w=SW, zdrop=100)
    j_score = splice_aligner(Flag.SPLICE_FOR | SO, SPLICE_JUNC_BONUS)
    prm = HL.halo_params(*single, 5, mat, 4, 2, -1)
    rounds = -(-HL.rows_limit(prm.qlen, prm.tlen, prm.w) // HALO_K)

    return [
        MeshCase("mixed512_run_fn", lambda m: scorer.extend_batch(
            jobs, run_fn=PM.make_sharded_run_fn(m)),
            lambda: scorer.extend_batch(jobs), MIXED_SCORE, ("strips_fwd",)),
        MeshCase("mixed512_mesh_score",
                 lambda m: scorer.extend_batch(jobs, mesh=m),
                 lambda: scorer.extend_batch(jobs), MIXED_SCORE,
                 ("strips_fwd",)),
        MeshCase("mixed512_mesh_cigar",
                 lambda m: cigar.extend_batch(jobs, mesh=m),
                 lambda: cigar.extend_batch(jobs),
                 [SHORT_CIGAR[0] + WHALE_CIGAR[0],
                  SHORT_CIGAR[1] + WHALE_CIGAR[1]],
                 ("batch_fwd", "band_walk"), ("strips_fwd", "strips_walk")),
        MeshCase("whale_strips_cigar", lambda m: PM.sharded_strips_cigar(
            m, *_padded(whale), 5, mat, 4, 2, zdrop=100),
            lambda: cigar.extend_batch(whale), list(WHALE_CIGAR),
            ("strips_fwd", "strips_walk")),
        MeshCase("sb_extz_score", lambda m: PM.sharded_extz_scores_pallas(
            m, *sb, wsb, 5, mat, 4, 2, zdrop=100),
            lambda: sb_score.extend_batch(sbj),
            BATCH_PINS["short_banded_score"][0], ("batch_fwd",)),
        MeshCase("sb_extd_score", lambda m: PM.sharded_extd_scores_pallas(
            m, *sb, wsb, 5, mat, *EXTD, zdrop=100),
            lambda: sb_extd.extend_batch(sbj),
            BATCH_PINS["short_banded_extd_score"][0], ("batch_extd_fwd",)),
        MeshCase("sb_extz_align", lambda m: PM.sharded_extz_align(
            m, *sb, 5, mat, 4, 2, w=wsb, zdrop=100),
            lambda: sb_cigar.extend_batch(sbj),
            list(BATCH_PINS["short_banded_cigar"][0]),
            ("batch_fwd", "band_walk")),
        MeshCase("splice_junc_score", lambda m: PM.sharded_exts_scores_pallas(
            m, *_padded(spl4), 5, smat, q, e, q2, noncan,
            zdrop=SPLICE_ZDROP, junc_bonus=SPLICE_JUNC_BONUS,
            flag=Flag.SPLICE_FOR, junc=junc4),
            lambda: j_score.extend_batch(spl4, juncs=junc4),
            SPLICE_TILES * SPLICE_PINS["splice_junc_score"][0],
            ("batch_exts_fwd",)),
        MeshCase("cli_extf_score", lambda m: PM.sharded_extf_scores_pallas(
            m, *extf, None, 2, 4, 2, xdrop=40),
            lambda: extf_batch_device(*extf, 2, 4, 2, xdrop=40,
                                      device="cuda"),
            None, ("batch_extf_fwd",)),
        MeshCase("single_halo", lambda m: HL.halo_extz_score(
            m, *single, 5, mat, 4, 2, block_diagonals=HALO_K),
            lambda: _k12_single(single, mat), None, ("halo_fwd",),
            exact={"halo_fwd": shards * rounds}),
    ]


def _mesh_launches(case: MeshCase, counts: dict, shards: int) -> None:
    """Fail unless a case's own launches are the ones its route makes."""
    want = set(case.per_shard) | set(case.local)
    got = {k for k, v in counts.items() if v}
    low = [k for k in case.per_shard if counts.get(k, 0) < shards] + \
        [k for k in case.local if not counts.get(k)]
    off = {k: counts.get(k, 0) for k, v in (case.exact or {}).items()
           if counts.get(k, 0) != v}
    if got != want or low or off:
        raise AssertionError(
            f"mesh {case.name}: launches {counts}, want {sorted(want)} "
            f"({list(case.per_shard)} at least {shards} times, exactly "
            f"{case.exact})")


def _k12_single(single, mat):
    """Kernel 12's score-only fields of the 50 kb pair (the halo's
    reference), the same ExtzResult contract."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.ops.extz import extz2_device

    return extz2_device(*single, 5, mat, 4, 2, flag=Flag.SCORE_ONLY,
                        device="cuda")


def _two_process_worker(expected: int, device: str = "cuda",
                        timeout: int = 240):
    """Two processes of ``python -m ksw2_tpu_torch.parallel.dryrun`` on
    ``device`` with gloo: their ``OK <rank> <checksum>`` lines."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ksw2_tpu_torch.parallel.dryrun", "--rank",
         str(r), "--world", "2", "--init", f"tcp://127.0.0.1:{port}",
         "--backend", "gloo", "--device", device], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    lines = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            ok = [ln for ln in out.splitlines() if ln.startswith("OK ")]
            if p.returncode != 0 or not ok:
                raise AssertionError(f"worker rc {p.returncode}: {out}\n"
                                     f"{err[-3000:]}")
            lines.append(ok[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if sorted(int(ln.split()[1]) for ln in lines) != [0, 1] or \
            any(int(ln.split()[2]) != expected for ln in lines):
        raise AssertionError(f"two-process checksums {lines}, want "
                             f"{expected}")
    return lines


def _halo_err(a, b) -> int:
    return max(int(np.abs(x.astype(np.int64) - y).max(initial=0))
               for x, y in zip(a.states + a.packages, b.states + b.packages))


def phase_mesh():
    """5j. mesh: every case of :func:`mesh_cases` on the mesh twice, the
    launch counters set to 0 just before the case's first run and read
    just after it (:func:`_mesh_launches` holds them to the case's
    route); each run equal to the other, to the port's unsharded route on
    the same input (run twice too, its walls beside the mesh's) and to
    its anchor; the 50 kb pair's halo fields equal to
    ``SINGLE_PINS["single_score"]`` and kernel 12's; then the halo kernel
    against its plain twin on the 50 kb pair's 2 kb cut (every state
    plane and package, exactly); then two processes of the dry-run worker
    with gloo on the card.  Walls are the host's, beside the pool's other
    workers."""
    import torch

    from ksw2_tpu_torch._build import LAUNCHES
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.batch_xla import extz_batch_scores
    from ksw2_tpu_torch.parallel import halo as HL
    from ksw2_tpu_torch.parallel import mesh as PM
    from ksw2_tpu_torch.parallel.dryrun import multihost_batch

    mesh = PM.make_mesh(devices=mesh_devices())
    out, total = {}, {}

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    for case in mesh_cases(mesh.size):
        LAUNCHES.clear()
        first, w0 = timed(case.sharded, mesh)
        counts = dict(LAUNCHES)
        _mesh_launches(case, counts, mesh.size)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        second, w1 = timed(case.sharded, mesh)
        (ref0, l0), (ref1, l1) = (timed(case.unsharded) for _ in range(2))
        keys = list(first) if isinstance(first, dict) else None
        a, b = _digest(first), _digest(second)
        if a != b or _digest(ref0, keys) != _digest(ref1, keys):
            raise AssertionError(f"mesh {case.name}: two runs differ")
        if case.name == "single_halo":
            got = single_pin(first, False)
            if list(got) != list(SINGLE_PINS["single_score"]):
                raise AssertionError(f"single_halo {got} != "
                                     f"{SINGLE_PINS['single_score']}")
        if a != _digest(ref0, keys):
            raise AssertionError(f"mesh {case.name}: != the unsharded "
                                 "route")
        pin = None if case.anchor is None else _pin_of(first)
        if case.anchor is not None and pin != case.anchor:
            raise AssertionError(f"mesh {case.name}: {pin} != anchor "
                                 f"{case.anchor}")
        out[case.name] = {"wall_ms": [w0, w1], "unsharded_wall_ms": [l0, l1],
                          "launches": counts, "anchor": pin}
        del first, second, ref0, ref1
    # the halo kernel against its plain twin on the 2 kb cut
    single = single_pair(SINGLE_SEED, SINGLE_LEN)
    cut = (single[0][:LG_PREFIX], single[1][:LG_PREFIX])
    prm = HL.halo_params(*cut, 5, simple_mat(5, 2, 4), 4, 2, -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kern = HL.halo_pipeline(mesh, *cut, prm, HALO_K, HL.halo_round)
    k_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plain = HL.halo_pipeline(mesh, *cut, prm, HALO_K, HL.halo_round_plain)
    p_ms = (time.perf_counter() - t0) * 1e3
    err = _halo_err(kern, plain)
    if err:
        raise AssertionError(f"halo kernel != plain twin on the 2 kb cut "
                             f"(max abs err {err})")
    Q, T, spec = multihost_batch()
    ln = np.full(len(Q), Q.shape[1], np.int32)
    expected = int(extz_batch_scores(spec, Q, T, ln, ln, ln,
                                     device="cuda")["score"].sum())
    t0 = time.perf_counter()
    lines = _two_process_worker(expected)
    emit({"phase": "mesh", "devices": [str(d) for d in mesh.devices],
          "cases": out, "launches": total,
          "halo_cut": {"max_abs_err": err, "kernel_wall_ms": k_ms,
                       "plain_wall_ms": p_ms, "shards": mesh.size,
                       "K": HALO_K},
          "two_process": {"lines": lines, "expected": expected,
                          "wall_s": time.perf_counter() - t0}})
    return {"counts": total, "err": err}


def phase_mesh_alone() -> int:
    """``--mesh``: phases 5j and 7b alone (the mesh cases, the halo
    kernel against its twin, the two-process worker, the mesh times)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the mesh phase needs a CUDA card")
    int_rate = phase_device()
    phase_build()
    phase_mesh()
    mesh_times(int_rate)
    return 0


def _round_cells(prm, r0: int, nk: int) -> int:
    """Cells of the true band [st0, en0] on diagonals r0 .. r0 + nk - 1."""
    from ksw2_tpu_torch.ops.bands import band_bounds

    st0, en0 = band_bounds(r0 + nk, prm.qlen, prm.tlen, prm.w)
    return int(np.maximum(0, en0[r0:] - st0[r0:] + 1).sum())


def mesh_times(int_rate):
    """7b. mesh times, alone: the halo kernel's round against its plain
    twin (exactly, and timed) on the 50 kb pair's widest block of HALO_K
    diagonals on one shard, its bound; the 50 kb pair's halo at 1 and
    MESH_SHARDS logical shards (host walls, and the device time of the
    one-shard run by CUDA events) beside the pair's bound; and
    scaling_efficiency on logical shards of cuda:0."""
    import torch

    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.parallel import halo as HL
    from ksw2_tpu_torch.parallel import mesh as PM

    single = single_pair(SINGLE_SEED, SINGLE_LEN)
    mat = simple_mat(5, 2, 4)
    prm = HL.halo_params(*single, 5, mat, 4, 2, -1)
    K = HALO_K
    C = -(-prm.tlen // 128) * 128
    rlim = HL.rows_limit(prm.qlen, prm.tlen, prm.w)
    n_blocks = -(-rlim // K)
    cells = [_round_cells(prm, b * K, min(K, rlim - b * K))
             for b in range(n_blocks)]
    j = int(np.argmax(cells))
    dev = torch.device("cuda", 0)
    qs = torch.from_numpy(np.asarray(single[0], np.uint8)).to(dev)
    tpad = np.zeros(C, np.uint8)
    tpad[:prm.tlen] = single[1]
    ts = torch.from_numpy(tpad).to(dev)
    st = HL.init_state(C, dev)
    pout = torch.zeros((K, 3), dtype=torch.int32, device=dev)
    for b in range(j):
        HL.halo_round(qs, ts, st, None, pout, prm, 0, b * K, K)
    st_j = st.clone()
    nk = min(K, rlim - j * K)
    k_ms = []
    for _ in range(3):
        st.copy_(st_j)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        HL.halo_round(qs, ts, st, None, pout, prm, 0, j * K, nk)
        e1.record()
        e1.synchronize()
        k_ms.append(e0.elapsed_time(e1))
    kst, kout = st.clone(), pout.clone()
    st.copy_(st_j)
    plain_run("halo_round", HL.halo_round_plain, qs, ts, st, None, pout,
              prm, 0, j * K, nk)
    err = max(int((kst - st).abs().max()), int((kout - pout).abs().max()))
    if err:
        raise AssertionError(f"halo round {j}: kernel != plain twin "
                             f"(max abs err {err})")
    ops_ms = cells[j] * OPS["halo_fwd"] / int_rate * 1e3
    bytes_ms = (2 * HL.NPLANES * 4 * C + prm.qlen + C + 2 * 3 * 4 * K) / \
        HBM_BYTES_PER_S * 1e3
    pair = {}
    for D in (1, MESH_SHARDS):
        mesh = PM.make_mesh(devices=["cuda:0"] * D)
        walls = []
        dev_ms = None
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            ez = HL.halo_extz_score(mesh, *single, 5, mat, 4, 2,
                                    block_diagonals=K)
            e1.record()
            e1.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            dev_ms = e0.elapsed_time(e1)
        if list(single_pin(ez, False)) != list(SINGLE_PINS["single_score"]):
            raise AssertionError(f"halo D={D}: {single_pin(ez, False)}")
        pair[D] = {"wall_ms": walls, "events_ms": dev_ms}
    pair_cells = sum(cells)
    t1, tn, eff = PM.scaling_efficiency(MESH_SHARDS, devices=["cuda:0"])
    line = {"phase": "mesh_times", "K": K, "round": j, "round_cells":
            cells[j], "round_ms": k_ms, "round_plain_ms":
            PLAIN_MS["halo_round"], "round_bound_ms": max(ops_ms, bytes_ms),
            "round_bound_by": "operations" if ops_ms >= bytes_ms
            else "bytes", "rounds_one_shard": n_blocks,
            "pair_cells": pair_cells,
            "pair_bound_ms": pair_cells * OPS["halo_fwd"] / int_rate * 1e3,
            "pair": {str(D): v for D, v in pair.items()},
            "scaling": {"shards": MESH_SHARDS, "t1_ms": t1 * 1e3,
                        "tn_ms": tn * 1e3, "wall_ratio": t1 / tn,
                        "efficiency": eff}}
    emit(line)
    return {"fwd_ms": min(k_ms), "fwd_plain_ms": PLAIN_MS["halo_round"],
            "fwd_bound_ms": line["round_bound_ms"],
            "fwd_bound_by": line["round_bound_by"], "err": err}


START = time.perf_counter()


def progress(msg: str) -> None:
    """One line on stderr with the run's seconds so far: where a run that
    is stopped got to."""
    print(f"[chip_smoke {time.perf_counter() - START:7.1f} s] {msg}",
          file=sys.stderr, flush=True)


# the kernel phases (3-5h) and the main path's CPU references are
# independent of each other and bound by the host (a plain version
# launches many small operations one after another), so most of them run
# side by side in PHASE_WORKERS processes on the one card, each
# rebuilding its inputs from their seeds.  The cases whose plain times
# phase 7 reports (ALONE: by phase, a pattern on the case's name) run
# first, alone in this process: a plain version that shares the host
# with the workers takes up to 4x as long.  A phase's two parts print
# one line, in phase order, once all have ended.
PHASE_WORKERS = 6
POOL_TIMEOUT_S = 800          # a stuck worker fails the run, not the limit
KERNEL_PHASES = ("splice", "kernel_a", "kernel_b", "rows", "band", "batch",
                 "single", "single2", "linear_global", "local", "walk")
ALONE = {"splice": r"main_.*",
         "kernel_a": r"(whale|mixed700|mixed512)_.*",
         "kernel_b": r"(whale|mixed700)_.*", "rows": r"short_score_z100",
         "band": r"long1_.*", "batch": r"sb_ext[zd]_score_z100_launch\d+",
         "single": r"sr_launch\d+", "single2": r"(sr_extd|splice_ends)_256",
         "linear_global": r"cli64_.*", "local": r".*", "walk": r"$^"}
# the pool's part, longest first (seconds in the pool on one H100: batch
# ~220-340 in two tasks of half its cases, band ~140, single2 ~135-165,
# splice ~120-180, single, linear_global and kernel_a ~55-75, walk ~45),
# the CPU references after them, then the short ones
POOL_FIRST = ("batch", "single2", "splice", "band", "walk", "single",
              "linear_global", "kernel_a")
POOL_LAST = ("kernel_b", "rows")
POOL_SPLIT = {"batch": 2}


def run_kernel_phase(name, alone, part=0, parts=1):
    """Kernel phase ``name`` on its cases in ALONE (``alone``) or on the
    others, rebuilt from their seeds (of those, every ``parts``-th from
    ``part`` on); None when there are none."""
    import re

    if name == "local":
        return phase_local() if alone else None
    fn, cases = {
        "splice": lambda: (phase_splice, splice_cases(splice_jobs())),
        "kernel_a": lambda: (phase_kernel_a, fwd_cases(mixed_jobs())),
        "kernel_b": lambda: (phase_kernel_b, fwd_cases(mixed_jobs())),
        "rows": lambda: (phase_rows, rows_cases(short_jobs())),
        "band": lambda: (phase_band, band_cases(long_banded_jobs(),
                                                mixed_jobs())),
        "batch": lambda: (phase_batch, batch_cases(short_banded_jobs())),
        "single": lambda: (phase_single, single_cases(short_banded_jobs())),
        "single2": lambda: (phase_single2, single2_cases(
            short_banded_jobs(), splice_jobs())),
        "linear_global": lambda: (phase_linear_global,
                                  lg_cases(mixed_jobs())),
        "walk": lambda: (phase_walk, [*WALK_CHECKED, "random"]),
    }[name]()
    picked = [c for c in cases
              if (re.fullmatch(ALONE[name], c if isinstance(c, str) else c[0])
                  is not None) == alone][part::parts]
    return fn(picked) if picked else None


def _captured(fn, *args):
    """(fn(*args), what it printed, seconds, the traceback or None)."""
    import traceback

    t0 = time.perf_counter()
    buf = io.StringIO()
    out, err = None, None
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
    except Exception:
        err = traceback.format_exc()
    return out, buf.getvalue(), time.perf_counter() - t0, err


def _pool_init():
    import torch

    torch.set_num_threads(1)
    torch.manual_seed(0)


def _pool_task(task):
    """One pool task, ("phase", name[, part, parts]) or an
    :func:`oracle_tasks` entry: (kind, name, (result, printed lines,
    seconds, error)).  Its plain times stay in its phase's line."""
    if task[0] == "phase":
        res = _captured(run_kernel_phase, task[1], False, *task[2:])
    elif task[0] == "mesh":
        res = _captured(phase_mesh)
    else:
        _, _, kw, _, pairs, juncs = task
        res = _captured(oracle_refs, kw, pairs, juncs)
    return task[0], task[1], res


def _fail(what, text, err):
    sys.stdout.write(text)
    sys.stdout.flush()
    raise AssertionError(f"{what} failed:\n{err}")


def _merge_worst(a, b):
    if a is None or b is None:
        return b if a is None else a
    if isinstance(a, dict):
        return {k: max(a.get(k, 0), b.get(k, 0)) for k in {*a, *b}}
    return max(a, b)


def _merge_lines(texts):
    """A phase's summary lines from its parts as one line."""
    objs = [json.loads(ln) for t in texts for ln in t.splitlines()
            if ln.strip()]
    line = {"phase": objs[0]["phase"], "max_abs_err": None, "cases": {}}
    for o in objs:
        line["max_abs_err"] = _merge_worst(line["max_abs_err"],
                                           o["max_abs_err"])
        line["cases"].update(o["cases"])
    return json.dumps(line) + "\n"


def run_kernel_phases(oracle):
    """The kernel phases' ALONE cases here, one after another, then their
    other cases and the ``oracle`` tasks in PHASE_WORKERS processes:
    {phase: result}, {run: CPU references}, {part: seconds}.  Fails on
    the first part that fails, and when the pool outlasts
    POOL_TIMEOUT_S."""
    import multiprocessing as mp

    import torch

    res, texts, secs, refs = {}, {}, {}, {}
    for name in KERNEL_PHASES:
        out, text, s, err = _captured(run_kernel_phase, name, True)
        progress(f"alone {name}: {s:.1f} s")
        if err:
            _fail(f"phase {name} (alone)", text, err)
        res[name], texts[name], secs[f"alone:{name}"] = out, [text], s
        torch.cuda.empty_cache()
    tasks = [("phase", n, k, POOL_SPLIT.get(n, 1)) for n in POOL_FIRST
             for k in range(POOL_SPLIT.get(n, 1))] + [("mesh", "mesh")] + \
        list(oracle) + [("phase", n) for n in POOL_LAST]
    assert {n for k, n, *_ in tasks if k == "phase"} | {"local"} == \
        set(KERNEL_PHASES)
    t0 = time.perf_counter()
    with mp.get_context("spawn").Pool(PHASE_WORKERS,
                                      initializer=_pool_init) as pool:
        it = pool.imap_unordered(_pool_task, tasks)
        for _ in tasks:
            left = POOL_TIMEOUT_S - (time.perf_counter() - t0)
            kind, name, (out, text, s, err) = it.next(max(left, 1))
            progress(f"{kind} {name}: {s:.1f} s")
            if err:
                _fail(f"{kind} {name}", text, err)
            secs[f"{kind}:{name}"] = secs.get(f"{kind}:{name}", 0) + s
            if kind == "oracle":
                refs[name] = out
                continue
            if kind == "mesh":
                res[name], mesh_text = out, text
                continue
            res[name] = _merge_worst(res[name], out)
            texts[name].append(text)
    secs["pool"] = time.perf_counter() - t0
    for name in KERNEL_PHASES:
        sys.stdout.write(_merge_lines(texts[name]))
    sys.stdout.write(mesh_text)
    sys.stdout.flush()
    return res, refs, secs


def main() -> int:
    import torch

    import ksw2_tpu_torch  # noqa: F401  (outside a checkout: fail first)

    clock = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        clock[name] = time.perf_counter() - t0
        progress(f"{name}: {clock[name]:.1f} s")
        return out

    int_rate = phase_device()
    torch.manual_seed(0)
    timed("build", phase_build)
    timed("operations", phase_operations)
    spl = splice_jobs()
    jobs = mixed_jobs()
    short = short_jobs()
    long = long_banded_jobs()
    sb = short_banded_jobs()
    single = single_pair(SINGLE_SEED, SINGLE_LEN)
    mt = single_pair(MT_SEED, MT_LEN)
    slong = splice_long_jobs()
    counts, _, results = timed("main_path", phase_main_path, jobs, short,
                               long, sb, spl, single, mt, slong)
    torch.cuda.empty_cache()
    oracle = oracle_tasks(results)
    errs, refs, secs = timed("kernel_phases", run_kernel_phases, oracle)
    oracle_check(results, oracle, refs)
    del results
    for name in KERNEL_PHASES:
        clock[name] = secs[f"alone:{name}"] + secs.get(f"phase:{name}", 0)
    clock["mesh"] = secs["mesh:mesh"]
    clock["pool"] = secs["pool"]
    clock["oracle_cpu"] = sum(s for k, s in secs.items()
                              if k.startswith("oracle:"))
    err_spl, err_a, err_b, err_r, err_band, err_batch, err_single, \
        err_single2, err_lg, err_local, err_walk = (errs[n]
                                                    for n in KERNEL_PHASES)
    scases = splice_cases(spl)
    cases = fwd_cases(jobs)
    rcases = rows_cases(short)
    lcases = lg_cases(jobs)
    times = timed("times", phase_times, cases, rcases, long, sb, scases,
                  single, spl, slong, int_rate, lcases, mt, jobs)
    mtimes = timed("mesh_times", mesh_times, int_rate)
    timed("profile", phase_profile, long, sb, spl, jobs, mt)
    emit({"phase": "clock", "workers": PHASE_WORKERS, "seconds": clock})
    whale = times["whale_cig_z100"]
    rows = times["short_score_z100"]
    ld = times["long1_extd_score"]
    lc = times["long1_extz_cig"]
    print(json.dumps({"kernels": [
        _kernel("strips_fwd", FWD_SRC, FWD_REPLACES, counts["strips_fwd"],
                max(err_a, err_spl["strips_fwd"]), whale, "fwd"),
        _kernel("strips_walk", WALK_SRC, WALK_REPLACES,
                counts["strips_walk"], max(err_b, err_spl["strips_walk"],
                                           err_walk["strips_walk"]),
                whale, "walk"),
        _kernel("rows_fwd", ROWS_SRC, ROWS_REPLACES, counts["rows_fwd"],
                err_r, rows, "rows"),
        _kernel("band_fwd", BAND_SRC, BAND_REPLACES, counts["band_fwd"],
                err_band["band_fwd"], lc, "fwd"),
        _kernel("band_extd_fwd", BAND_SRC, BAND_EXTD_REPLACES,
                counts["band_extd_fwd"], err_band["band_extd_fwd"], ld,
                "fwd"),
        _kernel("band_walk", BAND_WALK_SRC, BAND_WALK_REPLACES,
                counts["band_walk"],
                max(err_band["band_walk"], err_batch["band_walk"],
                    err_spl["band_walk"], err_lg["band_walk"],
                    err_walk["band_walk"]), lc, "walk"),
        _kernel("batch_fwd", BATCH_SRC, BATCH_REPLACES, counts["batch_fwd"],
                err_batch["batch_fwd"], times["sb_extz_score"], "fwd"),
        _kernel("batch_extd_fwd", BATCH_SRC, BATCH_EXTD_REPLACES,
                counts["batch_extd_fwd"], err_batch["batch_extd_fwd"],
                times["sb_extd_score"], "fwd"),
        _kernel("batch_exts_fwd", BATCH_EXTS_SRC, BATCH_EXTS_REPLACES,
                counts["batch_exts_fwd"], err_spl["batch_exts_fwd"],
                times["main_junc_score"], "fwd"),
        _kernel("extz_fwd", EXTZ_SRC, EXTZ_REPLACES, counts["extz_fwd"],
                err_single["extz_fwd"], times["sr_extz_cig"], "fwd"),
        _kernel("extz_walk", EXTZ_WALK_SRC, EXTZ_WALK_REPLACES,
                counts["extz_walk"],
                max(err_single["extz_walk"], err_single2["extz_walk"],
                    err_walk["extz_walk"]),
                times["sr_extz_cig"], "walk"),
        _kernel("extd_fwd", EXTZ_SRC, EXTD_REPLACES, counts["extd_fwd"],
                err_single2["extd_fwd"], times["sr_extd_256"], "fwd"),
        _kernel("exts_fwd", EXTZ_SRC, EXTS_REPLACES, counts["exts_fwd"],
                err_single2["exts_fwd"], times["splice_ends_256"], "fwd"),
        _kernel("batch_extf_fwd", EXTF_SRC, BATCH_EXTF_REPLACES,
                counts["batch_extf_fwd"], err_lg["batch_extf_fwd"],
                times["cli64_extf_batch"], "fwd"),
        _kernel("batch_gg2_fwd", GG2_SRC, BATCH_GG2_REPLACES,
                counts["batch_gg2_fwd"], err_lg["batch_gg2_fwd"],
                times["cli64_gg2_batch"], "fwd"),
        _kernel("extf_fwd", LG_SRC, EXTF_REPLACES, counts["extf_fwd"],
                err_lg["extf_fwd"], times["cli64_extf_single"], "fwd"),
        _kernel("gg2_fwd", LG_SRC, GG2_REPLACES, counts["gg2_fwd"],
                err_lg["gg2_fwd"], times["cli64_gg2_single"], "fwd"),
        _kernel("batch_local_fwd", LOCAL_SRC, LOCAL_REPLACES,
                counts["batch_local_fwd"],
                max(err_local, times["local_64k"]["max_abs_err"]),
                times["local_64k"], "fwd"),
        _kernel("halo_fwd", HALO_SRC, HALO_REPLACES,
                errs["mesh"]["counts"]["halo_fwd"],
                max(errs["mesh"]["err"], mtimes["err"]), mtimes, "fwd"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lg-times"]:
        sys.exit(phase_lg_times())
    if sys.argv[1:2] == ["--strips-times"]:
        sys.exit(phase_strips_times())
    if sys.argv[1:2] == ["--walk-times"]:
        sys.exit(phase_walk_times())
    if sys.argv[1:2] == ["--batch-times"]:
        sys.exit(phase_batch_times())
    if sys.argv[1:2] == ["--rows-times"]:
        sys.exit(phase_rows_times())
    if sys.argv[1:2] == ["--exts-times"]:
        sys.exit(phase_exts_times())
    if sys.argv[1:2] == ["--local-times"]:
        sys.exit(phase_local_times())
    if sys.argv[1:2] == ["--mesh"]:
        sys.exit(phase_mesh_alone())
    if sys.argv[1:2] == ["--sass-diff"]:
        sys.exit(phase_sass_diff(sys.argv[2]))
    if sys.argv[1:2] == ["--breakdown"]:
        sys.exit(phase_breakdown(tuple(sys.argv[2:])
                                 or ("extz", "band", "lg", "strips", "walk",
                                     "batch", "exts", "local", "gg2",
                                     "extf", "rows")))
    sys.exit(main())
