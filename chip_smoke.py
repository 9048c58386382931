#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ksw2_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (nvidia-smi) and its int32
   rate (132 SMs x 64 lanes x the maximum SM clock);
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
5b. band: kernels C / C2 (band forward, one- and two-piece) against
   their plain version, records and direction bytes exactly, in score,
   CIG and APPROX forms with bands from 1 to 1472 on pairs of up to 900
   bp and the shortest long-banded pair cut to 2 kb, and kernel D (band
   walker) against its plain version on the kernels' bytes;
5c. batch: kernels E / E2 (batched forward, one- and two-piece, one warp
   a pair) against their plain version, records and direction bytes
   exactly, in score, CIG and APPROX forms with w 0, 1, 16, 100 and
   unbanded on targets up to 1700 (P = 1-14 rows a pair on the TPU),
   zdrop -1/100, RIGHT, GENERIC_SC, default and swapped two-piece costs,
   and on the launches the scheduler makes of the short-banded workload
   (below); kernel D on their bytes;
5d. splice: kernel A's spl form (score and CIG) with kernel B's nop
   form on its bytes, and kernel 6 (batched exts forward, one warp a
   pair; score, CIG and APPROX) with kernel D walking its bytes with
   min_intron, against their plain versions exactly, on seeded spliced
   pairs of 30-900 bp (RIGHT, SPLICE_REV, FLANK, GENERIC_SC, junction
   tracks) and on the one launch of each form the scheduler makes of the
   splice workload (below);
5e. single: kernel 12 (single-pair forward, tiles of 128 positions:
   pairs of 30-1500 bp over 1-12 tiles; score, CIG and APPROX forms,
   w -1, 0, 1, 16, 751 and 2000, zdrop -1/100, RIGHT, GENERIC_SC,
   EXTZ_ONLY with end_bonus) against its plain version, records, stops
   and direction bytes exactly, and kernel 17 (single-pair walker) on
   its bytes (upper_force 1 and 0, min_intron 0 and 5), also on the
   launches the scheduler makes of the sr-extension workload (below);
5f. single2: kernels 13 and 14, and 17 on their bytes;
5g. linear_global: kernels 7 and 15 (batched and single-pair extf)
   against their plain version's records, kernels 8 and 16 (batched and
   single-pair gg2) against theirs (without and with the reference's
   u/v/x/y/s block overrun) on scores and every byte of the flat store,
   and band_walk's flat form on the kernels' bytes, exactly: seeded
   pairs of 30-1500 bp, banded and unbanded, xdrop -1 and 40, two pairs
   with qlen > tlen + w, and the first 64 pairs of each launch of the
   CLI path (below);
6. the main path through ``Aligner.extend_batch(_async)``, one path at a
   time with the launch counters set to 0 just before it and read just
   after: one-piece (extz) scores and CIGARs on the seeded mixed
   workload (seed 777, A2 B4 O4 E2, z100), two-piece (extd, O4,13 E2,1)
   scores and CIGARs on the same workload, short-pair scores on a second
   seeded workload (seed 778, q and t <= 128) that takes the rows route,
   the band route on the seeded long-banded workload (seed 779, 128
   pairs of 4-16 kb at -w751 -z400: extz, extd and approx scores, extz
   and extd CIGARs; no strips kernel may launch), the mixed workload
   at -w751 (strips and band in one batch) and the batched route on the
   seeded short-banded workload (seed 780, 4096 pairs of 150-512 bp at
   -w100 -z100: extz, extd and approx scores, extz and extd CIGARs; EQX
   CIGARs and two-piece end_bonus scores on the mixed workload's pairs
   of 1536 bp or less; only kernels E, E2 and D may launch), and the
   splice path on the JAX bench's spliced workload (seed 1234, 256 pairs
   of 290 x 512 bp with a GT..AG intron, tiled 4x; minimap2 -x splice
   costs A1 B2 -O2,32 -E1,0 -C9 -z200): CIGARs, scores and 4 async
   handles on the strips route (only kernels A and B may launch), and
   the same pairs annotated (a junction track at the intron, junc_bonus
   9) on the batched exts route (only kernels 6 and D); the single-pair
   engine (only kernels 12 and 17): a seeded 50 kb pair (seed 781)
   through ``Aligner.extend`` (exact score, ``-sg``, CIGAR) and
   ``extend_batch`` (scores, the any-device route), a seeded pair of the
   MT length (seed 782, 16,569 bp; CIGAR and EXTZ_ONLY CIGAR at -z100)
   and sr-extension: the short-banded workload as EXTZ_ONLY CIGARs at
   -w100 -z100 --end-bonus 10 (minimap2 -x sr's extension call), one
   launch of each kernel a bucket; the paths of kernels 13 and 14
   (single_extd, sr_extension_extd, splice_ends, splice_long); and the
   paths of kernels 7, 8, 15 and 16 (pins ``LG_PINS``, only those four
   and band_walk may launch): "single_extf" (the 50 kb pair through
   ``extf2_device`` at A2 B4 E2, xdrop -1), "single_gg2_mt" (the MT pair
   through ``Aligner.global_align``) and "cli_batch" (the mixed workload
   as FASTA through ``cli.main(["--backend", "batch", ...])`` at -t
   gg2_sse -w 100 and -t extf2_sse -z 40).  Each anchor or spec pin is
   asserted,
   each path must have launched its kernels, and sampled pairs are held
   against the port's plain CPU route;
7. times: every kernel and its plain version at main-path shapes (CUDA
   events; the batched kernels on the main path's own launches of the
   short-banded workload, kernels 12 and 17 on the 50 kb pair and on
   the sr-extension launches) beside its bound, the main paths' walls
   and Gcells/s (band cells on the band and batched routes), and a
   profile of the long-banded, short-banded, splice and sr-extension
   batches with the device's idle share.

It exits non-zero, before any result line, when there is no CUDA card or
any phase fails.  The last line is the ``{"ok": true, ...}`` record.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import os
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
BATCH_EXTS_SRC = "ksw2_tpu_torch/csrc/batch_exts_fwd.cu"
BATCH_EXTS_REPLACES = "ksw2_tpu/ops/wavefront_batch_exts.py:55"
EXTZ_SRC = "ksw2_tpu_torch/csrc/extz_fwd.cu"
EXTZ_WALK_SRC = "ksw2_tpu_torch/csrc/extz_walk.cu"
EXTZ_REPLACES = "ksw2_tpu/ops/wavefront.py:175"
EXTD_REPLACES = "ksw2_tpu/ops/wavefront_extd.py:68"
EXTS_REPLACES = "ksw2_tpu/ops/wavefront_exts.py:54"
EXTZ_WALK_REPLACES = "ksw2_tpu/ops/traceback_device.py:50"
EXTF_SRC = "ksw2_tpu_torch/csrc/batch_extf_fwd.cu"
GG2_SRC = "ksw2_tpu_torch/csrc/gg2_fwd.cu"
BATCH_EXTF_REPLACES = "ksw2_tpu/ops/wavefront_batch_extf.py:42"
EXTF_REPLACES = "ksw2_tpu/ops/wavefront_extf.py:41"
BATCH_GG2_REPLACES = "ksw2_tpu/ops/wavefront_batch_gg2.py:42"
GG2_REPLACES = "ksw2_tpu/ops/wavefront_gg2.py:50"

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
        kd = S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm)
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


def band_launch(pairs, w, flag, zdrop, costs=None, mat=None):
    """One band (or batched) launch of ``pairs`` at bands ``w`` (an int
    or one per pair): A2 B4 (or ``mat``) with O4 E2, or the two-piece
    ``costs``."""
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.band import band_prep

    mat = simple_mat(5, 2, -4) if mat is None else mat
    q, e, q2, e2 = (4, 2, 0, 0) if costs is None else costs
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    wv = np.broadcast_to(np.asarray(w, np.int32), ql.shape)
    (ln,) = band_prep([a for a, _ in pairs], [t for _, t in pairs], ql, tl,
                      wv, 5, mat, q, e, zdrop, flag,
                      cig=not int(flag) & int(Flag.SCORE_ONLY),
                      two=costs is not None, q2=q2, e2=e2)
    return ln


def short_banded_launches(sb, flag, costs=None, choose=None):
    """The launches the scheduler makes of the short-banded workload
    (-w100 -z100) in one form: its buckets as ``scheduler._route`` makes
    them (the bucket ladder, longest pairs first, routed by ``choose``;
    by default every bucket takes the batched route, as phase 6 checks),
    each split by ``band_prep`` as the scheduler splits it.  Returns the
    launches and the host seconds of the routing and of the prep."""
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops.band import band_prep

    mat = simple_mat(5, 2, -4)
    q, e, q2, e2 = (4, 2, 0, 0) if costs is None else costs
    jobs = [sched.AlignJob(a, b, SHORT_BANDED_W) for a, b in sb]
    t0 = time.perf_counter()
    buckets = sched._route(jobs, mat, q + e, [None] * len(jobs),
                           choose or (lambda *_: "batch"))
    t1 = time.perf_counter()
    launches = [ln for bk in buckets for ln in band_prep(
        [jobs[i].query for i in bk.idxs], [jobs[i].target for i in bk.idxs],
        bk.qlen, bk.tlen, bk.w, 5, mat, q, e, 100, flag,
        cig=not int(flag) & int(Flag.SCORE_ONLY), two=costs is not None,
        q2=q2, e2=e2)]
    return launches, t1 - t0, time.perf_counter() - t1


LONG1_CUT = 2000


def long1_pair(long):
    """The long-banded workload's shortest pair cut to its first
    LONG1_CUT bp: the band kernels' case beside their plain version."""
    q, t = min(long, key=lambda p: len(p[1]))
    return [(q[:LONG1_CUT], t[:LONG1_CUT])]


def band_cases(long):
    """(name, launch) cases for kernels C and C2: small seeded launches
    of 60-900 bp with bands from 1 to 1472 (N bases, one clipped query)
    in score, CIG and APPROX forms, zdrop -1/100/400, RIGHT and
    GENERIC_SC, one-piece, two-piece and swapped costs; and the shortest
    pair of the long-banded workload cut to LONG1_CUT bp at its settings
    (the plain forward takes milliseconds a diagonal)."""
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
    return cases


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
    targets up to 512 (P = 1-4 rows a pair on the TPU; N bases, one
    clipped query) with w 0, 1, 16, 100 and unbanded in score, CIG and
    APPROX forms, zdrop -1/100, RIGHT and GENERIC_SC, one-piece,
    two-piece and swapped costs; two wide launches on targets of 1000 to
    1700 (P = 8, 10, 14; the score form's targets over 1536), score and
    CIG; and the launches the main path makes of the short-banded
    workload's 4096 pairs, one- and two-piece score, and the first of
    its two-piece CIG launches."""
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
    approx = Flag.APPROX_MAX | Flag.APPROX_DROP
    forms = [
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
    cases = [(f"small_{name}",
              band_launch(small, w_small, flag, zdrop, costs,
                          _generic_mat() if flag & Flag.GENERIC_SC
                          else None))
             for name, flag, zdrop, costs in forms]
    cases += [
        ("wide_extz_score_z100",
         band_launch(wide, w_wide, Flag.SCORE_ONLY, 100)),
        ("wide_extd_cig_right_zm1",
         band_launch(wide, w_wide, Flag.RIGHT, -1, EXTD)),
    ]
    for name, flag, costs in (("sb_extz_score_z100", Flag.SCORE_ONLY, None),
                              ("sb_extd_score_z100", Flag.SCORE_ONLY, EXTD),
                              ("sb_extd_cig_z100", Flag.NONE, EXTD)):
        launches, _, _ = short_banded_launches(sb, flag, costs)
        if flag == Flag.NONE:
            launches = launches[:1]
        cases += [(f"{name}_launch{k}", ln) for k, ln in enumerate(launches)]
    return cases


def phase_batch(cases):
    """Kernels E / E2 (batch_fwd, batch_extd_fwd) against the plain
    forward on every case, records and direction bytes exactly; kernel D
    (band_walk) against the plain walker on the kernels' bytes (the
    first 256 pairs of a launch)."""
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
        prec, pp = plain_run((name, "fwd"), BD.band_forward_plain, *args,
                             ln.prm, ln.nd, ln.ncol)
        errs = {"records": _max_err(krec, prec)}
        if ln.prm.cig:
            errs["bytes"] = _max_err(kp, pp)
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
        out[name] = {"pairs": len(ln.qlen), "nd": ln.nd, "ncol": ln.ncol,
                     "Lt": int(ln.target.shape[1]),
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
    return cases


def phase_splice(cases):
    """The splice kernels against their plain versions, exactly: the
    strips forward's spl form (D, Dq, hl, records, bytes) and the nop
    walker on its bytes; kernel 6 (records, bytes) and the band walker
    with min_intron = long_thres on its bytes (the first 256 pairs of a
    launch for the walkers' plain versions)."""
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
            _, _, ql, tl, w = args[:5]
            krec, kp = BE.batch_exts_forward_cuda(*args, ln.prm, ln.nd,
                                                  ln.ncol)
            prec, pp = plain_run((name, "fwd"), BE.batch_exts_forward_plain,
                                 *args, ln.prm, ln.nd, ln.ncol)
            errs["records"] = _max_err(krec, prec)
            if ln.prm.cig:
                errs["bytes"] = _max_err(kp, pp)
                del pp
                n = min(256, len(ln.qlen))
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
            worst["batch_exts_fwd"] = max(worst["batch_exts_fwd"],
                                          errs["records"],
                                          errs.get("bytes", 0))
            out[name] = {"route": route, "pairs": len(ln.qlen),
                         "nd": ln.nd, "ncol": ln.ncol,
                         "Lt": int(ln.target.shape[1]), "lt": ln.prm.lt,
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
    launches of few pairs, so tiles of 128 positions (pairs of 30-1500 bp over 1-12
    tiles; N bases; the 900 bp pair diverges after 450 bp, so z100 stops
    it mid-matrix) with w -1, 0, 1, 16, 751 and 2000, zdrop -1 / 100, in
    score, CIG and APPROX forms, RIGHT, GENERIC_SC and EXTZ_ONLY with
    end_bonus; and the launches the main path makes of the sr-extension
    workload (the scheduler's own tile).  About 15,000 diagonals of the
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
    cases += [(f"sr_launch{k}", ln, END_BONUS)
              for k, ln in enumerate(sr_launches(sb))]
    return cases


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
    14 ("exts"): seeded launches of few pairs, so tiles of 128 positions
    (pairs of 30-1500 bp over 1-12 tiles; N bases; the 900 bp pair
    diverges after 450 bp, so z100 stops it mid-matrix) in score, CIG and
    APPROX forms; kernel 13 with w -1, 0, 1, 16 and 751, zdrop -1 / 100,
    RIGHT, GENERIC_SC, EXTZ_ONLY with end_bonus, default and swapped
    costs; kernel 14 with SPLICE_FOR / SPLICE_REV, FLANK, junction tracks
    (junc_bonus 9), GENERIC_SC, EXTZ_ONLY and RIGHT|REV_CIGAR; and the
    first 256 pairs of the launches the main path makes of
    sr-extension-extd and splice-ends.  No plain version runs on a pair
    over 1500 bp."""
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


def lg_cases(jobs):
    """(name, kind, pairs, resolved bands, xdrop, forms) cases for kernels
    7 and 15 (kind "extf") and 8 and 16 (kind "gg2"): seeded pairs of
    30-1500 bp (N bases) with w 0, 16, 100 and unbanded, xdrop -1 and
    40; two pairs with qlen > tlen + w for kernel 16's block overrun;
    and the first 64 pairs of each launch the CLI run makes of the
    mixed-512 workload (-t extf2_sse -z 40, -t gg2_sse -w 100: the
    batched launch and the single-pair one).  ``forms`` names the
    kernels a case holds: "batch" (7 / 8), "single" (15 / 16)."""
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
    ]


def phase_linear_global(cases):
    """Kernels 7 and 15 (batch_extf_fwd, extf_fwd) against their plain
    version's records, kernels 8 and 16 (batch_gg2_fwd, gg2_fwd) against
    theirs (without and with the block overrun) on scores and every byte
    of the flat store, and band_walk's flat form against its plain
    version on the kernels' bytes (end cells and runs), exactly."""
    import torch
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch_extf as BF
    from ksw2_tpu_torch.ops import batch_gg2 as BG
    from ksw2_tpu_torch.ops import extf as XF
    from ksw2_tpu_torch.ops import gg2 as G1

    table = torch.from_numpy(simple_mat(5, 2, -4).astype(np.int32)).cuda()
    worst = dict.fromkeys(("batch_extf_fwd", "extf_fwd", "batch_gg2_fwd",
                           "gg2_fwd", "band_walk"), 0)
    out = {}
    for name, kind, pairs, w, xdrop, forms in cases:
        args = BF.pack_pairs(pairs, w, "cuda")
        errs = {}
        row = {"pairs": len(pairs), "forms": list(forms),
               "Lt": int(args[1].shape[1])}
        if kind == "extf":
            want = plain_run((name, "fwd"), BF.extf_forward_plain, *args,
                             2, -4, 2, xdrop)
            if "batch" in forms:
                errs["batch_extf_fwd"] = _max_err(
                    BF.batch_extf_forward_cuda(*args, 2, -4, 2, xdrop), want)
            errs["extf_fwd"] = _max_err(
                XF.extf_single_forward_cuda(*args, 2, -4, 2, xdrop), want)
            row["zdropped"] = int(want[:, 8].sum())
        else:
            single = "single" in forms
            ql_np = [len(a) for a, _ in pairs]
            tl_np = [len(b) for _, b in pairs]
            pb_np, total = BG.flat_layout(ql_np, tl_np, w)
            pb = torch.from_numpy(pb_np).cuda()
            ws, wp = plain_run((name, "fwd"), BG.gg2_forward_plain, *args,
                               table, 5, 4, 2, pb, total, single)
            fwd = (G1.gg2_single_forward_cuda if single
                   else BG.batch_gg2_forward_cuda)
            ks, kp = fwd(*args, table, 5, 4, 2, pb, total)
            kname = "gg2_fwd" if single else "batch_gg2_fwd"
            errs[kname] = max(_max_err(ks, ws), _max_err(kp, wp))
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
    launches, and kernels 15 and 16 on the 50 kb and MT pairs (no plain
    version runs there: it takes milliseconds a diagonal)."""
    import torch
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch_extf as BF
    from ksw2_tpu_torch.ops import batch_gg2 as BG
    from ksw2_tpu_torch.ops import extf as XF
    from ksw2_tpu_torch.ops import gg2 as G1

    table = torch.from_numpy(simple_mat(5, 2, -4).astype(np.int32)).cuda()
    by_name = {c[0]: c for c in lcases}
    eb, es = cli_split(jobs, "extf2_sse")
    gb, gs = cli_split(jobs, "gg2_sse")
    runs = [
        ("cli64_extf_batch", "batch_extf_fwd", None, 5),
        ("cli64_extf_single", "extf_fwd", None, 5),
        ("cli64_gg2_batch", "batch_gg2_fwd", None, 5),
        ("cli64_gg2_single", "gg2_fwd", None, 5),
        ("cli_extf_batch", "batch_extf_fwd", (eb, _resolve(eb, -1), 40), 3),
        ("cli_extf_single", "extf_fwd", (es, _resolve(es, -1), 40), 3),
        ("cli_gg2_batch", "batch_gg2_fwd", (gb, [100] * len(gb), None), 3),
        ("cli_gg2_single", "gg2_fwd", (gs, [100] * len(gs), None), 3),
        ("single50k_extf", "extf_fwd", ([single], _resolve([single], -1), -1),
         2),
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
        if kname.endswith("extf_fwd"):
            def fwd(args=args, fn=fn, xdrop=xdrop):
                return fn(*args, 2, -4, 2, xdrop)
            row["fwd_ms"] = cuda_ms(fwd, reps)
            cells, nbytes = lg_work(pairs, w, fwd())
            row["zdropped"] = int(fwd()[:, 8].sum())
        else:
            pb_np, total = BG.flat_layout([len(a) for a, _ in pairs],
                                          [len(b) for _, b in pairs], w)
            pb = torch.from_numpy(pb_np).cuda()

            def fwd(args=args, fn=fn, pb=pb, total=total):
                return fn(*args, table, 5, 4, 2, pb, total)
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


def phase_main_path(jobs, short, long, sb, spl, single, mt, slong):
    from ksw2_tpu_torch import Aligner
    from ksw2_tpu_torch.batch import scheduler as sched
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
    eqx = Aligner(zdrop=100, flag=Flag.EQX)
    bonus = Aligner(q=q, e=e, q2=q2, e2=e2, zdrop=100, end_bonus=END_BONUS,
                    flag=Flag.SCORE_ONLY)
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
    counts = {}
    runs = {}
    results = {}
    for path, spec, needs, never in paths:
        c, r, res = _path(path, spec, needs, never)
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        runs[path] = r
        results.update(res)
        # one launch of each kernel a bucket, in each of a run's 5
        # batches (the first, 3 timed, the submit/wait one)
        n = len({sched._bucket_key(len(a), len(b)) for a, b in sb})
        if path == "sr_extension" and \
                not c["extz_fwd"] == c["extz_walk"] == 5 * n:
            raise AssertionError(f"sr_extension: {c} launches for "
                                 f"{n} buckets in 5 batches")
        if path == "sr_extension_extd" and \
                not (c["extd_fwd"] == 10 * n and c["extz_walk"] == 5 * n):
            raise AssertionError(f"sr_extension_extd: {c} launches for "
                                 f"{n} buckets in 2 runs of 5 batches")

    # sampled pairs against the port's plain CPU route (which the CPU
    # test suite holds against the JAX package and the NumPy spec)
    rng = np.random.default_rng(16)
    checked = 0
    for name, (pairs, ezs, aln, sample, juncs) in results.items():
        cpu = Aligner(q=aln.q, e=aln.e, q2=aln.q2, e2=aln.e2, w=aln.w,
                      zdrop=aln.zdrop, end_bonus=aln.end_bonus,
                      flag=aln.flag, m=aln.m, mat=aln.mat,
                      splice=aln.splice, noncan=aln.noncan,
                      junc_bonus=aln.junc_bonus, device="cpu")
        idx = sample if sample is not None else \
            rng.choice(len(pairs), min(8, len(pairs)), replace=False)
        if len(idx) == 0:
            continue
        ref = cpu.extend_batch([pairs[i] for i in idx],
                               juncs=None if juncs is None else
                               [juncs[i] for i in idx])
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


def phase_profile(long, sb, spl, jobs, mt):
    """Device time by kernel over one score batch and one CIGAR batch of
    the long-banded (-w751 -z400) and of the short-banded (-w100 -z100)
    workloads, one CIGAR batch of the splice workload unannotated and
    annotated, the sr-extension CIGAR batch (one- and two-piece), the
    splice-ends CIGAR batch, the MT pair's global alignment and the two
    CLI runs (torch.profiler), beside the run's host wall and the
    device's idle share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ksw2_tpu_torch import Aligner
    from ksw2_tpu_torch.core.flags import Flag

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
    glob = Aligner()
    runs.append(("single_gg2_mt", lambda: glob.global_align(*mt)))
    files = cli_files(jobs)
    runs += [(name, cli_lines(name, files)) for name in CLI_BATCH_ARGS]
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
        for ev in prof.key_averages():
            dev = getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0))
            if dev > 0:
                rows[ev.key[:60]] = round(dev / 1e3, 3)
        busy = sum(rows.values())
        out[name] = {"wall_ms": wall * 1e3,
                     "device_ms_by_name": dict(sorted(
                         rows.items(), key=lambda kv: -kv[1])[:8]),
                     "device_ms": round(busy, 3),
                     "idle_share": round(1 - busy / (wall * 1e3), 4)}
    emit({"phase": "profile", "runs": out})
    return out


def bound(name, ops_units, nbytes, int_rate, cig=False):
    """(bound_ms, bound_by): the larger of the operations over the card's
    int32 rate and the bytes over its memory rate; ``cig`` counts the
    direction byte of a forward that writes bytes."""
    ops = OPS[name] + (BYTE_OPS.get(name, 0) if cig else 0)
    t_ops = ops * ops_units / int_rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def walk_work(res, runs, per_pair):
    """(steps, bytes) of one walk on this run's data: the steps are the
    summed lengths of its runs, each reading one direction byte; the
    bytes add one int32 for each run written (``res[:, 2]``, the runs a
    pair wrote) and ``per_pair`` bytes of start cell and result."""
    n = res[:, 2].cpu().numpy().astype(np.int64)
    r = runs.cpu().numpy()
    steps = int(sum((r[b, :n[b]].astype(np.int64) >> 4).sum()
                    for b in range(len(n))))
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
    min_intron annotated) beside their bounds and the plain versions'
    times from phase 5d (the walkers' on a launch's first 256 pairs,
    where the kernel is timed on the same 256)."""
    import torch
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import batch_exts as BE
    from ksw2_tpu_torch.ops import strips as S
    from ksw2_tpu_torch.ops import strips_walker as W

    out = {}
    for name, route, ln in scases:
        if not name.startswith("main"):
            continue
        row = {"route": route, "pairs": len(ln.qlen)}
        if route == "strips":
            qs, ts, ql, tl, tab = S.upload(ln, "cuda")
            sites = S.site_rows(ln, "cuda")
            B, Lq = qs.shape
            tv = ln.prm.tv
            row.update(kernel="strips_fwd (spl)", Lq=int(Lq), tv=tv)

            def fwd():
                return S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm,
                                             sites)
            row["fwd_ms"] = cuda_ms(fwd, 5)
            row["fwd_plain_ms"] = PLAIN_MS[(name, "fwd")]
            row["cells"] = int((ql.long() * tl.long()).sum())
            nbytes = B * (Lq + tv + 8 + 4 * Lq + 8 * (Lq + tv) + 4 * tv
                          + (tv * Lq if ln.prm.cig else 0))
            row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
                "strips_spl_fwd", row["cells"], nbytes, int_rate,
                ln.prm.cig)
            if ln.prm.cig:
                D, Dq, hl, d8 = fwd()
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
                       Lt=int(ln.target.shape[1]))

            def fwd():
                return BE.batch_exts_forward_cuda(*args, ln.prm, ln.nd,
                                                  ln.ncol)
            row["fwd_ms"] = cuda_ms(fwd, 5)
            row["fwd_plain_ms"] = PLAIN_MS[(name, "fwd")]
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
                row["walk_plain_ms"] = PLAIN_MS[(name, "walk")]
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


def single_times(single, sb, int_rate):
    """Kernels 12 and 17 at the main path's shapes: the 50 kb pair's one
    launch in each form (score, -sg, CIG; walker on the CIG bytes) and
    the launches the scheduler makes of the sr-extension workload, timed
    together as the path runs them, beside their bounds; the plain
    versions' times on the sr-extension launches come from phase 5e (on
    the 50 kb pair the plain forward would take minutes)."""
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


def phase_times(cases, rcases, long, sb, scases, single, spl, slong,
                int_rate, lcases, mt, jobs):
    import torch
    from ksw2_tpu_torch.core.flags import Flag
    from ksw2_tpu_torch.core.matrix import simple_mat
    from ksw2_tpu_torch.ops import band as BD
    from ksw2_tpu_torch.ops import band_walker as BW
    from ksw2_tpu_torch.ops import rows as R
    from ksw2_tpu_torch.ops import strips as S
    from ksw2_tpu_torch.ops import strips_walker as W

    out = {}
    for name, ln in cases:
        if name.startswith("sample"):
            continue
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        B, Lq = qs.shape
        row = {"pairs": int(B), "Lq": int(Lq), "tv": ln.prm.tv}
        row["fwd_ms"] = cuda_ms(
            lambda: S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm), 5)
        row["fwd_plain_ms"] = PLAIN_MS[(name, "fwd")]
        row["cells"] = int((ql.long() * tl.long()).sum())
        nbytes = B * (Lq + ln.prm.tv + 8 + 4 * Lq + 8 * (Lq + ln.prm.tv)
                      + (ln.prm.tv * Lq if ln.prm.cig else 0))
        row["fwd_bound_ms"], row["fwd_bound_by"] = bound(
            "strips_fwd", row["cells"], nbytes, int_rate, ln.prm.cig)
        if ln.prm.cig:
            D, Dq, hl, d8 = S.strips_forward_cuda(qs, ts, ql, tl, tab,
                                                  ln.prm)
            rec = S.replay_records(ln.prm, D, Dq, hl, ql, tl)
            starts = W.start_cells(rec, ql, tl, ln.prm.flag, 0)
            row["walk_ms"] = cuda_ms(lambda: W.strips_walk_cuda(d8, starts),
                                     5)
            row["walk_plain_ms"] = PLAIN_MS[(name, "walk")]
            steps, nbytes = walk_work(*W.strips_walk_cuda(d8, starts), 20)
            row["walk_bound_ms"], row["walk_bound_by"] = bound(
                "strips_walk", steps, nbytes, int_rate)
        row["fwd_gcells_per_s"] = row["cells"] / row["fwd_ms"] / 1e6
        out[name] = row
    for name, ln in rcases:
        if name.startswith("short_sample"):
            continue
        qs, ts, ql, tl, tab = S.upload(ln, "cuda")
        B, Lq = qs.shape
        row = {"pairs": int(B), "Lq": int(Lq), "tv": ln.prm.tv}
        row["rows_ms"] = cuda_ms(
            lambda: R.rows_forward_cuda(qs, ts, ql, tl, tab, ln.prm), 20)
        row["rows_plain_ms"] = PLAIN_MS[(name, "rows")]
        row["fwd_ms"] = cuda_ms(
            lambda: S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm), 20)
        row["cells"] = int((ql.long() * tl.long()).sum())
        row["rows_bound_ms"], row["rows_bound_by"] = bound(
            "rows_fwd", row["cells"],
            B * (Lq + ln.prm.tv + 8 + 4 * Lq + 8 * (Lq + ln.prm.tv)),
            int_rate)
        row["rows_gcells_per_s"] = row["cells"] / row["rows_ms"] / 1e6
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

    # the batched kernels at the main path's shape: the launches the
    # scheduler makes of the short-banded workload's 4096 pairs
    # (-w100 -z100), timed together as the path runs them; the plain
    # forward's time on the same launches (phase 5c) for the score forms
    from ksw2_tpu_torch.batch import scheduler as sched
    from ksw2_tpu_torch.ops import batch as BT
    for name, flag, costs, plain in (
            ("sb_extz_score", Flag.SCORE_ONLY, None, "sb_extz_score_z100"),
            ("sb_extd_score", Flag.SCORE_ONLY, EXTD, "sb_extd_score_z100"),
            ("sb_approx_score", Flag.SCORE_ONLY | approx, None, None),
            ("sb_extz_cig", Flag.NONE, None, None),
            ("sb_extd_cig", Flag.NONE, EXTD, None)):
        lns, _, _ = short_banded_launches(sb, flag, costs)
        args = [BD.band_upload(ln, "cuda") for ln in lns]
        kname = "batch_extd_fwd" if costs else "batch_fwd"
        row = {"pairs": len(sb), "kernel": kname,
               "launches": [{"pairs": len(ln.qlen), "nd": ln.nd,
                             "ncol": ln.ncol, "Lt": int(ln.target.shape[1])}
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
        row["band_cells"] = band_cells(sb, SHORT_BANDED_W)
        row["fwd_band_gcells_per_s"] = row["band_cells"] / row["fwd_ms"] / 1e6
        if plain:
            row["fwd_plain_ms"] = sum(PLAIN_MS[(f"{plain}_launch{k}", "fwd")]
                                      for k in range(len(lns)))
        if plain and costs is None:
            # host work of the score batch before its launches (host
            # clock): the route table on every bucket (rows, strips and
            # band refuse them), and the buckets' padding
            _, route_s, prep_s = short_banded_launches(
                sb, flag, costs,
                sched._score_chooser(flag, 5, simple_mat(5, 2, -4), 100, 4,
                                     2))
            row["host_route_ms"] = route_s * 1e3
            row["host_prep_ms"] = prep_s * 1e3
        if lns[0].prm.cig:
            walks = []
            for (rec, p), (_, _, ql, tl, w, _), ln in zip(outs, args, lns):
                walks.append((p, W.start_cells(rec, ql, tl, ln.prm.flag, 0),
                              ql, tl, w))
            row["walk_ms"] = cuda_ms(
                lambda: [BW.band_walk_cuda(*a) for a in walks], 5)
            steps, nbytes = walks_work(
                [BW.band_walk_cuda(*a) for a in walks], 20)
            row["walk_steps"] = steps
            row["walk_bound_ms"], row["walk_bound_by"] = bound(
                "band_walk", steps, nbytes, int_rate)
            del walks
        del outs
        out[name] = row
        torch.cuda.empty_cache()
    out.update(splice_times(scases, int_rate))
    out.update(single_times(single, sb, int_rate))
    out.update(single2_times(single, sb, spl, slong, int_rate))
    out.update(linear_global_times(lcases, single, mt, jobs, int_rate))
    emit({"phase": "times", "cases": out})
    return out


def _kernel(name, src, replaces, launches, err, row, prefix):
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": row[f"{prefix}_ms"], "plain_ms": row[f"{prefix}_plain_ms"],
            "bound_ms": row[f"{prefix}_bound_ms"],
            "bound_by": row[f"{prefix}_bound_by"], "library_ms": None}


def main() -> int:
    import torch

    import ksw2_tpu_torch  # noqa: F401  (outside a checkout: fail first)

    clock = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        clock[name] = time.perf_counter() - t0
        return out

    int_rate = phase_device()
    torch.manual_seed(0)
    timed("build", phase_build)
    spl = splice_jobs()
    scases = splice_cases(spl)
    err_spl = timed("splice", phase_splice, scases)
    jobs = mixed_jobs()
    short = short_jobs()
    long = long_banded_jobs()
    cases = fwd_cases(jobs)
    rcases = rows_cases(short)
    err_a = timed("kernel_a", phase_kernel_a, cases)
    err_b = timed("kernel_b", phase_kernel_b, cases)
    err_r = timed("rows", phase_rows, rcases)
    err_band = timed("band", phase_band, band_cases(long))
    sb = short_banded_jobs()
    err_batch = timed("batch", phase_batch, batch_cases(sb))
    err_single = timed("single", phase_single, single_cases(sb))
    err_single2 = timed("single2", phase_single2, single2_cases(sb, spl))
    lcases = lg_cases(jobs)
    err_lg = timed("linear_global", phase_linear_global, lcases)
    single = single_pair(SINGLE_SEED, SINGLE_LEN)
    mt = single_pair(MT_SEED, MT_LEN)
    slong = splice_long_jobs()
    counts, _ = timed("main_path", phase_main_path, jobs, short, long, sb,
                      spl, single, mt, slong)
    times = timed("times", phase_times, cases, rcases, long, sb, scases,
                  single, spl, slong, int_rate, lcases, mt, jobs)
    timed("profile", phase_profile, long, sb, spl, jobs, mt)
    emit({"phase": "clock", "seconds": clock})
    whale = times["whale_cig_z100"]
    rows = times["short_score_z100"]
    ld = times["long1_extd_score"]
    lc = times["long1_extz_cig"]
    print(json.dumps({"kernels": [
        _kernel("strips_fwd", FWD_SRC, FWD_REPLACES, counts["strips_fwd"],
                max(err_a, err_spl["strips_fwd"]), whale, "fwd"),
        _kernel("strips_walk", WALK_SRC, WALK_REPLACES,
                counts["strips_walk"], max(err_b, err_spl["strips_walk"]),
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
                    err_spl["band_walk"], err_lg["band_walk"]), lc, "walk"),
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
                max(err_single["extz_walk"], err_single2["extz_walk"]),
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
        _kernel("extf_fwd", EXTF_SRC, EXTF_REPLACES, counts["extf_fwd"],
                err_lg["extf_fwd"], times["cli64_extf_single"], "fwd"),
        _kernel("gg2_fwd", GG2_SRC, GG2_REPLACES, counts["gg2_fwd"],
                err_lg["gg2_fwd"], times["cli64_gg2_single"], "fwd"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
