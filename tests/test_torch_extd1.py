"""The single-pair two-piece engine (kernel 13, walked by kernel 17)
against the JAX package, the spec and the reference binary.

``ops/extd.extd2_device`` over kernel 13's plain version
(``extd_forward_plain``) and kernel 17's is held against the JAX
``ops/extd.extd2_device(..., interpret=True)`` (its Pallas kernels
interpreted, as ``tests/test_kernel_interpret.py`` runs them) on seeded
cases of 10-150 bp; the plain forward's records, stops and compact store
against the spec's ``extd2`` and its ``Trace`` on pairs over several
tiles of 128 positions; every golden ``extd2_sse`` case through
``Aligner.extend`` against the reference binary's rows; and
``convert.extd_params_from_jax`` against the JAX tuple.  Costs (4, 2, 13,
1) are minimap2's, which do not swap; (24, 1, 4, 2) swap.  Every
comparison is exact.
"""
import json
import os

import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import wavefront_extd as wfd
from ksw2_tpu.ops.extd import extd2_device as j_extd2_device
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner, convert
from ksw2_tpu_torch.ops import extd as ED
from ksw2_tpu_torch.ops import extz_fwd as F
from ksw2_tpu_torch.ops.band import band_upload

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)
APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP
DEFAULT = (4, 2, 13, 1)
SWAPPED = (24, 1, 4, 2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cases.jsonl")


def _generic_mat():
    rng = np.random.default_rng(3)
    mat = rng.integers(-4, 3, (5, 5)).astype(np.int8)
    np.fill_diagonal(mat, 2)
    return mat.reshape(-1)


def _cases():
    """(query, target, costs, w, zdrop, end_bonus, flag, mat) seeded cases
    of 10-150 bp covering the options the engine takes."""
    rng = np.random.default_rng(22)
    opts = [Flag.NONE, Flag.SCORE_ONLY, Flag.SCORE_ONLY | APPROX,
            Flag.SCORE_ONLY | Flag.APPROX_MAX, Flag.EQX,
            Flag.EXTZ_ONLY, Flag.EXTZ_ONLY | Flag.SCORE_ONLY,
            Flag.EXTZ_ONLY | Flag.RIGHT | Flag.REV_CIGAR, Flag.RIGHT,
            Flag.GENERIC_SC, Flag.GENERIC_SC | Flag.SCORE_ONLY, APPROX,
            Flag.REV_CIGAR, Flag.NONE, Flag.EQX | Flag.RIGHT,
            Flag.EXTZ_ONLY]
    out = []
    for k, flag in enumerate(opts):
        t, q = refcmp.random_pair(rng, int(rng.integers(10, 151)),
                                  divergence=0.25, indel=0.1,
                                  with_n=k % 3 == 0)
        costs = SWAPPED if k % 2 else DEFAULT
        w = (-1, 0, 5, 16)[k % 4]
        z = (-1, 20)[(k // 4) % 2]
        eb = 10 if flag & Flag.EXTZ_ONLY else 0
        mat = _generic_mat() if flag & Flag.GENERIC_SC else MAT
        out.append((encode_dna(q), encode_dna(t), costs, w, z, eb, flag, mat))
    return out


CASES = _cases()


def _fields(ez):
    return (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, bool(ez.zdropped), bool(ez.reach_end), list(ez.cigar))


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_extd2_device_matches_jax(idx):
    """``extd2_device`` over kernel 13's and kernel 17's plain versions
    equals the JAX single-pair two-piece engine: all 9 fields, reach_end
    and the CIGAR words."""
    q, t, costs, w, z, eb, flag, mat = CASES[idx]
    want, _ = j_extd2_device(q, t, 5, mat, *costs, w=w, zdrop=z,
                             end_bonus=eb, flag=flag, interpret=True)
    got = ED.extd2_device(q, t, 5, mat, *costs, w=w, zdrop=z, end_bonus=eb,
                          flag=flag, device="cpu")
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("seed,tlen,w,costs,zdrop", [
    (0, 300, -1, DEFAULT, 200), (1, 700, 100, SWAPPED, -1),
    (2, 520, 3, DEFAULT, -1), (3, 460, -1, SWAPPED, 30)])
def test_plain_forward_matches_the_spec_trace(seed, tlen, w, costs, zdrop):
    """Kernel 13's plain version on pairs over several tiles of 128
    positions: its records are the spec's fields, its stop the rows the
    spec computed, and each row r of its compact store is the spec's row
    ``p[r, :en - st + 1]`` up to the stop (0 after it)."""
    rng = np.random.default_rng(seed)
    t, q = refcmp.random_pair(rng, tlen, divergence=0.15, indel=0.06)
    if zdrop == 30:
        q = q[:200] + "".join(rng.choice(list("ACGT"), len(q) - 200))
    q, t = encode_dna(q), encode_dna(t)
    ez, trace = diagdiff.extd2(q, t, 5, MAT, *costs, w=w, zdrop=zdrop,
                               keep_trace=True)
    wr = max(len(q), len(t)) if w < 0 else w
    launch, = ED.extd_prep([q], [t], [len(q)], [len(t)], [wr], 5, MAT,
                           *costs, zdrop, 0, cig=True)
    assert int(launch.lay.tbase[-1]) >= 3
    rec, p, stop = ED.extd_forward_plain(*band_upload(launch, "cpu"),
                                         launch.prm, launch.lay)
    assert rec[0].tolist() == [ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t,
                               ez.mte, ez.mte_q, ez.score, int(ez.zdropped)]
    nrow = int(stop[0])
    rlim = int(F.first_empty_diag(len(q), len(t), wr))
    # a Z-drop stops the pair early (the last case's random tail does);
    # else it runs to its first empty band
    assert nrow < rlim if zdrop == 30 else nrow == rlim
    wid = F.row_widths(nrow, len(q), len(t), wr)
    want = np.concatenate([trace.p[r, :wid[r]] for r in range(nrow)])
    assert np.array_equal(p.numpy()[:wid.sum()], want)
    assert not p.numpy()[wid.sum():].any()


def test_plain_forward_needs_two_piece_params():
    q, t = encode_dna("ACGTACGT"), encode_dna("ACGTACGA")
    launch, = ED.extd_prep([q], [t], [8], [8], [8], 5, MAT, *DEFAULT, -1, 0,
                           cig=False)
    one = launch.prm._replace(two=0)
    with pytest.raises(ValueError, match="two-piece"):
        ED.extd_forward_plain(*band_upload(launch, "cpu"), one, launch.lay)


def _golden():
    with open(GOLDEN) as f:
        cases = [json.loads(line) for line in f]
    return [c for c in cases if c["algo"] == "extd2_sse"]


def test_golden_extd2_cases_through_extend():
    """All 87 golden ``extd2_sse`` cases (approx included, as
    tests/refcmp.py runs them) through ``Aligner.extend``, the single-pair
    two-piece engine, as the JAX ``extend`` runs ``extd2_device``: each
    equals the reference binary's row."""
    cases = _golden()
    assert len(cases) == 87
    for c in cases:
        p = c["params"]
        flag = ((Flag.RIGHT if p["right"] else Flag.NONE)
                | (Flag.SCORE_ONLY if p["score_only"] else Flag.NONE)
                | (APPROX if p["approx"] else Flag.NONE))
        aln = Aligner(a=p["a"], b=p["b"], q=p["q"], e=p["e"], q2=p["q2"],
                      e2=p["e2"], w=p["w"], zdrop=p["z"], flag=flag,
                      device="cpu")
        got = aln.extend(c["query"], c["target"]).tsv_fields()
        if c.get("fields_only"):
            got = got[:4]
        assert got == c["expect"], (p, c["query"], c["target"])


@pytest.mark.parametrize("costs", [DEFAULT, SWAPPED])
def test_convert_extd_params_from_jax(costs):
    """``extd_params_from_jax`` carries the JAX tuple's values (post-swap
    costs, the pre-swap q + e, long_thres / long_diff) and drops the TPU
    layout fields; the port's host side builds the same tuple."""
    q, t = encode_dna("ACGTACGTAAC"), encode_dna("ACGTTCGTAACGG")
    qq, e, q2, e2 = costs
    qe_pre = qq + e
    if q2 + e2 < qq + e:
        qq, q2, e, e2 = q2, qq, e2, e
    lt, ld = ED.long_params(qq, e, q2, e2)
    jprm = wfd.ExtdParams(qlen=11, tlen=13, m=5, sc_mch=2, sc_mis=-4,
                          sc_N=-e2, q=qq, e=e, q2=q2, e2=e2,
                          qe_pre_swap=qe_pre, long_thres=lt, long_diff=ld,
                          w=13, zdrop=100, flag=0, chunk=128, n_diag=23,
                          n_rows=8, p_rows=32)
    prm = convert.extd_params_from_jax(jprm._asdict())
    assert prm == ED.extd_params(q, t, 5, MAT, *costs, -1, 100, 0)
    assert prm._asdict() == {k: v for k, v in jprm._asdict().items()
                             if k not in ("chunk", "n_rows", "p_rows")}
