"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips when
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on the machine with the card:

    python -m pytest tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from chip_smoke import random_pair, spliced_pair
from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.core.flags import Flag
from ksw2_tpu_torch.core.matrix import encode_dna, simple_mat
from ksw2_tpu_torch.ops import band as BD
from ksw2_tpu_torch.ops import band_walker as BW
from ksw2_tpu_torch.ops import batch as BT
from ksw2_tpu_torch.ops import batch_exts as BE
from ksw2_tpu_torch.ops import extd as ED
from ksw2_tpu_torch.ops import exts as ES
from ksw2_tpu_torch.ops import extz as EZ
from ksw2_tpu_torch.ops import extz_fwd as F
from ksw2_tpu_torch.ops import rows as R
from ksw2_tpu_torch.ops import strips as S
from ksw2_tpu_torch.ops import strips_walker as W
from ksw2_tpu_torch.ops import traceback_device as TB

MAT = simple_mat(5, 2, -4)
GEN = np.array([[3, -2, -4, -3, 0],
                [-3, 2, -2, -4, 0],
                [-4, -2, 4, -1, 0],
                [-2, -3, -1, 2, 0],
                [0, 0, 0, 0, 0]], np.int8).reshape(-1)
EDGE = [(1, 1), (1, 129), (129, 1), (127, 128), (128, 128), (129, 127),
        (128, 129), (257, 130)]
# two-piece costs: minimap2's -O4,13 -E2,1 (no swap) and costs that swap
# the pieces (off0 = -19)
TWO_PIECE = [(4, 2, 13, 1), (24, 1, 4, 2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _pairs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for L in (700, 300, 1500, 3000):
        t, q = random_pair(rng, L, divergence=0.2, indel=0.08, with_n=True)
        out.append((encode_dna(q), encode_dna(t)))
    out += [(rng.integers(0, 5, ql).astype(np.uint8),
             rng.integers(0, 5, tl).astype(np.uint8)) for ql, tl in EDGE]
    return out


def _launch(pairs, flag, zdrop, cig, costs=None):
    """One launch at O4 E2, or at the two-piece ``costs`` (q, e, q2, e2)."""
    q, e, q2, e2 = (4, 2, 0, 0) if costs is None else costs
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    (ln,) = S.strips_prep([q for q, _ in pairs], [t for _, t in pairs], ql,
                          tl, 5, MAT, q, e, zdrop, flag, cig=cig,
                          two=costs is not None, q2=q2, e2=e2)
    return ln


@pytest.mark.cuda
@pytest.mark.parametrize("flag,cig", [(Flag.SCORE_ONLY, False),
                                      (Flag.NONE, True), (Flag.RIGHT, True)])
def test_forward_kernel_matches_plain(cuda_device, flag, cig):
    pairs = _pairs(14)
    ln = _launch(pairs, flag, 100, cig)
    args = S.upload(ln, cuda_device)
    kd = S.strips_forward_cuda(*args, ln.prm)
    pd = S.strips_forward_plain(*args, ln.prm)
    for a, b in zip(kd[:3], pd[:3]):
        assert torch.equal(a, b)
    if cig:
        for b, (q, t) in enumerate(pairs):
            assert torch.equal(kd[3][b, :len(t), :len(q)],
                               pd[3][b, :len(t), :len(q)])


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [Flag.NONE, Flag.RIGHT])
def test_walk_kernel_matches_plain(cuda_device, flag):
    pairs = _pairs(30)
    ln = _launch(pairs, flag, 30, True)
    qs, ts, ql, tl, tab = S.upload(ln, cuda_device)
    D, Dq, hl, d8 = S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm)
    rec = S.replay_records(ln.prm, D, Dq, hl, ql, tl)
    starts = W.start_cells(rec, ql, tl, flag, 0)
    kres, kruns = W.strips_walk_cuda(d8, starts)
    pres, pruns = W.strips_walk_plain(d8, starts)
    assert torch.equal(kres, pres)
    for b in range(len(pairs)):
        n = int(kres[b, 2])
        assert torch.equal(kruns[b, :n], pruns[b, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("costs", TWO_PIECE)
@pytest.mark.parametrize("flag,cig", [(Flag.SCORE_ONLY, False),
                                      (Flag.NONE, True), (Flag.RIGHT, True)])
def test_forward_kernel_two_piece_matches_plain(cuda_device, costs, flag,
                                                cig):
    pairs = _pairs(15)
    ln = _launch(pairs, flag, 100, cig, costs)
    args = S.upload(ln, cuda_device)
    kd = S.strips_forward_cuda(*args, ln.prm)
    pd = S.strips_forward_plain(*args, ln.prm)
    for a, b in zip(kd[:3], pd[:3]):
        assert torch.equal(a, b)
    if cig:
        for b, (q, t) in enumerate(pairs):
            assert torch.equal(kd[3][b, :len(t), :len(q)],
                               pd[3][b, :len(t), :len(q)])


@pytest.mark.cuda
@pytest.mark.parametrize("costs", TWO_PIECE)
@pytest.mark.parametrize("flag", [Flag.NONE, Flag.RIGHT])
def test_walk_kernel_on_7bit_bytes_matches_plain(cuda_device, costs, flag):
    pairs = _pairs(31)
    ln = _launch(pairs, flag, 30, True, costs)
    qs, ts, ql, tl, tab = S.upload(ln, cuda_device)
    D, Dq, hl, d8 = S.strips_forward_cuda(qs, ts, ql, tl, tab, ln.prm)
    rec = S.replay_records(ln.prm, D, Dq, hl, ql, tl)
    starts = W.start_cells(rec, ql, tl, flag, 0)
    kres, kruns = W.strips_walk_cuda(d8, starts)
    pres, pruns = W.strips_walk_plain(d8, starts)
    assert torch.equal(kres, pres)
    for b in range(len(pairs)):
        n = int(kres[b, 2])
        assert torch.equal(kruns[b, :n], pruns[b, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [50, 51])
def test_rows_kernel_matches_plain_and_strips(cuda_device, seed):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(40):
        t, q = random_pair(rng, int(rng.integers(1, 121)), divergence=0.2,
                           indel=0.1, with_n=True)
        pairs.append((encode_dna(q[:128]), encode_dna(t)))
    pairs += [(rng.integers(0, 5, ql).astype(np.uint8),
               rng.integers(0, 5, tl).astype(np.uint8))
              for ql, tl in [(1, 1), (1, 128), (128, 1), (127, 128),
                             (128, 128), (128, 127)]]
    ln = _launch(pairs, Flag.SCORE_ONLY, 100, False)
    args = S.upload(ln, cuda_device)
    kd = R.rows_forward_cuda(*args, ln.prm)
    pd = R.rows_forward_plain(*args, ln.prm)
    ad = S.strips_forward_cuda(*args, ln.prm)
    for a, b, c in zip(kd[:3], pd[:3], ad[:3]):
        assert torch.equal(a, b) and torch.equal(a, c)


def _band_launch(seed, flag, zdrop, costs=None, mat=MAT):
    """One band launch of seeded long-ish pairs with bands from 1 to 1472
    (one clipped query, N bases), at O4 E2 or the two-piece ``costs``."""
    rng = np.random.default_rng(seed)
    pairs = []
    for L in (700, 300, 1500, 2000, 900, 60):
        t, q = random_pair(rng, L, divergence=0.2, indel=0.08, with_n=True)
        pairs.append((encode_dna(q), encode_dna(t)))
    pairs[1] = (pairs[1][0][:150], pairs[1][1])
    w = np.array([1, 37, 751, 1472, 200, 16], np.int32)
    q, e, q2, e2 = (4, 2, 0, 0) if costs is None else costs
    qs, ts = [a for a, _ in pairs], [b for _, b in pairs]
    (ln,) = BD.band_prep(qs, ts, [len(a) for a in qs], [len(b) for b in ts],
                         w, 5, mat, q, e, zdrop, flag,
                         cig=not flag & Flag.SCORE_ONLY,
                         two=costs is not None, q2=q2, e2=e2)
    return ln


BAND_FORMS = [(Flag.SCORE_ONLY, 100), (Flag.NONE, 100), (Flag.RIGHT, -1),
              (Flag.SCORE_ONLY | Flag.APPROX_MAX, -1),
              (Flag.SCORE_ONLY | Flag.APPROX_MAX | Flag.APPROX_DROP, 100),
              (Flag.APPROX_MAX | Flag.APPROX_DROP, 400),
              (Flag.GENERIC_SC, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("costs", [None] + TWO_PIECE)
@pytest.mark.parametrize("flag,zdrop", BAND_FORMS)
def test_band_forward_kernel_matches_plain(cuda_device, costs, flag, zdrop):
    mat = GEN if flag & Flag.GENERIC_SC else MAT
    ln = _band_launch(60, flag, zdrop, costs, mat)
    args = BD.band_upload(ln, cuda_device)
    krec, kp = BD.band_forward_cuda(*args, ln.prm, ln.nd, ln.ncol)
    prec, pp = BD.band_forward_plain(*args, ln.prm, ln.nd, ln.ncol)
    assert torch.equal(krec, prec)
    if ln.prm.cig:
        assert torch.equal(kp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("costs", [None] + TWO_PIECE)
@pytest.mark.parametrize("flag", [Flag.NONE, Flag.RIGHT])
def test_band_walk_kernel_matches_plain(cuda_device, costs, flag):
    ln = _band_launch(61, flag, 60, costs)
    qs, ts, ql, tl, w, tab = BD.band_upload(ln, cuda_device)
    rec, p = BD.band_forward_cuda(qs, ts, ql, tl, w, tab, ln.prm, ln.nd,
                                  ln.ncol)
    starts = W.start_cells(rec, ql, tl, flag, 0)
    kres, kruns = BW.band_walk_cuda(p, starts, ql, tl, w)
    pres, pruns = BW.band_walk_plain(p, starts, ql, tl, w)
    assert torch.equal(kres, pres)
    for b in range(len(ql)):
        n = int(kres[b, 2])
        assert torch.equal(kruns[b, :n], pruns[b, :n])


def _batch_launch(seed, flag, zdrop, costs=None, mat=MAT):
    """One batched launch of seeded short pairs (N bases, one clipped
    query) with w 0, 1, 16, 100 and unbanded on targets up to 1000 (P = 1
    to 8 rows a pair on the TPU), at O4 E2 or the two-piece ``costs``."""
    rng = np.random.default_rng(seed)
    pairs = []
    for L in (60, 150, 300, 500, 240, 1000):
        t, q = random_pair(rng, L, divergence=0.2, indel=0.08, with_n=True)
        pairs.append((encode_dna(q), encode_dna(t)))
    pairs[2] = (pairs[2][0][:120], pairs[2][1])
    w = np.array([0, 1, 16, 100, 600, 1100], np.int32)
    q, e, q2, e2 = (4, 2, 0, 0) if costs is None else costs
    qs, ts = [a for a, _ in pairs], [b for _, b in pairs]
    (ln,) = BD.band_prep(qs, ts, [len(a) for a in qs], [len(b) for b in ts],
                         w, 5, mat, q, e, zdrop, flag,
                         cig=not flag & Flag.SCORE_ONLY,
                         two=costs is not None, q2=q2, e2=e2)
    return ln


@pytest.mark.cuda
@pytest.mark.parametrize("costs", [None] + TWO_PIECE)
@pytest.mark.parametrize("flag,zdrop", BAND_FORMS)
def test_batch_forward_kernel_matches_plain(cuda_device, costs, flag, zdrop):
    """Kernels E / E2 against the plain forward: records and bytes, and
    the band walker on the kernel's bytes."""
    mat = GEN if flag & Flag.GENERIC_SC else MAT
    ln = _batch_launch(62, flag, zdrop, costs, mat)
    qs, ts, ql, tl, w, tab = BD.band_upload(ln, cuda_device)
    krec, kp = BT.batch_forward_cuda(qs, ts, ql, tl, w, tab, ln.prm, ln.nd,
                                     ln.ncol)
    prec, pp = BD.band_forward_plain(qs, ts, ql, tl, w, tab, ln.prm, ln.nd,
                                     ln.ncol)
    assert torch.equal(krec, prec)
    if ln.prm.cig:
        assert torch.equal(kp, pp)
        starts = W.start_cells(krec, ql, tl, flag, 0)
        kres, kruns = BW.band_walk_cuda(kp, starts, ql, tl, w)
        pres, pruns = BW.band_walk_plain(kp, starts, ql, tl, w)
        assert torch.equal(kres, pres)
        for b in range(len(ql)):
            n = int(kres[b, 2])
            assert torch.equal(kruns[b, :n], pruns[b, :n])


SPL_MAT = simple_mat(5, 1, 2)
SPLICE_FORMS = [(Flag.SPLICE_FOR | Flag.SCORE_ONLY, 200),
                (Flag.SPLICE_FOR, 200), (Flag.SPLICE_FOR | Flag.RIGHT, -1),
                (Flag.SPLICE_REV | Flag.SPLICE_FLANK, 30),
                (Flag.SPLICE_FOR | Flag.GENERIC_SC, 200)]


def _splice_pairs(seed):
    """Seeded spliced pairs (a GT..AG intron, 5% substitutions, N bases)
    on targets of 30 to 1500, and edge shapes."""
    rng = np.random.default_rng(seed)
    pairs = [spliced_pair(rng, L, with_n=True)
             for L in (30, 120, 512, 700, 1500)]
    pairs += [(rng.integers(0, 5, ql).astype(np.uint8),
               rng.integers(0, 5, tl).astype(np.uint8))
              for ql, tl in [(1, 1), (1, 129), (129, 1), (128, 129)]]
    return pairs


def _splice_launch(seed, flag, zdrop):
    """One strips launch of spliced pairs at -x splice costs (noncan 9)."""
    pairs = _splice_pairs(seed)
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    (ln,) = S.strips_exts_prep([q for q, _ in pairs], [t for _, t in pairs],
                               ql, tl, 5, GEN if flag & Flag.GENERIC_SC
                               else SPL_MAT, 2, 1, 32, 9, zdrop, flag,
                               cig=not flag & Flag.SCORE_ONLY)
    return pairs, ln


@pytest.mark.cuda
@pytest.mark.parametrize("flag,zdrop", SPLICE_FORMS)
def test_splice_forward_kernel_matches_plain(cuda_device, flag, zdrop):
    """The strips forward's spl form against its plain version, and the
    walker's nop form on its bytes."""
    pairs, ln = _splice_launch(63, flag, zdrop)
    args = S.upload(ln, cuda_device)
    sites = S.site_rows(ln, cuda_device)
    kd = S.strips_forward_cuda(*args, ln.prm, sites)
    pd = S.strips_forward_plain(*args, ln.prm, sites)
    for a, b in zip(kd[:3], pd[:3]):
        assert torch.equal(a, b)
    if not ln.prm.cig:
        return
    for b, (q, t) in enumerate(pairs):
        assert torch.equal(kd[3][b, :len(t), :len(q)],
                           pd[3][b, :len(t), :len(q)])
    _, _, ql, tl, _ = args
    rec = S.replay_records(ln.prm, *kd[:3], ql, tl)
    starts = W.start_cells(rec, ql, tl, flag, 0)
    kres, kruns = W.strips_walk_cuda(kd[3], starts, ln.prm.lt)
    pres, pruns = W.strips_walk_plain(kd[3], starts, ln.prm.lt)
    assert torch.equal(kres, pres)
    for b in range(len(pairs)):
        n = int(kres[b, 2])
        assert torch.equal(kruns[b, :n], pruns[b, :n])


def _exts_launch(seed, flag, zdrop, junc_bonus=0):
    """One batched exts launch of spliced pairs at -x splice costs; with
    ``junc_bonus`` every pair carries a junction track at its site."""
    pairs = _splice_pairs(seed)
    juncs = None
    if junc_bonus:
        juncs = []
        for _, t in pairs:
            j = np.zeros(len(t), np.uint8)
            j[len(t) // 3] = 1
            j[2 * len(t) // 3] = 2
            juncs.append(j)
    qs, ts = [a for a, _ in pairs], [b for _, b in pairs]
    (ln,) = BE.batch_exts_prep(qs, ts, [len(a) for a in qs],
                               [len(b) for b in ts], 5,
                               GEN if flag & Flag.GENERIC_SC else SPL_MAT, 2,
                               1, 32, 9, zdrop, flag, juncs, junc_bonus,
                               cig=not flag & Flag.SCORE_ONLY)
    return ln


EXTS_FORMS = SPLICE_FORMS + [
    (Flag.SPLICE_FOR | Flag.SCORE_ONLY | Flag.APPROX_MAX, -1),
    (Flag.SPLICE_FOR | Flag.APPROX_MAX | Flag.APPROX_DROP, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("junc_bonus", [0, 9])
@pytest.mark.parametrize("flag,zdrop", EXTS_FORMS)
def test_batch_exts_forward_kernel_matches_plain(cuda_device, flag, zdrop,
                                                 junc_bonus):
    """Kernel 6 against its plain version: records and bytes, and the
    band walker with min_intron on the kernel's bytes."""
    ln = _exts_launch(64, flag, zdrop, junc_bonus)
    args = BD.band_upload(ln, cuda_device)
    krec, kp = BE.batch_exts_forward_cuda(*args, ln.prm, ln.nd, ln.ncol)
    prec, pp = BE.batch_exts_forward_plain(*args, ln.prm, ln.nd, ln.ncol)
    assert torch.equal(krec, prec)
    if not ln.prm.cig:
        return
    assert torch.equal(kp, pp)
    _, _, ql, tl, w = args[:5]
    starts = W.start_cells(krec, ql, tl, flag, 0)
    kres, kruns = BW.band_walk_cuda(kp, starts, ql, tl, w, ln.prm.lt)
    pres, pruns = BW.band_walk_plain(kp, starts, ql, tl, w, ln.prm.lt)
    assert torch.equal(kres, pres)
    for b in range(len(ql)):
        n = int(kres[b, 2])
        assert torch.equal(kruns[b, :n], pruns[b, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [Flag.SPLICE_FOR,
                                  Flag.SPLICE_FOR | Flag.SCORE_ONLY])
@pytest.mark.parametrize("junc_bonus", [0, 9])
def test_splice_aligner_matches_cpu(cuda_device, flag, junc_bonus):
    """Aligner(splice=True) on the card and on the CPU: the strips route
    without tracks, the batched exts route with them."""
    pairs = _splice_pairs(65)
    juncs = [np.full(len(t), 3, np.uint8) for _, t in pairs]
    kw = dict(a=1, b=2, q=2, e=1, q2=32, splice=True, noncan=9,
              junc_bonus=junc_bonus, zdrop=200, flag=flag)
    for tracks in (None, juncs):
        want = Aligner(device="cpu", **kw).extend_batch(pairs, juncs=tracks)
        got = Aligner(**kw).extend_batch(pairs, juncs=tracks)
        assert [(g.max, g.max_t, g.max_q, g.mqe, g.mte, g.score, g.cigar)
                for g in got] == \
            [(w.max, w.max_t, w.max_q, w.mqe, w.mte, w.score, w.cigar)
             for w in want]


@pytest.mark.cuda
def test_aligner_on_every_card_matches_cpu(cuda_device):
    # the current device stays 0: each launch must move to its tensors' card
    pairs = _pairs(41)
    want = Aligner(zdrop=100, device="cpu").extend_batch(pairs)
    for k in range(torch.cuda.device_count()):
        got = Aligner(zdrop=100, device=f"cuda:{k}").extend_batch(pairs)
        assert [(g.max, g.mqe, g.mte, g.score, g.cigar) for g in got] == \
            [(w.max, w.mqe, w.mte, w.score, w.cigar) for w in want], k


def _extz_launch(seed, flag, zdrop):
    """One single-pair launch with tiles of 128 positions: seeded pairs of
    300-1500 bp (3-12 tiles; N bases; the fifth diverges after 600 bp,
    so z100 stops it mid-matrix), a 30 bp pair and the edge shapes (1 bp,
    127-129 bp, 257 bp), with w from 0 to unbanded."""
    rng = np.random.default_rng(seed)
    pairs = []
    for L in (300, 1500, 30, 700, 1000):
        t, q = random_pair(rng, L, divergence=0.2, indel=0.08, with_n=True)
        pairs.append((encode_dna(q), encode_dna(t)))
    q, t = pairs[4]
    pairs[4] = (np.concatenate([q[:600], rng.integers(0, 4, 400).astype(
        np.uint8)]), t)
    pairs += [(rng.integers(0, 5, a).astype(np.uint8),
               rng.integers(0, 5, b).astype(np.uint8)) for a, b in EDGE]
    ql = np.array([len(a) for a, _ in pairs], np.int32)
    tl = np.array([len(b) for _, b in pairs], np.int32)
    w = np.concatenate([[16, 2000, 0, 751, max(ql[4], tl[4])],
                        np.maximum(ql[5:], tl[5:])]).astype(np.int32)
    mat = GEN if flag & Flag.GENERIC_SC else MAT
    (ln,) = EZ.extz_prep([a for a, _ in pairs], [b for _, b in pairs], ql, tl,
                         w, 5, mat, 4, 2, zdrop, flag,
                         cig=not flag & Flag.SCORE_ONLY)
    return ln


EXTZ_FORMS = [(Flag.SCORE_ONLY, -1), (Flag.SCORE_ONLY, 100), (Flag.NONE, 100),
              (Flag.RIGHT | Flag.GENERIC_SC, -1),
              (Flag.SCORE_ONLY | Flag.APPROX_MAX, -1),
              (Flag.APPROX_MAX | Flag.APPROX_DROP, 100),
              (Flag.EXTZ_ONLY, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("flag,zdrop", EXTZ_FORMS)
def test_extz_forward_and_walk_kernels_match_plain(cuda_device, flag, zdrop):
    """Kernel 12 (tiles of 128 positions) against its plain version:
    records, stops and the bytes of every row a pair computed; kernel 17
    against its plain version on the kernel's bytes, upper_force 1 and 0,
    min_intron 0 and 5."""
    ln = _extz_launch(63, flag, zdrop)
    args = BD.band_upload(ln, cuda_device)
    krec, kp, kstop = F.extz_forward_cuda(*args, ln.prm, ln.lay)
    prec, pp, pstop = F.extz_forward_plain(*args, ln.prm, ln.lay)
    assert torch.equal(krec, prec) and torch.equal(kstop, pstop)
    if not ln.prm.cig:
        return
    ends = F.row_off(kstop.cpu().numpy(), ln.qlen, ln.tlen, ln.w)
    for b, n in enumerate(ends):
        s = int(ln.lay.pbase[b])
        assert torch.equal(kp[s:s + int(n)], pp[s:s + int(n)])
    _, _, ql, tl, w = args[:5]
    starts = W.start_cells(krec, ql, tl, flag, 10)
    pbase = torch.from_numpy(ln.lay.pbase).to(cuda_device)
    wr = ln.query.shape[1] + ln.target.shape[1] + 2
    for upper_force, min_intron in ((1, 0), (0, 0), (1, 5)):
        kres, kruns = TB.extz_walk_cuda(kp, pbase, starts, ql, tl, w, wr,
                                        min_intron, upper_force)
        pres, pruns = TB.extz_walk_plain(kp, pbase, starts, ql, tl, w, wr,
                                         min_intron, upper_force)
        assert torch.equal(kres, pres)
        for b in range(len(ql)):
            n = int(kres[b, 2])
            assert torch.equal(kruns[b, :n], pruns[b, :n])


@pytest.mark.cuda
def test_extz_launch_too_large_raises_with_its_size(cuda_device):
    """A single-pair CIG launch whose buffers exceed the card (a 300 kb
    pair's store takes ~90 GB) raises with their size before launching."""
    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, 300_000).astype(np.uint8)
    t = rng.integers(0, 4, 300_000).astype(np.uint8)
    (ln,) = EZ.extz_prep([q], [t], [len(q)], [len(t)], [len(t)], 5, MAT, 4,
                         2, -1, 0, cig=True)
    assert ln.lay.device_bytes() > torch.cuda.get_device_properties(
        cuda_device).total_memory
    args = BD.band_upload(ln, cuda_device)
    n = F.LAUNCHES["extz_fwd"]
    with pytest.raises(RuntimeError, match=str(ln.lay.device_bytes())):
        F.extz_forward_cuda(*args, ln.prm, ln.lay)
    assert F.LAUNCHES["extz_fwd"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [Flag.NONE, Flag.EXTZ_ONLY,
                                  Flag.SCORE_ONLY,
                                  Flag.SCORE_ONLY | Flag.APPROX_MAX])
def test_single_pair_aligner_matches_cpu(cuda_device, flag):
    """``Aligner.extend`` and ``extend_batch`` on the single-pair engine
    and the any-device route: the card gives the CPU route's results."""
    pairs = _pairs(42)[:4]
    for aln_kw in (dict(zdrop=100, end_bonus=10, flag=flag),
                   dict(w=1500, flag=flag)):
        want = [Aligner(device="cpu", **aln_kw).extend(q, t)
                for q, t in pairs]
        got = [Aligner(**aln_kw).extend(q, t) for q, t in pairs]
        assert [(g.max, g.max_t, g.mqe, g.mte, g.score, g.zdropped,
                 g.reach_end, g.cigar) for g in got] == \
            [(x.max, x.max_t, x.mqe, x.mte, x.score, x.zdropped,
              x.reach_end, x.cigar) for x in want]


def _single_pairs(seed, spliced=False):
    """Seeded pairs of 30-1500 bp over 1-12 tiles of 128 positions (N
    bases), spliced ones with a GT..AG intron, and the edge shapes."""
    rng = np.random.default_rng(seed)
    pairs = []
    for L in (300, 1500, 30, 700):
        if spliced:
            pairs.append(spliced_pair(rng, L, with_n=True))
        else:
            t, q = random_pair(rng, L, divergence=0.2, indel=0.08,
                               with_n=True)
            pairs.append((encode_dna(q), encode_dna(t)))
    pairs += [(rng.integers(0, 5, a).astype(np.uint8),
               rng.integers(0, 5, b).astype(np.uint8)) for a, b in EDGE]
    return pairs


def _check_single(ln, args, kernel, plain, end_bonus, min_intron):
    """A single-pair form against its plain version: records, stops, the
    bytes of every row a pair computed, and kernel 17 on the kernel's
    bytes with ``min_intron``."""
    krec, kp, kstop = kernel(*args, ln.prm, ln.lay)
    prec, pp, pstop = plain(*args, ln.prm, ln.lay)
    assert torch.equal(krec, prec) and torch.equal(kstop, pstop)
    if not ln.prm.cig:
        return
    ends = F.row_off(kstop.cpu().numpy(), ln.qlen, ln.tlen, ln.w)
    for b, n in enumerate(ends):
        s = int(ln.lay.pbase[b])
        assert torch.equal(kp[s:s + int(n)], pp[s:s + int(n)])
    _, _, ql, tl, w = args[:5]
    starts = W.start_cells(krec, ql, tl, ln.prm.flag, end_bonus)
    pbase = torch.from_numpy(ln.lay.pbase).to(kp.device)
    wr = ln.query.shape[1] + ln.target.shape[1] + 2
    kres, kruns = TB.extz_walk_cuda(kp, pbase, starts, ql, tl, w, wr,
                                    min_intron)
    pres, pruns = TB.extz_walk_plain(kp, pbase, starts, ql, tl, w, wr,
                                     min_intron)
    assert torch.equal(kres, pres)
    for b in range(len(ql)):
        n = int(kres[b, 2])
        assert torch.equal(kruns[b, :n], pruns[b, :n])


APPROX = Flag.APPROX_MAX | Flag.APPROX_DROP
EXTD_FORMS = [(Flag.SCORE_ONLY, -1, 0), (Flag.NONE, 100, 1),
              (Flag.RIGHT | Flag.GENERIC_SC, -1, 0), (APPROX, 100, 1),
              (Flag.EXTZ_ONLY, 100, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("flag,zdrop,costs", EXTD_FORMS)
def test_extd_forward_kernel_matches_plain(cuda_device, flag, zdrop, costs):
    """Kernel 13 (tiles of 128 positions) against its plain version, with
    w from 0 to unbanded, default and swapped costs; kernel 17 on its
    bytes."""
    pairs = _single_pairs(64)
    ql = np.array([len(a) for a, _ in pairs], np.int32)
    tl = np.array([len(b) for _, b in pairs], np.int32)
    w = np.concatenate([[16, 2000, 0, 751], np.maximum(ql[4:], tl[4:])])
    (ln,) = ED.extd_prep([a for a, _ in pairs], [b for _, b in pairs], ql,
                         tl, w.astype(np.int32), 5,
                         GEN if flag & Flag.GENERIC_SC else MAT,
                         *TWO_PIECE[costs], zdrop, flag,
                         cig=not flag & Flag.SCORE_ONLY)
    assert ln.lay.tp == 128
    _check_single(ln, BD.band_upload(ln, cuda_device), ED.extd_forward_cuda,
                  ED.extd_forward_plain, 10, 0)


SPL = Flag.SPLICE_FOR
EXTS_FORMS = [(SPL | Flag.SCORE_ONLY, 200, False), (SPL, 200, True),
              (Flag.SPLICE_REV | Flag.SPLICE_FLANK, -1, False),
              (SPL | Flag.EXTZ_ONLY | Flag.RIGHT | Flag.REV_CIGAR, 200,
               True),
              (SPL | APPROX, 100, True),
              (SPL | Flag.GENERIC_SC | Flag.RIGHT, 200, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("flag,zdrop,junc", EXTS_FORMS)
def test_exts_forward_kernel_matches_plain(cuda_device, flag, zdrop, junc):
    """Kernel 14 (tiles of 128 positions) against its plain version on
    spliced pairs, with junction tracks (junc_bonus 9); kernel 17 on its
    bytes with min_intron = long_thres."""
    pairs = _single_pairs(65, spliced=True)
    tracks = None
    if junc:
        tracks = []
        for _, t in pairs:
            j = np.zeros(len(t), np.uint8)
            j[len(t) // 3], j[2 * len(t) // 3] = 1, 2
            tracks.append(j)
    ql = np.array([len(a) for a, _ in pairs], np.int32)
    tl = np.array([len(b) for _, b in pairs], np.int32)
    (ln,) = ES.exts_prep([a for a, _ in pairs], [b for _, b in pairs], ql,
                         tl, 5, GEN if flag & Flag.GENERIC_SC else
                         simple_mat(5, 1, -2), 2, 1, 32, 9, zdrop, flag,
                         tracks, 9 if junc else 0,
                         cig=not flag & Flag.SCORE_ONLY)
    assert ln.lay.tp == 128
    _check_single(ln, BD.band_upload(ln, cuda_device), ES.exts_forward_cuda,
                  ES.exts_forward_plain, 0, ln.prm.lt)


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [Flag.NONE, Flag.EXTZ_ONLY, Flag.EQX,
                                  Flag.SCORE_ONLY | Flag.EXTZ_ONLY])
def test_two_piece_and_splice_aligner_matches_cpu(cuda_device, flag):
    """``Aligner.extend`` and ``extend_batch`` on the single-pair two-piece
    and splice engines: the card gives the CPU route's results."""
    pairs = _single_pairs(66)[:4]
    spliced = _single_pairs(67, spliced=True)[:4]
    juncs = [None, None, None, None]
    rng = np.random.default_rng(8)
    juncs[1] = rng.integers(0, 3, len(spliced[1][1])).astype(np.uint8)
    for kw, ps, js in ((dict(q2=13, e2=1, zdrop=100, end_bonus=10), pairs,
                        None),
                       (dict(a=1, b=2, q=2, e=1, q2=32, splice=True,
                             noncan=9, junc_bonus=9, zdrop=200), spliced,
                        juncs)):
        f = flag | (SPL if kw.get("splice") else Flag.NONE)
        cpu = Aligner(device="cpu", flag=f, **kw)
        card = Aligner(flag=f, **kw)
        want = [cpu.extend(q, t, None if js is None else js[k])
                for k, (q, t) in enumerate(ps)]
        got = [card.extend(q, t, None if js is None else js[k])
               for k, (q, t) in enumerate(ps)]
        got_b = card.extend_batch(ps, juncs=js)

        def key(ez):
            return (ez.max, ez.max_t, ez.mqe, ez.mte, ez.score, ez.zdropped,
                    ez.reach_end, ez.cigar)
        assert [key(g) for g in got] == [key(x) for x in want]
        assert [key(g) for g in got_b] == [key(x) for x in want]


# --------------------------------------------------------------------------
# kernels 7, 8, 15 and 16 and the flat walk (band_walk.cu's gg2 form)

def _lg_pairs(seed, n=10, lo=30, hi=1500, overrun=False):
    """Seeded pairs of lo-hi bp with bands; ``overrun`` adds pairs with
    qlen > tlen + w (kernel 16's H0-walk quirk)."""
    rng = np.random.default_rng(seed)
    pairs, ws = [], []
    for k in range(n):
        t, q = random_pair(rng, int(rng.integers(lo, hi + 1)),
                           divergence=0.2, indel=0.08, with_n=k % 2 == 0)
        q, t = encode_dna(q), encode_dna(t)
        w = int(rng.choice([-1, 0, 1, 16, 100]))
        if overrun and k % 3 == 0:
            q = np.concatenate([q, q[:len(q) // 2 + 40]])
            w = int(rng.choice([0, 1, 8, 16]))
        pairs.append((q, t))
        ws.append(w if w >= 0 else max(len(q), len(t)))
    return pairs, ws


@pytest.mark.cuda
@pytest.mark.parametrize("xdrop", [-1, 40])
def test_extf_kernels_match_plain(cuda_device, xdrop):
    """Kernels 7 (one warp a pair) and 15 (one block a pair) give the
    plain version's records exactly."""
    from ksw2_tpu_torch.ops import batch_extf as BF
    from ksw2_tpu_torch.ops import extf as XF
    pairs, ws = _lg_pairs(71 + xdrop)
    args = BF.pack_pairs(pairs, ws, cuda_device)
    want = BF.extf_forward_plain(*args, 2, -4, 2, xdrop)
    k7 = BF.batch_extf_forward_cuda(*args, 2, -4, 2, xdrop)
    k15 = XF.extf_single_forward_cuda(*args, 2, -4, 2, xdrop)
    torch.cuda.synchronize()
    assert torch.equal(k7, want)
    assert torch.equal(k15, want)


@pytest.mark.cuda
def test_gg2_kernels_match_plain(cuda_device):
    """Kernel 16 against the plain version with the block overrun, kernel
    8 against it without, on pairs with qlen <= tlen + w: scores and
    every byte of the flat store; the flat walk against its plain
    version on the kernels' bytes."""
    from ksw2_tpu_torch.ops import batch_gg2 as BG
    from ksw2_tpu_torch.ops import gg2 as G1
    from ksw2_tpu_torch.ops.batch_extf import pack_pairs
    table = torch.from_numpy(MAT.astype(np.int32)).to(cuda_device)
    pairs, ws = _lg_pairs(81, overrun=True)
    for single in (True, False):
        sel = [k for k, (q, t) in enumerate(pairs)
               if single or len(q) <= len(t) + ws[k]]
        sub = [pairs[k] for k in sel]
        wv = [ws[k] for k in sel]
        args = pack_pairs(sub, wv, cuda_device)
        pb_np, total = BG.flat_layout([len(q) for q, _ in sub],
                                      [len(t) for _, t in sub], wv)
        pb = torch.from_numpy(pb_np).to(cuda_device)
        ws_, wp = BG.gg2_forward_plain(*args, table, 5, 4, 2, pb, total,
                                       single)
        fwd = (G1.gg2_single_forward_cuda if single
               else BG.batch_gg2_forward_cuda)
        ks, kp = fwd(*args, table, 5, 4, 2, pb, total)
        torch.cuda.synchronize()
        assert torch.equal(ks, ws_)
        assert torch.equal(kp, wp)
        _, _, ql, tl, w = args
        kres, kruns = BW.flat_walk_cuda(kp, pb, ql, tl, w)
        pres, pruns = BW.flat_walk_plain(wp, pb, ql, tl, w)
        torch.cuda.synchronize()
        assert torch.equal(kres, pres)
        assert BW.flat_walk_cigars(kres, kruns) == \
            BW.flat_walk_cigars(pres, pruns)


@pytest.mark.cuda
def test_global_align_and_linear_gap_on_card_match_cpu(cuda_device):
    """``Aligner.global_align`` and ``extf2_device`` on the card give the
    CPU route's results."""
    from ksw2_tpu_torch.ops.extf import extf2_device
    pairs, _ = _lg_pairs(91, n=4, hi=600)
    cpu, card = Aligner(device="cpu", w=50), Aligner(w=50)
    for q, t in pairs:
        a, b = card.global_align(q, t), cpu.global_align(q, t)
        assert (a.score, a.cigar, a.max_t, a.mqe) == \
            (b.score, b.cigar, b.max_t, b.mqe)
        x = extf2_device(q, t, 2, 4, 2, xdrop=30)
        y = extf2_device(q, t, 2, 4, 2, xdrop=30, device="cpu")
        assert x.tsv_fields() == y.tsv_fields()
