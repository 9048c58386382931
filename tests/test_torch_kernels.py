"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here carries the ``cuda`` marker and skips when
``torch.cuda.is_available()`` is false.  The file imports neither JAX nor
the JAX package, so it runs on the machine with the card:

    python -m pytest tests/test_torch_kernels.py -q
"""
import numpy as np
import pytest
import torch

from chip_smoke import random_pair
from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.core.flags import Flag
from ksw2_tpu_torch.core.matrix import encode_dna, simple_mat
from ksw2_tpu_torch.ops import rows as R
from ksw2_tpu_torch.ops import strips as S
from ksw2_tpu_torch.ops import strips_walker as W

MAT = simple_mat(5, 2, -4)
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


@pytest.mark.cuda
def test_aligner_on_every_card_matches_cpu(cuda_device):
    # the current device stays 0: each launch must move to its tensors' card
    pairs = _pairs(41)
    want = Aligner(zdrop=100, device="cpu").extend_batch(pairs)
    for k in range(torch.cuda.device_count()):
        got = Aligner(zdrop=100, device=f"cuda:{k}").extend_batch(pairs)
        assert [(g.max, g.mqe, g.mte, g.score, g.cigar) for g in got] == \
            [(w.max, w.mqe, w.mte, w.score, w.cigar) for w in want], k
