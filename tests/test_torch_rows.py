"""The port's rows route (short pairs, q and t <= 128) against the JAX
package.

``rows_eligible`` is held against ``wavefront_rows.rows_eligible`` on
random envelopes; the records of the port's rows route against the JAX
``extz_rows_records`` run under the Pallas interpreter, exactly; the
scheduler is shown to route an all-short bucket to the rows kernel and a
mixed one to strips; and the short-pair pin of ``chip_smoke.py`` is
recomputed from the byte-parity spec ``spec.diagdiff.extz2``.  The CUDA
kernel's own test, which needs a card, is in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops import wavefront_rows as jrows
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.batch import scheduler as sched
from ksw2_tpu_torch.ops import rows as R
from ksw2_tpu_torch.ops import strips as S

MAT = simple_mat(5, 2, -4)
GEN = np.array([[3, -5, -2, -6, -1],
                [-5, 2, -6, -3, -1],
                [-2, -6, 4, -5, -1],
                [-6, -3, -5, 2, -1],
                [-1, -1, -1, -1, -1]], np.int8).reshape(-1)


def _short(seed, n, lo=1, hi=129):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t, q = refcmp.random_pair(
            rng, int(rng.integers(lo, hi)),
            divergence=float(rng.uniform(0, 0.4)),
            indel=float(rng.uniform(0, 0.25)), with_n=bool(rng.integers(2)))
        out.append((encode_dna(q[:128]), encode_dna(t)))
    return out


def _lens(pairs):
    return (np.array([len(q) for q, _ in pairs], np.int32),
            np.array([len(t) for _, t in pairs], np.int32))


def _launch(pairs, mat, flag, zdrop, q=4, e=2):
    ql, tl = _lens(pairs)
    (ln,) = S.strips_prep([x for x, _ in pairs], [t for _, t in pairs], ql,
                          tl, 5, mat, q, e, zdrop, flag)
    return ln


def test_rows_eligible_matches_jax():
    rng = np.random.default_rng(3)
    checked = 0
    for _ in range(400):
        B = int(rng.integers(1, 5))
        ql = rng.integers(0, 160, B)
        tl = rng.integers(0, 160, B)
        w = np.where(rng.random(B) < 0.4, rng.integers(0, 140, B),
                     np.maximum(ql, tl))
        flag = int(rng.choice([Flag.SCORE_ONLY, Flag.NONE, Flag.RIGHT,
                               Flag.SCORE_ONLY | Flag.APPROX_MAX,
                               Flag.SCORE_ONLY | Flag.RIGHT]))
        want = jrows.rows_eligible(ql, tl, w, flag, 100, 5, MAT)
        assert R.rows_eligible(ql, tl, w, flag, 100, 5, MAT) == want
        checked += want
    assert checked > 30
    assert not R.rows_eligible([], [], [], Flag.SCORE_ONLY, -1, 5, MAT)


def _jax_rows(pairs, mat, q, e, zdrop, flag):
    ql, tl = _lens(pairs)
    B = len(pairs)
    Q = np.zeros((B, ql.max()), np.int32)
    T = np.zeros((B, tl.max()), np.int32)
    for i, (x, t) in enumerate(pairs):
        Q[i, :len(x)], T[i, :len(t)] = x, t
    assert jrows.rows_eligible(ql, tl, np.maximum(ql, tl), flag, zdrop, 5,
                               mat)
    return np.concatenate([np.asarray(p) for p in jrows.extz_rows_records(
        Q, T, ql, tl, 5, mat, q, e, zdrop=zdrop, flag=flag,
        interpret=True)])


@pytest.mark.parametrize("zdrop", [-1, 10, 100])
def test_rows_records_match_jax_rows(zdrop):
    pairs = _short(40 + zdrop, 12)
    ln = _launch(pairs, MAT, Flag.SCORE_ONLY, zdrop)
    assert ln.prm.tv <= R.LQ_MAX and ln.query.shape[1] <= R.LQ_MAX
    got = R.rows_records(ln, "cpu").numpy()
    want = _jax_rows(pairs, MAT, 4, 2, zdrop, Flag.SCORE_ONLY)
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("q,e", [(4, 2), (6, 1)])
def test_rows_records_match_jax_rows_generic(q, e):
    pairs = _short(50 + q, 10) + [(encode_dna("A"), encode_dna("C")),
                                  (encode_dna("ACGT" * 32),
                                   encode_dna("ACGA" * 32))]
    flag = Flag.SCORE_ONLY | Flag.GENERIC_SC
    ln = _launch(pairs, GEN, flag, 30, q, e)
    got = R.rows_records(ln, "cpu").numpy()
    assert np.array_equal(got, _jax_rows(pairs, GEN, q, e, 30, flag))


def test_rows_forward_refuses_what_the_kernel_does_not_take():
    ln = _launch(_short(2, 3), MAT, Flag.SCORE_ONLY, 100)
    args = S.upload(ln, "cpu")
    with pytest.raises(ValueError, match="one-piece"):
        R.rows_forward(*args, ln.prm._replace(two=1))
    long = _launch([(encode_dna("A" * 200), encode_dna("A" * 100))], MAT,
                   Flag.SCORE_ONLY, 100)
    with pytest.raises(ValueError, match="Lq, tv <= 128"):
        R.rows_forward(*S.upload(long, "cpu"), long.prm)
    with pytest.raises(ValueError, match="device"):
        R.rows_forward(*(t.to("meta") for t in args), ln.prm)
    a = R.rows_forward(*args, ln.prm)
    b = S.strips_forward_plain(*args, ln.prm)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))


def test_scheduler_routes_short_buckets_to_rows(monkeypatch):
    calls = []
    for name in ("rows_records", "strips_records"):
        fn = getattr(sched, name)
        monkeypatch.setattr(
            sched, name,
            lambda ln, dev, fn=fn, name=name: calls.append(name)
            or fn(ln, dev))
    short = _short(60, 8, lo=10, hi=120)
    aln = Aligner(zdrop=100, flag=Flag.SCORE_ONLY, device="cpu")
    got = aln.extend_batch(short)
    assert calls == ["rows_records"]
    # one long query in the same (Lq, Lt) bucket: the bucket runs strips
    calls.clear()
    mixed = short + [(encode_dna("ACGT" * 60), encode_dna("ACGA" * 25))]
    got2 = aln.extend_batch(mixed)
    assert calls == ["strips_records"]
    assert [(g.max, g.score) for g in got2[:-1]] == \
        [(g.max, g.score) for g in got]
    # clipping bands are not rows-eligible: strips refuses them too
    with pytest.raises(NotImplementedError, match="ROADMAP items 10, 11"):
        aln.extend_batch(short, w=[2] * len(short))


def test_short_pair_pin_matches_spec():
    """The pinned sum of max of chip_smoke's short-pair workload (seed
    778, A2 B4 O4 E2 -s -z100) equals the byte-parity spec's, and the
    port's rows route on the CPU gives it too."""
    jobs = chip_smoke.short_jobs()
    assert len(jobs) > 400
    assert max(len(q) for q, _ in jobs) <= 128
    assert max(len(t) for _, t in jobs) <= 120
    total = 0
    for q, t in jobs:
        ez, _ = diagdiff.extz2(q, t, 5, MAT, 4, 2, w=-1, zdrop=100,
                               flag=Flag.SCORE_ONLY)
        total += ez.max
    assert total == chip_smoke.SHORT_ROWS_SCORE
    ezs = Aligner(zdrop=100, flag=Flag.SCORE_ONLY,
                  device="cpu").extend_batch(jobs)
    assert sum(ez.max for ez in ezs) == chip_smoke.SHORT_ROWS_SCORE
