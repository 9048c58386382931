"""The linear-gap extension engines (kernels 7 and 15) against the JAX
package and the spec.

``ops.batch_extf.extf_forward_plain``, the plain version of both
kernels, is held against the JAX batched engine
``batch_pallas.extf_batch_device(..., interpret=True)`` (as
``tests/test_batch_pallas.py:422`` runs it) through the port's
``extf_batch_device``, and the port's ``extf2_device`` (kernel 15's
route) against the JAX ``extf2_device(..., interpret=True)`` (as
``tests/test_kernel_interpret.py:50`` runs it), on seeded pairs of
10-127 bp; the plain version against the spec's ``extf2`` on seeded
pairs of up to 300 bp over bands, X-drops and N; and
``convert``'s carry-overs against the JAX parameter tuples.  Every
comparison is exact.
"""
import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core.matrix import encode_dna
from ksw2_tpu.ops import wavefront_batch_extf as wbf
from ksw2_tpu.ops import wavefront_extf as wff
from ksw2_tpu.ops.batch_pallas import extf_batch_device as j_extf_batch
from ksw2_tpu.ops.extf import extf2_device as j_extf2_device
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import convert
from ksw2_tpu_torch.ops import batch_extf as BF
from ksw2_tpu_torch.ops import extf as XF

torch.set_num_threads(1)


def _batch(seed, B, lo=8, hi=128):
    """``test_batch_pallas._make_batch``'s draws: B pairs, targets of
    lo..hi-1 bp, padded to (B, Lq) / (B, 128)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(B):
        tlen = int(rng.integers(lo, hi))
        t, q = refcmp.random_pair(
            rng, tlen, divergence=float(rng.uniform(0, 0.4)),
            indel=float(rng.uniform(0, 0.2)),
            with_n=bool(rng.integers(0, 2)))
        pairs.append((encode_dna(q), encode_dna(t)))
    Lq = max(len(q) for q, _ in pairs)
    Q = np.zeros((B, Lq), np.int32)
    T = np.zeros((B, 128), np.int32)
    for i, (q, t) in enumerate(pairs):
        Q[i, :len(q)] = q
        T[i, :len(t)] = t
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    return pairs, Q, T, ql, tl


@pytest.mark.parametrize("xdrop,banded", [(-1, False), (40, False),
                                          (25, True)])
def test_batched_plain_matches_jax_batched_engine(xdrop, banded):
    """Kernel 7's plain version gives the JAX batched engine's fields."""
    pairs, Q, T, ql, tl = _batch(301 + xdrop, 6)
    rng = np.random.default_rng(7 + xdrop)
    wv = rng.integers(8, 60, 6).astype(np.int32) if banded else None
    want = j_extf_batch(Q, T, ql, tl, 2, -4, 2, w=wv, xdrop=xdrop,
                        interpret=True)
    got = BF.extf_batch_device(Q, T, ql, tl, 2, -4, 2, w=wv, xdrop=xdrop,
                               device="cpu")
    for k in ("max", "max_t", "max_q", "score", "zdropped"):
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


_rngi = np.random.default_rng(55)
INTERP = []
for _i in range(6):
    _t, _q = refcmp.random_pair(_rngi, int(_rngi.integers(10, 90)),
                                divergence=0.3, indel=0.1,
                                with_n=bool(_i % 2))
    INTERP.append((_t, _q, int(_rngi.choice([-1, 8, 24])),
                   int(_rngi.choice([-1, 30]))))


@pytest.mark.parametrize("idx", range(len(INTERP)))
def test_single_pair_matches_jax_engine(idx):
    """The port's ``extf2_device`` (kernel 15's route, its plain version
    here) gives the JAX single-pair engine's record."""
    t, q, w, xd = INTERP[idx]
    qs, ts = encode_dna(q), encode_dna(t)
    want = j_extf2_device(qs, ts, 2, -4, 2, w=w, xdrop=xd, interpret=True)
    got = XF.extf2_device(qs, ts, 2, -4, 2, w=w, xdrop=xd, device="cpu")
    assert got.tsv_fields() == want.tsv_fields()
    assert got.zdropped == want.zdropped


def _spec_cases(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        t, q = refcmp.random_pair(rng, int(rng.integers(5, 301)),
                                  divergence=0.3, indel=0.1,
                                  with_n=k % 2 == 0)
        out.append((encode_dna(q), encode_dna(t),
                    int(rng.choice([-1, 0, 1, 5, 16, 40]))))
    return out


@pytest.mark.parametrize("xdrop", [-1, 5, 20, 60])
@pytest.mark.parametrize("mis", [-4, 4])
def test_plain_matches_spec(xdrop, mis):
    """The plain version (one launch of every pair) gives the spec's
    extf2 for bands 0-40 and unbanded, N in the sequences, ``mis`` of
    either sign (canonicalised to <= 0)."""
    cases = _spec_cases(400 + xdrop, 16)
    got = XF.extf_pairs([(q, t) for q, t, _ in cases], 2, mis, 2,
                        [w for _, _, w in cases], xdrop, device="cpu")
    for (q, t, w), ez in zip(cases, got):
        want = diagdiff.extf2(q, t, 2, mis, 2, w=w, xdrop=xdrop)
        assert (ez.max, ez.max_t, ez.max_q, ez.score, ez.zdropped) == \
            (want.max, want.max_t, want.max_q, want.score, want.zdropped)


def test_empty_sequences_reset():
    """An empty query or target gives the reset ez, as
    ``extf2_device`` returns it."""
    q = encode_dna("ACGT")
    for qs, ts in ((q[:0], q), (q, q[:0])):
        ez = XF.extf2_device(qs, ts, 2, 4, 2, device="cpu")
        assert ez.tsv_fields() == ["-1073741824", "0", "-1", "-1"]
    ezs = XF.extf_pairs([(q[:0], q), (q, q)], 2, 4, 2, [-1, -1],
                        device="cpu")
    assert ezs[0].tsv_fields() == ["-1073741824", "0", "-1", "-1"]
    assert ezs[1].score == 8


def test_routes_refuse_what_they_do_not_take():
    """The batched route takes targets of up to 1536; a CUDA device
    without a card raises rather than running elsewhere."""
    with pytest.raises(ValueError, match="1536"):
        BF.extf_batch_device(np.zeros((1, 4)), np.zeros((1, 1537)), [4],
                             [1537], 2, 4, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA"):
            BF.batch_extf_forward_cuda(*BF.pack_pairs(
                [(np.zeros(3, np.uint8), np.zeros(3, np.uint8))], [3],
                "cpu"), 2, -4, 2, -1)


def test_convert_carries_extf_params():
    """``convert.launch_values_from_jax`` keeps every non-layout field of the
    JAX tuples."""
    jp = wff.ExtfParams(qlen=70, tlen=64, mch=2, mis=-4, e=2, w=70,
                        xdrop=30, chunk=512, n_diag=133, n_rows=8)
    assert convert.launch_values_from_jax(jp._asdict()) == dict(
        qlen=70, tlen=64, mch=2, mis=-4, e=2, w=70, xdrop=30)
    jb = wbf.BatchExtfParams(n_rows=16, n_diag=256, mch=2, mis=-4, e=2,
                             xdrop=-1, chunk=128, p=2)
    assert convert.launch_values_from_jax(jb._asdict()) == dict(
        mch=2, mis=-4, e=2, xdrop=-1)
