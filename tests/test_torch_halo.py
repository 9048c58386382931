"""The port's halo wavefront (ksw2_tpu_torch/parallel/halo.py): one pair's
target axis split over a mesh.

On the CPU the rounds run the plain twin (``halo_round_plain``) on a mesh
of ``["cpu"] * 8`` (and 1-5 shards on the fuzzed pairs), held to the JAX
package's ``halo_extz_score`` on its 8-device CPU mesh and to
``spec/diagdiff.py:extz2``, all 9 fields, on tests/test_halo.py's shapes
(K not dividing the diagonals, a target far shorter than the mesh's
positions, a band across shard edges) and at w = 0.  The ``cuda`` test
holds the kernel (``csrc/halo_fwd.cu``) to its twin on a card; the file
imports the JAX package inside the tests that use it, so that test runs
where there is no JAX:

    python -m pytest tests/test_torch_halo.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from ksw2_tpu_torch.core.flags import Flag
from ksw2_tpu_torch.core.matrix import encode_dna, simple_mat
from ksw2_tpu_torch.parallel import halo as HL
from ksw2_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)
FIELDS = ("score", "max", "max_t", "max_q", "mqe", "mqe_t", "mte", "mte_q",
          "zdropped")


def fields(ez):
    return tuple(int(getattr(ez, f)) for f in FIELDS)


def random_seqs(ql, tl):
    """tests/test_halo.py's unrelated ACGTN sequences."""
    rng = np.random.default_rng(ql + tl)
    q = "".join(rng.choice(list("ACGTN"), ql, p=[.24, .24, .24, .24, .04]))
    t = "".join(rng.choice(list("ACGTN"), tl, p=[.24, .24, .24, .24, .04]))
    return encode_dna(q), encode_dna(t)


@pytest.mark.parametrize("ql,tl,w,K", [
    (700, 740, -1, 256),     # unbanded, blocks divide unevenly
    (900, 30, 40, 64),       # target much shorter than the mesh's lanes
    (257, 1300, 75, 128),    # band reaches across shard boundaries
    (300, 320, 0, 64),       # w = 0: one diagonal (rlim = 1)
])
def test_halo_matches_jax_and_spec(ql, tl, w, K):
    from ksw2_tpu.core.flags import Flag as JFlag
    from ksw2_tpu.parallel.halo import halo_extz_score as jhalo
    from ksw2_tpu.parallel.mesh import make_mesh as jmake_mesh
    from ksw2_tpu.spec import diagdiff

    qs, ts = random_seqs(ql, tl)
    ez = HL.halo_extz_score(make_mesh(devices=["cpu"] * 8), qs, ts, 5, MAT,
                            4, 2, w=w, block_diagonals=K)
    jx = jhalo(jmake_mesh(8), qs, ts, 5, MAT, 4, 2, w=w, block_diagonals=K)
    want, _ = diagdiff.extz2(qs, ts, 5, MAT, 4, 2, w=w,
                             flag=JFlag.SCORE_ONLY)
    assert fields(ez) == fields(want)
    assert fields(jx) == fields(want)


def test_halo_fuzz_matches_spec():
    """Mutated pairs (real maxima, ties and query-end captures) on 1-5
    shards, bands -1 to 100, K 8-256, varied costs == diagdiff.extz2."""
    import refcmp
    from ksw2_tpu.spec import diagdiff

    rng = np.random.default_rng(5)
    for it in range(24):
        t, q = refcmp.random_pair(rng, int(rng.integers(20, 500)),
                                  divergence=float(rng.choice([.05, .2, .4])),
                                  indel=0.08, with_n=True)
        qs, ts = encode_dna(q), encode_dna(t)
        w = int(rng.choice([-1, 0, 1, 5, 16, 40, 100]))
        D = int(rng.choice([1, 2, 3, 5]))
        K = int(rng.choice([8, 32, 64, 256]))
        mat = simple_mat(5, int(rng.integers(1, 4)), int(rng.integers(1, 6)))
        qq, ee = int(rng.integers(1, 8)), int(rng.integers(1, 3))
        ez = HL.halo_extz_score(make_mesh(devices=["cpu"] * D), qs, ts, 5,
                                mat, qq, ee, w=w, block_diagonals=K)
        want, _ = diagdiff.extz2(qs, ts, 5, mat, qq, ee, w=w,
                                 flag=Flag.SCORE_ONLY)
        assert fields(ez) == fields(want), (it, len(qs), len(ts), w, D, K)


def test_halo_rejects_unsupported_modes_and_guards():
    mesh = make_mesh(devices=["cpu"] * 8)
    qs = encode_dna("ACGTACGT")
    for flag in (Flag.SCORE_ONLY | Flag.APPROX_MAX,
                 Flag.SCORE_ONLY | Flag.GENERIC_SC, Flag.NONE):
        with pytest.raises(ValueError):
            HL.halo_extz_score(mesh, qs, qs, 5, MAT, 4, 2, flag=flag)
    reset = HL.ExtzResult()
    reset.reset()
    # the reference guard (-min_sc > 2 (q + e)) and empty sequences
    assert fields(HL.halo_extz_score(mesh, qs, qs, 5, simple_mat(5, 2, 20),
                                     4, 2)) == fields(reset)
    assert fields(HL.halo_extz_score(mesh, qs[:0], qs, 5, MAT, 4, 2)) == \
        fields(reset)


def test_halo_packages_and_padding_shards():
    """Shards past the target change nothing, and each shard's package
    holds its last position's x, v, H after diagonal r - 1 at row r: the
    next shard's lane 0 input."""
    qs, ts = random_seqs(120, 200)
    prm = HL.halo_params(qs, ts, 5, MAT, 4, 2, -1)
    run3 = HL.halo_pipeline(make_mesh(devices=["cpu"] * 3), qs, ts, prm, 16)
    run8 = HL.halo_pipeline(make_mesh(devices=["cpu"] * 8), qs, ts, prm, 16)
    s3 = np.concatenate(run3.states, axis=1)
    s8 = np.concatenate(run8.states, axis=1)
    assert np.array_equal(s3, s8[:, :s3.shape[1]])
    init = HL.init_state(128, "cpu").numpy()
    for s in run8.states[2:]:            # positions 256 on: past tlen
        assert np.array_equal(s, init)
    rlim = HL.rows_limit(prm.qlen, prm.tlen, prm.w)
    pk = run3.packages[0].reshape(-1, 3)[:rlim]
    assert (pk[1:] != pk[:1]).any()      # the edge saw the band


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ql,tl,w,K,D", [(700, 740, -1, 256, 4),
                                         (257, 1300, 75, 128, 3),
                                         (900, 30, 40, 64, 8),
                                         (2000, 2100, -1, 256, 1)])
def test_halo_round_kernel_matches_plain(cuda_device, ql, tl, w, K, D):
    """Kernel and plain twin on the same card tensors: every state plane
    and every package, exactly."""
    rng = np.random.default_rng(ql)
    qs = rng.integers(0, 5, ql).astype(np.uint8)
    ts = np.where(rng.random(tl) < 0.1, rng.integers(0, 5, tl),
                  np.resize(qs, tl)).astype(np.uint8)
    mesh = make_mesh(devices=[cuda_device] * D)
    prm = HL.halo_params(qs, ts, 5, MAT, 4, 2, w)
    got = HL.halo_pipeline(mesh, qs, ts, prm, K, HL.halo_round)
    want = HL.halo_pipeline(mesh, qs, ts, prm, K, HL.halo_round_plain)
    for a, b in zip(got.states + got.packages, want.states + want.packages):
        assert np.array_equal(a, b)
