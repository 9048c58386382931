"""The port's JAX-free core and package boundary against ksw2_tpu.core.

The port keeps its own copies of the core modules (importing anything
under ksw2_tpu configures JAX); these tests hold the copies to the
originals and check that the port never imports JAX or the JAX package.
"""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu.core import cigar as jcigar
from ksw2_tpu.core import flags as jflags
from ksw2_tpu.core import matrix as jmatrix
from ksw2_tpu.core.result import ExtzResult as JExtzResult

import chip_smoke
from ksw2_tpu_torch import Aligner
from ksw2_tpu_torch.core import cigar, flags, matrix
from ksw2_tpu_torch.core.result import ExtzResult
from ksw2_tpu_torch.ops import strips, strips_walker

# one intra-op thread a process: tier-1 runs several pytest workers on
# the CPU's cores, where per-process thread pools oversubscribe them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flag_and_op_codes_match():
    assert flags.NEG_INF == jflags.NEG_INF
    assert flags.CIGAR_CHARS == jflags.CIGAR_CHARS
    assert {f.name: int(f) for f in flags.Flag} == \
        {f.name: int(f) for f in jflags.Flag}
    assert {o.name: int(o) for o in flags.CigarOp} == \
        {o.name: int(o) for o in jflags.CigarOp}


@pytest.mark.parametrize("seed", range(4))
def test_cigar_codec_matches(seed):
    rng = np.random.default_rng(seed)
    ops = rng.choice([0, 1, 2, 3], 30)
    lens = rng.integers(1, 9, 30)
    a, b = [], []
    for op, n in zip(ops, lens):
        cigar.push(a, int(op), int(n))
        jcigar.push(b, int(op), int(n))
    assert a == b
    s = cigar.to_string(a)
    assert s == jcigar.to_string(b)
    assert cigar.from_string(s) == jcigar.from_string(s)
    assert cigar.consumed(a) == jcigar.consumed(b)
    t_len, q_len = cigar.consumed(a)
    t = rng.integers(0, 4, t_len)
    q = rng.integers(0, 4, q_len)
    assert cigar.to_eqx(a, q, t) == jcigar.to_eqx(b, q, t)
    mat = jmatrix.simple_mat(5, 2, -4)
    assert cigar.score_of(a, q, t, mat, 5, 4, 2) == \
        jcigar.score_of(b, q, t, mat, 5, 4, 2)


def test_result_reset_and_matrix_match():
    ez, jz = ExtzResult(max=9, cigar=[5]), JExtzResult(max=9, cigar=[5])
    ez.reset()
    jz.reset()
    assert dataclasses.asdict(ez) == dataclasses.asdict(jz)
    assert ez.tsv_fields() == jz.tsv_fields()
    assert np.array_equal(matrix.simple_mat(5, 2, -4),
                          jmatrix.simple_mat(5, 2, -4))
    assert np.array_equal(matrix.encode_dna("ACGTNacgtx"),
                          jmatrix.encode_dna("ACGTNacgtx"))


def test_import_leaves_jax_out():
    code = ("import sys, ksw2_tpu_torch, ksw2_tpu_torch.convert\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ksw2_tpu.')) or m == 'ksw2_tpu']\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_package_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|ksw2_tpu)(\.|\s|$)")
    pkg = os.path.join(REPO, "ksw2_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    for n, line in enumerate(f, 1):
                        assert not pat.match(line), (name, n, line)


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Aligner(device="cuda")
    with pytest.raises(ValueError):
        Aligner(device="meta")


def test_cuda_index_past_visible_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    Aligner(device="cuda:0")
    with pytest.raises(ValueError, match="visible"):
        Aligner(device="cuda:1")


def test_cuda_wrappers_refuse_cpu_tensors():
    prm = strips.make_params(5, matrix.simple_mat(5, 2, -4), 4, 2, -1,
                             flags.Flag.SCORE_ONLY, 32)
    qs = torch.zeros((1, 32), dtype=torch.uint8)
    ts = torch.zeros((1, 32), dtype=torch.uint8)
    ln = torch.ones(1, dtype=torch.int32)
    tab = torch.from_numpy(strips.score_table(prm))
    with pytest.raises(ValueError, match="CUDA"):
        strips.strips_forward_cuda(qs, ts, ln, ln, tab, prm)
    with pytest.raises(ValueError, match="CUDA"):
        strips_walker.strips_walk_cuda(
            torch.zeros((1, 32, 32), dtype=torch.uint8),
            torch.zeros((1, 2), dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 777])
def test_smoke_generator_matches_refcmp(seed):
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for L in (1, 40, 300):
        for kw in ({}, {"divergence": 0.3, "indel": 0.2, "with_n": True}):
            assert chip_smoke.random_pair(a, L, **kw) == \
                refcmp.random_pair(b, L, **kw)
