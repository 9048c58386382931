"""The port's ksw2-test CLI (``python -m ksw2_tpu_torch.cli``) on the CPU.

Every golden ``gg2_sse``, ``extf2_sse``, ``gg``, ``gg2``, ``extz`` and
``extd`` case of ``tests/golden/cases.jsonl`` (the reference binary's
rows), and a few of ``extz2_sse``, ``extd2_sse`` and ``exts2_sse``, whose
engines other files hold to the whole corpus, run through
``cli.main(..., "--device", "cpu")`` in-process and print the golden
``expect`` (``fields_only`` as ``tests/test_spec_parity.py:29`` applies
it); ``--backend batch`` prints ``--backend pair``'s TSV and the JAX
CLI's ``--backend spec`` TSV on a seeded FASTA file, as
``tests/test_cli.py:104`` holds the JAX CLI; ``--stats`` prints its
report and a missing card raises.  Every comparison is exact.
"""
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import refcmp
from ksw2_tpu import cli as jcli

from ksw2_tpu_torch import cli

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cases.jsonl")
ALL = ("gg2_sse", "extf2_sse", "gg", "gg2", "extz", "extd")
SOME = {"extz2_sse": 6, "extd2_sse": 6, "exts2_sse": 6}


def _golden():
    out, seen = [], {}
    with open(GOLDEN) as f:
        for line in f:
            c = json.loads(line)
            k = seen.get(c["algo"], 0)
            if c["algo"] in ALL or k < SOME.get(c["algo"], 0):
                out.append(c)
            seen[c["algo"]] = k + 1
    return out


CASES = _golden()


def run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.getvalue()


def run_jax(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(argv) == 0
    return buf.getvalue()


def _argv(case):
    p = case["params"]
    argv = ["-t", case["algo"], "-A", str(p["a"]), "-B", str(p["b"]),
            "-O", f"{p['q']},{p['q2']}", "-E", f"{p['e']},{p['e2']}",
            "-w", str(p["w"]), "-z", str(p["z"])]
    argv += ["-r"] * p["right"] + ["-s"] * p["score_only"]
    argv += ["-g"] * p["approx"]
    return argv + ["--device", "cpu", case["target"], case["query"]]


@pytest.mark.parametrize("idx", range(len(CASES)),
                         ids=lambda i: f"{CASES[i]['algo']}-{i}")
def test_golden_case(idx):
    """The CLI prints the reference binary's fields for the case."""
    case = CASES[idx]
    out = run(_argv(case)).rstrip("\n").split("\t")
    assert out[:2] == ["first", "second"]
    got = out[2:4 + 2] if case.get("fields_only") else out[2:]
    assert got == case["expect"], (case["algo"], case["params"])


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """A seeded FASTA pair file: 10 pairs of 20-300 bp, one of them with
    qlen > tlen + 30 (gg2_sse's single-pair shape at -w30)."""
    rng = np.random.default_rng(909)
    d = tmp_path_factory.mktemp("fa")
    ts, qs = [], []
    for k in range(10):
        t, q = refcmp.random_pair(rng, int(rng.integers(20, 301)),
                                  divergence=0.2, indel=0.08,
                                  with_n=k % 3 == 0)
        if k == 4:
            q = q + q[:60]
        ts.append(f">t{k}\n{t}\n")
        qs.append(f">q{k}\n{q}\n")
    (d / "t.fa").write_text("".join(ts))
    (d / "q.fa").write_text("".join(qs))
    return str(d / "t.fa"), str(d / "q.fa")


@pytest.mark.parametrize("algo,extra", [
    ("gg2_sse", ["-w", "30"]),
    ("gg2_sse", []),
    ("extf2_sse", ["-z", "40"]),
    ("extf2_sse", ["-w", "20"]),
    ("exts2_sse", ["-z", "100"]),
    ("extz2_sse", ["-z", "100"]),
    ("extd2_sse", ["-s"]),
])
def test_batch_backend_matches_pair_and_jax(fasta, algo, extra):
    """``--backend batch`` prints ``--backend pair``'s TSV, and both print
    the JAX CLI's ``--backend spec`` TSV."""
    base = ["-t", algo] + extra + list(fasta)
    pair = run(["--device", "cpu"] + base)
    batch = run(["--backend", "batch", "--device", "cpu"] + base)
    assert batch == pair
    assert pair == run_jax(["--backend", "spec"] + base)
    assert len(pair.splitlines()) == 10


def test_stats_and_missing_card_raise(capsys):
    """``--stats`` prints the alignment and then the km_stat report to
    stderr; ``--device cuda`` without a card raises rather than running
    on the CPU."""
    assert cli.main(["--stats", "--device", "cpu", "ACGT", "ACGT"]) == 0
    out, err = capsys.readouterr()
    assert out.startswith("first\tsecond\t")
    assert "[ksw2_tpu_torch] kernel launches:" in err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["-t", "gg2_sse", "ACGT", "ACGT"])
