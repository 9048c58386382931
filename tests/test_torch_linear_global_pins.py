"""The linear-gap and global engines' pins in chip_smoke.py, recomputed
from the spec.

No reference-binary anchors exist in this tree for these workloads (the
JAX bench's 50 kb and MT files are not in it), so ``chip_smoke.LG_PINS``
were computed with the byte-parity spec: ``ksw2_tpu.spec.diagdiff.extf2``
on the seeded 50 kb pair (the JAX bench's extf_50k_score row),
``gg2_sse`` on the seeded MT-length pair (its gg2_mt_cigar row), and the
JAX CLI's ``--backend spec`` on the mixed-512 workload written as FASTA
(``-t gg2_sse -w 100``, ``-t extf2_sse -z 40``).  The tier-1 tests
recompute the prefix pins (the pairs cut to their first 2 kb, the first
16 pairs of the CLI runs) and run the port's CPU route on them; the tests
marked ``slow`` recompute the whole pins (about 3 minutes, ~1 GB for the
MT pair's byte matrix):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_linear_global_pins.py -m slow
"""
import contextlib
import io

import pytest
import torch

import chip_smoke
from ksw2_tpu import cli as jcli
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.spec import diagdiff

from ksw2_tpu_torch import Aligner, cli
from ksw2_tpu_torch.ops.extf import extf2_device

torch.set_num_threads(1)

MAT = simple_mat(5, 2, 4)


def _cut(pair, prefix):
    q, t = pair
    return (q[:chip_smoke.LG_PREFIX], t[:chip_smoke.LG_PREFIX]) \
        if prefix else pair


def spec_extf(prefix: bool):
    q, t = _cut(chip_smoke.single_pair(chip_smoke.SINGLE_SEED,
                                       chip_smoke.SINGLE_LEN), prefix)
    ez = diagdiff.extf2(q, t, 2, -4, 2, w=-1, xdrop=-1)
    return (ez.max, ez.max_t, ez.max_q, ez.score, int(ez.zdropped))


def spec_gg2_mt(prefix: bool):
    q, t = _cut(chip_smoke.single_pair(chip_smoke.MT_SEED,
                                       chip_smoke.MT_LEN), prefix)
    score, cig, _ = diagdiff.gg2_sse(q, t, 5, MAT, 4, 2, w=-1)
    return chip_smoke.gg2_pin(score, cig)


def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def cli_pin(name, tmp, prefix: bool, port=False):
    """The pin of CLI run ``name`` on the mixed-512 workload (its first
    CLI_BATCH_PREFIX pairs with ``prefix``): the JAX CLI's spec backend,
    or with ``port`` the port's batch backend on the CPU."""
    jobs = chip_smoke.mixed_jobs()
    if prefix:
        jobs = jobs[:chip_smoke.CLI_BATCH_PREFIX]
    files = chip_smoke.write_pairs_fasta(jobs, str(tmp))
    args = chip_smoke.CLI_BATCH_ARGS[name] + list(files)
    col = chip_smoke.CLI_PIN_COL[name]
    if port:
        return chip_smoke.tsv_pin(_lines(cli.main, [
            "--backend", "batch", "--device", "cpu"] + args), col)
    return chip_smoke.tsv_pin(_lines(jcli.main, ["--backend", "spec"] + args),
                              col)


def test_pins_have_every_run():
    assert set(chip_smoke.LG_PINS) == {"single_extf", "single_gg2_mt",
                                       "cli_batch_gg2", "cli_batch_extf"}


def test_prefix_pins_match_spec_and_cpu_route():
    """The prefix pins are the spec's, and the port's CPU route
    (``extf2_device``, ``Aligner.global_align``) gives them."""
    pins = chip_smoke.LG_PINS
    assert spec_extf(True) == pins["single_extf"][1]
    q, t = _cut(chip_smoke.single_pair(chip_smoke.SINGLE_SEED,
                                       chip_smoke.SINGLE_LEN), True)
    ez = extf2_device(q, t, 2, 4, 2, xdrop=-1, device="cpu")
    assert (ez.max, ez.max_t, ez.max_q, ez.score, int(ez.zdropped)) == \
        pins["single_extf"][1]
    assert spec_gg2_mt(True) == pins["single_gg2_mt"][1]
    q, t = _cut(chip_smoke.single_pair(chip_smoke.MT_SEED,
                                       chip_smoke.MT_LEN), True)
    ez = Aligner(device="cpu").global_align(q, t)
    assert chip_smoke.gg2_pin(ez.score, ez.cigar) == \
        pins["single_gg2_mt"][1]


@pytest.mark.parametrize("name", sorted(chip_smoke.CLI_BATCH_ARGS))
def test_cli_prefix_pins_match_spec_and_port(name, tmp_path):
    """The CLI prefix pins are the JAX CLI's, and the port's batch
    backend on the CPU prints the same TSV."""
    want = list(chip_smoke.LG_PINS[name][1])
    assert cli_pin(name, tmp_path, True) == want
    assert cli_pin(name, tmp_path, True, port=True) == want


@pytest.mark.slow
def test_single_pins_match_spec():
    pins = chip_smoke.LG_PINS
    assert spec_extf(False) == pins["single_extf"][0]
    assert spec_gg2_mt(False) == pins["single_gg2_mt"][0]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(chip_smoke.CLI_BATCH_ARGS))
def test_cli_pins_match_spec(name, tmp_path):
    assert cli_pin(name, tmp_path, False) == \
        list(chip_smoke.LG_PINS[name][0])
