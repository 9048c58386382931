"""The port's km_stat report (``ksw2_tpu_torch.utils.stats``), the CLI's
``--stats`` and the warm-up step ``python -m ksw2_tpu_torch.precompile``.

On the CPU: the report has its library, launch and device parts, the
device part empty; it renders, and the CLI prints it to stderr after
its alignment; precompile raises without a card and walks the JAX
package's ladder.  The ``cuda`` case checks the allocator counters and
the launch counts after one batch on a card.
"""
import numpy as np
import pytest
import torch

from ksw2_tpu_torch import _build, cli, precompile
from ksw2_tpu_torch.core.matrix import simple_mat
from ksw2_tpu_torch.ops.batch_local import local_batch_device
from ksw2_tpu_torch.utils import stats

torch.set_num_threads(1)


@pytest.fixture
def launches():
    """The launch counter, empty for the test and restored after it (the
    wrappers hold the counter object itself)."""
    saved = _build.LAUNCHES.copy()
    _build.LAUNCHES.clear()
    yield _build.LAUNCHES
    _build.LAUNCHES.clear()
    _build.LAUNCHES.update(saved)


def test_engine_stats_parts_on_cpu(launches):
    launches.update({"batch_local_fwd": 3, "strips_fwd": 2})
    st = stats.engine_stats()
    assert set(st) == {"library", "launches", "device"}
    assert st["library"]["path"] == str(_build.library_path())
    assert set(st["library"]) == {"path", "built", "loaded"}
    assert st["launches"] == {"batch_local_fwd": 3, "strips_fwd": 2}
    if not torch.cuda.is_initialized():
        assert st["device"] == {}


def test_format_stats_renders(launches):
    launches.update({"batch_local_fwd": 3, "strips_fwd": 2})
    text = stats.format_stats()
    lines = text.splitlines()
    assert lines[0].startswith("[ksw2_tpu_torch] kernel library: ")
    assert lines[1] == "[ksw2_tpu_torch] kernel launches: 5 (2 kernels)"
    assert lines[2:4] == ["  batch_local_fwd: 3", "  strips_fwd: 2"]


def test_print_stats_writes_stderr(launches, capsys):
    stats.print_stats()
    out, err = capsys.readouterr()
    assert out == "" and err.strip() == stats.format_stats()


@pytest.mark.parametrize("algo", ["extz2_sse", "gg2_sse", "extf2_sse"])
def test_cli_stats_prints_report_after_the_run(algo, capsys):
    assert cli.main(["--stats", "--device", "cpu", "-t", algo,
                     "ACGTACGTTTGACA", "ACGTTCGTTTGACA"]) == 0
    out, err = capsys.readouterr()
    assert out.startswith("first\tsecond\t")
    assert err.strip() == stats.format_stats()


def test_cli_stats_reports_on_a_failed_run(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--stats", "-t", "extz2_sse", "ACGT", "ACGT"])
    assert "[ksw2_tpu_torch] kernel launches" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["--quick"]])
def test_precompile_without_a_card_raises(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        precompile.main(argv)


@pytest.mark.parametrize("quick", [True, False])
def test_precompile_ladder_is_the_jax_ladder(quick):
    pytest.importorskip("jax")
    from ksw2_tpu import precompile as jpre
    assert precompile._ladder(quick) == jpre._ladder(quick)


def test_precompile_warmups_cover_every_family():
    import argparse
    names = [n for n, _ in precompile._warmups(
        argparse.Namespace(quick=True, scores="2,4,4,2"),
        np.random.default_rng(0), device="cpu")]
    assert len(names) == 5 + 14
    for family in ("rows", "band", "batched", "splice annotated",
                   "single extz", "single extd", "single exts", "extf batch",
                   "extf single", "gg2 batch", "gg2 single", "local"):
        assert any(n.startswith(family) for n in names), family


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_report_after_one_batch_on_the_card(cuda_device, launches):
    rng = np.random.default_rng(3)
    Q = rng.integers(0, 4, (64, 200))
    T = rng.integers(0, 4, (64, 128))
    ln = np.full(64, 200, np.int32)
    local_batch_device(Q, T, ln, np.full(64, 128, np.int32), 5,
                       simple_mat(5, 2, -4), 4, 2)
    st = stats.engine_stats()
    assert st["library"]["loaded"] and st["library"]["built"]
    assert st["launches"] == {"batch_local_fwd": 1}
    dev = st["device"]
    for key in stats.MEMORY_KEYS:
        assert key in dev
    assert dev["allocated_bytes.all.peak"] > 0
    assert dev["reserved_bytes.all.current"] > 0
    assert 0 < dev["free_bytes"] <= dev["total_bytes"]
    assert "allocated_bytes.all.current=" in stats.format_stats()
