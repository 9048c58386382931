"""Two processes of the port's dry-run worker with torch.distributed (gloo)
on the CPU: ``python -m ksw2_tpu_torch.parallel.dryrun --rank R --world 2
--init tcp://127.0.0.1:PORT --backend gloo --device cpu``.

Each rank scores its row block of tests/multihost_demo.py's seeded
16 x 64 batch, all-gathers the records and all-reduces the score sum; the
two checksums must agree with each other and with the JAX package's
``extz_batch_scores`` on the whole batch (tests/test_multihost.py:60-85).
"""
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_workers():
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ksw2_tpu_torch.parallel.dryrun", "--rank",
         str(r), "--world", "2", "--init", init, "--backend", "gloo",
         "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            oks = [ln for ln in out.splitlines() if ln.startswith("OK ")]
            assert p.returncode == 0 and oks, (p.returncode, out,
                                               err[-2000:])
            outs.append(oks[-1])
    finally:
        for p in procs:          # stop our own children on a failure
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_two_process_gloo():
    # a worker that loses the rendezvous (a port taken meanwhile, a loaded
    # host) gets one retry on a fresh port
    try:
        outs = _spawn_workers()
    except (subprocess.TimeoutExpired, AssertionError):
        outs = _spawn_workers()
    ranks = sorted(int(o.split()[1]) for o in outs)
    sums = [int(o.split()[-1]) for o in outs]
    assert ranks == [0, 1] and sums[0] == sums[1], outs

    import jax.numpy as jnp

    from ksw2_tpu.core.flags import Flag
    from ksw2_tpu.ops.batch_xla import BatchSpec, extz_batch_scores

    rng = np.random.default_rng(0)
    B, L = 16, 64
    Q = rng.integers(0, 4, size=(B, L)).astype(np.int32)
    T = np.where(rng.random((B, L)) < 0.15,
                 rng.integers(0, 4, size=(B, L)), Q).astype(np.int32)
    spec = BatchSpec(Lq=L, Lt=L, m=5, sc_mch=2, sc_mis=-4, sc_N=-2,
                     q=4, e=2, zdrop=100, flag=int(Flag.SCORE_ONLY))
    ln = jnp.full((B,), L, jnp.int32)
    out = extz_batch_scores(spec, jnp.asarray(Q), jnp.asarray(T), ln, ln, ln)
    assert sums[0] == int(np.asarray(out["score"]).sum()), sums
