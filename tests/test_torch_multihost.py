"""Two processes in one gloo group on localhost drive the port's
scale-out across the process boundary (the counterpart of
tests/test_multihost.py): the flat tier in f64 on each rank's half of a
batch, and one MIQP's tree split over the two ranks.  Each rank checks
its own lanes against the constructed optima; rank 0 checks the MIQP
against the port's single solve, and the test against the JAX
package's.  The worker is this file run as a script:

    python tests/test_torch_multihost.py RANK WORLD_SIZE PORT
"""
import os
import re
import socket
import subprocess
import sys

import numpy as np

from daqp_tpu_torch.types import BINARY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _miqp():
    """tests/multihost_worker.py's MIQP (seed 23, n = 8, m = 16, four
    binaries on identity rows)."""
    rng = np.random.default_rng(23)
    nq, mq, nb = 8, 16, 4
    Mx = rng.standard_normal((nq, nq))
    H = Mx.T @ Mx + 0.5 * np.eye(nq)
    f = 10 * rng.standard_normal(nq)
    A = rng.standard_normal((mq, nq))
    bu = 15 * rng.random(mq)
    bl = -15 * rng.random(mq)
    A[:nb] = 0.0
    A[np.arange(nb), np.arange(nb)] = 1.0
    bu[:nb] = 1.0
    bl[:nb] = 0.0
    sense = np.zeros(mq, np.int32)
    sense[:nb] = BINARY
    return (H, f, A, bu, bl, sense), nb


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_solve():
    import daqp_tpu
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), "2",
         str(port)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    try:
        # the JAX package's solve while the ranks run
        prob, _ = _miqp()
        ref = daqp_tpu.quadprog(*prob, ms=0)
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    fvals = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        ok = re.search(rf"MULTIHOST_OK {rank} fval=(\S+)", out)
        assert ok, f"rank {rank} output:\n{out}"
        fvals.append(float(ok.group(1)))
    # every rank returns the winner's objective: the JAX package's
    assert int(ref.exitflag) == 1
    for fval in fvals:
        assert abs(fval - float(ref.fval)) < 1e-6, (fvals, float(ref.fval))


def main(rank, size, port):
    sys.path.insert(0, ROOT)
    import torch
    import daqp_tpu_torch as dt
    from daqp_tpu_torch.parallel import distributed, sharding
    from tests.gen import generate_test_qp_batch

    distributed.initialize("gloo", init_method=f"tcp://localhost:{port}",
                           world_size=size, rank=rank)
    try:
        world = distributed.global_mesh("cpu")
        assert (world.rank, world.size) == (rank, size)
        st = dt.as_settings(None, torch.float64)

        # the flat tier on this rank's half of the batch
        B = 8
        d = generate_test_qp_batch(B, 6, 12, 0, 4, 1e2, rng=5)
        args = distributed.distribute_batch(
            world, *(d[k] for k in ('H', 'f', 'A', 'bupper', 'blower',
                                    'sense')))
        res, stats = sharding.solve_batch_sharded(*args, st, world,
                                                  tier="flat")
        assert stats.n_optimal == B, stats
        k = B // size
        lanes = slice(rank * k, (rank + 1) * k)
        err = np.linalg.norm(res.x.numpy() - d['x'][lanes], axis=1).max()
        assert res.x.shape[0] == k and err < 1e-5, err

        # the tree split over the ranks, the bound exchanged
        prob, nb = _miqp()
        x, fval, status, nodes = sharding.solve_miqp_sharded(
            *prob, 0, st, world)
        assert status == dt.EXIT_OPTIMAL, status
        H, f, A, bu, bl, sense = prob
        if rank == 0:
            one = dt.quadprog(*prob, ms=0, dtype=torch.float64,
                              device="cpu")
            assert abs(float(fval) - float(one.fval)) < 1e-6, \
                (float(fval), float(one.fval))
            ax = A @ x.numpy()
            assert np.all((ax <= bu + 1e-6) & (ax >= bl - 1e-6))
            xb = ax[:nb]
            assert np.all((np.abs(xb - 1) < 1e-6) | (np.abs(xb) < 1e-6)), xb
        print(f"MULTIHOST_OK {rank} fval={float(fval)!r} nodes={nodes}",
              flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
