"""Multi-host orchestration test: a real 2-process ``jax.distributed`` run.

``initialize_multihost`` (relp_tpu/parallel/mesh.py) was previously only a
thin untested wrapper; this exercises the genuine multi-process code path on
CPU — two OS processes, a coordinator, a global 4-device mesh spanning both,
and a column-sharded pricing matvec whose global result must match numpy.
On a multi-host cluster the same call sequence spans the hosts.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
import numpy as np

process_id = int(sys.argv[1])
coordinator = sys.argv[2]

import jax
from relp_tpu.parallel.mesh import initialize_multihost, make_mesh

initialize_multihost(
    coordinator_address=coordinator, num_processes=2, process_id=process_id
)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()
assert jax.local_device_count() == 2

from jax.sharding import NamedSharding, PartitionSpec as P

mesh = make_mesh((1, 4))

# Column-sharded pricing matvec over the global mesh: each process holds the
# columns of its 2 local devices; jit computes pi @ A globally.
M, N = 8, 16
rng = np.random.default_rng(0)
A_host = rng.standard_normal((M, N))
pi_host = rng.standard_normal(M)

sharding = NamedSharding(mesh, P(None, "col"))
A = jax.make_array_from_process_local_data(
    sharding, A_host[:, process_id * (N // 2):(process_id + 1) * (N // 2)],
    global_shape=(M, N),
)
pi = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P()), pi_host, global_shape=(M,)
)

d = jax.jit(lambda pi, A: pi @ A)(pi, A)
from jax.experimental import multihost_utils
d_global = multihost_utils.process_allgather(d, tiled=True)
expected = pi_host @ A_host
assert np.allclose(np.asarray(d_global), expected, atol=1e-12)
print(f"proc {process_id} OK", flush=True)
jax.distributed.shutdown()
"""


def test_initialize_multihost_two_processes():
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_NUM_PROCESSES", None)

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), coordinator],
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outputs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"multihost workers timed out; partial output: {outputs}")
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out, out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
