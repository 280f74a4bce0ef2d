"""Multi-host rehearsal without hardware: two real OS processes join a
jax.distributed cluster over localhost and run collectives through
gogp.parallel.mesh.init_multihost + make_mesh.

This is the CPU stand-in for a multi-host topology: each process owns one
CPU device (its host-local devices),
``init_multihost`` wires the coordinator, and a shard_map psum over the
mesh must see both processes' shards.  Everything the multi-chip layer
emits (named-axis psum/all_gather) is process-count agnostic, so this
green means mesh.py:71-101 is exercised, not design-only.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)  # one device per process
    pid, port = int(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, sys.argv[3])
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gogp.parallel.mesh import CHAIN_AXIS, init_multihost, make_mesh

    n = init_multihost(f"localhost:{port}", num_processes=2, process_id=pid)
    assert n == 2, f"expected 2 global devices, got {n}"
    assert jax.process_count() == 2

    # host-aware layout: chain axis across hosts (one device each)
    mesh = make_mesh(n_chain=2, n_data=1)
    sh = NamedSharding(mesh, P(CHAIN_AXIS))
    data = np.asarray([1.0, 2.0])
    arr = jax.make_array_from_callback((2,), sh, lambda idx: data[idx])

    f = jax.jit(
        jax.shard_map(
            lambda x: jax.lax.psum(x, CHAIN_AXIS),
            mesh=mesh, in_specs=P(CHAIN_AXIS), out_specs=P(),
        )
    )
    out = f(arr)
    local = np.asarray(out.addressable_data(0))
    assert np.allclose(local, 3.0), local
    print(f"proc {pid}: psum over 2 processes = {float(local[0])} OK", flush=True)
    """
)


def test_two_process_collective():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), str(port), str(REPO)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert "OK" in out, out
