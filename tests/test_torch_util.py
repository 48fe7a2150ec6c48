"""Helpers shared by the tests/test_torch_*.py parity tests (no tests here).

The JAX side's parameters are made without running its init: the shapes come
from ``jax.eval_shape`` and the values from a seeded numpy generator, scaled
so that activations stay of order one. The same numpy arrays then go to the
port through ``dawn_tpu_torch.weights.jax_bridge``.
"""

import numpy as np
import pytest
import torch
import jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port's tiny CPU ops on one thread. The suite runs several
    test processes at once; each torch op spreading over every core would
    oversubscribe the machine and slow the other processes' tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_tree(shapes, seed: int):
    """A tree of float32 numpy arrays shaped like ``shapes``."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name in ("scale", "gamma", "q_scale", "k_scale"):
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        return rng.randn(*shape).astype(np.float32)     # null_kv, T5 table

    return jax.tree_util.tree_map_with_path(fill, shapes)


def leaves_with_paths(tree):
    """{'a/b/c': leaf} of a nested dict."""
    return {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def start_ranks(cases, world: int, workdir: str):
    """Start ``world`` gloo processes of ``tests/torch_seq_worker.py`` on the
    cases (a list of dicts of tensors, numbers and strings), over localhost;
    returns a function that waits for them and returns each rank's results.
    The workers import torch and the port only, so the caller can compute
    its JAX references meanwhile."""
    import os
    import socket
    import subprocess
    import sys

    os.makedirs(workdir, exist_ok=True)
    spec = os.path.join(workdir, "spec.pt")
    torch.save(cases, spec)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DAWN_COORDINATOR=f"localhost:{port}",
               DAWN_NUM_PROCESSES=str(world), OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, os.path.join(tests, "torch_seq_worker.py"),
                               spec, workdir], env=dict(env, DAWN_PROCESS_ID=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]

    def wait(timeout: float = 300.0):
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"rank {r} of {world} failed:\n{log[-4000:]}"
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=True)
                for r in range(world)]

    return wait
