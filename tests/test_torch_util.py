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
