"""The logging and seeding helpers of the training scripts.

Port of the ``Logger`` and ``setup_seed`` parts of ``dawn_tpu/utils/misc.py``
(reference misc.py:86-96).
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np
import torch


class Logger:
    """Tee a stream (stdout by default) to a file, flushed on every write."""

    def __init__(self, path: str, stream=None):
        self.terminal = stream or sys.stdout
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.log = open(path, "a")

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


def setup_seed(seed: int = 1234):
    """Seed the host generators (python, numpy) and torch's default
    generators, which draw the port's initial weights."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
