"""The benchmark's own spans around the program's layers, kept in memory.

A host span times a layer with the host clock, the card synchronised at
both ends. A device span brackets a layer with CUDA events on the current
stream (its device time, no synchronisation) and also keeps the host
seconds the layer took to issue. A count records the operations and bytes
of one call of an op. Every span and count is tagged with the call of the
window it belongs to, and each is a ``torch.profiler`` annotation
(``bench::<name>``), so a traced run can find the kernels launched inside.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.call = -1
        self.host_s: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        self.device_ms: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        self.issue_ms: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        self.counts: Dict[str, List[Tuple[int, float, float]]] = defaultdict(list)
        self._open: Dict[str, list] = defaultdict(list)
        self._pending: List[Tuple[str, int, object, object]] = []

    @contextlib.contextmanager
    def host(self, name: str):
        """Host seconds of the block, the card synchronised at both ends."""
        with torch.profiler.record_function(f"bench::{name}"):
            sync(self.device)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                sync(self.device)
                self.host_s[name].append((self.call, time.perf_counter() - t0))

    def begin(self, name: str) -> None:
        """Opens a device span (closed by :meth:`end`, e.g. from a hook pair)."""
        rf = torch.profiler.record_function(f"bench::{name}")
        rf.__enter__()
        start = None
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        self._open[name].append((rf, start, time.perf_counter()))

    def end(self, name: str) -> None:
        rf, start, t0 = self._open[name].pop()
        self.issue_ms[name].append((self.call, (time.perf_counter() - t0) * 1e3))
        if self.cuda:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            self._pending.append((name, self.call, start, stop))
        rf.__exit__(None, None, None)

    def count(self, name: str, flops: float, nbytes: float) -> None:
        self.counts[name].append((self.call, flops, nbytes))

    def resolve(self) -> None:
        """Reads the device spans' events; call after a synchronisation."""
        for name, call, start, stop in self._pending:
            self.device_ms[name].append((call, start.elapsed_time(stop)))
        self._pending.clear()

    def per_call(self, table: Dict[str, list], name: str) -> Dict[int, List[float]]:
        out: Dict[int, List[float]] = defaultdict(list)
        for call, *values in table.get(name, []):
            out[call].append(values[0])
        return out
