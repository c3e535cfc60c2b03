"""Host input pipeline: shuffled, prefetching batch loader (port of
``rankpo_tpu.data.loader``).

The epoch order is ``numpy.random.default_rng((seed, epoch)).permutation``,
the JAX package's, so one seed gives the same batches in the same order. The
collator runs in a background thread that keeps ``prefetch`` batches ahead,
so collation overlaps the device's work. ``stack`` groups that many
consecutive micro-batches into one [stack, B, ...] array per leaf (the
gradient-accumulation group); a trailing partial group is dropped.

Multi-process sharding (``process_count > 1``) is not ported: the port
trains on one card (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


def _stack(groups: list):
    """np.stack each leaf of a list of equally-shaped nested dicts."""
    first = groups[0]
    if isinstance(first, dict):
        return {k: _stack([g[k] for g in groups]) for k in first}
    return np.stack(groups, axis=0)


class DataLoader:
    def __init__(
        self,
        dataset,
        collator: Callable,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
    ):
        if process_count != 1 or process_index != 0:
            raise NotImplementedError(
                "multi-process data sharding is not ported: the port trains on "
                "one card (ROADMAP.md Queue 1 item 8)"
            )
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch

    def steps_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, epoch)).permutation(n)
        return np.arange(n)

    def epoch(self, epoch: int = 0, start_step: int = 0, stack: int = 0) -> Iterator[dict]:
        """Iterate one epoch's batches from ``start_step``; with ``stack`` > 0,
        yield [stack, B, ...] accumulation groups."""
        if stack > 0 and not self.drop_last:
            raise ValueError(
                "drop_last=False is incompatible with stacked accumulation "
                "groups (static shapes); set dataloader_drop_last=True"
            )
        order = self._epoch_order(epoch)
        steps = self.steps_per_epoch()
        stop = threading.Event()

        def produce(out_q: queue.Queue):
            def put(item) -> bool:
                # gives up when the consumer abandoned the generator
                while not stop.is_set():
                    try:
                        out_q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            try:
                group = []
                for step in range(start_step, steps):
                    if stop.is_set():
                        return
                    lo = step * self.batch_size
                    ids = order[lo : lo + self.batch_size]
                    collated = self.collator([self.dataset[int(i)] for i in ids])
                    if stack <= 0:
                        if not put(("batch", collated)):
                            return
                        continue
                    group.append(collated)
                    if len(group) == stack:
                        stacked, group = _stack(group), []
                        if not put(("batch", stacked)):
                            return
                put(("done", None))
            except Exception as e:  # surfaced in the consumer
                put(("error", e))

        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise payload
                yield payload
        finally:
            stop.set()  # release the producer when the consumer stops early
