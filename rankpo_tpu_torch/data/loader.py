"""Host input pipeline: shuffled, prefetching batch loader (port of
``rankpo_tpu.data.loader``).

The epoch order is ``numpy.random.default_rng((seed, epoch)).permutation``,
the JAX package's, so one seed gives the same batches in the same order. The
collator runs in a background thread that keeps ``prefetch`` batches ahead,
so collation overlaps the device's work. ``stack`` groups that many
consecutive micro-batches into one [stack, B, ...] array per leaf (the
gradient-accumulation group); a trailing partial group is dropped.
:meth:`DataLoader.replay` runs the collator over the batches a resumed run
skips, so a collator with state (the contrastive collator's sampling RNG,
the packer's row budget) stands where the uninterrupted run left it.

With ``process_count`` > 1 (data-parallel training, one process per card)
``batch_size`` is the global micro-batch: every process draws the same
seeded order and takes ``global_ids[process_index::process_count]`` of each
global batch (JAX ``loader.py:128-132``), ``batch_size / process_count``
rows; :meth:`DataLoader.replay` replays this process's rows.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


def _stack(groups: list, key=None):
    """np.stack each leaf of a list of nested dicts. Where the leaves'
    shapes differ (packed micro-batches whose row budgets differ,
    ``data/packing.py``), the row dimension is padded to the group's
    largest first: ``slot_index`` with -1 (no slot), every other array with
    0 (segment 0 is no text), as JAX ``_stack_microbatches`` pads them."""
    first = groups[0]
    if isinstance(first, dict):
        return {k: _stack([g[k] for g in groups], k) for k in first}
    if len({g.shape for g in groups}) > 1:
        rows = max(g.shape[0] for g in groups)
        fill = -1 if key == "slot_index" else 0
        groups = [np.pad(g, [(0, rows - g.shape[0])] + [(0, 0)] * (g.ndim - 1),
                         constant_values=fill) for g in groups]
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
        if batch_size % process_count != 0:
            raise ValueError(
                f"global batch_size {batch_size} must divide evenly over "
                f"{process_count} processes"
            )
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not in [0, {process_count})")
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.local_batch_size = batch_size // process_count
        self.process_index = process_index
        self.process_count = process_count
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

    def _local_rows(self, order: np.ndarray, step: int) -> list:
        """This process's rows of global batch ``step`` of ``order``."""
        lo = step * self.batch_size
        ids = order[lo : lo + self.batch_size][self.process_index :: self.process_count]
        return [self.dataset[int(i)] for i in ids]

    def replay(self, epoch: int, start_step: int) -> None:
        """Collate, and drop, every micro-batch an uninterrupted run would
        have collated before micro-batch ``start_step`` of ``epoch``: all of
        each earlier epoch's (a trailing partial group's too), then the
        first ``start_step`` of ``epoch``. A resumed run that then calls
        :meth:`epoch` from ``start_step`` draws the uninterrupted run's
        batches. Host work only; the JAX package restarts the collator
        instead."""
        steps = self.steps_per_epoch()
        for e in range(epoch + 1):
            order = self._epoch_order(e)
            for step in range(steps if e < epoch else min(start_step, steps)):
                self.collator(self._local_rows(order, step))

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
                    collated = self.collator(self._local_rows(order, step))
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
