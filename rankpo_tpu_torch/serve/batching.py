"""Dynamic micro-batching for the retrieval service (port of
``rankpo_tpu.serve.batching``; pure threading, unchanged but for imports).

A device serves one stream of work; concurrent request threads each
dispatching their own small encoder forward waste
the device and stack queueing delay. The standard production fix is a
micro-batcher: requests enqueue, a single worker drains the queue, groups up
to ``max_batch`` queries arriving within ``max_wait_ms``, runs ONE
encode+search dispatch, and fans results back out. Under load this raises
throughput toward the batched ceiling and *lowers* tail latency (one queue,
no lock convoy on the device).

The reference has no serving path (closest: the offline evaluate.py loop);
this wraps :class:`rankpo_tpu_torch.serve.service.RetrievalService` without
changing its single-caller semantics.

Top-k is computed once per group at ``k_max`` and sliced per request, so
one group serves requests that asked for different k.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("text", "k", "return_passages", "event", "result", "error")

    def __init__(self, text: str, k: int, return_passages: bool):
        self.text = text
        self.k = k
        self.return_passages = return_passages
        self.event = threading.Event()
        self.result: Optional[Dict] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Groups concurrent ``query`` calls into single device dispatches.

    Drop-in alongside RetrievalService.query for serving frontends: call
    :meth:`query` from any number of request threads; a single worker thread
    owns the device.
    """

    def __init__(
        self,
        service,
        *,
        max_batch: int = 64,
        max_wait_ms: float = 3.0,
        k_max: int = 100,
    ):
        self.service = service
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.k_max = k_max
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stopping = False
        # serializes {check _stopping + enqueue} against close()'s
        # {set _stopping + final drain}: without it a query() thread that
        # passed the check could enqueue after the final drain and block
        # forever on an event nobody will set
        self._close_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name="microbatcher", daemon=True
        )
        self._worker.start()
        # observability: dispatch counts let tests (and ops) verify grouping
        self.n_dispatches = 0
        self.n_queries = 0

    # ------------------------------------------------------------------
    def query(self, text: str, k: int = 10, *, return_passages: bool = True) -> Dict:
        """Single-query call; blocks until its group's dispatch completes."""
        if k > self.k_max:
            raise ValueError(f"k={k} exceeds serving k_max={self.k_max}")
        req = _Pending(text, k, return_passages)
        with self._close_lock:
            if self._stopping:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        if req.result is None:  # drained by close() without dispatching
            raise RuntimeError("MicroBatcher closed while request was queued")
        return req.result

    def close(self) -> None:
        with self._close_lock:
            self._stopping = True
            self._queue.put(None)  # wake the worker
        self._worker.join(timeout=5)
        self._drain()  # no enqueue can follow: _stopping was set under the lock

    def _drain(self) -> None:
        """Release any requests still queued (enqueued around close(), or
        behind the sentinel) so their callers never block forever."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req.event.set()

    # ------------------------------------------------------------------
    def _collect(self) -> List[_Pending]:
        first = self._queue.get()
        if first is None:
            return []
        group = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(group) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            group.append(nxt)
        return group

    def _run(self) -> None:
        while not self._stopping:
            group = self._collect()
            if not group:
                continue
            if self._stopping:  # closed mid-collect: release, don't dispatch
                for req in group:
                    req.event.set()
                return
            try:
                k_eff = min(self.k_max, self.service.ntotal or self.k_max)
                # return_passages=True: the service attaches texts from the
                # same _state snapshot it searched; slicing here must not
                # touch live corpus_texts (mutation race)
                results = self.service.query(
                    [r.text for r in group], k=k_eff, return_passages=True
                )
                self.n_dispatches += 1
                self.n_queries += len(group)
                from rankpo_tpu_torch.serve.service import finalize_hits

                for req, res in zip(group, results):
                    req.result = finalize_hits(res, req.k, req.return_passages)
            except BaseException as e:  # propagate to every waiter in the group
                for req in group:
                    req.error = e
            finally:
                for req in group:
                    req.event.set()
