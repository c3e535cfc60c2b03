"""Multi-process serving: one HTTP frontend on rank 0, every rank in each
search (port of ``rankpo_tpu.serve.multihost``).

With the corpus row-sharded over the data group (``serve/service.py``
``group=``), a search, a mutation, a save and the warmup are collectives:
every rank must run the same call in the same order. HTTP requests reach
rank 0 only, so rank 0 broadcasts each dispatch on the control plane
(``core/mesh.py`` ``control_group``, a gloo group, whatever the data
group's backend) and the followers replay it against their own service.

Usage: every rank builds the same ``RetrievalService`` (the same corpus or
index file) over the data group and wraps it in :class:`MultihostFrontend`
(a collective); rank 0 serves HTTP through the frontend and the others call
:meth:`MultihostFrontend.follower_loop`, which returns at :meth:`stop`.

Every check that can fail runs on rank 0 before the broadcast (the texts,
the filters, the ids, the knobs, the payload's size): once a dispatch is
announced every rank must run it, and a rank that failed after its
collective started would leave the others waiting. A follower whose
dispatch fails anyway logs it and goes on (rank 0 reports its own copy of
the failure). An idle follower waits on the control group between
requests; gloo ends a wait past the group's timeout, so rank 0 sends a
keep-alive after a quarter of the timeout without a dispatch. A rank that
is gone fails the next broadcast: rank 0 then records the failure, calls
``on_failure`` (the server shuts down and exits non-zero) and raises, and a
follower's loop raises (its process exits non-zero).
"""

from __future__ import annotations

import logging
import pickle
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.index.flat import build_selector_mask

logger = logging.getLogger(__name__)


class MultihostFrontend:
    """The ``RetrievalService`` surface the HTTP handler and the
    micro-batcher use (``query``, ``add_passages``, ``remove_passages``,
    ``save_index``, ``ntotal``, ``corpus_texts``), run on every rank: rank 0
    calls it, and each call is broadcast once and replayed by the
    followers."""

    def __init__(self, service, *, max_payload_bytes: int = 1 << 24, on_failure=None):
        self.service = service
        self.max_payload = int(max_payload_bytes)
        self.on_failure = on_failure
        self.failure: Optional[BaseException] = None  # the broadcast that failed
        self.process_index = mesh.process_index()
        self._group = mesh.control_group()
        self.keepalive_s = mesh.control_timeout() / 4
        # one collective stream: a broadcast and its dispatch never interleave
        # with another's
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._last = time.monotonic()
        self.n_dispatches = 0  # dispatches sent (rank 0) or replayed (followers)
        self._pinger = None
        if self.process_index == 0:
            self._pinger = threading.Thread(target=self._keepalive, daemon=True,
                                            name="multihost-keepalive")
            self._pinger.start()

    @property
    def ntotal(self) -> int:
        return self.service.ntotal

    @property
    def corpus_texts(self) -> List[str]:
        return self.service.corpus_texts

    # -- the wire ------------------------------------------------------
    def _broadcast(self, msg: Optional[Dict]) -> Dict:
        """Rank 0's ``msg`` on every rank (followers pass None)."""
        if self.process_index == 0:
            size = len(pickle.dumps(msg))
            if size > self.max_payload:
                raise ValueError(
                    f"payload {size} B exceeds max_payload_bytes={self.max_payload}; "
                    "raise it or send fewer or shorter texts")
        try:
            msg = mesh.broadcast_object(msg, group=self._group)
        except Exception as e:  # a rank is gone: nothing can run on every rank
            first, self.failure = self.failure is None, self.failure or e
            self._stopped.set()
            if first and self.on_failure is not None:
                self.on_failure()
            raise RuntimeError("multi-process serving: the control group failed; a rank "
                               "is gone") from e
        self._last = time.monotonic()
        if msg["op"] != "ping":
            self.n_dispatches += 1
        return msg

    def _keepalive(self) -> None:
        """Rank 0: a ping whenever no dispatch went out for ``keepalive_s``."""
        while not self._stopped.wait(self.keepalive_s / 2):
            if time.monotonic() - self._last < self.keepalive_s:
                continue
            if not self._lock.acquire(blocking=False):
                continue  # a dispatch is running
            try:
                if not self._stopped.is_set():
                    self._broadcast({"op": "ping"})
            except Exception:
                logger.exception("keep-alive broadcast failed")
            finally:
                self._lock.release()

    def _rank0(self, what: str) -> None:
        if self.process_index != 0:
            raise RuntimeError(f"{what}() is rank 0's; the followers run follower_loop()")

    def _require_index(self):
        index = self.service.index
        if index is None:
            raise RuntimeError("no index built; call build_index first")
        return index

    # -- rank 0 --------------------------------------------------------
    def query(self, texts: Sequence[str] | str, k: int = 10, *, return_passages: bool = True,
              allowed_ids=None, disallowed_ids=None, nprobe=None, candidates=None):
        self._rank0("query")
        single = isinstance(texts, str)
        batch = [texts] if single else list(texts)
        if not all(isinstance(t, str) for t in batch):
            raise ValueError("Input items should be text.")
        index = self._require_index()
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        sel: Dict = {}
        if allowed_ids is not None or disallowed_ids is not None:
            # the service's own mask, built here first: a bad id raises now
            build_selector_mask(index.ntotal, **self.service._selector_kwargs(
                allowed_ids, disallowed_ids, self.service.passage_ids))
            key = "allowed_ids" if allowed_ids is not None else "disallowed_ids"
            sel[key] = [int(i) for i in (allowed_ids if allowed_ids is not None
                                         else disallowed_ids)]
        if nprobe is not None:
            raise ValueError("nprobe applies to IVF indexes only (--index_type ivf)")
        if candidates is not None:
            if not hasattr(index, "candidates"):
                raise ValueError("candidates applies to two-stage indexes only "
                                 "(--index_type refine)")
            sel["candidates"] = int(candidates)
        with self._lock:
            self._broadcast({"op": "query", "texts": batch, "k": int(k), **sel})
            result = self.service.query(batch, k=int(k), return_passages=return_passages,
                                        **sel)
        return result[0] if single else result

    def add_passages(self, texts: Sequence[str], *, ids=None, **kwargs) -> None:
        """Every rank encodes the new texts and appends them to its shard."""
        self._rank0("add_passages")
        texts = list(texts)
        if not texts or not all(isinstance(t, str) for t in texts):
            raise ValueError("add_passages takes a non-empty list of texts")
        self._require_index()
        self.service._require_stable_for(ids)
        if ids is not None:
            ids = self.service._validate_ids(ids, len(texts)).tolist()
            clash = np.intersect1d(ids, self.service.passage_ids)
            if clash.size:
                raise ValueError(f"ids already present: {clash[:8].tolist()}")
        with self._lock:
            self._broadcast({"op": "add", "texts": texts, "ids": ids, "kwargs": kwargs})
            self.service.add_passages(texts, ids=ids, **kwargs)

    def remove_passages(self, ids) -> int:
        self._rank0("remove_passages")
        ids = sorted({int(i) for i in ids})
        n = self.ntotal
        self._require_index()
        if ids and not self.service.stable_ids:
            if ids[0] < 0 or ids[-1] >= n:
                raise ValueError(f"remove id out of range: corpus has {n} passages, got "
                                 f"ids in [{ids[0]}, {ids[-1]}]")
            if len(ids) == n:
                raise ValueError("cannot remove every passage; build a new index instead")
        with self._lock:
            self._broadcast({"op": "remove", "ids": ids})
            return self.service.remove_passages(ids)

    def save_index(self, path: str) -> None:
        """A collective save: the shards gather, rank 0 writes."""
        self._rank0("save_index")
        if not path or not isinstance(path, str):
            raise ValueError("save_index needs a path")
        self._require_index()
        with self._lock:
            self._broadcast({"op": "save", "path": path})
            self.service.save_index(path)

    def warmup(self, k: int = 10) -> None:
        """The service's warmup on every rank (a mutation's rewarm then runs
        on every rank as well)."""
        self._rank0("warmup")
        self._require_index()
        with self._lock:
            self._broadcast({"op": "warmup", "k": int(k)})
            self.service.warmup(k=int(k))

    def stop(self) -> None:
        """Release the followers (rank 0; once; not after a failure)."""
        if self.process_index != 0 or self._stopped.is_set():
            return
        with self._lock:
            self._stopped.set()
            self._broadcast({"op": "stop"})
        if self._pinger is not None:
            self._pinger.join(timeout=5)

    # -- ranks 1.. -----------------------------------------------------
    def _dispatch(self, msg: Dict) -> None:
        op = msg["op"]
        if op == "query":
            sel = {key: msg[key] for key in ("allowed_ids", "disallowed_ids", "candidates")
                   if key in msg}
            self.service.query(msg["texts"], k=msg["k"], return_passages=False, **sel)
        elif op == "add":
            self.service.add_passages(msg["texts"], ids=msg["ids"], **msg["kwargs"])
        elif op == "remove":
            self.service.remove_passages(msg["ids"])
        elif op == "save":
            self.service.save_index(msg["path"])
        elif op == "warmup":
            self.service.warmup(k=msg["k"])
        else:
            raise ValueError(f"unknown dispatch {op!r}")

    def follower_loop(self) -> None:
        """Replay rank 0's dispatches until it broadcasts ``stop``."""
        if self.process_index == 0:
            raise RuntimeError("follower_loop() is for ranks other than 0")
        logger.info("follower %d entering the serve loop", self.process_index)
        while True:
            msg = self._broadcast(None)
            if msg["op"] == "stop":
                logger.info("follower %d stopping", self.process_index)
                return
            if msg["op"] == "ping":
                continue
            try:
                self._dispatch(msg)
            except Exception:
                # rank 0 reports its own copy of the failure and serves on;
                # a follower that died would leave the next collective a rank short
                logger.exception("follower %d: dispatch %s failed, continuing",
                                 self.process_index, msg["op"])
