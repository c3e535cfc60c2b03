"""Host-side sequence packing: bin-pack tokenized texts into fixed rows (port
of ``rankpo_tpu.data.packing``, pure numpy, kept as the port's own copy).

Several texts share a row as contiguous segments (ids 1..n, a 0-id pad
tail); attention is block-diagonal (``ops/flash_attention.py``
``segment_ids``), positions and pooling restart per segment
(``models/packing.py``). Packing is best-fit-decreasing (sort by length
descending, place each text into the fullest bin it fits, open a new bin
otherwise) with a stable sort and bisect, so one input gives one layout.

Data-parallel packing (:func:`configure_multiprocess_packing`): the
processes agree on FIXED row budgets once, before the training loop, with
one ``all_gather`` of their probed needs (:func:`sync_packed_budgets`), so
every rank's packed batches keep one shape for the whole run. The port's
ranks embed and scatter their own rows and then gather the reps
(``losses/contrastive.py``), so their slot tables stay local: the JAX
package's global slot offsets (``set_process_shard``, for global arrays)
are left at 0.
"""

from __future__ import annotations

import bisect
import copy
import warnings
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from rankpo_tpu_torch.data.collators import ContrastiveCollator


@dataclass
class PackedRows:
    """One packed chunk. ``input_ids``/``segment_ids`` are [R, capacity];
    ``text_index`` is [R, max_segments] mapping slot j of row r to the index
    of the packed text in the input list (-1 for empty slots)."""

    input_ids: np.ndarray
    segment_ids: np.ndarray
    text_index: np.ndarray

    @property
    def n_rows(self) -> int:
        return self.input_ids.shape[0]

    @property
    def max_segments(self) -> int:
        return self.text_index.shape[1]


def pack_lengths(lengths: Sequence[int], capacity: int, max_segments: int) -> List[List[int]]:
    """Best-fit-decreasing: item indices grouped into bins of ``capacity``
    with at most ``max_segments`` items per bin. Every length must be
    1..capacity (truncate upstream)."""
    lengths = np.asarray(lengths)
    if lengths.size == 0:
        return []
    if int(lengths.max(initial=0)) > capacity:
        raise ValueError(
            f"text of {int(lengths.max())} tokens exceeds pack capacity "
            f"{capacity}; truncate before packing"
        )
    if int(lengths.min(initial=1)) < 1:
        raise ValueError("cannot pack empty token lists")
    # stable argsort then reverse: a deterministic descending order
    order = np.argsort(lengths, kind="stable")[::-1]
    caps: List[int] = []  # sorted remaining capacities of open bins
    cap_bin: List[int] = []  # parallel: bin id of each caps entry
    bins: List[List[int]] = []
    for idx in order:
        need = int(lengths[idx])
        j = bisect.bisect_left(caps, need)  # the tightest bin that still fits
        if j < len(caps):
            b = cap_bin.pop(j)
            rem = caps.pop(j) - need
            bins[b].append(int(idx))
            if rem > 0 and len(bins[b]) < max_segments:
                at = bisect.bisect_left(caps, rem)
                caps.insert(at, rem)
                cap_bin.insert(at, b)
        else:
            bins.append([int(idx)])
            rem = capacity - need
            if rem > 0 and max_segments > 1:
                at = bisect.bisect_left(caps, rem)
                caps.insert(at, rem)
                cap_bin.insert(at, len(bins) - 1)
    return bins


def pack_token_lists(ids_list: Sequence[Sequence[int]], capacity: int, max_segments: int,
                     pad_id: int) -> PackedRows:
    """Pack tokenized texts into PackedRows. Segment ids are 1..n in each
    row's placement order; ``text_index`` recovers input order."""
    bins = pack_lengths([len(x) for x in ids_list], capacity, max_segments)
    n_rows = len(bins)
    m = max((len(b) for b in bins), default=1)
    input_ids = np.full((n_rows, capacity), pad_id, np.int32)
    segment_ids = np.zeros((n_rows, capacity), np.int32)
    text_index = np.full((n_rows, m), -1, np.int32)
    for r, items in enumerate(bins):
        off = 0
        for s_i, idx in enumerate(items):
            ids = ids_list[idx]
            n = len(ids)
            input_ids[r, off : off + n] = ids
            segment_ids[r, off : off + n] = s_i + 1
            text_index[r, s_i] = idx
            off += n
    return PackedRows(input_ids, segment_ids, text_index)


def occupancy(packed: PackedRows) -> float:
    """Fraction of non-pad tokens."""
    if packed.n_rows == 0:
        return 1.0
    return float((packed.segment_ids != 0).mean())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class _BlockPacker:
    """Packs one field (queries or passages) into batches of a fixed width.

    Capacity and the slot-table width are fixed; the ROW count is a sticky
    budget: the first batch sets it (rows needed plus 1/8 slack, rounded up
    to ``rows_multiple``), later batches reuse it, and a batch that needs
    more rounds up to a multiple of the budget. :meth:`set_budget` FIXES it
    instead: every batch then has exactly that many rows, and one that needs
    more is truncated to fit (the texts clipped to the longest length whose
    packing fits). ``slot_offset`` shifts the slot-table entries, as a
    process's shard of a global batch would need."""

    def __init__(self, capacity: int, max_segments: int, pad_id: int, rows_multiple: int = 1):
        self.capacity = capacity
        self.max_segments = max_segments
        self.pad_id = pad_id
        self.rows_multiple = rows_multiple
        self._budget: int | None = None
        self._fixed = False
        self.slot_offset = 0
        self.n_truncated = 0  # overflow batches clipped to fit (fixed budget)

    def set_budget(self, rows: int) -> int:
        """Fix the row budget (rounded up to ``rows_multiple``). Later
        batches come out at exactly this many rows."""
        self._budget = _round_up(int(rows), self.rows_multiple)
        self._fixed = True
        return self._budget

    def probe_rows(self, seqs) -> int:
        """Rows a batch would need, without touching the sticky budget."""
        seqs = [list(s)[: self.capacity] or [self.pad_id] for s in seqs]
        return max(len(pack_lengths([len(s) for s in seqs], self.capacity,
                                    self.max_segments)), 1)

    def _truncate_to_fit(self, seqs, rows: int) -> PackedRows:
        """The fixed budget's overflow repair: clip every text to the largest
        length whose packing fits ``rows`` rows (a binary search, each probe
        an exact packing)."""
        n = len(seqs)
        per_row = min(self.capacity, self.max_segments)
        if rows * per_row < n:
            raise ValueError(
                f"packed row budget {rows} cannot hold {n} texts even at 1 token "
                f"each (max {per_row} segments/row); raise the budget or max_segments"
            )

        def fits(cap_len: int) -> bool:
            lengths = [min(len(s), cap_len) for s in seqs]
            return len(pack_lengths(lengths, self.capacity, self.max_segments)) <= rows

        lo, hi = 1, self.capacity  # fits(1) holds by the check above
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if fits(mid):
                lo = mid
            else:
                hi = mid - 1
        self.n_truncated += 1
        if self.n_truncated <= 3:
            warnings.warn(
                f"packed batch overflowed its fixed row budget ({rows} rows); texts "
                f"clipped to {lo} tokens to fit. Frequent overflow means the budget is "
                "too tight: raise the slack or the explicit budget."
            )
        return pack_token_lists([s[:lo] for s in seqs], self.capacity, self.max_segments,
                                self.pad_id)

    def __call__(self, seqs) -> dict:
        # an empty tokenization becomes one pad token (a finite embedding, as
        # the unpacked path's all-pad row) instead of a packer error
        seqs = [list(s)[: self.capacity] or [self.pad_id] for s in seqs]
        packed = pack_token_lists(seqs, self.capacity, self.max_segments, self.pad_id)
        need = max(packed.n_rows, 1)
        if self._budget is None:
            self._budget = _round_up(need + need // 8, self.rows_multiple)
        if self._fixed:
            rows = self._budget
            if need > rows:
                packed = self._truncate_to_fit(seqs, rows)
        else:
            rows = self._budget if need <= self._budget else _round_up(need, self._budget)
        m = self.max_segments
        ids = np.pad(packed.input_ids, ((0, rows - packed.n_rows), (0, 0)),
                     constant_values=self.pad_id)
        seg = np.pad(packed.segment_ids, ((0, rows - packed.n_rows), (0, 0)))
        slot = np.pad(packed.text_index,
                      ((0, rows - packed.n_rows), (0, m - packed.max_segments)),
                      constant_values=-1)
        if self.slot_offset:
            slot = np.where(slot >= 0, slot + self.slot_offset, slot)
        return {
            "input_ids": ids,
            "segment_ids": seg,
            "slot_index": slot,
            # carries the number of texts (the scatter's output rows) by its shape
            "slots": np.arange(len(seqs), dtype=np.int32),
        }


class PackedContrastiveCollator:
    """The contrastive collator with packed blocks: the same example sampling
    (:meth:`ContrastiveCollator.sample`, one seeded RNG), but the query and
    passage blocks come out packed, with a slot table that maps each
    segment back to its batch position (``train/steps.py``)."""

    def __init__(
        self,
        pad_token_id: int = 0,
        num_negatives: int = 5,
        max_query_length: int = 512,
        max_passage_length: int = 512,
        query_max_segments: int = 16,
        passage_max_segments: int = 16,
        rows_multiple: int = 1,
        seed: int = 0,
    ):
        self._sampler = ContrastiveCollator(
            pad_token_id=pad_token_id, num_negatives=num_negatives,
            max_query_length=max_query_length, max_passage_length=max_passage_length,
            seed=seed,
        )
        self.num_negatives = num_negatives
        self._q = _BlockPacker(max_query_length, query_max_segments, pad_token_id,
                               rows_multiple)
        self._p = _BlockPacker(max_passage_length, passage_max_segments, pad_token_id,
                               rows_multiple)

    def __call__(self, rows) -> dict:
        queries, passages = self._sampler.sample(rows)
        return {"query": self._q(queries), "passage": self._p(passages)}

    def probe_needs(self, rows) -> tuple:
        """(query_rows, passage_rows) a batch like ``rows`` would need,
        sampled on a copy of the RNG, so the training stream is untouched."""
        queries, passages = copy.deepcopy(self._sampler).sample(rows)
        return self._q.probe_rows(queries), self._p.probe_rows(passages)

    def set_budgets(self, query_rows: int, passage_rows: int) -> tuple:
        """Fix both row budgets (see _BlockPacker)."""
        return self._q.set_budget(query_rows), self._p.set_budget(passage_rows)

    def set_process_shard(self, process_index: int, batch_rows_local: int):
        """Point the slot tables at global batch positions: process k's
        queries are slots [k B, (k + 1) B), its passages from k B (1 + n)."""
        self._q.slot_offset = process_index * batch_rows_local
        self._p.slot_offset = process_index * batch_rows_local * (1 + self.num_negatives)


def _rankpo_texts(rows):
    """(queries, passages) with the chosen/rejected interleave: passage
    slot 2i is row i's chosen, 2i + 1 its rejected."""
    queries = [row["query"] for row in rows]
    passages = []
    for row in rows:
        passages.append(row["chosen"])
        passages.append(row["rejected"])
    return queries, passages


class PackedRankPOCollator:
    """The RankPO collator with packed blocks; the slot table keeps the
    chosen/rejected interleave, so the loss's [B, 2] scores are unchanged."""

    def __init__(
        self,
        pad_token_id: int = 0,
        max_query_length: int = 512,
        max_passage_length: int = 512,
        query_max_segments: int = 16,
        passage_max_segments: int = 16,
        rows_multiple: int = 1,
    ):
        self._q = _BlockPacker(max_query_length, query_max_segments, pad_token_id,
                               rows_multiple)
        self._p = _BlockPacker(max_passage_length, passage_max_segments, pad_token_id,
                               rows_multiple)

    def __call__(self, rows) -> dict:
        for key in ("query", "chosen", "rejected"):
            if key not in rows[0]:
                raise KeyError(f"key '{key}' is missing from batch rows")
        queries, passages = _rankpo_texts(rows)
        return {"query": self._q(queries), "passage": self._p(passages)}

    def probe_needs(self, rows) -> tuple:
        queries, passages = _rankpo_texts(rows)
        return self._q.probe_rows(queries), self._p.probe_rows(passages)

    def set_budgets(self, query_rows: int, passage_rows: int) -> tuple:
        return self._q.set_budget(query_rows), self._p.set_budget(passage_rows)

    def set_process_shard(self, process_index: int, batch_rows_local: int):
        self._q.slot_offset = process_index * batch_rows_local
        self._p.slot_offset = process_index * batch_rows_local * 2


def sync_packed_budgets(collator, sample_rows, *, slack: float = 0.25):
    """Agree on FIXED packed row budgets across the processes of the
    ``torch.distributed`` group (JAX ``packing.py:391-414``): each process
    probes its packing need on ``sample_rows`` (a local-batch-sized
    sample), the needs are all-gathered (ONE collective, on the main thread
    before the training loop: a collective on the loader's thread could
    interleave with the step's and deadlock the ranks), and every process
    fixes its budgets to the global max plus ``slack``. Rare overflow then
    truncates to fit locally (``_BlockPacker``). Returns the (query_rows,
    passage_rows) fixed. Without a group the needs are this process's."""
    import torch.distributed as dist

    needs = tuple(int(x) for x in collator.probe_needs(sample_rows))
    if dist.is_available() and dist.is_initialized():
        all_needs = [None] * dist.get_world_size()
        dist.all_gather_object(all_needs, needs)
    else:
        all_needs = [needs]
    q_need, p_need = (max(n[i] for n in all_needs) for i in range(2))
    return collator.set_budgets(
        q_need + max(1, int(q_need * slack)),
        p_need + max(1, int(p_need * slack)),
    )


def configure_multiprocess_packing(collator, dataset, local_batch_rows: int, *,
                                   slack: float = 0.25):
    """The data-parallel packed-training bring-up both CLIs share (JAX
    ``packing.py:417-427``): probe a local-batch-sized sample of the
    dataset and fix the row budgets by :func:`sync_packed_budgets`. Call
    from the MAIN thread before training. Returns the fixed (query_rows,
    passage_rows)."""
    probe = [dataset[i] for i in range(min(local_batch_rows, len(dataset)))]
    return sync_packed_budgets(collator, probe, slack=slack)
