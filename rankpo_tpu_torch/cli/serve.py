"""HTTP retrieval server over a flat, refine or IVF index (port of
``rankpo_tpu.cli.serve``).

    python -m rankpo_tpu_torch.cli.serve --model_name_or_path CKPT \\
        --tokenizer_name hash:128256 --corpus_data corpus.jsonl --device cuda \\
        [--index_type SQ8 | --recall_target 0.95 | --index_type ivf |
         --index_type IVF4096,PQ64 | --index_type refine --refine_dim 256] \\
        [--stable_ids] [--index_file index.npz [--autosave]] \
        [--pack_queries [--pack_max_segments 16]]

POST /search {"queries": ["..."], "k": 10[, "nprobe": 8][, "candidates": 512]
              [, "allowed_ids": [...] | "disallowed_ids": [...]]}
    -> {"results": [...]}
POST /add    {"passages": ["..."][, "ids": [...]]} -> extends the index
POST /remove {"ids": [...]} -> drops passages (FAISS renumbering, or
             external ids under --stable_ids)
POST /save   [{"path": "..."}] -> persists the live index
GET  /healthz -> {"status": "ok", "ntotal": N}
GET  /statsz  -> serving counters

The flags keep the JAX CLI's names. ``--index_file`` loads the index from
that file when it exists (no corpus encode, no build) and otherwise builds
from ``--corpus_data`` and saves it there. ``--pack_queries`` packs each
group's queries several to a row (``--pack_max_segments`` at most), with
block-diagonal attention.

Over W processes every rank runs this CLI with the same flags plus
``--coordinator_address host:port --num_processes W --process_id r`` (one
card per rank under NCCL, or gloo with ``--device cpu``): the flat or
refine index is row-sharded over the ranks, each encoding its own shard of
the corpus. Rank 0 serves HTTP through ``serve/multihost.py``'s frontend,
which replays every request on the other ranks; they exit 0 when rank 0
stops (shutdown or SIGTERM). An IVF index over several processes is not
ported (ROADMAP.md Queue 1, the rest of item 8c) and fails at parse time.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from rankpo_tpu_torch.cli.arguments import DistributedArguments
from rankpo_tpu_torch.core import mesh
from rankpo_tpu_torch.core.device import resolve_device
from rankpo_tpu_torch.data.datasets import load_eval_corpus
from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
from rankpo_tpu_torch.index.encoding import InferenceEncoder
from rankpo_tpu_torch.index.io import MULTI_CARD_IVF
from rankpo_tpu_torch.models.hf_io import load_pretrained
from rankpo_tpu_torch.serve.batching import MicroBatcher
from rankpo_tpu_torch.serve.multihost import MultihostFrontend
from rankpo_tpu_torch.serve.service import RetrievalService, finalize_hits, resolve_tier

logger = logging.getLogger(__name__)

_INDEX_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def make_handler(service: RetrievalService, batcher=None, k_max: int = 100,
                 index_file: str | None = None, autosave: bool = False):
    """``service``: the RetrievalService, or over several processes rank
    0's MultihostFrontend (the same surface). ``batcher``: a MicroBatcher;
    single-query requests route through it so concurrent clients share
    device work. Every path searches at ``k_max`` and slices to the
    client's k. ``index_file``: the default target of POST /save and of
    ``autosave``, which persists the index after every successful /add and
    /remove (the reply waits for the save)."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "ntotal": service.ntotal})
            elif self.path == "/statsz":
                stats = {"ntotal": service.ntotal, "k_max": k_max}
                if batcher is not None:
                    n_d = batcher.n_dispatches
                    stats.update(
                        microbatch_dispatches=n_d,
                        microbatch_queries=batcher.n_queries,
                        avg_group_size=round(batcher.n_queries / n_d, 2)
                        if n_d else None,
                    )
                self._reply(200, stats)
            else:
                self._reply(404, {"error": "not found"})

        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length)) if length else {}

        def _reply_mutated(self, extra: dict) -> None:
            """The reply to a mutation that already committed. A failed
            autosave answers 500 with ``mutated`` true: the mutation stands,
            and a client must not retry it."""
            payload = {"status": "ok", "ntotal": service.ntotal, **extra}
            if autosave and index_file:
                try:
                    service.save_index(index_file)
                    payload["saved"] = index_file
                except Exception as e:
                    self._reply(500, {"error": f"autosave failed: {e}", "mutated": True,
                                      "ntotal": service.ntotal, **extra})
                    return
            self._reply(200, payload)

        def do_POST(self):
            if self.path == "/add":
                # FAISS add: encode and extend the live index; searches in
                # flight finish on the old one (the state swaps atomically)
                try:
                    req = self._body()
                    service.add_passages(req["passages"], ids=req.get("ids"))
                except Exception as e:
                    self._reply(400, {"error": str(e)})
                    return
                self._reply_mutated({})
                return
            if self.path == "/remove":
                # FAISS remove_ids: by corpus position (the rest shift down),
                # or by external id under --stable_ids
                try:
                    removed = service.remove_passages(self._body()["ids"])
                except Exception as e:
                    self._reply(400, {"error": str(e)})
                    return
                self._reply_mutated({"removed": removed})
                return
            if self.path == "/save":
                # FAISS write_index of the live index, mutations included;
                # the body may name {"path": ...}, else --index_file
                try:
                    path = self._body().get("path") or index_file
                    if not path:
                        raise ValueError("no save target: pass {'path': ...} or start "
                                         "the server with --index_file")
                    service.save_index(path)
                    self._reply(200, {"status": "ok", "saved": path,
                                      "ntotal": service.ntotal})
                except Exception as e:
                    self._reply(400, {"error": str(e)})
                return
            if self.path != "/search":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                queries = req.get("queries")
                if queries is None and "query" in req:
                    queries = [req["query"]]  # single-query sugar
                if not isinstance(queries, list) or not all(
                    isinstance(q, str) for q in queries
                ):
                    self._reply(400, {
                        "error": "body must carry 'queries': [str, ...] "
                                 "(or 'query': str)"
                    })
                    return
                k = int(req.get("k", 10))
                if k > k_max:
                    self._reply(400, {
                        "error": f"k={k} exceeds serving k_max={k_max} "
                                 "(start the server with --serving_k_max)"
                    })
                    return
                # FAISS SearchParameters: IDSelector filters (external ids
                # under --stable_ids, corpus positions otherwise) and a
                # per-call nprobe or candidates are per REQUEST: such
                # requests bypass the micro-batcher, whose grouped dispatch
                # shares one search
                sel = {key: req[key] for key in ("allowed_ids", "disallowed_ids")
                       if req.get(key) is not None}
                sel.update({key: int(req[key]) for key in ("nprobe", "candidates")
                            if req.get(key) is not None})
                if batcher is not None and len(queries) == 1 and not sel:
                    results = [batcher.query(queries[0], k=k)]
                else:
                    k_eff = min(k_max, service.ntotal or k_max)
                    results = [
                        finalize_hits(r, k)
                        for r in service.query(queries, k=k_eff,
                                               return_passages=True, **sel)
                    ]
                self._reply(200, {"results": results})
            except Exception as e:  # a request boundary: report, keep serving
                logger.exception("search failed")
                self._reply(400, {"error": str(e)})

        def log_message(self, fmt, *args):
            logger.info("%s - %s", self.address_string(), fmt % args)

    return Handler


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="rankpo_tpu_torch.cli.serve")
    parser.add_argument("--model_name_or_path", required=True)
    parser.add_argument("--tokenizer_name", default=None,
                        help="'hash:<vocab>' for the hermetic tokenizer")
    parser.add_argument("--corpus_data", default=None,
                        help='jsonl corpus, {"text": ...} per line; optional when '
                             "--index_file exists")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' fails when no card is visible")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max_query_length", type=int, default=512)
    parser.add_argument("--max_passage_length", type=int, default=512)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--recall_target", type=float, default=1.0,
                        help="< 1: the flat tier's approximate top-k; the "
                             "refine/ivf tiers' build-time tune target (1.0 "
                             "tunes to 0.95)")
    parser.add_argument("--index_dtype", default="float32",
                        choices=["float32", "bfloat16", "int8"],
                        help="row storage: fp32 / bf16 (half the memory) / int8 "
                             "(a quarter; flat and ivf)")
    parser.add_argument("--index_type", default="flat",
                        help="flat = exact brute force (FAISS IndexFlatIP "
                             "parity); refine = two-stage PCA prefilter + "
                             "exact rerank; ivf = clustered inverted-file "
                             "probing (both approximate, tuned to "
                             "--recall_target); or a FAISS "
                             "index_factory-style spec, e.g. 'IVF4096,PQ64' "
                             "or 'PCA128,Flat' (the spec then supplies the "
                             "tier's knobs and the --refine_*/--ivf_* flags "
                             "are ignored)")
    parser.add_argument("--refine_dim", type=int, default=256,
                        help="refine index stage-1 PCA dimension")
    parser.add_argument("--refine_candidates", default="auto",
                        help="refine rerank candidate count, or 'auto' to "
                             "tune at build time against --recall_target")
    parser.add_argument("--ivf_clusters", default="auto",
                        help="ivf cluster count, or 'auto' (~4*sqrt(N))")
    parser.add_argument("--ivf_nprobe", default="auto",
                        help="ivf probed clusters per query, or 'auto' to "
                             "tune at build time against --recall_target")
    parser.add_argument("--ivf_pq_m", type=int, default=0,
                        help="> 0 stores residual product-quantization codes "
                             "(this many uint8 per row) instead of rows")
    parser.add_argument("--ivf_pq_rotate", default="none",
                        choices=("none", "random", "opq"),
                        help="orthogonal pre-rotation for the PQ codec; "
                             "requires --ivf_pq_m")
    parser.add_argument("--ivf_reduced_dim", type=int, default=0,
                        help="> 0 enables the IVF+PCA hybrid: probed rows "
                             "score in this projected dimension, the top "
                             "candidates rerank at full width")
    parser.add_argument("--ivf_candidates", default="auto",
                        help="hybrid rerank pool size, or 'auto' (~2k)")
    parser.add_argument("--ivf_balance_eta", type=float, default=0.0,
                        help="balanced k-means assignment-bias step for IVF "
                             "builds (0 = off)")
    parser.add_argument("--index_file", default=None,
                        help="persisted index (.npz): loaded if it exists, else "
                             "built from --corpus_data and saved here")
    parser.add_argument("--pack_queries", action="store_true",
                        help="sequence-pack each group's queries several to a row "
                             "of --max_query_length tokens (block-diagonal "
                             "attention); hits as unpacked")
    parser.add_argument("--pack_max_segments", type=int, default=16,
                        help="packing: max queries per packed row")
    parser.add_argument("--microbatch_wait_ms", type=float, default=3.0,
                        help="dynamic micro-batching window for concurrent "
                             "single-query requests; 0 disables")
    parser.add_argument("--microbatch_max", type=int, default=64)
    parser.add_argument("--serving_k_max", type=int, default=100,
                        help="all requests search once at this k and slice "
                             "to the client's k; requests above it get a 400")
    parser.add_argument("--stable_ids", action="store_true",
                        help="FAISS IndexIDMap analog: passages carry external "
                             "int64 ids that survive /remove; /add takes 'ids', "
                             "/remove and filters take external ids, hits gain "
                             "an 'id' field")
    parser.add_argument("--warmup", default="full",
                        choices=["full", "fast", "off"],
                        help="'full' and 'fast' both run one small pass that "
                             "builds the kernels before the first request")
    parser.add_argument("--rewarm_after_mutations", action="store_true",
                        help="/add and /remove replay the startup warmup before "
                             "they return")
    parser.add_argument("--autosave", action="store_true",
                        help="persist the index to --index_file after every "
                             "successful /add and /remove (the reply waits)")
    parser.add_argument("--mutation_headroom", type=float, default=0.25,
                        help="extra fraction of rows (or IVF slots) an /add "
                             "that outgrows the storage pre-pays for later adds")
    parser.add_argument("--log_level", default="info")
    # several processes: every rank runs this CLI with the same corpus or
    # index file; rank 0 binds HTTP, the others replay its dispatches
    parser.add_argument("--coordinator_address", default=None,
                        help="host:port of rank 0's rendezvous")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="processes of the server (one per card)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank, 0..num_processes-1")
    return parser


class Follower:
    """A rank other than 0 of a multi-process server: ``serve_forever``
    replays rank 0's dispatches (``MultihostFrontend.follower_loop``) until
    rank 0 stops; it binds no port."""

    batcher = None

    def __init__(self, frontend: MultihostFrontend):
        self.frontend = frontend
        self.service = frontend.service

    def serve_forever(self) -> None:
        self.frontend.follower_loop()

    def shutdown(self) -> None:
        pass

    def server_close(self) -> None:
        pass


def make_server(argv=None):
    """Parse flags, join the processes (if any), load the checkpoint, encode
    the corpus into the index and bind the HTTP server (not yet serving).
    The server carries ``service``, ``frontend`` (the service itself in one
    process) and ``batcher`` attributes. On a rank other than 0 of a
    multi-process server it returns a :class:`Follower`."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.autosave and not args.index_file:
        parser.error("--autosave needs --index_file as the save target")
    if args.index_file and not args.index_file.endswith(".npz"):
        # the writer appends .npz; without this a restart would never find
        # the file and would re-encode the corpus every time
        args.index_file += ".npz"
    restart = bool(args.index_file) and os.path.exists(args.index_file)
    if not restart and args.corpus_data is None:
        parser.error("--corpus_data is required unless --index_file points at an "
                     "existing persisted index")
    dtype = _INDEX_DTYPES[args.index_dtype]
    if args.index_type not in ("flat", "refine", "ivf") and args.index_dtype == "float32":
        # factory spec: its storage component (or the tier default) goes
        # through; a non-default --index_dtype still wins
        dtype = None
    def auto_or_int(flag):
        return "auto" if flag == "auto" else int(flag)

    index_kwargs = {}
    if args.index_type == "refine":
        index_kwargs["reduced_dim"] = args.refine_dim
        index_kwargs["candidates"] = auto_or_int(args.refine_candidates)
    elif args.index_type == "ivf":
        for key, flag in (("n_clusters", args.ivf_clusters), ("nprobe", args.ivf_nprobe)):
            index_kwargs[key] = auto_or_int(flag)
        if args.ivf_reduced_dim > 0:
            index_kwargs["reduced_dim"] = args.ivf_reduced_dim
            index_kwargs["candidates"] = auto_or_int(args.ivf_candidates)
        if args.ivf_pq_m > 0:
            index_kwargs["pq_m"] = args.ivf_pq_m
            if args.ivf_pq_rotate != "none":
                index_kwargs["pq_rotate"] = args.ivf_pq_rotate
        elif args.ivf_pq_rotate != "none":
            # fail loudly rather than build plain rows, 32x the memory of
            # the codec that was asked for
            parser.error("--ivf_pq_rotate requires --ivf_pq_m")
        if args.ivf_balance_eta:
            index_kwargs["balance_eta"] = args.ivf_balance_eta
    if args.ivf_balance_eta and args.index_type != "ivf":
        parser.error("--ivf_balance_eta requires --index_type ivf")
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    resolve_device(args.device)  # before anything loads: no CPU fallback
    service_kw = dict(recall_target=args.recall_target, index_dtype=dtype,
                      index_type=args.index_type, index_kwargs=index_kwargs)
    try:  # the tier's checks, before the checkpoint loads
        tier = resolve_tier(args.index_type, dtype, index_kwargs)[0]
    except ValueError as e:
        parser.error(f"--index_type {args.index_type}: {e}")
    if tier == "ivf" and (args.num_processes or 1) > 1:
        parser.error(f"--index_type {args.index_type}: "
                     + MULTI_CARD_IVF.format(args.num_processes))
    # this rank's card; an NCCL bring-up that fails raises
    device, group = DistributedArguments(args.coordinator_address, args.num_processes,
                                         args.process_id).join(args.device)
    config, state = load_pretrained(args.model_name_or_path)
    tokenizer = resolve_tokenizer(args.tokenizer_name, args.model_name_or_path)
    encoder = InferenceEncoder(config, state, tokenizer, device=device)
    del state
    service = RetrievalService(
        encoder, max_query_length=args.max_query_length, stable_ids=args.stable_ids,
        rewarm_after_mutation=args.rewarm_after_mutations,
        mutation_headroom=args.mutation_headroom, pack_queries=args.pack_queries,
        pack_max_segments=args.pack_max_segments, group=group, **service_kw)
    if restart:
        service.load_index_file(args.index_file)  # no corpus encode, no build
    else:
        service.build_index(
            load_eval_corpus(args.corpus_data),
            max_passage_length=args.max_passage_length, batch_size=args.batch_size,
        )
        if args.index_file:
            service.save_index(args.index_file)
    frontend = service
    shutdown = []  # the server, once bound: a failed rank shuts it down
    if group is not None:  # every request runs on every rank
        frontend = MultihostFrontend(service, on_failure=lambda: [
            threading.Thread(target=s.shutdown, daemon=True).start() for s in shutdown])
        if mesh.process_index() != 0:
            return Follower(frontend)
    if args.warmup != "off":
        frontend.warmup(k=args.serving_k_max)
    batcher = None
    if args.microbatch_wait_ms > 0:
        batcher = MicroBatcher(
            frontend, max_batch=args.microbatch_max,
            max_wait_ms=args.microbatch_wait_ms, k_max=args.serving_k_max,
        )
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(frontend, batcher, k_max=args.serving_k_max,
                     index_file=args.index_file, autosave=args.autosave),
    )
    server.service = service
    server.frontend = frontend
    server.batcher = batcher
    shutdown.append(server)
    logger.info("serving %d passages on %s:%d (%s, torch %s)", service.ntotal,
                args.host, server.server_address[1], device, torch.__version__)
    return server


def main(argv=None):
    server = make_server(argv)
    if threading.current_thread() is threading.main_thread():
        # SIGTERM ends serving as a shutdown does: rank 0 then releases the
        # other ranks, and every process exits 0
        signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
            target=server.shutdown, daemon=True).start())
    try:
        server.serve_forever()
    finally:
        if server.batcher is not None:
            server.batcher.close()
        frontend = getattr(server, "frontend", None)
        if isinstance(frontend, MultihostFrontend):
            frontend.stop()
        server.server_close()
    if isinstance(frontend, MultihostFrontend) and frontend.failure is not None:
        raise RuntimeError("multi-process serving stopped: a rank is gone") from frontend.failure


if __name__ == "__main__":
    main()
