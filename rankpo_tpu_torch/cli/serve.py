"""HTTP retrieval server over an exact flat index (port of
``rankpo_tpu.cli.serve``).

    python -m rankpo_tpu_torch.cli.serve --model_name_or_path CKPT \\
        --tokenizer_name hash:128256 --corpus_data corpus.jsonl --device cuda

POST /search {"queries": ["..."], "k": 10} -> {"results": [...]}
GET  /healthz -> {"status": "ok", "ntotal": N}
GET  /statsz  -> serving counters

The flags keep the JAX CLI's names. Flags of tiers and features the port
does not have yet are rejected with the ROADMAP.md item that will bring
them; /add, /remove and /save answer that they are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from rankpo_tpu_torch.data.datasets import load_eval_corpus
from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
from rankpo_tpu_torch.index.encoding import InferenceEncoder, resolve_device
from rankpo_tpu_torch.models.hf_io import load_pretrained
from rankpo_tpu_torch.serve.batching import MicroBatcher
from rankpo_tpu_torch.serve.service import RetrievalService, finalize_hits

logger = logging.getLogger(__name__)

_NOT_PORTED = "not ported to rankpo_tpu_torch yet (ROADMAP.md Queue 1, {})"

# flag -> (value that means "off", ROADMAP item that ports it)
_UNPORTED_FLAGS = {
    "index_type": ("flat", "index tiers"),
    "index_dtype": ("float32", "bf16/int8 flat storage"),
    "pack_queries": (False, "packed query encode"),
    "stable_ids": (False, "serving endpoints"),
    "index_file": (None, "index persistence"),
    "autosave": (False, "index persistence"),
    "rewarm_after_mutations": (False, "serving endpoints"),
    "coordinator_address": (None, "multi-host serving"),
    "num_processes": (None, "multi-host serving"),
    "process_id": (None, "multi-host serving"),
}


def make_handler(service: RetrievalService, batcher=None, k_max: int = 100):
    """``batcher``: a MicroBatcher; single-query requests route through it
    so concurrent clients share device work. Every path searches at
    ``k_max`` and slices to the client's k."""

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

        def do_POST(self):
            if self.path in ("/add", "/remove", "/save"):
                self._reply(501, {"error": f"{self.path} is " + _NOT_PORTED.format(
                    "serving endpoints")})
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
                unported = [key for key in ("allowed_ids", "disallowed_ids",
                                            "nprobe", "candidates")
                            if req.get(key) is not None]
                if unported:
                    self._reply(400, {"error": f"{unported} " + _NOT_PORTED.format(
                        "filtered search and per-call index knobs")})
                    return
                if batcher is not None and len(queries) == 1:
                    results = [batcher.query(queries[0], k=k)]
                else:
                    k_eff = min(k_max, service.ntotal or k_max)
                    results = [
                        finalize_hits(r, k)
                        for r in service.query(queries, k=k_eff,
                                               return_passages=True)
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
    parser.add_argument("--corpus_data", required=True,
                        help='jsonl corpus, {"text": ...} per line')
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cuda' fails when no card is visible")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max_query_length", type=int, default=512)
    parser.add_argument("--max_passage_length", type=int, default=512)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--recall_target", type=float, default=1.0,
                        help="only 1.0 (exact search) is ported")
    parser.add_argument("--index_dtype", default="float32",
                        choices=["float32", "bfloat16", "int8"],
                        help="only float32 is ported")
    parser.add_argument("--index_type", default="flat",
                        help="only flat (exact brute force) is ported")
    parser.add_argument("--index_file", default=None, help="not ported")
    parser.add_argument("--pack_queries", action="store_true", help="not ported")
    parser.add_argument("--microbatch_wait_ms", type=float, default=3.0,
                        help="dynamic micro-batching window for concurrent "
                             "single-query requests; 0 disables")
    parser.add_argument("--microbatch_max", type=int, default=64)
    parser.add_argument("--serving_k_max", type=int, default=100,
                        help="all requests search once at this k and slice "
                             "to the client's k; requests above it get a 400")
    parser.add_argument("--stable_ids", action="store_true", help="not ported")
    parser.add_argument("--warmup", default="full",
                        choices=["full", "fast", "off"],
                        help="'full' and 'fast' both run one small pass that "
                             "builds the kernels before the first request")
    parser.add_argument("--rewarm_after_mutations", action="store_true",
                        help="not ported")
    parser.add_argument("--autosave", action="store_true", help="not ported")
    parser.add_argument("--log_level", default="info")
    parser.add_argument("--coordinator_address", default=None, help="not ported")
    parser.add_argument("--num_processes", type=int, default=None, help="not ported")
    parser.add_argument("--process_id", type=int, default=None, help="not ported")
    return parser


def make_server(argv=None) -> ThreadingHTTPServer:
    """Parse flags, load the checkpoint, encode the corpus into the index and
    bind the HTTP server (not yet serving). The server carries ``service``
    and ``batcher`` attributes."""
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, (off, item) in _UNPORTED_FLAGS.items():
        if getattr(args, flag) != off:
            parser.error(f"--{flag} {getattr(args, flag)}: " + _NOT_PORTED.format(item))
    if args.recall_target < 1.0:
        parser.error("--recall_target < 1: approximate top-k is "
                     + _NOT_PORTED.format("index tiers"))
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    device = resolve_device(args.device)  # before any loading: no CPU fallback
    config, state = load_pretrained(args.model_name_or_path)
    tokenizer = resolve_tokenizer(args.tokenizer_name, args.model_name_or_path)
    encoder = InferenceEncoder(config, state, tokenizer, device=device)
    del state
    service = RetrievalService(encoder, max_query_length=args.max_query_length)
    service.build_index(
        load_eval_corpus(args.corpus_data),
        max_passage_length=args.max_passage_length, batch_size=args.batch_size,
    )
    if args.warmup != "off":
        service.warmup(k=args.serving_k_max)
    batcher = None
    if args.microbatch_wait_ms > 0:
        batcher = MicroBatcher(
            service, max_batch=args.microbatch_max,
            max_wait_ms=args.microbatch_wait_ms, k_max=args.serving_k_max,
        )
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(service, batcher, k_max=args.serving_k_max),
    )
    server.service = service
    server.batcher = batcher
    logger.info("serving %d passages on %s:%d (%s, torch %s)", service.ntotal,
                args.host, server.server_address[1], device, torch.__version__)
    return server


def main(argv=None):
    server = make_server(argv)
    try:
        server.serve_forever()
    finally:
        if server.batcher is not None:
            server.batcher.close()
        server.server_close()


if __name__ == "__main__":
    main()
