"""The IVF tuner's recall on the smoke's own embeddings, the JAX package's
index beside the port's, on the CPU: is a recall that falls short of the
tuned target the data's or the port's?

    python3 scripts/ivf_recall_witness.py --dump DIR      # on the card
    python3 scripts/ivf_recall_witness.py --rows DIR      # on the CPU

``--dump`` (the card; no JAX) makes what the smoke's W = 2 spawn indexes:
the FEATURE_LAYERS cut of the random-weight Llama-3.2-1B checkpoint from
seed 0, its 4096 serving passages encoded in two halves as the two ranks'
shards are (``encode_device`` of each half, batches of 64, 512 positions:
the smoke holds the ranks' shards bit-equal to this) and the 256 span
queries as ``cli.evaluate`` encodes them (64 positions). It writes
``rows.npy`` [4096, 2048] and ``queries.npy`` [256, 2048] fp32 to DIR.

Without ``--dump`` (the CPU; it imports JAX and the port side by side, as
the tests do) it builds each of ``IVF64,PQ64``, ``OPQ64,IVF64,PQ64`` and
``PCA256,IVF64,SQbf16`` at recall target 0.95 three times on those rows:
the JAX package's ``IVFIPIndex`` on one device and ``from_sharded`` on a
2-device data mesh (the smoke's W = 2 build), and the port's on one
process. For each it prints the tuned knobs (clusters, capacity, nprobe a
shard, the hybrid's candidates a shard) and recall@100 against the index's
own exact search at storage precision (near-ties within 1e-5 of the 100th
score counted, as the smoke counts them): on the span queries, on the
tuner's own pseudo-queries (256 corpus rows drawn by
``default_rng(1)``, as the smoke draws them), and with every cluster
probed (the hybrid reranking every probed slot); the hybrid on one device
also at twice its candidates, what the two shards of a mesh rerank in all
(each picks its own max(2k, 128)). About ten minutes on 8 CPU cores.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = ("IVF64,PQ64", "OPQ64,IVF64,PQ64", "PCA256,IVF64,SQbf16")
RECALL_TARGET = 0.95
K = 100
SCORE_ATOL = 1e-5
TUNE_SEED = 1


def dump(out_dir: str) -> None:
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from rankpo_tpu_torch.data.datasets import load_eval_corpus, load_eval_queries
    from rankpo_tpu_torch.data.tokenization import resolve_tokenizer
    from rankpo_tpu_torch.index.encoding import InferenceEncoder

    os.makedirs(out_dir, exist_ok=True)
    cs.phase_build()
    with tempfile.TemporaryDirectory(prefix="ivf_witness_") as tmp:
        ckpt, _ = cs.make_model_checkpoint(tmp, 0, "llama-3.2-1b", cs.FEATURE_LAYERS, False)
        corpus, corpus_file, _ = cs._serving_data(0, tmp)
        query_file, _, _ = cs.write_eval_queries(tmp, 0, corpus)
        queries, _ = load_eval_queries(query_file)
        texts = load_eval_corpus(corpus_file)
        encoder = InferenceEncoder.from_pretrained(
            ckpt, tokenizer=resolve_tokenizer("hash:128256", ckpt), device="cuda",
            compute_dtype=torch.bfloat16)
        half = len(texts) // 2
        rows = torch.cat([encoder.encode_device(texts[r * half:(r + 1) * half], batch_size=64,
                                                max_length=512)[0][:half].cpu()
                          for r in range(2)])
        q = encoder.encode(list(queries), batch_size=64, max_length=64)
    np.save(os.path.join(out_dir, "rows.npy"), rows.numpy().astype(np.float32))
    np.save(os.path.join(out_dir, "queries.npy"), np.asarray(q, np.float32))
    print(f"wrote rows {tuple(rows.shape)} and queries {tuple(np.shape(q))} to {out_dir}")


def recall(idx: np.ndarray, exact_s: np.ndarray, exact_i: np.ndarray) -> float:
    """Share of returned ids whose exact score (from the exact search's own
    list; outside it, -inf) clears its 100th score less SCORE_ATOL."""
    hit = []
    for r, row in enumerate(idx):
        lookup = dict(zip(exact_i[r].tolist(), exact_s[r].tolist()))
        scores = np.array([lookup.get(int(i), -np.inf) for i in row])
        hit.append(scores >= exact_s[r, K - 1] - SCORE_ATOL)
    return float(np.mean(np.concatenate(hit)))


def measure(index, q: np.ndarray, q_rows: np.ndarray, local: int, cap: int,
            twice: bool) -> dict:
    """Recalls on the span queries, the tuner's rows and every cluster
    probed; with ``twice`` (the hybrid on one device) also the span
    queries' at twice the candidates, what two shards rerank in all."""
    out = {}
    for name, queries in (("span", q), ("rows", q_rows)):
        e_s, e_i = (np.asarray(a) for a in index.exact_search(queries, k=K + 1))
        got = np.asarray(index.search(queries, k=K, batch_size=64)[1])
        out[name] = recall(got, e_s, e_i)
        if name == "span":
            full = np.asarray(index.search(queries, k=K, batch_size=64, nprobe=local,
                                           candidates=local * cap)[1])
            out["full"] = recall(full, e_s, e_i)
            if twice:
                c2 = 2 * index._effective_candidates(K, None)
                got = np.asarray(index.search(queries, k=K, batch_size=64, candidates=c2)[1])
                out["twice"] = recall(got, e_s, e_i)
    return out


def compare(rows_dir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    import jax.numpy as jnp
    import torch

    sys.path.insert(0, REPO)
    from rankpo_tpu.core.mesh import MeshConfig, make_mesh
    from rankpo_tpu.index import factory as jfactory
    from rankpo_tpu.index import ivf as jivf
    from rankpo_tpu_torch.index import factory as pfactory
    from rankpo_tpu_torch.index import ivf as pivf

    rows = np.load(os.path.join(rows_dir, "rows.npy"))
    q = np.load(os.path.join(rows_dir, "queries.npy"))
    q_rows = rows[np.random.default_rng(TUNE_SEED).choice(len(rows), pivf.TUNE_SAMPLE,
                                                           replace=False)]
    mesh2 = make_mesh(MeshConfig(data_parallel=2), devices=jax.devices()[:2])
    print(f"rows {rows.shape}, span queries {q.shape}, tuner's pseudo-queries {q_rows.shape}; "
          f"recall@{K} against each index's own exact search at storage precision")
    for spec in SPECS:
        jkw = dict(jfactory.parse_index_spec(spec)[1], recall_target=RECALL_TARGET)
        pkw = dict(pfactory.parse_index_spec(spec)[1], recall_target=RECALL_TARGET)
        builds = (
            ("JAX, one device", lambda: jivf.IVFIPIndex(rows, **jkw)),
            ("JAX, 2-device mesh", lambda: jivf.IVFIPIndex.from_sharded(
                jnp.asarray(rows), len(rows), mesh2, **jkw)),
            ("port, one process", lambda: pivf.IVFIPIndex(torch.from_numpy(rows), **pkw)),
        )
        for name, build in builds:
            t0 = time.perf_counter()
            index = build()
            built = time.perf_counter() - t0
            local = getattr(index, "local_clusters", index.n_clusters)
            hybrid = index.reduced_dim is not None
            got = measure(index, q, q_rows, local, index.capacity,
                          hybrid and local == index.n_clusters)
            print(f"{spec:<22} {name:<19} K {index.n_clusters} ({local} a shard), cap "
                  f"{index.capacity}, nprobe {index.nprobe} a shard"
                  + (f", candidates {index._effective_candidates(K, None)} a shard"
                     if hybrid else "")
                  + f"; recall span {got['span']:.4f}, tuner's rows {got['rows']:.4f}, every "
                  f"cluster {got['full']:.4f}"
                  + (f", span at twice the candidates {got['twice']:.4f}" if "twice" in got
                     else "")
                  + f"; build {built:.1f} s", flush=True)
            del index


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--dump", help="write rows.npy and queries.npy here (the card)")
    group.add_argument("--rows", help="read rows.npy and queries.npy from here (the CPU)")
    args = ap.parse_args()
    if args.dump:
        dump(args.dump)
    else:
        compare(args.rows)


if __name__ == "__main__":
    main()
