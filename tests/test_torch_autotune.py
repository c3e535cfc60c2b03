"""The index auto-tuner (``tools/autotune.py``, ``cli/autotune.py``) on the
CPU against the JAX package's (after tests/test_autotune.py): the same
default ladder, the same recall for every spec on the same embeddings and
queries (exact flat and int8 flat storage: their hits are the JAX index's
outside near-ties, so recall within 1/(Q k) of a hit or two), the memory
column and budget filter, bad specs reported, and the CLI's synthetic
corpus bit-equal to the JAX CLI's. At W = 2 (two gloo processes,
``torch_serve_workers.autotune_worker``) every tier of a ladder with PQ,
OPQ and the hybrid shards over the group: both ranks return the same
report (the same ``best``), and each spec's memory equals the one-process
ladder's (the cluster counts are even, so both build the same shapes)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from rankpo_tpu.cli import autotune as jcli
from rankpo_tpu.index import parse_index_spec as jax_parse
from rankpo_tpu.tools import autotune_index as jax_autotune
from rankpo_tpu.tools import default_specs as jax_default_specs
from rankpo_tpu_torch.cli import autotune as cli
from rankpo_tpu_torch.index.factory import parse_index_spec
from rankpo_tpu_torch.tools.autotune import autotune_index, default_specs

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_workers as workers  # noqa: E402
import torch_serve_workers as sw  # noqa: E402

torch.set_num_threads(2)


def _unit_rows(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,dim", [(1000, 64), (100_000, 1024), (4096, 48), (65536, 2048)])
def test_default_ladder_matches_jax(n, dim):
    specs = default_specs(n, dim)
    assert specs == jax_default_specs(n, dim)
    for s in specs:
        assert parse_index_spec(s)[0] == jax_parse(s)[0]
    assert ("IVF,Flat" in specs) == (n >= 4096)


def test_report_matches_jax():
    """Flat exact (recall 1.0) and SQ8 on the same rows and self-queries:
    the same recall column as the JAX report, int8 a quarter of the fp32
    memory, the table ranked by queries/s and JSON-serialisable."""
    emb = _unit_rows(512, 64)
    kw = dict(k=10, recall_target=0.95, n_queries=32, repeats=1, specs=["Flat", "SQ8", "SQbf16"])
    report = autotune_index(emb, device="cpu", **kw)
    ref = jax_autotune(emb, **kw)
    by_spec = {r["spec"]: r for r in report["results"]}
    ref_spec = {r["spec"]: r for r in ref["results"]}
    assert by_spec["Flat"]["recall"] == 1.0 and by_spec["Flat"]["feasible"]
    for spec in ("Flat", "SQ8", "SQbf16"):
        assert abs(by_spec[spec]["recall"] - ref_spec[spec]["recall"]) <= 2 / 320, spec
        # JAX also counts its 4-byte device scalar of the row count
        assert by_spec[spec]["memory_mb"] == pytest.approx(ref_spec[spec]["memory_mb"],
                                                           abs=0.011), spec
    assert by_spec["SQ8"]["memory_mb"] < by_spec["Flat"]["memory_mb"] / 3
    assert report["best"] in ("Flat", "SQ8", "SQbf16")
    qps = [r["qps"] for r in report["results"] if "qps" in r]
    assert qps == sorted(qps, reverse=True)
    assert {k: report[k] for k in ("k", "recall_target", "n", "dim", "n_queries")} == {
        k: ref[k] for k in ("k", "recall_target", "n", "dim", "n_queries")}
    json.dumps(report)


def test_memory_budget_filters():
    emb = _unit_rows(512, 64)
    report = autotune_index(emb, k=10, recall_target=0.0, n_queries=16, repeats=1,
                            specs=["Flat", "SQ8"], device="cpu",
                            memory_budget_gb=0.3 * 512 * 64 * 4 / (1 << 30))
    by_spec = {r["spec"]: r for r in report["results"]}
    assert not by_spec["Flat"]["feasible"] and by_spec["SQ8"]["feasible"]
    assert report["best"] == "SQ8"


def test_bad_spec_reported_not_raised():
    emb = _unit_rows(256, 48)
    report = autotune_index(emb, k=5, n_queries=8, repeats=1, specs=["Flat", "IVF4,PQ7"],
                            device="cpu")
    by_spec = {r["spec"]: r for r in report["results"]}
    assert "error" in by_spec["IVF4,PQ7"]
    assert by_spec["Flat"]["recall"] == 1.0 and report["best"] == "Flat"


def test_ivf_and_refine_rows_in_the_report():
    emb = _unit_rows(4096, 32, seed=2)
    report = autotune_index(emb, k=10, n_queries=32, repeats=1, device="cpu",
                            specs=["PCA16,Flat", "IVF16,Flat", "IVF16,SQ8"])
    for row in report["results"]:
        assert "error" not in row and 0.0 <= row["recall"] <= 1.0, row
        assert row["memory_mb"] > 0 and row["build_s"] >= 0


def test_cli_synthetic(capsys, tmp_path):
    """The synthetic corpus is the JAX CLI's, bit for bit; the CLI prints
    its report as the last line and writes it to --output_file."""
    np.testing.assert_array_equal(cli._synthetic(300, 32, 4), jcli._synthetic(300, 32, 4))
    out = tmp_path / "report.json"
    report = cli.main(["--synthetic_rows", "512", "--synthetic_dim", "64", "--k", "10",
                       "--n_queries", "16", "--specs", "Flat;SQ8", "--device", "cpu",
                       "--output_file", str(out)])
    assert report["best"] is not None
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == report == json.loads(out.read_text())
    with pytest.raises(SystemExit):
        cli.main(["--synthetic_rows", "8", "--embeddings", "x.npy", "--device", "cpu"])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("autotune_w2"))
    emb = _unit_rows(4096, 32, seed=5)
    np.save(os.path.join(out, "emb.npy"), emb)
    workers.spawn(sw.autotune_worker, 2, out, timeout=240.0)
    return out, emb, [workers.load(out, f"autotune_{r}.pt") for r in range(2)]


def test_autotune_at_two_ranks_matches_one_process(two_ranks):
    """Both ranks' reports are the same (times are the slowest rank's), every
    spec of the ladder built and searched, and each spec's memory is the
    one-process ladder's (the sum over the ranks, a replicated codebook,
    rotation or basis counted once)."""
    _, emb, ranks = two_ranks
    got = ranks[0]["tool"]
    assert ranks[1]["tool"] == got and got["best"] is not None
    one = autotune_index(emb, specs=sw.AUTOTUNE_SPECS, device="cpu", **sw.AUTOTUNE_KW)
    mem = {r["spec"]: r["memory_mb"] for r in one["results"]}
    for row in got["results"]:
        assert "error" not in row and 0.0 <= row["recall"] <= 1.0, row
        assert row["memory_mb"] == mem[row["spec"]], row["spec"]
    assert {r["spec"] for r in got["results"]} == set(sw.AUTOTUNE_SPECS)


def test_cli_autotune_at_two_ranks(two_ranks):
    """``cli.autotune`` joins the process group: both ranks return the same
    report, and rank 0 alone writes ``--output_file``."""
    out, _, ranks = two_ranks
    assert ranks[1]["cli"] == ranks[0]["cli"] and ranks[0]["cli"]["best"] is not None
    with open(os.path.join(out, "report_0.json")) as f:
        assert json.loads(f.read()) == ranks[0]["cli"]
    assert not os.path.exists(os.path.join(out, "report_1.json"))


@pytest.mark.parametrize("spec", ["Flat", "SQ8", "PCA16,Flat", "IVF8,PQ8", "OPQ8,IVF8,PQ8",
                                  "PCA16,IVF8,SQbf16"])
def test_nbytes_counts_every_tensor_in_one_process(spec):
    """The memory column is the index's ``nbytes()``: in one process the
    bytes of every tensor it holds, the ones a group would hold whole
    (``_replicated``) included."""
    from rankpo_tpu_torch.index.factory import build_offline_index

    emb = torch.from_numpy(_unit_rows(1024, 32, seed=6))
    index_type, kwargs = parse_index_spec(spec)
    index = build_offline_index(emb, len(emb), index_type, kwargs, 0.9)
    tensors = [v for v in vars(index).values() if isinstance(v, torch.Tensor)]
    assert index.nbytes() == sum(t.numel() * t.element_size() for t in tensors) > 0
    assert all(isinstance(getattr(index, name), (torch.Tensor, type(None)))
               for name in index._replicated)
