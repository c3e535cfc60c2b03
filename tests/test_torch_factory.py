"""The port's index factory grammar (``rankpo_tpu_torch.index.factory``)
against the JAX package's: the same (index_type, kwargs) for every spelling,
storage dtypes compared by name, and the same errors."""

import numpy as np
import pytest
import torch

from rankpo_tpu.index.factory import parse_index_spec as jax_parse
from rankpo_tpu.index.factory import resolve_index_spec as jax_resolve
from rankpo_tpu_torch.index.factory import parse_index_spec, resolve_index_spec

SPECS = [
    "Flat", "flat", "SQ8", "SQbf16", "SQfp16", "PCA128,Flat", "PCAR64,Flat",
    "PCAW32,Flat", "IVF4096,Flat", "IVF,Flat", "IVF1024,SQ8", "IVF64,SQbf16",
    "IVF4096,PQ64", "OPQ64,IVF4096,PQ64", "RR64,IVF4096,PQ64", "OPQ,IVF16,PQ8",
    "RR,IVF16,PQ8", "PCA128,IVF4096,Flat", " ivf64 , pq8 ", "PCA64,SQbf16",
]

ERRORS = [
    ("HNSW32", "unknown"), ("OPQ64,IVF16,Flat", "PQ<m>"),
    ("OPQ32,IVF16,PQ64", "!= PQ m"), ("PQ64", "IVF"), ("PCA64,SQ8", "int8"),
    ("IVF16,PQ8,SQ8", "SQ"), ("  ", "empty"), (",", "empty"), ("", "empty"),
    ("IVF16,IVF32,Flat", "duplicate"), ("SQ8,SQbf16", "duplicate"),
    ("OPQ8,RR8,IVF16,PQ8", "duplicate rotation"), ("PCA8,PCA16,Flat", "duplicate"),
    ("IVF8,PQ8,PQ16", "duplicate"),
]


def _names(kwargs):
    """Storage dtypes by name, so torch and jnp dtypes compare."""
    out = {}
    for key, value in kwargs.items():
        if isinstance(value, torch.dtype):
            value = str(value).replace("torch.", "")
        elif key in ("dtype", "store_dtype"):
            value = np.dtype(value).name
        out[key] = value
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_parse_matches_jax(spec):
    kind, kwargs = parse_index_spec(spec)
    j_kind, j_kwargs = jax_parse(spec)
    assert kind == j_kind
    assert _names(kwargs) == _names(j_kwargs)
    for key in ("dtype", "store_dtype"):
        if key in kwargs:
            assert kwargs[key] in (torch.int8, torch.bfloat16)


@pytest.mark.parametrize("spec,match", ERRORS)
def test_errors_match_jax(spec, match):
    with pytest.raises(ValueError, match=match) as port_err:
        parse_index_spec(spec)
    with pytest.raises(ValueError) as jax_err:
        jax_parse(spec)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("index_type,kwargs", [
    ("ivf", {"nprobe": 4}), ("flat", {}), ("refine", {"reduced_dim": 8}),
    ("IVF64,PQ8", {"n_clusters": 32}), ("IVF16,Flat", {"nprobe": 3}),
])
def test_resolve_passthrough_and_merge(index_type, kwargs):
    kind, got = resolve_index_spec(index_type, kwargs)
    j_kind, j_got = jax_resolve(index_type, kwargs)
    assert kind == j_kind and _names(got) == _names(j_got)
