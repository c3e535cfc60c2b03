"""FAISS ``index_factory`` analog (port of ``rankpo_tpu.index.factory``):
one spec string -> (index_type, kwargs), with the same grammar and errors.

    Flat                  -> flat, fp32 rows (exact, FAISS-parity default)
    SQ8 / SQbf16          -> flat with int8 / bfloat16 storage
    PCA128,Flat           -> refine (PCA prefilter in d'=128 + exact rerank)
    IVF4096,Flat          -> ivf with 4096 clusters, bf16 storage
    IVF4096,SQ8           -> ivf with int8 storage
    IVF4096,PQ64          -> ivf + product-quantized residual codes (m=64)
    OPQ64,IVF4096,PQ64    -> same, with the OPQ learned rotation
    RR64,IVF4096,PQ64     -> same, with the seeded random rotation
    PCA128,IVF4096,Flat   -> ivf + PCA probe-scoring hybrid (reduced_dim)

Storage dtypes are torch dtypes (``torch.int8``, ``torch.bfloat16``).

``build_offline_index`` is the index step of the offline tools
(evaluation, mining, predictions; each resolves its spec first with
``resolve_index_spec``, before any encode), as their JAX versions build
it: the flat tier over fp32, bf16 or int8 rows, the refine tier
(``reduced_dim`` min(256, D) unless the kwargs name one) or an IVF index,
tuned to the tool's recall target under the caller's explicit kwargs.
"""

from __future__ import annotations

import re
from typing import Tuple

import torch

from rankpo_tpu_torch.core import mesh

_IVF = re.compile(r"^ivf(\d+)?$")
_PCA = re.compile(r"^pca(?:r|w)?(\d+)$")  # PCAR/PCAW accepted as PCA
_PQ = re.compile(r"^pq(\d+)$")
_OPQ = re.compile(r"^opq(\d+)?$")
_RR = re.compile(r"^rr(\d+)?$")
_SQ = re.compile(r"^sq(8|bf16|fp16)$")


def parse_index_spec(spec: str) -> Tuple[str, dict]:
    """Parse a factory string into ``(index_type, index_kwargs)``. Raises
    ValueError with a pointed message on unknown or inconsistent
    components."""
    if not spec or not spec.strip():
        raise ValueError("empty index factory spec")
    parts = [p.strip().lower() for p in spec.split(",") if p.strip()]
    if not parts:
        raise ValueError(f"empty index factory spec: {spec!r}")

    pca_dim = None
    ivf = False
    n_clusters = None
    pq_m = None
    rotate = None  # 'opq' | 'random'
    rotate_m = None
    store = None  # torch.int8 | torch.bfloat16 | None (tier default)

    for part in parts:
        m = _PCA.match(part)
        if m:
            if pca_dim is not None:
                raise ValueError(f"duplicate PCA component in {spec!r}")
            pca_dim = int(m.group(1))
            continue
        m = _IVF.match(part)
        if m:
            if ivf:
                raise ValueError(f"duplicate IVF component in {spec!r}")
            ivf = True
            if m.group(1):
                n_clusters = int(m.group(1))
            continue
        m = _PQ.match(part)
        if m:
            if pq_m is not None:
                raise ValueError(f"duplicate PQ component in {spec!r}")
            pq_m = int(m.group(1))
            continue
        m = _OPQ.match(part)
        if m:
            if rotate is not None:
                raise ValueError(f"duplicate rotation component in {spec!r}")
            rotate = "opq"
            rotate_m = int(m.group(1)) if m.group(1) else None
            continue
        m = _RR.match(part)
        if m:
            if rotate is not None:
                raise ValueError(f"duplicate rotation component in {spec!r}")
            rotate = "random"
            rotate_m = int(m.group(1)) if m.group(1) else None
            continue
        m = _SQ.match(part)
        if m:
            if store is not None:
                raise ValueError(f"duplicate SQ component in {spec!r}")
            # fp16 maps to bf16, the half-width storage tier
            store = torch.int8 if m.group(1) == "8" else torch.bfloat16
            continue
        if part == "flat":
            continue
        raise ValueError(
            f"unknown index_type / factory component {part!r} in {spec!r}; "
            "expected a tier name (flat|refine|ivf) or factory components: "
            "Flat, SQ8, SQbf16, PCA<d>, IVF<n>, PQ<m>, OPQ<m>, RR<m>"
        )

    if rotate is not None and pq_m is None:
        raise ValueError(
            f"{spec!r}: OPQ/RR rotations apply to PQ codes; add a PQ<m> "
            "component"
        )
    if rotate_m is not None and pq_m is not None and rotate_m != pq_m:
        raise ValueError(
            f"{spec!r}: rotation block count {rotate_m} != PQ m {pq_m} "
            "(FAISS requires these to match; so do we)"
        )
    if pq_m is not None and not ivf:
        raise ValueError(
            f"{spec!r}: flat PQ is not implemented — PQ codes ride the IVF "
            "tier (use IVF<n>,PQ<m>)"
        )

    kwargs: dict = {}
    if ivf:
        if n_clusters is not None:
            kwargs["n_clusters"] = n_clusters
        if pq_m is not None:
            kwargs["pq_m"] = pq_m
            if rotate is not None:
                kwargs["pq_rotate"] = rotate
        if pca_dim is not None:
            kwargs["reduced_dim"] = pca_dim
        if store is not None:
            if pq_m is not None:
                raise ValueError(
                    f"{spec!r}: PQ codes replace row storage; drop the SQ "
                    "component"
                )
            kwargs["store_dtype"] = store
        return "ivf", kwargs

    if pca_dim is not None:
        kwargs["reduced_dim"] = pca_dim
        if store == torch.int8:
            raise ValueError(
                f"{spec!r}: the PCA refine tier reranks on fp32/bf16 rows; "
                "int8 storage is a flat/IVF option"
            )
        if store is not None:
            kwargs["store_dtype"] = store
        return "refine", kwargs

    if store is not None:
        kwargs["dtype"] = store
    return "flat", kwargs


def resolve_index_spec(index_type: str, index_kwargs=None) -> Tuple[str, dict]:
    """CLI bridge: a plain tier name passes through with ``index_kwargs``;
    anything else is parsed as a factory string and MERGED with
    ``index_kwargs`` (explicit kwargs win)."""
    index_kwargs = dict(index_kwargs or {})
    if index_type in ("flat", "refine", "ivf"):
        return index_type, index_kwargs
    kind, kwargs = parse_index_spec(index_type)
    kwargs.update(index_kwargs)
    return kind, kwargs


def shard_count(group) -> int:
    """The shards of an index over ``group`` (None: one device)."""
    return 1 if group is None else mesh.group_size(group)


def check_sharded_tier(index_type: str, shards: int) -> None:
    """Raise for a tier that has no sharded build (IVF) over more than one
    shard."""
    if index_type == "ivf" and shards > 1:
        from rankpo_tpu_torch.index.io import MULTI_CARD_IVF

        raise NotImplementedError(MULTI_CARD_IVF.format(shards))


def build_offline_index(embeddings, n_total: int, index_type: str,
                        index_kwargs: dict, recall_target: float, *,
                        as_constructor: bool = False, group=None):
    """The index over ``embeddings`` [N_buf, D] (rows past ``n_total`` are
    padding) on their device, for a tier from :func:`resolve_index_spec`.
    The refine and flat tiers build as the JAX evaluator and prediction tool
    build them (``from_sharded``: refine's PCA second moment of the fp32
    rows, flat int8 scales rounded as XLA rounds them) or, with
    ``as_constructor``, as the JAX mining tool does (the constructors: the
    moment of the stored rows, the host's int8 rounding). With ``group``,
    ``embeddings`` is this rank's shard (``InferenceEncoder.encode_shard``)
    and the index is sharded over the group; ``as_constructor`` then keeps
    the constructors' rounding and moment on the shard's rows."""
    if index_type == "ivf" and shard_count(group) == 1:
        group = None  # one shard: the one-device build
    check_sharded_tier(index_type, shard_count(group))
    if group is not None:
        from rankpo_tpu_torch.index.flat import FlatIPIndex
        from rankpo_tpu_torch.index.refined import RefineIPIndex

        if index_type == "refine":
            kwargs = dict(recall_target=recall_target,
                          reduced_dim=min(256, int(embeddings.shape[1])))
            kwargs.update(index_kwargs)
            with torch.inference_mode():
                return RefineIPIndex.from_sharded(embeddings, n_total, group=group,
                                                  moment_of_stored=as_constructor, **kwargs)
        return FlatIPIndex.from_sharded(embeddings, n_total, group=group,
                                        times_reciprocal=not as_constructor, **index_kwargs)
    if index_type in ("ivf", "refine"):
        from rankpo_tpu_torch.index.ivf import IVFIPIndex
        from rankpo_tpu_torch.index.refined import RefineIPIndex

        kwargs = dict(recall_target=recall_target)
        if index_type == "refine":
            kwargs["reduced_dim"] = min(256, int(embeddings.shape[1]))
        kwargs.update(index_kwargs)
        with torch.inference_mode():
            if index_type == "ivf":
                return IVFIPIndex(embeddings, n_total=n_total, **kwargs)
            if as_constructor:
                return RefineIPIndex(embeddings, n_total=n_total, **kwargs)
            return RefineIPIndex.from_sharded(embeddings, n_total, **kwargs)
    from rankpo_tpu_torch.index.flat import FlatIPIndex

    if as_constructor:
        return FlatIPIndex(embeddings, n_total=n_total, **index_kwargs)
    return FlatIPIndex.from_sharded(embeddings, n_total, **index_kwargs)
