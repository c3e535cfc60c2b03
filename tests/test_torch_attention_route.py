"""The "auto" attention dispatch's rule (``ops/flash_attention.py``
``auto_build``): the Hopper kernels are built for bf16 at head_dim 64, 128
and 256 (``kernel_fits``) and run there at every length; the generic build
takes fp32, fp16 and bf16 at any head_dim that is a multiple of 8
(``kernel_for``) and runs where JAX's ``_use_flash`` runs its Pallas kernel
(S >= 1024, head_dim a multiple of 8 and at least 64); a CUDA tensor
elsewhere runs the plain attention, counted in ``reference_routes``
(``routes_to_reference``), where JAX runs XLA too. On a CPU tensor "auto"
is the plain attention whatever the rule says, bit for bit, and counts
nothing; ``impl="flash"`` raises there. The card's side of the rule is in
``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rankpo_tpu_torch.ops import flash_attention as port_flash
from rankpo_tpu_torch.ops.attention import attention_reference, multi_head_attention

torch.set_num_threads(2)

DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}
JAX_DTYPES = {"bf16": jnp.bfloat16, "fp16": jnp.float16, "fp32": jnp.float32}


def _qkv(d, dtype, b=2, s=24, hq=4, hkv=2, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32)).to(dtype)
               for h in (hq, hkv, hkv))
    mask = torch.from_numpy((np.arange(s)[None, :] < np.array([[s], [s - 7]])).astype(np.int32))
    return q, k, v, mask


@pytest.mark.parametrize("d", [32, 64, 80, 128, 256, 512])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_fits_bf16_at_built_head_dims_only(dtype, d):
    q = torch.zeros((1, 2, 2, d), dtype=DTYPES[dtype])
    assert port_flash.kernel_fits(q) == (dtype == "bf16" and d in (64, 128, 256))


@pytest.mark.parametrize("d", [8, 32, 60, 64, 72, 80, 96, 100, 128, 256, 320, 512, 1024])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_for_names_the_build(dtype, d):
    """The Hopper kernels for bf16 at 64, 128 and 256; the generic build for
    fp32, fp16 and bf16 at every other head_dim that is a multiple of 8;
    none for another head_dim or dtype."""
    q = torch.zeros((1, 2, 2, d), dtype=DTYPES[dtype])
    want = ("hopper" if dtype == "bf16" and d in (64, 128, 256)
            else "generic" if d % 8 == 0 else None)
    assert port_flash.kernel_for(q) == want
    assert port_flash.kernel_for(q.double()) is None


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_auto_rule_against_use_flash_on_the_tpu(dtype, monkeypatch):
    """What "auto" runs on a CUDA tensor, over a grid of head_dim and
    length: the Hopper kernels where built, else the generic build where
    JAX's ``_use_flash`` (backend set to the TPU) runs its kernel, else the
    plain attention; wherever JAX runs its kernel, some build takes the
    input."""
    from rankpo_tpu.ops import attention as jattn

    monkeypatch.setattr(jattn.jax, "default_backend", lambda: "tpu")
    for s in (64, 512, 1023, 1024, 1280, 4096):
        for d in (32, 60, 64, 72, 80, 96, 100, 128, 256, 320, 512):
            q = torch.zeros((1, s, 1, d), dtype=DTYPES[dtype])
            jax_kernel = jattn._use_flash(jax.ShapeDtypeStruct((1, s, 1, d), JAX_DTYPES[dtype]))
            hopper = dtype == "bf16" and d in (64, 128, 256)
            want = "hopper" if hopper else ("generic" if jax_kernel else "plain")
            assert port_flash.auto_build(q) == want, (s, d)
            assert port_flash.routes_to_reference(q) == (want == "plain"), (s, d)
            if jax_kernel:
                assert port_flash.kernel_for(q) is not None, (s, d)


@pytest.mark.parametrize("s", [512, 1023, 1024, 4096])
@pytest.mark.parametrize("d", [32, 60, 64, 72, 80, 128, 256, 512])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reference_only_where_jax_leaves_its_kernel(dtype, d, s):
    """The plain attention where the Hopper kernels are not built and JAX
    runs XLA (its ``_use_flash`` on the same shape); a kernel build
    everywhere else."""
    q = torch.zeros((1, s, 1, d), dtype=DTYPES[dtype])
    jax_kernel = d % 8 == 0 and d >= 64 and s >= 1024
    assert port_flash.jax_runs_kernel(q) == jax_kernel
    built = dtype == "bf16" and d in (64, 128, 256)
    assert port_flash.routes_to_reference(q) == (not built and not jax_kernel)


def test_jax_rule_is_use_flash_on_the_tpu(monkeypatch):
    """``jax_runs_kernel`` is JAX's ``_use_flash`` with the backend set to
    the TPU."""
    from rankpo_tpu.ops import attention as jattn

    monkeypatch.setattr(jattn.jax, "default_backend", lambda: "tpu")
    for s in (512, 1023, 1024, 2048):
        for d in (32, 60, 64, 72, 80, 128, 256, 512):
            q = torch.zeros((1, s, 1, d))
            assert port_flash.jax_runs_kernel(q) == jattn._use_flash(
                jax.ShapeDtypeStruct((1, s, 1, d), jax.numpy.float32)), (s, d)


@pytest.mark.parametrize("dtype,d", [("fp32", 64), ("bf16", 32), ("bf16", 80), ("bf16", 128)])
def test_auto_on_a_cpu_tensor_is_the_reference_bit_for_bit(dtype, d):
    q, k, v, mask = _qkv(d, DTYPES[dtype])
    port_flash.reset_launches()
    got = multi_head_attention(q, k, v, mask=mask, causal=True)
    assert torch.equal(got, attention_reference(q, k, v, mask, True))
    assert port_flash.reference_routes == {"dtype": 0, "head_dim": 0}  # by device, not the rule
    assert not any(port_flash.launches.values())


@pytest.mark.parametrize("dtype,d", [("fp32", 64), ("bf16", 80), ("bf16", 64)])
def test_flash_still_raises_on_a_cpu_tensor(dtype, d):
    q, k, v, mask = _qkv(d, DTYPES[dtype])
    with pytest.raises(ValueError, match="CUDA tensors only"):
        multi_head_attention(q, k, v, mask=mask, causal=True, impl="flash")


def test_reference_routes_count_by_reason_and_reset_with_the_launches():
    port_flash.reset_launches()
    for dtype, d in (("fp32", 64), ("fp32", 80), ("bf16", 32)):
        port_flash.count_reference_route(torch.zeros((1, 1, 1, d), dtype=DTYPES[dtype]))
    assert port_flash.reference_routes == {"dtype": 2, "head_dim": 1}
    port_flash.reset_launches()
    assert port_flash.reference_routes == {"dtype": 0, "head_dim": 0}
