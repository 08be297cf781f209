"""The port's flash attention against the JAX package's.

On CPU tensors the port's ``flash_attention`` is its plain PyTorch version;
it must equal the JAX Pallas kernel run in interpret mode and the JAX
oracle ``flash_attention_ref`` at the shapes of the JAX package's own
kernel test (``tests/test_kernels.py``), each with both masks, within that
test's tolerances: 2e-5 in float32, 2e-2 in bfloat16 (``rtol = atol``).
Inputs are drawn with numpy from a seed and handed to both.  The CUDA
kernel is held against the same plain version in ``tests/test_torch_gpu.py``,
which runs only where there is a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_ref as jax_flash_attention_ref)

from repro_torch.kernels.flash_attention import (LAUNCHES, flash_attention,
                                                 flash_attention_ref,
                                                 reset_launches)
from repro_torch.kernels.flash_attention.flash_attention import (HEAD_DIMS,
                                                                 _check)

# tests/test_kernels.py's shapes: (B, S, H, KV, hd, block_q, block_k) of
# the JAX kernel; its mask per shape is replaced by both masks here
SHAPES = [
    (2, 512, 4, 2, 64, 128, 128),
    (1, 1024, 8, 8, 128, 256, 256),
    (2, 256, 4, 1, 64, 128, 128),     # MQA
    (1, 512, 6, 2, 128, 512, 256),    # uneven block_q/block_k
    (2, 256, 4, 4, 32, 128, 128),     # small head dim
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, S, H, KV, hd, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = S if Sk is None else Sk
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))


def _both(arrays, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd,bq,bk", SHAPES)
def test_flash_attention_matches_reference(B, S, H, KV, hd, bq, bk, causal,
                                           dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(B, S, H, KV, hd, seed=B * S + H), dtype)
    reset_launches()
    out = flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert LAUNCHES["flash_attention"] == 0      # the CPU runs no kernel
    kern = jax_flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                               block_k=bk)
    ref = jax_flash_attention_ref(jq, jk, jv, causal=causal)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(kern), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,Sk,H,KV,hd", [
    (1, 77, 77, 4, 1, 32),            # S divides no tile
    (2, 100, 130, 6, 3, 16),          # Sk != S: the causal mask from 0
    (1, 33, 33, 48, 1, 128),          # granite-20b's G = 48 fold
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_matches_reference_oracle(B, S, Sk, H, KV, hd,
                                                         causal):
    """Shapes the JAX kernel refuses (S no multiple of its block): the
    port takes them, and equals the JAX oracle in float32."""
    (jq, jk, jv), (tq, tk, tv) = _both(
        _inputs(B, S, H, KV, hd, seed=S + Sk, Sk=Sk), "float32")
    out = flash_attention(tq, tk, tv, causal=causal)
    ref = jax_flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2e-5, atol=2e-5)


def test_plain_version_keeps_p_in_the_input_dtype():
    """The plain version rounds p to bf16 before the PV product, as the
    JAX oracle does: bit-equal to the oracle's output computed the same
    way by hand."""
    (_, _, _), (q, k, v) = _both(_inputs(1, 64, 4, 2, 32, seed=5),
                                 "bfloat16")
    qg = q.reshape(1, 64, 2, 2, 32)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k).float() * 32 ** -0.5
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), -1e30)
    p = torch.softmax(s, -1).to(torch.bfloat16)
    want = torch.einsum("bkgst,btkh->bskgh", p, v).reshape(1, 64, 4, 32)
    assert torch.equal(flash_attention_ref(q, k, v, causal=True), want)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 8, 4, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="H % KV"):
        flash_attention(q, torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32))
    for bad in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="float32 and bfloat16"):
            flash_attention(q.to(bad), kv.to(bad), kv.to(bad))
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention(q, kv.bfloat16(), kv.bfloat16())
    with pytest.raises(ValueError, match="one device"):
        flash_attention(q, kv.to("meta"), kv.to("meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, kv, kv[:, :4])
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, kv[..., :16], kv[..., :16])
    with pytest.raises(ValueError, match="4-D"):
        flash_attention(q[0], kv[0], kv[0])
    with pytest.raises(TypeError, match="tensor"):
        flash_attention(q.numpy(), kv, kv)


def test_wrapper_rejects_head_dims_without_a_kernel():
    """A head dim the CUDA kernel has no instantiation for raises for a
    card tensor (checked here without a card through the wrapper's check),
    while the CPU's plain version takes it."""
    q, kv = torch.zeros(1, 8, 4, 96), torch.zeros(1, 8, 2, 96)
    assert 96 not in HEAD_DIMS
    with pytest.raises(ValueError, match="head dim 96"):
        _check(q, kv, kv, for_kernel=True)
    _check(q, kv, kv, for_kernel=False)
    assert flash_attention(q, kv, kv).shape == q.shape
    for hd in HEAD_DIMS:
        _check(torch.zeros(1, 8, 4, hd), torch.zeros(1, 8, 1, hd),
               torch.zeros(1, 8, 1, hd), for_kernel=True)
