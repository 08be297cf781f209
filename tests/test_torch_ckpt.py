"""The port's checkpoints (``repro_torch.ckpt``) on the CPU: the JAX
package's fault-tolerance tests (``tests/test_ft.py``) mirrored, and the
two packages' checkpoints read across both ways (leaves bit for bit).

The JAX package cannot restore a bf16 leaf it saved (``astype`` from its
``<V2`` records fails; ROADMAP.md, Queue 3); the port reads them, so the
cross test saves bf16 through the JAX package and restores it here, and
the reverse direction is held on float32 and int32 leaves.
"""
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jax_restore_checkpoint
from repro.ckpt import save_checkpoint as jax_save_checkpoint

from repro_torch.ckpt import (_msgpack, latest_step, restore_checkpoint,
                              save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_to_reference
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves
from repro_torch.optim import OptConfig, adamw_init


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32),
                  "d": torch.tensor(7.0),
                  "e": torch.randn(2, 3).to(torch.bfloat16)}}
    save_checkpoint(str(tmp_path), 3, tree)
    like = {"a": torch.zeros(3, 4),
            "b": {"c": torch.zeros(5, dtype=torch.int32),
                  "d": torch.zeros(()), "e": torch.zeros(2, 3)}}
    out, step = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert step == 3
    for x, y, z in zip(tree_leaves(tree), tree_leaves(out),
                       tree_leaves(like)):
        assert y.dtype == z.dtype and x.shape == y.shape
        assert torch.equal(x.to(z.dtype), y)
    # like's tensors are filled in place (no second copy of the state),
    # the bf16 leaf cast to like's fp32 first
    assert out["a"] is like["a"] and out["b"]["e"] is like["b"]["e"]
    assert torch.equal(out["b"]["e"], tree["b"]["e"].float())
    out2, _ = restore_checkpoint(str(tmp_path), tree, device="cpu")
    for x, y in zip(tree_leaves(tree), tree_leaves(out2)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_latest_and_gc(tmp_path):
    tree = {"x": torch.zeros(4)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["step_000000004",
                                            "step_000000005"]


def test_torn_checkpoint_ignored(tmp_path):
    tree = {"x": torch.zeros(4)}
    save_checkpoint(str(tmp_path), 1, tree)
    torn = tmp_path / "step_000000002"           # a crash mid-save
    torn.mkdir()
    (torn / "x.npy").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) == 1
    _, step = restore_checkpoint(str(tmp_path), tree, device="cpu")
    assert step == 1
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree, device="cpu")
    with pytest.raises(KeyError, match="missing leaf y"):
        restore_checkpoint(str(tmp_path), {"y": torch.zeros(4)},
                           device="cpu")


def _train_state(dtype):
    """A SMOKE model's params and AdamW state (the factored branch keeps
    ``m`` in bf16), with nonzero moments."""
    cfg = get_config("granite-20b", smoke=True, dtype=dtype)
    params = build_model(cfg).init(0, device="cpu")
    state = adamw_init(params, OptConfig(factored=True))
    gen = torch.Generator().manual_seed(1)
    for t in tree_leaves(state["m"]) + tree_leaves(state["vr"]):
        t.copy_(torch.randn(t.shape, generator=gen))
    state["step"].fill_(5)
    return {"params": params, "opt": state}


def test_port_restores_a_reference_checkpoint_with_bf16_leaves(tmp_path):
    tree = _train_state("bfloat16")
    ref_tree = jax.tree.map(jnp.asarray, lm_params_to_reference(tree))
    jax_save_checkpoint(str(tmp_path), 5, ref_tree)
    like = jax.tree.map(lambda t: torch.zeros_like(t), tree)
    out, step = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert step == 5
    assert [k for k, _ in _items(tree)] == [k for k, _ in _items(out)]
    for (_, x), (_, y) in zip(_items(tree), _items(out)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(_bits(y), _bits(x))
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(out))
    # the JAX package's own restore fails on those leaves (ROADMAP Queue 3)
    with pytest.raises(ValueError):
        jax_restore_checkpoint(str(tmp_path), ref_tree)


def test_reference_restores_a_port_checkpoint(tmp_path):
    tree = _train_state("float32")
    tree["opt"].pop("m")                    # its one bf16 leaf (see above)
    save_checkpoint(str(tmp_path), 7, tree)
    ref_like = jax.tree.map(jnp.asarray, lm_params_to_reference(tree))
    out, step = jax_restore_checkpoint(str(tmp_path), ref_like)
    assert step == 7
    want = lm_params_to_reference(tree)
    assert jax.tree.structure(want) == jax.tree.structure(out)
    for x, y in zip(jax.tree.leaves(want), jax.tree.leaves(out)):
        assert np.asarray(y).dtype == x.dtype
        np.testing.assert_array_equal(np.asarray(y), x)
    assert np.asarray(out["opt"]["step"]).dtype == np.int32


def test_port_files_equal_the_reference_files(tmp_path):
    """The same tree saved by both packages: the same file names and
    bytes, the manifest included (bf16 leaves as ``<V2`` records)."""
    tree = _train_state("bfloat16")
    save_checkpoint(str(tmp_path / "port"), 2, tree)
    jax_save_checkpoint(str(tmp_path / "ref"), 2, jax.tree.map(
        jnp.asarray, lm_params_to_reference(tree)))
    a, b = tmp_path / "port" / "step_000000002", \
        tmp_path / "ref" / "step_000000002"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.msgpack" in names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


MANIFEST_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
    -2 ** 31 - 1, -2 ** 63, "", "x" * 31, "x" * 32, "é" * 200, "y" * 300,
    "z" * 70000, [], list(range(15)), list(range(16)), list(range(70000)),
    {"step": 12, "leaves": {f"layers/attn/w{i}": {
        "file": f"layers__attn__w{i}.npy", "shape": [2, 64, 4, 16],
        "dtype": "bfloat16"} for i in range(20)}},
    {str(i): i for i in range(70000)},
]


@pytest.mark.parametrize("i", range(len(MANIFEST_VALUES)))
def test_msgpack_codec_against_msgpack(i):
    v = MANIFEST_VALUES[i]
    packed = msgpack.packb(v)
    assert _msgpack.packb(v) == packed
    assert _msgpack.unpackb(packed) == msgpack.unpackb(packed) == v
    assert msgpack.unpackb(_msgpack.packb(v)) == v
