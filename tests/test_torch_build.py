"""What the flash-attention wrapper decides on the host, and the kernel
build's cache key, checked without a card or ``nvcc``.

The wrapper picks the kernel body from (dtype, head dim) alone, and lets
TMA read an input in place only where its base and strides allow; both
are pure functions of the tensor's metadata, so CPU tensors show them.
The build names each library by the hash of its source, of every header
under ``csrc/`` and of the flags, so an edited header is rebuilt.
"""
import shutil

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention.flash_attention import (
    HEAD_DIMS, ROUTES, _check, _route, _strides, _tma_ready)


@pytest.mark.parametrize("hd", [8, 16, 32, 64, 96, 128, 256, 512])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.float64])
def test_route_table(dtype, hd):
    """bfloat16 -> the tensor-core body, float32 -> the CUDA-core body, at
    every head dim of HEAD_DIMS; anything else raises."""
    if dtype in (torch.bfloat16, torch.float32) and hd in HEAD_DIMS:
        want = "tc" if dtype == torch.bfloat16 else "simt"
        assert _route(dtype, hd) == want == ROUTES[(dtype, hd)]
    else:
        match = f"head dim {hd}" if dtype in (torch.bfloat16,
                                             torch.float32) else "float32"
        with pytest.raises(ValueError, match=match):
            _route(dtype, hd)


def test_no_bfloat16_head_dim_left_on_the_cuda_core_body():
    assert {hd for (dt, hd), body in ROUTES.items()
            if dt == torch.bfloat16 and body == "simt"} == set()
    assert set(ROUTES) == {(dt, hd) for dt in (torch.bfloat16, torch.float32)
                           for hd in HEAD_DIMS}


def _views():
    """name -> (tensor, whether TMA reads it in place)."""
    qkv = torch.zeros(2, 96, 6 + 2 + 2, 64, dtype=torch.bfloat16)
    bhsd = torch.zeros(2, 4, 96, 64, dtype=torch.bfloat16)
    flat = torch.zeros(2 * 96 * 4 * 64 + 8, dtype=torch.bfloat16)
    wide = torch.zeros(2, 96, 4, 20, dtype=torch.bfloat16)
    return {
        "contiguous": (torch.zeros(2, 96, 4, 64, dtype=torch.bfloat16),
                       True),
        "fused qkv, q": (qkv[:, :, :6], True),
        "fused qkv, k": (qkv[:, :, 6:8], True),
        "fused qkv, v": (qkv[:, :, 8:], True),
        "(B, H, S, hd) transposed": (bhsd.transpose(1, 2), True),
        "base off by 16 bytes": (flat[8:].view(2, 96, 4, 64), True),
        "base off by 2 bytes": (flat[1:1 + 2 * 96 * 4 * 64]
                                .view(2, 96, 4, 64), False),
        "head stride of 40 bytes": (wide[..., :16], False),
        "head dim strided": (torch.zeros(2, 96, 64, 4, dtype=torch.bfloat16)
                             .transpose(2, 3), False),
        "float32 contiguous": (torch.zeros(1, 8, 2, 32), True),
    }


@pytest.mark.parametrize("name", list(_views()))
def test_tma_eligibility(name):
    """TMA needs a 16-byte-aligned base and (batch, sequence, head) strides
    of a multiple of 16 bytes, with the head dim dense; the wrapper copies
    any other input into a contiguous tensor first."""
    t, want = _views()[name]
    assert _tma_ready(t) is want


def test_strides_ignore_size_one_dims():
    """A size-1 dim is never stepped along, so whatever stride torch gives
    it is replaced by the packed one and cannot make an input ineligible."""
    t = torch.zeros(4, 64, 1, 128, dtype=torch.bfloat16).as_strided(
        (1, 64, 1, 128), (7, 128, 3, 1))
    assert _strides(t) == (64 * 128, 128, 128)
    assert _tma_ready(t)
    q = torch.zeros(2, 96, 4, 64)
    assert _strides(q) == q.stride()[:3]


def test_wrapper_checks_the_tensor_core_grid():
    q = torch.zeros(1, 128 * 65536, 1, 16, dtype=torch.bfloat16,
                    device="meta")
    k = torch.zeros(1, 8, 1, 16, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="launch grid"):
        _check(q, k, k, for_kernel=True)
    _check(q[:, :128 * 65535], k, k, for_kernel=True)


def test_reset_launches_zeroes_every_count():
    for key in LAUNCHES:
        LAUNCHES[key] = 3
    reset_launches()
    assert LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0,
                        "flash_attention_simt": 0}


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """The kernel sources copied to a scratch directory the build reads."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("edit", ["hopper.cuh", "new header.h"])
def test_editing_a_header_changes_the_library_path(csrc_copy, edit):
    before = {n: _build.library_path(n)
              for n in ("flash_attention", "frontier_expand")}
    path = csrc_copy / edit
    path.write_text((path.read_text() if path.exists() else "") + "\n// x\n")
    after = {n: _build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    assert all(p.parent == _build.BUILD_DIR for p in after.values())


def test_library_path_follows_its_own_source_only(csrc_copy):
    fa, fe = (_build.library_path(n)
              for n in ("flash_attention", "frontier_expand"))
    src = csrc_copy / "flash_attention.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.library_path("flash_attention") != fa
    assert _build.library_path("frontier_expand") == fe
    assert _build.library_path("flash_attention").name.startswith(
        "flash_attention-")
