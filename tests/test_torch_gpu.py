"""The CUDA kernel against its plain PyTorch version, on the card.

This file imports no JAX, so it runs on a card host that has only the
port's dependencies: ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Where there is no card the test skips inside its body (the kernel has no
CPU mode); the CPU path is held against the JAX package in
``tests/test_torch_frontier_expand.py``.
"""
import pytest
import torch

from repro_torch.graphs import instance_sets, random_bipartite
from repro_torch.kernels.frontier_expand import (LAUNCHES,
                                                 frontier_expand_fused,
                                                 frontier_expand_fused_ref,
                                                 reset_launches)
from repro_torch.matching import Matcher, MatcherConfig, TorchCSR
from repro_torch.matching.solve import _apply_winner, level0_state


@pytest.mark.gpu
def test_cuda_kernel_equals_plain_version():
    """Winners bit for bit (tolerance 0) at every level of a first BFS
    phase, WR and plain body, on a graph whose edge count is no multiple
    of the launch shape; the plain version runs on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = random_bipartite(30000, 25000, 4.0, seed=7, pad_to=130001)
    cpu = TorchCSR.from_host(g, device="cpu")
    dev = TorchCSR.from_host(g, device="cuda")
    warm = Matcher(warm_start="cheap").init(cpu)
    reset_launches()
    for wr in (True, False):
        bfs, root = level0_state(warm.cmatch)
        pred = torch.full((g.nr + 1,), g.nc, dtype=torch.int32)
        rmatch, level, ins = warm.rmatch, 2, True
        while ins:
            rt = root if wr else None
            want = frontier_expand_fused_ref(cpu.ecol, cpu.cadj, bfs, rt,
                                             rmatch, level)
            got = frontier_expand_fused(
                dev.ecol, dev.cadj, bfs.cuda(),
                rt.cuda() if wr else None, rmatch.cuda(), level)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (wr, level)
            bfs, root, pred, rmatch, ins_t, _ = _apply_winner(
                want, bfs, root, pred, rmatch, level, wr=wr, wr_exact=False)
            ins, level = bool(ins_t), level + 1
    assert LAUNCHES["frontier_expand_fused_wr"] > 0
    assert LAUNCHES["frontier_expand_fused_plain"] > 0


@pytest.mark.gpu
def test_cuda_kernel_skips_out_of_range_slots_as_cpu_does():
    """A malformed graph (negative and too-large rows and columns) and
    out-of-range roots: the kernel skips those slots, neither reading nor
    writing out of bounds, and gives the CPU version's winners."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(3)
    g = random_bipartite(3000, 2500, 4.0, seed=9, pad_to=14001)
    ecol = torch.from_numpy(g.ecol.copy())
    cadj = torch.from_numpy(g.cadj.copy())
    bad = torch.randperm(g.nnz, generator=gen)[:400]
    ecol[bad[:100]] = -7
    ecol[bad[100:200]] = g.nc + 5
    cadj[bad[200:300]] = -1
    cadj[bad[300:]] = g.nr + 3
    bfs = torch.tensor([1, 2, 2, -2**30], dtype=torch.int32)[
        torch.randint(0, 4, (g.nc + 1,), generator=gen)]
    root = torch.randint(-3, g.nc + 4, (g.nc + 1,), generator=gen,
                         dtype=torch.int32)
    rmatch = torch.randint(-1, g.nc, (g.nr + 1,), generator=gen,
                           dtype=torch.int32)
    for rt in (root, None):
        want = frontier_expand_fused_ref(ecol, cadj, bfs, rt, rmatch, 2)
        got = frontier_expand_fused(
            ecol.cuda(), cadj.cuda(), bfs.cuda(),
            None if rt is None else rt.cuda(), rmatch.cuda(), 2)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert int((want < 2**30).sum()) > 100


@pytest.mark.gpu
def test_cuda_run_equals_cpu_run():
    """The whole solve on the card equals the solve on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for name, g in instance_sets("mini").items():
        for cfg in (MatcherConfig(), MatcherConfig(
                algo="apsb", kernel="gpubfs", schedule="mt")):
            a = Matcher(cfg, "cheap").run(TorchCSR.from_host(g, device="cpu"))
            b = Matcher(cfg, "cheap").run(TorchCSR.from_host(g))
            assert torch.equal(a.cmatch, b.cmatch.cpu()), name
            assert torch.equal(a.rmatch, b.rmatch.cpu()), name
            assert (int(a.phases), int(a.fallbacks), bool(a.certified)) == \
                (int(b.phases), int(b.fallbacks), bool(b.certified)), name
