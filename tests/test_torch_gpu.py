"""The CUDA kernels against their plain PyTorch versions, on the card.

The frontier sweeps (K1-K3) bit for bit; flash attention (K4) within the
JAX package's kernel tolerances, 2e-5 in float32 (TF32 off) and 2e-2 in
bfloat16 (``rtol = atol``).

This file imports no JAX, so it runs on a card host that has only the
port's dependencies: ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.
Where there is no card the test skips inside its body (the kernel has no
CPU mode); the CPU path is held against the JAX package in
``tests/test_torch_frontier_expand.py``.
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.graphs import instance_sets, random_bipartite
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS
from repro_torch.kernels.frontier_expand import (
    LAUNCHES, frontier_bits, frontier_bits_ref, frontier_expand,
    frontier_expand_fused, frontier_expand_fused_ref, frontier_expand_pull,
    frontier_expand_pull_ref, frontier_expand_ref, reset_launches)
from repro_torch.matching import (SOLVE_PATHS, Matcher, MatcherConfig,
                                  TorchCSR)
from repro_torch.matching.solve import _apply_winner, level0_state
from repro_torch.models import build_model
from repro_torch.models.common import tree_map


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
    ecol, cadj, bfs, root, rmatch = _malformed(3)
    for rt in (root, None):
        want = frontier_expand_fused_ref(ecol, cadj, bfs, rt, rmatch, 2)
        got = frontier_expand_fused(
            ecol.cuda(), cadj.cuda(), bfs.cuda(),
            None if rt is None else rt.cuda(), rmatch.cuda(), 2)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
        assert int((want < 2**30).sum()) > 100


def _view(t, offset):
    """``t`` on the card as a view ``offset`` int32 slots into a larger
    buffer, so its base is 4 * offset bytes past an allocation's."""
    buf = torch.full((t.numel() + offset,), -99, dtype=torch.int32,
                     device="cuda")
    buf[offset:] = t.cuda()
    return buf[offset:]


def _phase_states(ecol, cadj, cmatch, rmatch, wr):
    """The (bfs, root, rmatch, level) of each level of a first BFS phase
    from a matching, walked on the CPU with the plain version."""
    nc, nr = cmatch.shape[0] - 1, rmatch.shape[0] - 1
    bfs, root = level0_state(cmatch)
    pred = torch.full((nr + 1,), nc, dtype=torch.int32)
    level, out = 2, []
    while True:
        out.append((bfs, root if wr else None, rmatch, level))
        win = frontier_expand_fused_ref(ecol, cadj, bfs, out[-1][1], rmatch,
                                        level)
        bfs, root, pred, rmatch, ins, _ = _apply_winner(
            win, bfs, root, pred, rmatch, level, wr=wr, wr_exact=False)
        level += 1
        if not bool(ins):
            return out


def _on_card(sweep, cols, rows, state, offsets=(0, 0)):
    """``sweep`` on the card with its edge arrays as views ``offsets``
    slots into their buffers; the result on the CPU."""
    bfs, root, rmatch, level = state
    return sweep(
        _view(cols, offsets[0]), _view(rows, offsets[1]), bfs.cuda(),
        None if root is None else root.cuda(), rmatch.cuda(), level).cpu()


def _fused_on_card(ecol, cadj, state, offsets=(0, 0)):
    return _on_card(frontier_expand_fused, ecol, cadj, state, offsets)


# ecol / cadj offsets in int32 slots: both at one offset, and at two that
# differ modulo 16 bytes (cadj then read slot by slot)
_OFFSETS = [(0, 0), (1, 1), (2, 2), (3, 3), (1, 3), (0, 2), (3, 0)]


def _short_edges(nnz):
    """``nnz`` random edge slots over 40 columns and 30 rows (the sentinels
    included), half the columns on level 2, random roots and matches."""
    gen = torch.Generator().manual_seed(nnz)
    nc, nr = 40, 30
    ecol = torch.randint(0, nc + 1, (nnz,), generator=gen, dtype=torch.int32)
    cadj = torch.randint(0, nr + 1, (nnz,), generator=gen, dtype=torch.int32)
    bfs = torch.tensor([1, 2], dtype=torch.int32)[
        torch.randint(0, 2, (nc + 1,), generator=gen)]
    bfs[nc] = -2**30
    root = torch.randint(0, nc + 1, (nc + 1,), generator=gen,
                         dtype=torch.int32)
    rmatch = torch.randint(-1, nc, (nr + 1,), generator=gen,
                           dtype=torch.int32)
    return ecol, cadj, bfs, root, rmatch


def _hot_rows(shuffle=True):
    """One free row that 6000 frontier columns propose to and row 7 that
    1000 do, beside random edges; shuffled slots, or sorted by row (the
    CSC order)."""
    gen = torch.Generator().manual_seed(21)
    nc, nr = 8000, 50
    cols = torch.arange(nc, dtype=torch.int32)
    ecol = torch.cat([cols, cols[:3000], cols])
    cadj = torch.cat([torch.zeros(nc, dtype=torch.int32),
                      torch.full((3000,), 7, dtype=torch.int32),
                      torch.randint(1, nr, (nc,), generator=gen,
                                    dtype=torch.int32)])
    order = (torch.randperm(ecol.shape[0], generator=gen) if shuffle
             else torch.argsort(cadj, stable=True))
    bfs = torch.full((nc + 1,), 1, dtype=torch.int32)
    bfs[2000:] = 2                       # columns 2000.. are on the frontier
    bfs[nc] = -2**30
    rmatch = torch.full((nr + 1,), -1, dtype=torch.int32)
    rmatch[nr] = -3
    return ecol[order], cadj[order], bfs, rmatch


@pytest.mark.gpu
@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
def test_cuda_fused_sweep_reads_views_at_every_offset(wr):
    """ecol and cadj as views 1, 2 and 3 slots into their buffers (the
    vector body's head and tail slots), at every level of a first BFS
    phase: the plain version's winners bit for bit, each view launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = random_bipartite(20000, 18000, 4.0, seed=12, pad_to=80003)
    cpu = TorchCSR.from_host(g, device="cpu")
    warm = Matcher(warm_start="cheap").init(cpu)
    states = _phase_states(cpu.ecol, cpu.cadj, warm.cmatch, warm.rmatch, wr)
    assert len(states) >= 3
    reset_launches()
    for st in states:
        want = frontier_expand_fused_ref(cpu.ecol, cpu.cadj, *st)
        for off in _OFFSETS:
            assert torch.equal(_fused_on_card(cpu.ecol, cpu.cadj, st, off),
                               want), (off, st[3])
    body = "wr" if wr else "plain"
    assert LAUNCHES[f"frontier_expand_fused_{body}"] == \
        len(states) * len(_OFFSETS)


@pytest.mark.gpu
@pytest.mark.parametrize("nnz", [0, 1, 3, 127, 129])
def test_cuda_fused_sweep_short_edge_lists(nnz):
    """Edge counts that leave 0-3 slots past the last whole vector, at
    every offset, both bodies, half the columns on the frontier."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ecol, cadj, bfs, root, rmatch = _short_edges(nnz)
    for rt in (root, None):
        st = (bfs, rt, rmatch, 2)
        want = frontier_expand_fused_ref(ecol, cadj, *st)
        if nnz >= 127:
            assert int((want < 2**30).sum()) > 0
        for off in _OFFSETS:
            assert torch.equal(_fused_on_card(ecol, cadj, st, off), want), \
                (off, rt is None)


@pytest.mark.gpu
def test_cuda_fused_sweep_unsorted_edges():
    """A random permutation of a graph's edge slots (ecol no longer
    sorted): the winners of every level of a first BFS phase, both bodies,
    equal the plain version's on the permuted and on the sorted slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = random_bipartite(20000, 18000, 4.0, seed=13, pad_to=80001)
    cpu = TorchCSR.from_host(g, device="cpu")
    warm = Matcher(warm_start="cheap").init(cpu)
    perm = torch.randperm(cpu.ecol.shape[0],
                          generator=torch.Generator().manual_seed(13))
    ecol, cadj = cpu.ecol[perm], cpu.cadj[perm]
    for wr in (True, False):
        for st in _phase_states(cpu.ecol, cpu.cadj, warm.cmatch,
                                warm.rmatch, wr):
            want = frontier_expand_fused_ref(cpu.ecol, cpu.cadj, *st)
            assert torch.equal(frontier_expand_fused_ref(ecol, cadj, *st),
                               want)
            for off in ((0, 0), (1, 2)):
                assert torch.equal(_fused_on_card(ecol, cadj, st, off),
                                   want), (wr, st[3], off)


@pytest.mark.gpu
def test_cuda_fused_sweep_hot_row():
    """One free row that 6000 frontier columns propose to (and a few other
    rows that many do), in shuffled slot order: the lowest proposing column
    wins, as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ecol, cadj, bfs, rmatch = _hot_rows()
    nc = bfs.shape[0] - 1
    for root in (torch.arange(nc + 1, dtype=torch.int32), None):
        st = (bfs, root, rmatch, 2)
        want = frontier_expand_fused_ref(ecol, cadj, *st)
        assert int(want[0]) == 2000 and int(want[7]) == 2000
        for off in ((0, 0), (3, 1)):
            assert torch.equal(_fused_on_card(ecol, cadj, st, off), want)


@pytest.mark.gpu
def test_cuda_fused_sweep_skips_out_of_range_slots_in_views():
    """The malformed inputs (out-of-range rows, columns and roots) through
    views at every offset: no read or write out of bounds, the CPU's
    winners."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ecol, cadj, bfs, root, rmatch = _malformed(5)
    for rt in (root, None):
        st = (bfs, rt, rmatch, 2)
        want = frontier_expand_fused_ref(ecol, cadj, *st)
        assert int((want < 2**30).sum()) > 100
        for off in _OFFSETS:
            assert torch.equal(_fused_on_card(ecol, cadj, st, off), want), \
                off
    torch.cuda.synchronize()


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


def _malformed(seed):
    """A graph with negative and too-large rows and columns in its edge
    slots, random levels, roots partly out of range, and a matching
    state: the inputs of the out-of-range tests."""
    gen = torch.Generator().manual_seed(seed)
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
    rmatch[-1] = -1                 # the sentinel row proposes (legacy)
    return ecol, cadj, bfs, root, rmatch


@pytest.mark.gpu
def test_cuda_legacy_and_pull_kernels_equal_plain_versions():
    """The proposal kernel (every edge slot) and the pull kernel (winners,
    and equal to the fused kernel's) bit for bit at every level of a first
    BFS phase, WR and plain body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = random_bipartite(30000, 25000, 4.0, seed=8, pad_to=130001)
    cpu = TorchCSR.from_host(g, device="cpu").with_csc()
    dev = TorchCSR.from_host(g, device="cuda").with_csc()
    for f in ("rxadj", "radj", "erow", "eperm"):
        assert torch.equal(getattr(dev, f).cpu(), getattr(cpu, f)), f
    warm = Matcher(warm_start="cheap").init(cpu)
    reset_launches()
    for wr in (True, False):
        bfs, root = level0_state(warm.cmatch)
        pred = torch.full((g.nr + 1,), g.nc, dtype=torch.int32)
        rmatch, level, ins = warm.rmatch, 2, True
        while ins:
            rt = root if wr else None
            st = (bfs.cuda(), rt.cuda() if wr else None, rmatch.cuda())
            prop = frontier_expand(dev.ecol, dev.cadj, st[0], st[1], st[2],
                                   level)
            pull = frontier_expand_pull(dev.radj, dev.erow, st[0], st[1],
                                        st[2], level)
            push = frontier_expand_fused(dev.ecol, dev.cadj, st[0], st[1],
                                         st[2], level)
            torch.cuda.synchronize()
            assert torch.equal(prop.cpu(), frontier_expand_ref(
                cpu.ecol, cpu.cadj, bfs, rt, rmatch, level)), (wr, level)
            want = frontier_expand_pull_ref(cpu.radj, cpu.erow, bfs, rt,
                                            rmatch, level)
            assert torch.equal(pull.cpu(), want), (wr, level)
            assert torch.equal(pull, push), (wr, level)
            bfs, root, pred, rmatch, ins_t, _ = _apply_winner(
                want, bfs, root, pred, rmatch, level, wr=wr, wr_exact=False)
            ins, level = bool(ins_t), level + 1
    for k in ("frontier_expand", "frontier_expand_pull"):
        assert LAUNCHES[f"{k}_wr"] > 0 and LAUNCHES[f"{k}_plain"] > 0, k


@pytest.mark.gpu
def test_cuda_legacy_and_pull_kernels_skip_out_of_range_slots():
    """The malformed inputs of the fused kernel's test through the
    proposal and the pull kernel: no read or write out of bounds, and the
    CPU version's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ecol, cadj, bfs, root, rmatch = _malformed(4)
    for rt in (root, None):
        args = (bfs, rt, rmatch, 2)
        cargs = (bfs.cuda(), None if rt is None else rt.cuda(),
                 rmatch.cuda(), 2)
        prop = frontier_expand(ecol.cuda(), cadj.cuda(), *cargs)
        pull = frontier_expand_pull(ecol.cuda(), cadj.cuda(), *cargs)
        torch.cuda.synchronize()
        want = frontier_expand_ref(ecol, cadj, *args)
        assert torch.equal(prop.cpu(), want)
        assert int((want < 2**30).sum()) > 100
        assert torch.equal(pull.cpu(),
                           frontier_expand_pull_ref(ecol, cadj, *args))


@pytest.mark.gpu
def test_cuda_solve_paths_equal_cpu():
    """Every registered solve path gives the same matching on the card and
    on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for name, g in instance_sets("mini").items():
        for pname, path in SOLVE_PATHS.items():
            a = path.run_host(g, device="cpu")
            b = path.run_host(g, device="cuda")
            assert (a[0] == b[0]).all() and (a[1] == b[1]).all(), \
                (name, pname)


@pytest.mark.gpu
@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
def test_cuda_proposals_read_views_at_every_offset(wr):
    """The proposal kernel with ecol and cadj as views 1-3 slots into their
    buffers (head and tail slots; its 16-byte store then falls back to
    four scalar ones), at every level of a first BFS phase: every edge
    slot bit for bit, each view launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = random_bipartite(20000, 18000, 4.0, seed=16, pad_to=80003)
    cpu = TorchCSR.from_host(g, device="cpu")
    warm = Matcher(warm_start="cheap").init(cpu)
    states = _phase_states(cpu.ecol, cpu.cadj, warm.cmatch, warm.rmatch, wr)
    assert len(states) >= 3
    reset_launches()
    for st in states:
        want = frontier_expand_ref(cpu.ecol, cpu.cadj, *st)
        for off in _OFFSETS:
            assert torch.equal(_on_card(frontier_expand, cpu.ecol, cpu.cadj,
                                        st, off), want), (off, st[3])
    body = "wr" if wr else "plain"
    assert LAUNCHES[f"frontier_expand_{body}"] == len(states) * len(_OFFSETS)


@pytest.mark.gpu
@pytest.mark.parametrize("nnz", [0, 1, 3, 127, 129])
def test_cuda_proposals_short_edge_lists(nnz):
    """Edge counts that leave 0-3 slots past the last whole vector, at
    every offset, both bodies: every slot written once, as the plain
    version writes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ecol, cadj, bfs, root, rmatch = _short_edges(nnz)
    for rt in (root, None):
        st = (bfs, rt, rmatch, 2)
        want = frontier_expand_ref(ecol, cadj, *st)
        if nnz >= 127:
            assert int((want < 2**30).sum()) > 0
        for off in _OFFSETS:
            got = _on_card(frontier_expand, ecol, cadj, st, off)
            assert got.shape == (nnz,) and torch.equal(got, want), \
                (off, rt is None)


@pytest.mark.gpu
def test_cuda_proposals_hot_row():
    """The hot rows of the fused kernel's test through the proposal
    kernel: every slot as the plain version has it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ecol, cadj, bfs, rmatch = _hot_rows()
    nc = bfs.shape[0] - 1
    for root in (torch.arange(nc + 1, dtype=torch.int32), None):
        st = (bfs, root, rmatch, 2)
        want = frontier_expand_ref(ecol, cadj, *st)
        assert int((want < 2**30).sum()) > 6000
        for off in ((0, 0), (3, 1)):
            assert torch.equal(_on_card(frontier_expand, ecol, cadj, st, off),
                               want)


@pytest.mark.gpu
@pytest.mark.parametrize("n_cols", [1, 31, 32, 33, 65])
def test_cuda_pull_bitmap_tail_words(n_cols):
    """nc + 1 columns that fill a word, stop short of one or spill one bit
    into the next: the column pass's words (bits past column nc zero) and
    the pull's winners, on row-sorted and on shuffled slots, both bodies,
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator().manual_seed(n_cols)
    nc, nr, nnz = n_cols - 1, 20, 301
    radj = torch.randint(0, nc + 1, (nnz,), generator=gen, dtype=torch.int32)
    erow = torch.randint(0, nr + 1, (nnz,), generator=gen, dtype=torch.int32)
    order = torch.argsort(erow, stable=True)
    bfs = torch.tensor([1, 2, 2], dtype=torch.int32)[
        torch.randint(0, 3, (nc + 1,), generator=gen)]
    root = torch.randint(-2, nc + 3, (nc + 1,), generator=gen,
                         dtype=torch.int32)
    rmatch = torch.randint(-2, max(nc, 1), (nr + 1,), generator=gen,
                           dtype=torch.int32)
    reset_launches()
    for rt in (root, None):
        words = frontier_bits(bfs.cuda(), None if rt is None else rt.cuda(),
                              2)
        assert torch.equal(words.cpu(), frontier_bits_ref(bfs, rt, 2))
        for cols, rows in ((radj[order], erow[order]), (radj, erow)):
            st = (bfs, rt, rmatch, 2)
            want = frontier_expand_pull_ref(cols, rows, *st)
            for off in ((0, 0), (1, 2)):
                assert torch.equal(_on_card(frontier_expand_pull, cols, rows,
                                            st, off), want), (off, rt is None)
    assert LAUNCHES["frontier_bits_wr"] == 1 + 4
    assert LAUNCHES["frontier_expand_pull_wr"] == 4


@pytest.mark.gpu
def test_cuda_pull_hot_row():
    """The hot rows through the pull kernel, the slots sorted by row (as
    the CSC mirror has them) and shuffled: the lowest proposing column
    wins, as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for shuffle in (False, True):
        cols, rows, bfs, rmatch = _hot_rows(shuffle)
        nc = bfs.shape[0] - 1
        for root in (torch.arange(nc + 1, dtype=torch.int32), None):
            st = (bfs, root, rmatch, 2)
            want = frontier_expand_pull_ref(cols, rows, *st)
            assert int(want[0]) == 2000 and int(want[7]) == 2000
            for off in ((0, 0), (3, 1)):
                assert torch.equal(_on_card(frontier_expand_pull, cols, rows,
                                            st, off), want), (shuffle, off)


@pytest.mark.gpu
def test_cuda_pull_unsorted_slots():
    """The CSC mirror's slots in a random order (erow no longer sorted) and
    as views: the pull's winners at every level of a first BFS phase, both
    bodies, equal the plain version's on the sorted slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = random_bipartite(20000, 18000, 4.0, seed=14, pad_to=80001)
    cpu = TorchCSR.from_host(g, device="cpu").with_csc()
    warm = Matcher(warm_start="cheap").init(cpu)
    perm = torch.randperm(cpu.radj.shape[0],
                          generator=torch.Generator().manual_seed(14))
    radj, erow = cpu.radj[perm], cpu.erow[perm]
    for wr in (True, False):
        for st in _phase_states(cpu.ecol, cpu.cadj, warm.cmatch,
                                warm.rmatch, wr):
            want = frontier_expand_pull_ref(cpu.radj, cpu.erow, *st)
            for off in ((0, 0), (1, 2)):
                assert torch.equal(_on_card(frontier_expand_pull, radj, erow,
                                            st, off), want), (wr, st[3], off)
                assert torch.equal(_on_card(frontier_expand_pull, cpu.radj,
                                            cpu.erow, st, off), want)


def _qkv(B, S, H, KV, hd, dtype, seed, Sk=None):
    gen = torch.Generator().manual_seed(seed)
    Sk = S if Sk is None else Sk
    return [torch.randn(shape, generator=gen).to(dtype)
            for shape in ((B, S, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_equals_plain_version(dtype):
    """Every head dim of the kernel, both masks, GQA, MQA with granite's
    G = 48, S and Sk that divide no tile, Sk != S; the plain version runs
    on the CPU in float32 matmuls."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    fa.reset_launches()
    n = 0
    for B, S, H, KV, hd, Sk in [(2, 256, 4, 2, 16, None),
                                (1, 300, 8, 8, 32, None),
                                (2, 200, 6, 3, 64, 130),
                                (1, 257, 48, 1, 128, None),
                                (2, 100, 4, 1, 256, None)]:
        q, k, v = _qkv(B, S, H, KV, hd, dtype, seed=S + hd, Sk=Sk)
        for causal in (True, False):
            got = fa.flash_attention(q.cuda(), k.cuda(), v.cuda(),
                                     causal=causal)
            torch.cuda.synchronize()
            want = fa.flash_attention_ref(q, k, v, causal=causal)
            assert got.dtype == dtype and got.shape == q.shape
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       rtol=tol, atol=tol)
            n += 1
    assert fa.LAUNCHES["flash_attention"] == n


@pytest.mark.gpu
def test_cuda_flash_attention_reads_strided_inputs():
    """q, k, v as views of a fused QKV projection (no copy): the kernel
    reads them through their strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 96, 6 + 2 + 2, 64, generator=gen)
    q, k, v = qkv[:, :, :6], qkv[:, :, 6:8], qkv[:, :, 8:]
    dev = qkv.cuda()
    got = fa.flash_attention(dev[:, :, :6], dev[:, :, 6:8], dev[:, :, 8:])
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), fa.flash_attention_ref(q, k, v),
                               rtol=2e-5, atol=2e-5)


# (B, S, H, KV, Sk): S and Sk that divide no tile, Sk below and above S,
# GQA, MQA with granite's G = 48
_TC_CASES = [(2, 200, 6, 3, 130), (1, 257, 48, 1, 257), (1, 77, 4, 4, 300)]
# chip_smoke.py's per-row gate: the worst query row's ||d|| / ||ref||
_ROW_TOL = 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_tensor_core_body_equals_plain_version(hd):
    """bfloat16 through the tensor-core body at every head dim, both masks,
    within 2e-2 of the plain version on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    fa.reset_launches()
    n = 0
    for B, S, H, KV, Sk in _TC_CASES:
        q, k, v = _qkv(B, S, H, KV, hd, torch.bfloat16, seed=S + Sk + hd,
                       Sk=Sk)
        for causal in (True, False):
            got = fa.flash_attention(q.cuda(), k.cuda(), v.cuda(),
                                     causal=causal)
            torch.cuda.synchronize()
            want = fa.flash_attention_ref(q, k, v, causal=causal)
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       rtol=2e-2, atol=2e-2)
            n += 1
    assert fa.LAUNCHES["flash_attention_tc"] == n
    assert fa.LAUNCHES["flash_attention_simt"] == 0


def _worst_row(got, want):
    d, w = got.float() - want.float(), want.float()
    return float((d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.gpu
def test_cuda_tensor_core_body_long_rows():
    """1 x 4096 x 4 heads x 128, one K/V head, both masks: the worst query
    row's ||d|| / ||ref|| stays within chip_smoke.py's per-row gate, which
    the plain version with one key tile dropped for one 128-row query tile
    exceeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = (t.cuda() for t in _qkv(1, 4096, 4, 1, 128, torch.bfloat16,
                                      seed=11))
    for causal in (True, False):
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        keep = torch.ones(4096, 4096, dtype=torch.bool, device="cuda")
        keep = keep.tril() if causal else keep
        keep[2176:2304, 2048:2176] = False
        s = torch.einsum("bshd,btd->bhst", q, k[:, :, 0]).float() * 128 ** -.5
        p = torch.softmax(s.masked_fill(~keep, -1e30), -1).bfloat16()
        control = torch.einsum("bhst,btd->bshd", p, v[:, :, 0])
        assert _worst_row(got, want) <= _ROW_TOL < _worst_row(control, want)


@pytest.mark.gpu
def test_cuda_tensor_core_body_reads_views():
    """bfloat16 views: the fused-QKV split and a transposed (B, H, S, hd)
    tensor are read in place through TMA; a view whose base is 2 bytes off
    a 16-byte boundary is first copied.  All equal the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(5)
    qkv = torch.randn(2, 96, 10, 64, generator=gen).bfloat16().cuda()
    bhsd = torch.randn(2, 6, 96, 64, generator=gen).bfloat16().cuda()
    flat = torch.randn(2 * 96 * 6 * 64 + 1, generator=gen).bfloat16().cuda()
    cases = [(qkv[:, :, :6], qkv[:, :, 6:8], qkv[:, :, 8:]),
             (bhsd.transpose(1, 2), qkv[:, :, 6:8], qkv[:, :, 8:]),
             (flat[1:].view(2, 96, 6, 64), qkv[:, :, 6:8], qkv[:, :, 8:])]
    fa.reset_launches()
    for q, k, v in cases:
        got = fa.flash_attention(q, k, v)
        want = fa.flash_attention_ref(*(t.cpu() for t in (q, k, v)))
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=2e-2, atol=2e-2)
    assert fa.LAUNCHES["flash_attention_tc"] == len(cases)


@pytest.mark.gpu
def test_cuda_flash_attention_at_local_head_shapes():
    """K4 on one rank's heads under a model axis of 2: granite-20b's 24 of
    48 query heads on its one replicated K/V head (G = 24) and
    deepseek-coder-33b's 28 of 56 on 4 of its 8 K/V heads, bf16 (the
    tensor-core body) and fp32 (the CUDA-core body), both masks, against
    the plain version; then a 1 x 2 gloo world sharing the card runs
    granite-20b SMOKE's ``pallas`` prefill: K4 launched once a layer on
    each rank, the gathered logits the card's one-device prefill's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    fa.reset_launches()
    n = 0
    for (B, S, H, KV, hd), dtype in [((1, 1024, 24, 1, 128), torch.bfloat16),
                                     ((1, 512, 28, 4, 128), torch.bfloat16),
                                     ((1, 256, 24, 1, 128), torch.float32)]:
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        q, k, v = _qkv(B, S, H, KV, hd, dtype, seed=S + H)
        for causal in (True, False):
            got = fa.flash_attention(q.cuda(), k.cuda(), v.cuda(),
                                     causal=causal)
            torch.cuda.synchronize()
            want = fa.flash_attention_ref(q, k, v, causal=causal)
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       rtol=tol, atol=tol)
            n += 1
    assert fa.LAUNCHES["flash_attention"] == n
    import torch_world_ranks as ranks
    from repro_torch.distributed import run_world
    out = run_world(ranks.axis_card_prefill, 2, "granite-20b", 2, 64,
                    mesh=(1, 2), timeout=300)
    single = ranks.axis_card_prefill(None, "granite-20b", 2, 64)
    layers = get_config("granite-20b", smoke=True).n_layers
    assert single["launches"]["flash_attention"] == layers
    for r in out:
        assert r["launches"]["flash_attention"] == layers
        torch.testing.assert_close(r["logits"], single["logits"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_flash_attention_on_straddling_heads():
    """K4 on a rank's heads that straddle K/V groups unevenly:
    deepseek-coder-33b over a model axis of 3, rank 0's 19 of 56 query
    heads on K/V heads 0-2 (7, 7 and 5 of them), the K/V expanded to one a
    query head (``attention.per_head``: G = 1 on the rank), bf16 and fp32,
    both masks, against the plain version of each group on its own K/V
    head; then a 1 x 3 gloo world sharing the card runs deepseek SMOKE with
    8 heads (3/3/2; rank 1's heads read K/V heads 0, 1, 1): K4 launched
    once a layer on each rank, the gathered ``pallas`` prefill the card's
    one device's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.models.attention import kv_index, per_head
    from repro_torch.models.common import Par
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-coder-33b")
    world = type("W", (), {"mesh": (1, 3), "model": type(
        "A", (), {"rank": 0, "size": 3})()})()
    idx = kv_index(cfg, Par(world, fsdp=False, sp=True))
    assert idx == (0,) * 7 + (1,) * 7 + (2,) * 5
    fa.reset_launches()
    n = 0
    for S, dtype in [(512, torch.bfloat16), (256, torch.float32)]:
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        q, k, v = _qkv(1, S, 19, 3, 128, dtype, seed=S + 19)
        for causal in (True, False):
            got = fa.flash_attention(q.cuda(), per_head(k.cuda(), idx),
                                     per_head(v.cuda(), idx), causal=causal)
            torch.cuda.synchronize()
            want = torch.cat([fa.flash_attention_ref(
                q[:, :, lo:hi], k[:, :, j:j + 1], v[:, :, j:j + 1],
                causal=causal) for j, (lo, hi) in enumerate(
                    ((0, 7), (7, 14), (14, 19)))], 2)
            torch.testing.assert_close(got.cpu().float(), want.float(),
                                       rtol=tol, atol=tol)
            n += 1
    assert fa.LAUNCHES["flash_attention"] == n
    import torch_world_ranks as ranks
    from repro_torch.distributed import run_world
    arch = "deepseek-coder-33b+h8"
    out = run_world(ranks.axis_card_prefill, 3, arch, 2, 48, mesh=(1, 3),
                    timeout=300)
    single = ranks.axis_card_prefill(None, arch, 2, 48)
    layers = get_config("deepseek-coder-33b", smoke=True).n_layers
    assert single["launches"]["flash_attention"] == layers
    for r in out:
        assert r["launches"]["flash_attention"] == layers
        torch.testing.assert_close(r["logits"], single["logits"],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_flash_attention_refuses_what_it_has_no_kernel_for():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v = (t.cuda() for t in _qkv(1, 8, 4, 2, 96, torch.float32, 0))
    with pytest.raises(ValueError, match="head dim 96"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="float32 and bfloat16"):
        fa.flash_attention(q.half(), k.half(), v.half())


@pytest.mark.gpu
def test_cuda_model_pallas_equals_xla_and_cpu():
    """A SMOKE granite model on the card: ``attn_impl="pallas"`` launches
    the kernel once per layer and agrees with "xla" and with the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    pallas = build_model(get_config("granite-20b", smoke=True,
                                    attn_impl="pallas"))
    xla = build_model(get_config("granite-20b", smoke=True))
    params = pallas.init(0, device="cpu")
    on_card = tree_map(lambda t: t.cuda(), params)
    toks = torch.randint(0, 512, (2, 96), generator=torch.Generator()
                         .manual_seed(1))
    fa.reset_launches()
    got, _ = pallas.forward(on_card, {"tokens": toks.cuda()})
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == pallas.cfg.n_layers
    ref, _ = xla.forward(on_card, {"tokens": toks.cuda()})
    cpu, _ = pallas.forward(params, {"tokens": toks})
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_at_dbrx_shape(dtype):
    """dbrx-132b's attention shape (48 query heads on 8 K/V heads, G = 6,
    hd 128) at B=2, S=512, both masks, against the plain version on the
    CPU; the body its dtype routes to launches once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    body = ("flash_attention_simt" if dtype == torch.float32
            else "flash_attention_tc")
    q, k, v = _qkv(2, 512, 48, 8, 128, dtype, seed=48)
    fa.reset_launches()
    for causal in (True, False):
        got = fa.flash_attention(q.cuda(), k.cuda(), v.cuda(), causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)
    assert fa.LAUNCHES[body] == fa.LAUNCHES["flash_attention"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_at_seamless_shape(dtype):
    """seamless-m4t-medium's self-attention shape (B=4, S=1024, 16 heads,
    MHA, hd 64): the encoder's full mask and the decoder's causal one,
    against the plain version on the CPU; the body its dtype routes to
    launches once a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    body = ("flash_attention_simt" if dtype == torch.float32
            else "flash_attention_tc")
    q, k, v = _qkv(4, 1024, 16, 16, 64, dtype, seed=64)
    fa.reset_launches()
    for causal in (False, True):
        got = fa.flash_attention(q.cuda(), k.cuda(), v.cuda(), causal=causal)
        torch.cuda.synchronize()
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)
    assert fa.LAUNCHES[body] == fa.LAUNCHES["flash_attention"] == 2


@pytest.mark.gpu
def test_cuda_encoder_decoder_pallas_equals_xla_and_cpu():
    """A SMOKE seamless model (fp32) on the card: ``attn_impl="pallas"``
    launches the kernel once a layer of the encoder (full) and of the
    decoder (causal), never for the cross-attention, and agrees with "xla"
    and with the CPU; decode over the encoder's cache agrees with the
    forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = "seamless-m4t-medium"
    pallas = build_model(get_config(arch, smoke=True, attn_impl="pallas"))
    xla = build_model(get_config(arch, smoke=True))
    params = pallas.init(0, device="cpu")
    on_card = tree_map(lambda t: t.cuda(), params)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 512, (2, 96), generator=gen),
             "enc_frames": torch.randn(2, 40, 64, generator=gen)}
    card = {k: t.cuda() for k, t in batch.items()}
    fa.reset_launches()
    got, _ = pallas.forward(on_card, card)
    torch.cuda.synchronize()
    cfg = pallas.cfg
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers + cfg.enc_layers
    ref, _ = xla.forward(on_card, card)
    cpu, _ = pallas.forward(params, batch)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=1e-4)
    cache = pallas.prefill_encoder(on_card, pallas.init_cache(
        2, 96, enc_len=40, device="cuda"), card)
    outs = []
    for t in range(96):
        lg, cache = pallas.decode_step(on_card, cache,
                                       card["tokens"][:, t:t + 1], t)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), got, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b",
                                  "paligemma-3b"])
def test_cuda_state_and_prefix_families_equal_cpu(arch):
    """SMOKE mamba2, zamba2 (past its window) and paligemma (fp32) on the
    card against the CPU: the forward over two SSD chunks (paligemma over
    its patches and tokens), then teacher-forced decode of its tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(get_config(arch, smoke=True))
    params = model.init(0, device="cpu")
    on_card = tree_map(lambda t: t.cuda(), params)
    gen = torch.Generator().manual_seed(2)
    cfg = model.cfg
    batch = {"tokens": torch.randint(0, 512, (2, 512), generator=gen)}
    if cfg.frontend == "vision":
        batch["frontend"] = torch.randn(2, cfg.frontend_len, cfg.d_model,
                                        generator=gen)
    got, _ = model.forward(on_card, {k: t.cuda() for k, t in batch.items()})
    want, _ = model.forward(params, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    caches = [model.init_cache(2, 40, device=d) for d in ("cpu", "cuda")]
    for t in range(40):
        tok = batch["tokens"][:, t:t + 1]
        a, caches[0] = model.decode_step(params, caches[0], tok, t)
        b, caches[1] = model.decode_step(on_card, caches[1], tok.cuda(), t)
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_routers_equal_cpu():
    """The three MoE routers on the card against the CPU at dbrx's router
    shape cut to T=256 (E=16, k=4, m=6, C=80): ``assign`` and ``slot`` bit
    for bit, probabilities within 1e-6; the exact router's gadget graph
    (130,560 edges) is solved through the fused frontier kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.moe import (route_matching, route_matching_exact,
                                 route_topk)
    T, E, k, C = 256, 16, 4, 80
    gen = torch.Generator().manual_seed(11)
    logits = torch.randn(T, E, generator=gen) + torch.linspace(1.5, 0, E)
    logits[::9, 5] = logits[::9, 2]                 # exact ties
    for route in (route_topk, route_matching, route_matching_exact):
        reset_launches()
        got = route(logits.cuda(), k, C)
        torch.cuda.synchronize()
        want = route(logits, k, C)
        for name, a, b in zip(("assign", "slot"), got, want):
            assert torch.equal(a.cpu(), b), (route.__name__, name)
        torch.testing.assert_close(got[2].cpu(), want[2], rtol=0, atol=1e-6)
        fused = LAUNCHES["frontier_expand_fused_wr"]
        assert (fused > 0) == (route is route_matching_exact), \
            (route.__name__, fused)


@pytest.mark.gpu
def test_cuda_unpadded_gadget_graph_equals_padded_and_cpu():
    """The exact router does not bucket its gadget graph.  At T=63, m=3
    (E=6, k=2, C=19) it has 4,158 edges, no multiple of the fused kernel's
    four slots a thread, so the kernel's scalar tail runs.  Solved on the
    card unpadded and padded to its ``bucket_nnz``, it gives one matching,
    the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.matching.device_csr import bucket_nnz
    from repro_torch.moe.matching_router import _gadget_graph, _top
    T, E, k, m = 63, 6, 2, 3
    C = int(0.9 * 64 * k / E)
    gen = torch.Generator().manual_seed(7)
    cand = _top(torch.randn(T, E, generator=gen) + torch.linspace(2, 0, E),
                m)
    got = []
    for device in ("cpu", "cuda"):
        g = _gadget_graph(cand.to(device), k, E, C)
        assert g.nnz == g.nnz_pad == 4158 and bucket_nnz(g.nnz) > g.nnz
        for graph in (g, g.pad_to(bucket_nnz(g.nnz))):
            reset_launches()
            state = Matcher(MatcherConfig(), warm_start="cheap").run(graph)
            assert bool(state.certified), (device, graph.nnz_pad)
            assert (LAUNCHES["frontier_expand_fused_wr"] > 0) == \
                (device == "cuda"), (device, dict(LAUNCHES))
            got.append((state.cmatch.cpu(), state.rmatch.cpu()))
    for cmatch, rmatch in got[1:]:
        assert torch.equal(cmatch, got[0][0])
        assert torch.equal(rmatch, got[0][1])


@pytest.mark.gpu
def test_cuda_moe_model_pallas_equals_xla_and_cpu():
    """A SMOKE dbrx model (fp32) on the card: ``attn_impl="pallas"``
    launches the kernel once per layer and agrees with "xla" and with the
    CPU; the MoE layers route on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    pallas = build_model(get_config("dbrx-132b", smoke=True,
                                    attn_impl="pallas"))
    xla = build_model(get_config("dbrx-132b", smoke=True))
    params = pallas.init(0, device="cpu")
    on_card = tree_map(lambda t: t.cuda(), params)
    toks = torch.randint(0, 512, (2, 96), generator=torch.Generator()
                         .manual_seed(1))
    fa.reset_launches()
    got, aux = pallas.forward(on_card, {"tokens": toks.cuda()})
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == pallas.cfg.n_layers
    ref, _ = xla.forward(on_card, {"tokens": toks.cuda()})
    cpu, cpu_aux = pallas.forward(params, {"tokens": toks})
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux["lb_loss"].cpu(), cpu_aux["lb_loss"],
                               rtol=1e-5, atol=1e-5)


# ---- the captured solve: one cache entry per bucket, graphs replayed -----
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")


def _outcome(state):
    return (state.cmatch.cpu(), state.rmatch.cpu(), int(state.phases),
            int(state.fallbacks), bool(state.certified))


def _same_outcome(a, b, what):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), what
    assert a[2:] == b[2:], what


@pytest.mark.gpu
@pytest.mark.parametrize("ws", ["cheap", "karp_sipser"])
def test_cuda_captured_run_equals_cpu_run_on_every_path(ws):
    """Every solve path, captured and replayed on the card, gives the CPU's
    state bit for bit, with the CPU's device counts (levels by sweep,
    ``ALTERNATE`` steps) and its host syncs."""
    _card()
    from repro_torch.matching.cache import compile_cache_clear
    compile_cache_clear()
    for name in ("kron", "grid", "comb"):
        g = instance_sets("mini")[name]
        for pname, path in SOLVE_PATHS.items():
            cfg = path.configure(MatcherConfig())
            runs = []
            for dev in ("cpu", "cuda"):
                t = TorchCSR.from_host(g, device=dev)
                m = Matcher(cfg, ws)
                st = m.run(t.with_csc() if cfg.dirop else t)
                runs.append((_outcome(st), m.last_counts))
            _same_outcome(runs[0][0], runs[1][0], (name, pname))
            assert runs[0][1] == runs[1][1], (name, pname)


@pytest.mark.gpu
def test_cuda_second_run_is_a_cache_hit_with_no_capture():
    _card()
    from repro_torch.matching.cache import (compile_cache_clear,
                                            compile_cache_entry,
                                            compile_cache_info)
    compile_cache_clear()
    g = TorchCSR.from_host(instance_sets("mini")["rand"])
    m = Matcher(MatcherConfig(), "cheap")
    first = _outcome(m.run(g))
    key = compile_cache_info()["keys"][0]
    prog = compile_cache_entry(key)
    captured = prog.captures(g.device)
    # the entry's bytes count its graphs' pool beside its static buffers
    assert captured > 0 and prog.nbytes(g.device) > \
        prog.static_bytes(g.device) > 0
    second = _outcome(m.run(g))
    _same_outcome(first, second, "second run")
    assert prog.captures(g.device) == captured
    info = compile_cache_info()
    assert (info["misses"], info["hits"]) == (1, 1)


@pytest.mark.gpu
def test_cuda_graphs_of_one_bucket_each_get_their_own_answer():
    """Graphs of one bucket in turn through one captured entry: each gets
    the answer of its own CPU run (stale static buffers would give the
    previous graph's)."""
    _card()
    from repro_torch.matching.cache import compile_cache_clear
    compile_cache_clear()
    gs = [random_bipartite(300, 280, 3.0, seed=s, pad_to=2048)
          for s in (11, 12, 13)]
    for pname in ("jnp", "dirop_pallas"):
        cfg = SOLVE_PATHS[pname].configure(MatcherConfig())
        m = Matcher(cfg, "karp_sipser")
        for g in gs + gs[:1]:
            runs = []
            for dev in ("cpu", "cuda"):
                t = TorchCSR.from_host(g, device=dev)
                runs.append(_outcome(Matcher(cfg, "karp_sipser").run(
                    t.with_csc() if cfg.dirop else t) if dev == "cpu"
                    else m.run(t.with_csc() if cfg.dirop else t)))
            _same_outcome(runs[0], runs[1], pname)


@pytest.mark.gpu
def test_cuda_replayed_launches_are_counted():
    """The launch counters live on the card: launches replayed from a
    captured graph count, a warm-up's and a gated-off launch do not."""
    _card()
    from repro_torch.matching.cache import compile_cache_clear
    from repro_torch.matching.solve import COUNTERS
    compile_cache_clear()
    g = TorchCSR.from_host(instance_sets("mini")["kron"])
    m = Matcher(MatcherConfig(), "cheap")
    m.run(g)                                         # captures
    for _ in range(2):
        reset_launches()
        COUNTERS.reset()
        m.run(g)
        assert LAUNCHES["frontier_expand_fused_wr"] == \
            m.last_counts["push_levels"] > 0


def _level_state(g):
    cpu = TorchCSR.from_host(g, device="cpu")
    warm = Matcher(warm_start="cheap").init(cpu)
    bfs, root = level0_state(warm.cmatch)
    dev = TorchCSR.from_host(g).with_csc()
    return dev, bfs.cuda(), root.cuda(), warm.rmatch.cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
def test_cuda_level_from_a_device_pointer_equals_the_immediate(wr):
    _card()
    g, bfs, root, rmatch = _level_state(instance_sets("mini")["rand"])
    rt = root if wr else None
    for level in (2, 3):
        lv = torch.full((), level, dtype=torch.int32, device="cuda")
        on = torch.ones((), dtype=torch.int32, device="cuda")
        for fn, cols, rows in ((frontier_expand_fused, g.ecol, g.cadj),
                               (frontier_expand, g.ecol, g.cadj),
                               (frontier_expand_pull, g.radj, g.erow)):
            want = fn(cols, rows, bfs, rt, rmatch, level)
            assert torch.equal(fn(cols, rows, bfs, rt, rmatch, lv), want)
            assert torch.equal(fn(cols, rows, bfs, rt, rmatch, lv, on),
                               want)
        assert torch.equal(frontier_bits(bfs, rt, lv),
                           frontier_bits(bfs, rt, level))


@pytest.mark.gpu
@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
def test_cuda_gated_off_sweeps_leave_no_winner_or_proposal(wr):
    """Gate 0: K1 and K3 leave their IINF fill, K2 writes IINF in every
    slot, as the plain versions give; nothing is counted."""
    _card()
    g, bfs, root, rmatch = _level_state(instance_sets("mini")["rand"])
    rt = root if wr else None
    off = torch.zeros((), dtype=torch.int32, device="cuda")
    reset_launches()
    for fn, ref, cols, rows in (
            (frontier_expand_fused, frontier_expand_fused_ref, g.ecol,
             g.cadj),
            (frontier_expand, frontier_expand_ref, g.ecol, g.cadj),
            (frontier_expand_pull, frontier_expand_pull_ref, g.radj,
             g.erow)):
        assert int((fn(cols, rows, bfs, rt, rmatch, 2) < 2**30).sum()) > 0
        got = fn(cols, rows, bfs, rt, rmatch, 2, off)
        want = ref(cols, rows, bfs, rt, rmatch, 2, gate=off)
        assert torch.equal(got, want) and bool((got == 2**30).all())
    body = "wr" if wr else "plain"
    assert [LAUNCHES[f"{k}_{body}"] for k in (
        "frontier_expand_fused", "frontier_expand", "frontier_expand_pull",
        "frontier_bits")] == [1, 1, 1, 1]


@pytest.mark.gpu
def test_cuda_warm_start_that_reads_the_host_raises_at_capture():
    """A registered warm start is captured whole; one that reads a device
    value on the host cannot be, and raises, naming the warm start."""
    _card()
    from repro_torch.matching import register_warm_start
    from repro_torch.matching.device_loop import CaptureError
    from repro_torch.matching.warmstart import WARM_STARTS, _VERSIONS

    def peeks(ecol, cadj, cmatch, rmatch):
        if int(cmatch[0]) == -1:                   # a host read
            return cmatch, rmatch
        return cmatch, rmatch

    try:
        register_warm_start("peeks", peeks)
        g = TorchCSR.from_host(instance_sets("mini")["rand"])
        with pytest.raises(CaptureError, match="peeks"):
            Matcher(MatcherConfig(), "peeks").run(g)
        # the card still works after the failed capture
        st = Matcher(MatcherConfig(), "cheap").run(g)
        assert bool(st.certified)
    finally:
        WARM_STARTS.pop("peeks", None)
        _VERSIONS.pop("peeks", None)


@pytest.mark.gpu
def test_cuda_while_node_runs_its_step_until_the_flag_drops():
    """A loop is one conditional WHILE node: the step runs exactly while
    its flag is set, tested before each step; a loop whose flag never drops
    stops at the runaway guard, and the next read raises."""
    _card()
    from repro_torch.matching.device_loop import Loop, Program

    def counting(limit):
        P = Program("cuda", loop_limit=limit)
        P.constant("n", torch.zeros((), dtype=torch.int32))
        P.scalars(("live",))
        return P

    P = counting(100)

    def step(B):
        B.n.add_(1)
        B.live.copy_(B.n < 7)

    loop = Loop("count", step, "live")
    P.loop(loop)
    assert int(P.buf.n) == 7 and P.read("live") == [0]
    P.loop(loop)                              # relaunched: one more step
    assert int(P.buf.n) == 8 and P.captures == 1
    P.loop(Loop("count", step, "live", start=False))  # flag down: no step
    assert int(P.buf.n) == 8
    Q = counting(5)
    Q.loop(Loop("forever", lambda B: B.n.add_(1), "live"))
    assert int(Q.buf.n) == 5
    with pytest.raises(RuntimeError, match="stopped"):
        Q.read("live")


@pytest.mark.gpu
@pytest.mark.parametrize("builtin", ["cheap", "karp_sipser"])
def test_cuda_registered_warm_start_may_call_a_builtin(builtin):
    """A registered warm start that calls a built-in one is captured with
    the built-in's rounds as WHILE nodes inside its graph: ``run`` and
    ``init`` give the CPU's state, and a second run is a hit that captures
    nothing."""
    _card()
    from repro_torch.matching import register_warm_start
    from repro_torch.matching.cache import (compile_cache_clear,
                                            compile_cache_entry,
                                            compile_cache_info)
    from repro_torch.matching.warmstart import (WARM_STARTS, _VERSIONS,
                                                cheap_init, karp_sipser_init)
    init = {"cheap": cheap_init, "karp_sipser": karp_sipser_init}[builtin]

    def custom(ecol, cadj, cmatch, rmatch):
        # pair the first edge by hand, on the device, then the built-in
        cm, rm = cmatch.clone(), rmatch.clone()
        cm.index_copy_(0, ecol[:1].long(), cadj[:1])
        rm.index_copy_(0, cadj[:1].long(), ecol[:1])
        return init(ecol, cadj, cm, rm)

    name = f"custom_then_{builtin}"
    try:
        register_warm_start(name, custom)
        compile_cache_clear()
        for fam in ("rand", "comb"):
            g = instance_sets("mini")[fam]
            runs = []
            for dev in ("cpu", "cuda"):
                t = TorchCSR.from_host(g, device=dev)
                m = Matcher(MatcherConfig(), name)
                ini = m.init(t)
                runs.append((_outcome(m.run(t)), ini.cmatch.cpu(),
                             ini.rmatch.cpu()))
            _same_outcome(runs[0][0], runs[1][0], (fam, "run"))
            assert torch.equal(runs[0][1], runs[1][1]), (fam, "init")
            assert torch.equal(runs[0][2], runs[1][2]), (fam, "init")
        t = TorchCSR.from_host(instance_sets("mini")["comb"])
        key = compile_cache_info()["keys"][-1]
        prog = compile_cache_entry(key)
        captured = prog.captures(t.device)
        assert key[3] == "run" and captured > 0
        Matcher(MatcherConfig(), name).run(t)
        assert prog.captures(t.device) == captured
    finally:
        WARM_STARTS.pop(name, None)
        _VERSIONS.pop(name, None)


@pytest.mark.gpu
def test_cuda_runaway_in_a_loop_with_no_read_after_it_raises():
    """The ``"init"`` entry's warm-start rounds have no read after them:
    the call reads the runaway guard before it returns, and raises."""
    _card()
    from repro_torch.matching.solve import MatcherProgram
    from repro_torch.matching.warmstart import CHEAP
    g = TorchCSR.from_host(instance_sets("mini")["rand"])
    prog = MatcherProgram(g.nc, g.nr, g.nnz_pad, None, CHEAP)
    prog.program(g.device).loop_limit = 1      # cheap needs more rounds
    with pytest.raises(RuntimeError, match="stopped"):
        prog(g)


# ---------------------------------------------------------------------------
# the lane dimension: one launch for a batch of graphs of one bucket
# ---------------------------------------------------------------------------
def _lane_batch(nb: int = 5, seed: int = 30):
    """``nb`` graphs of one bucket (3000 x 2500, 13001 edge slots: an odd
    row length, so the lanes' 16-byte heads and tails differ), each a few
    levels into its first BFS phase from a cheap start (lanes at different
    levels), stacked on the CPU; a gate vector with lanes off."""
    from repro_torch.matching import TorchCSR as T
    gs = [T.from_host(random_bipartite(3000, 2500, 3.0 + i % 2,
                                       seed=seed + i, pad_to=13001),
                      device="cpu").with_csc() for i in range(nb)]
    lanes = []
    for i, g in enumerate(gs):
        st = Matcher(warm_start="cheap").init(g)
        bfs, root = level0_state(st.cmatch)
        pred = torch.full((g.nr + 1,), g.nc, dtype=torch.int32)
        rm, level = st.rmatch, 2
        for _ in range(i % 3):
            win = frontier_expand_fused_ref(g.ecol, g.cadj, bfs, root, rm,
                                            level)
            bfs, root, pred, rm, _, _ = _apply_winner(
                win, bfs, root, pred, rm, level, wr=True, wr_exact=False)
            level += 1
        lanes.append((bfs, root, rm, level))
    batch = T.stack(gs)
    bfs, root, rm = (torch.stack([x[k] for x in lanes]) for k in range(3))
    level = torch.tensor([x[3] for x in lanes], dtype=torch.int32)
    gate = torch.tensor([1, 0, 1, 1, 0][:nb], dtype=torch.int32)
    return batch, bfs, root, rm, level, gate


@pytest.mark.gpu
@pytest.mark.parametrize("wr", [True, False], ids=["wr", "plain"])
def test_cuda_batched_kernels_equal_single_launches_and_plain(wr):
    """K1, K2, K3 and K3's column pass over a 5-lane batch with lanes at
    different levels and two lanes gated off: one launch (counted once)
    equals the batched plain version on the CPU and, lane by lane, the
    single-graph launch with that lane's gate, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, bfs, root, rm, level, gate = _lane_batch()
    rt = root if wr else None
    body = "wr" if wr else "plain"
    c = {k: v.cuda() for k, v in dict(
        ecol=b.ecol, cadj=b.cadj, radj=b.radj, erow=b.erow, bfs=bfs,
        root=root, rm=rm, level=level, gate=gate).items()}
    crt = c["root"] if wr else None
    sweeps = [("frontier_expand_fused", frontier_expand_fused,
               frontier_expand_fused_ref, "ecol", "cadj"),
              ("frontier_expand", frontier_expand, frontier_expand_ref,
               "ecol", "cadj"),
              ("frontier_expand_pull", frontier_expand_pull,
               frontier_expand_pull_ref, "radj", "erow")]
    for name, kernel, plain, cols, rows in sweeps:
        reset_launches()
        got = kernel(c[cols], c[rows], c["bfs"], crt, c["rm"], c["level"],
                     c["gate"])
        # one launch, counted once, as the batched instantiation
        assert (LAUNCHES[f"{name}_{body}_batched"],
                LAUNCHES[f"{name}_{body}"]) == (1, 0), name
        want = plain(getattr(b, cols), getattr(b, rows), bfs, rt, rm, level,
                     gate)
        assert torch.equal(got.cpu(), want), name
        for i in range(bfs.shape[0]):
            one = kernel(c[cols][i].contiguous(), c[rows][i].contiguous(),
                         c["bfs"][i].contiguous(),
                         None if crt is None else crt[i].contiguous(),
                         c["rm"][i].contiguous(), c["level"][i].clone(),
                         c["gate"][i].clone())
            assert torch.equal(got[i], one), (name, i)
        off = torch.zeros_like(c["gate"])
        reset_launches()
        kernel(c[cols], c[rows], c["bfs"], crt, c["rm"], c["level"], off)
        assert LAUNCHES[f"{name}_{body}_batched"] == 0, name
    bits = frontier_bits(c["bfs"], crt, c["level"])
    assert torch.equal(bits.cpu(), frontier_bits_ref(bfs, rt, level))
    for i in range(bfs.shape[0]):
        assert torch.equal(bits[i], frontier_bits(
            c["bfs"][i].contiguous(),
            None if crt is None else crt[i].contiguous(),
            c["level"][i].clone()))


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["jnp", "legacy", "dirop", "dirop_pallas"])
def test_cuda_run_many_equals_cpu(path):
    """``run_many`` on the card (captured entry, batched kernels) equals the
    CPU's ``run_many`` lane by lane, and each lane the card's ``run``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    cfg = SOLVE_PATHS[path].configure(MatcherConfig())
    gs = [random_bipartite(3000, 2500, 3.0 + i % 2, seed=40 + i,
                           pad_to=16384) for i in range(4)]
    out = {}
    for dev in ("cpu", "cuda"):
        ts = [TorchCSR.from_host(g, device=dev) for g in gs]
        if cfg.dirop:
            ts = [t.with_csc() for t in ts]
        out[dev] = Matcher(cfg, "cheap").run_many(TorchCSR.stack(ts))
        if dev == "cuda":
            singles = [Matcher(cfg, "cheap").run(t) for t in ts]
    for f in ("cmatch", "rmatch", "phases", "fallbacks", "certified"):
        assert torch.equal(getattr(out["cuda"], f).cpu(),
                           getattr(out["cpu"], f)), f
        for i, one in enumerate(singles):
            assert torch.equal(getattr(out["cuda"], f)[i],
                               getattr(one, f)), (f, i)


@pytest.mark.gpu
def test_cuda_flush_after_warm_up_captures_nothing():
    """``warm_up()`` captures every step of its entries, the walk's among
    them (its empty graphs never walk): real flushes afterwards, which
    walk, add no capture to any entry and miss no cache entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.matching import compile_cache_clear, compile_cache_info
    from repro_torch.matching.cache import compile_cache_entry
    from repro_torch.serving import Bucketizer, MatchingService, SizeBucket
    compile_cache_clear()
    bucket = SizeBucket(4096, 4096, 32768)
    gs = [random_bipartite(3000 + 17 * i, 2800, 4.0, seed=80 + i)
          for i in range(6)]
    with MatchingService(bucketizer=Bucketizer((bucket,), device="cuda"),
                         config=MatcherConfig(), warm_start="cheap",
                         max_batch=4, max_delay_ms=1.0) as svc:
        svc.warm_up()
        keys = compile_cache_info()["keys"]
        before = {k: compile_cache_entry(k).captures("cuda") for k in keys}
        results = [f.result(timeout=300)
                   for f in [svc.submit(g) for g in gs]]
        svc.drain()
        misses = svc.metrics.snapshot()["compile_misses"]
    after = {k: compile_cache_entry(k).captures("cuda") for k in keys}
    assert all(before.values()) and after == before and misses == 0
    assert all(bool(r.state.certified) for r in results)
    assert any(int(r.state.phases) > 1 for r in results)   # a walk ran


@pytest.mark.gpu
def test_cuda_submits_from_four_threads_during_a_cold_capture():
    """Four threads submit (each admission uploads on its own thread) while
    the flush thread builds and captures cold ``run_many`` entries; every
    request resolves with the CPU's state for its graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import threading
    from repro_torch.matching import compile_cache_clear
    from repro_torch.serving import Bucketizer, MatchingService, SizeBucket
    compile_cache_clear()
    bucket = SizeBucket(4096, 4096, 32768)
    gs = [random_bipartite(3000 + 17 * i, 2800, 4.0, seed=60 + i)
          for i in range(16)]
    futs, errors = [None] * len(gs), []
    start = threading.Barrier(4)
    with MatchingService(bucketizer=Bucketizer((bucket,), device="cuda"),
                         config=MatcherConfig(), warm_start="cheap",
                         max_batch=4, max_delay_ms=1.0) as svc:
        def submit(t):
            try:
                start.wait()
                for i in range(t, len(gs), 4):
                    futs[i] = svc.submit(gs[i])
            except Exception as e:        # pragma: no cover - failure path
                errors.append(e)

        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        results = [f.result(timeout=300) for f in futs]
        svc.drain()
    cpu = Bucketizer((bucket,), device="cpu")
    for g, res in zip(gs, results):
        want = Matcher(MatcherConfig(), "cheap").run(cpu.admit(g).graph)
        for f in ("cmatch", "rmatch", "phases", "fallbacks", "certified"):
            assert torch.equal(getattr(res.state, f).cpu(),
                               getattr(want, f)), f


# ---------------------------------------------------------------------------
# training and the two knobs on the card (no kernel of the port: these hold
# the torch-op paths on the card against the same code on the CPU)
# ---------------------------------------------------------------------------
def _train_data(cfg, step, device, batch=2, seq=64):
    from repro_torch.data import DataConfig, synthetic_batch
    nb = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch), step)
    return {k: torch.from_numpy(v).to(device) for k, v in nb.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.gpu
@pytest.mark.parametrize("arch,factored", [("granite-20b", False),
                                           ("mamba2-2.7b", False),
                                           ("dbrx-132b", True)])
def test_cuda_train_step_equals_cpu(arch, factored):
    """One fp32 SMOKE train step on the card against the CPU's: the loss
    within 1e-5, every leaf within ``1e-4 * (|cpu| + max |leaf|)`` (bf16:
    one ulp plus that floor), Adam's near-zero-gradient entries of the
    parameters at most 1e-3 of them and never more than 2 lr off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import build_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    opt = OptConfig(warmup=1, factored=factored)
    params = model.init(0, device="cpu")
    card = tree_map(lambda t: t.cuda(), params)
    step = build_train_step(model, opt)
    pc, sc, mc = step(card, adamw_init(card, opt),
                      _train_data(cfg, 0, "cuda"))
    pp, sp, mp = step(params, adamw_init(params, opt),
                      _train_data(cfg, 0, "cpu"))
    assert abs(float(mc["loss"]) - float(mp["loss"])) <= \
        1e-5 * abs(float(mp["loss"]))
    got = dict(_leaves({"params": pc, "opt": sc}))
    off = total = 0
    for key, want in _leaves({"params": pp, "opt": sp}):
        g, w = got[key].float().cpu(), want.float()
        diff = (g - w).abs()
        floor = 1e-4 * float(w.abs().max())
        lim = (2.0 ** -7 * torch.maximum(g.abs(), w.abs())
               if want.dtype == torch.bfloat16 else 1e-4 * w.abs()) + floor
        bad = diff > lim
        total += w.numel()
        if bad.any():
            assert key.startswith("/params") or "/master/" in key, key
            assert float(diff.max()) <= 2 * opt.lr + 1e-6, key
            off += int(bad.sum())
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-20b", "dbrx-132b", "zamba2-7b"])
def test_cuda_remat_gradients_bit_exact(arch):
    """On the card, under torch.use_deterministic_algorithms: the
    gradients with each layer under torch.utils.checkpoint equal those
    without, bit for bit (the recomputed forward, the router's too, is
    the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.train import cross_entropy
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        grads = {}
        for remat in (False, True):
            cfg = get_config(arch, smoke=True, remat=remat)
            model = build_model(cfg)
            params = model.init(3, device="cuda")
            leaves = [p.requires_grad_(True) for _, p in _leaves(params)]
            b = _train_data(cfg, 1, "cuda")
            logits, aux = model.forward(params, b)
            loss = cross_entropy(logits, b["labels"]) + 0.01 * aux["lb_loss"]
            grads[remat] = torch.autograd.grad(loss, leaves)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_train_restart_bit_exact(tmp_path):
    """mamba2 SMOKE on the card: 4 steps straight against 2 steps, a
    checkpoint, fresh state restored from it and 2 more; the last loss
    bit for bit under torch.use_deterministic_algorithms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import build_train_step
    cfg = get_config("mamba2-2.7b", smoke=True, dtype="bfloat16",
                     remat=True)
    model = build_model(cfg)
    opt = OptConfig(warmup=1)
    step = build_train_step(model, opt)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        p = model.init(0, device="cuda")
        s = adamw_init(p, opt)
        for k in range(4):
            p, s, m = step(p, s, _train_data(cfg, k, "cuda"))
        gold = float(m["loss"])
        p = model.init(0, device="cuda")
        s = adamw_init(p, opt)
        for k in range(2):
            p, s, _ = step(p, s, _train_data(cfg, k, "cuda"))
        save_checkpoint(str(tmp_path), 2, {"params": p, "opt": s})
        fresh = model.init(1, device="cuda")
        state, at = restore_checkpoint(
            str(tmp_path), {"params": fresh, "opt": adamw_init(fresh, opt)},
            device="cuda")
        assert at == 2 and int(state["opt"]["step"]) == 2
        p, s = state["params"], state["opt"]
        for k in range(2, 4):
            p, s, m = step(p, s, _train_data(cfg, k, "cuda"))
    finally:
        torch.use_deterministic_algorithms(False)
    assert float(m["loss"]) == gold


@pytest.mark.gpu
def test_cuda_int8_cache_equals_cpu():
    """granite SMOKE (fp32) with the int8 cache, 8 decode steps on the
    card and on the CPU: codes at most one apart, scales at most one bf16
    ulp, the logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(get_config("granite-20b", smoke=True,
                                   opt_kv_quant=True))
    params = model.init(0, device="cpu")
    card_params = tree_map(lambda t: t.cuda(), params)
    toks = torch.randint(0, model.cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    cc = model.init_cache(2, 8, device="cuda")
    cp = model.init_cache(2, 8, device="cpu")
    for t in range(8):
        lc, cc = model.decode_step(card_params, cc, toks[:, t:t + 1].cuda(),
                                   t)
        lp, cp = model.decode_step(params, cp, toks[:, t:t + 1], t)
        torch.testing.assert_close(lc.cpu(), lp, rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        assert cc[name].dtype == torch.int8
        assert int((cc[name].cpu().int() - cp[name].int()).abs().max()) <= 1
    for name in ("k_scale", "v_scale"):
        a, b = cc[name].cpu().float(), cp[name].float()
        assert bool(((a - b).abs() <= 2.0 ** -7 * torch.maximum(
            a.abs(), b.abs())).all())


@pytest.mark.gpu
def test_cuda_hflat_blockwise_attn_equals_blockwise():
    """The H-flat layout on the card against blockwise_attn and against
    the CPU, fp32 (TF32 off), GQA and the causal mask, 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models.attention import (blockwise_attn,
                                              hflat_blockwise_attn)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(2, 256, 8, 32, generator=gen)
    k = torch.randn(2, 256, 2, 32, generator=gen)
    v = torch.randn(2, 256, 2, 32, generator=gen)
    pos = torch.arange(256, dtype=torch.int32)
    args = ("causal", 0, 0)
    kw = dict(q_block=64, kv_block=64)
    card = hflat_blockwise_attn(q.cuda(), k.cuda(), v.cuda(), pos.cuda(),
                                pos.cuda(), *args, **kw)
    torch.testing.assert_close(card, blockwise_attn(
        q.cuda(), k.cuda(), v.cuda(), pos.cuda(), pos.cuda(), *args, **kw),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(card.cpu(), hflat_blockwise_attn(
        q, k, v, pos, pos, *args, **kw), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_checkpoint_round_trip_and_flash_refused_in_training(tmp_path):
    """A tree of bf16, fp32 and int32 leaves on the card restores on the
    card bit for bit; the flash kernel is refused under autograd."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import build_train_step
    tree = {"a": torch.randn(3, 5, device="cuda").to(torch.bfloat16),
            "b": {"c": torch.randn(7, device="cuda"),
                  "d": torch.tensor(4, dtype=torch.int32, device="cuda")}}
    save_checkpoint(str(tmp_path), 1, tree)
    out, step = restore_checkpoint(str(tmp_path), tree, device="cuda")
    assert step == 1
    for (_, x), (_, y) in zip(_leaves(tree), _leaves(out)):
        assert y.is_cuda and x.dtype == y.dtype and torch.equal(x, y)
    model = build_model(get_config("granite-20b", smoke=True,
                                   attn_impl="pallas"))
    params = model.init(0, device="cuda")
    with pytest.raises(NotImplementedError, match="Queue 1, item 12"):
        build_train_step(model, OptConfig())(
            params, adamw_init(params, OptConfig()),
            _train_data(model.cfg, 0, "cuda"))


# ---------------------------------------------------------------------------
# The edge-sharded matcher: D shards on one card
# ---------------------------------------------------------------------------
# the three kernel paths and the body each must launch, once a shard a level
_SHARDED_PATHS = {"jnp": "frontier_expand_fused_wr",
                  "legacy": "frontier_expand_wr",
                  "dirop_pallas": "frontier_expand_pull_wr"}


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(_SHARDED_PATHS))
@pytest.mark.parametrize("d", [1, 2, 4])
def test_cuda_sharded_equals_single_device_and_cpu(d, path):
    """``ShardedMatcher`` over D shards on the card: the card's
    single-device state and the CPU's sharded one bit for bit, the
    single-device run's host syncs and levels, one merge a level, and the
    path's kernel launched once a shard on each level that swept."""
    _card()
    from repro_torch.matching import ShardedMatcher, make_mesh
    g = random_bipartite(3000, 2800, 4.0, seed=31)
    cfg = SOLVE_PATHS[path].configure(MatcherConfig())
    runs = {}
    for dev in ("cpu", "cuda"):
        t = TorchCSR.from_host(g, device=dev)
        t = t.with_csc() if cfg.dirop else t
        single = Matcher(cfg, "cheap")
        one = single.run(t)
        mesh = make_mesh((d,), ("data",), devices=[dev] * d)
        sharded = ShardedMatcher(mesh, config=cfg, warm_start="cheap")
        sharded.run(t)                                 # capture
        reset_launches()
        st = sharded.run(t)
        launches = dict(LAUNCHES)
        runs[dev] = (_outcome(st), sharded.last_counts)
        _same_outcome(_outcome(one), runs[dev][0], (dev, d, path))
        c, c1 = sharded.last_counts, single.last_counts
        assert c["host_syncs"] == c1["host_syncs"], (c, c1)
        assert c["levels"] == c1["levels"] == c["merges"]
    _same_outcome(runs["cpu"][0], runs["cuda"][0], (d, path))
    c = runs["cuda"][1]
    swept = c["pull_levels"] if path == "dirop_pallas" else c["push_levels"]
    assert swept > 0 and launches[_SHARDED_PATHS[path]] == d * swept
    if path == "dirop_pallas":
        assert launches["frontier_expand_fused_wr"] == d * c["push_levels"]


@pytest.mark.gpu
def test_cuda_kernels_on_shard_slices_equal_plain_versions():
    """K1a, K2a and K3a on each shard's slice of the edge buffers (views at
    ``d * per_shard``), K1 and K3 writing into a row of one winner
    buffer, against their plain versions over the first BFS phase; the
    rows' min is the whole graph's winners."""
    _card()
    from repro_torch.matching import make_mesh
    g = random_bipartite(5000, 4500, 4.0, seed=37)
    cpu = TorchCSR.from_host(g, device="cpu").with_csc()
    warm = Matcher(warm_start="cheap").init(cpu)
    d = 4
    sh = TorchCSR.from_host(g, device="cuda").with_csc().shard(
        make_mesh((d,), ("data",), devices=["cuda:0"] * d))
    ref = cpu.shard(make_mesh((d,), ("data",), devices=["cpu"] * d))
    cols, rows = ref.shard_slices("ecol"), ref.shard_slices("cadj")
    rcols, rrows = ref.shard_slices("radj"), ref.shard_slices("erow")
    bfs, root = level0_state(warm.cmatch)
    pred = torch.full((g.nr + 1,), g.nc, dtype=torch.int32)
    rmatch, level, ins = warm.rmatch, 2, True
    win = torch.empty((2 * d, g.nr + 1), dtype=torch.int32, device="cuda")
    while ins:
        args = (bfs.cuda(), root.cuda(), rmatch.cuda(), level)
        for i, (e, c, re, rr) in enumerate(zip(
                sh.shard_slices("ecol"), sh.shard_slices("cadj"),
                sh.shard_slices("radj"), sh.shard_slices("erow"))):
            frontier_expand_fused(e, c, *args[:2], args[2], level,
                                  out=win[i])
            frontier_expand_pull(re, rr, *args[:2], args[2], level,
                                 out=win[d + i])
            prop = frontier_expand(e, c, *args[:2], args[2], level)
            want = frontier_expand_fused_ref(cols[i], rows[i], bfs, root,
                                             rmatch, level)
            torch.cuda.synchronize()
            assert torch.equal(win[i].cpu(), want), (i, level)
            assert torch.equal(win[d + i].cpu(), frontier_expand_pull_ref(
                rcols[i], rrows[i], bfs, root, rmatch, level)), (i, level)
            assert torch.equal(prop.cpu(), frontier_expand_ref(
                cols[i], rows[i], bfs, root, rmatch, level)), (i, level)
        merged = win[:d].amin(0).cpu()
        assert torch.equal(merged, frontier_expand_fused_ref(
            cpu.ecol, cpu.cadj, bfs, root, rmatch, level)), level
        assert torch.equal(win[d:].amin(0).cpu(), merged), level
        bfs, root, pred, rmatch, ins_t, _ = _apply_winner(
            merged, bfs, root, pred, rmatch, level, wr=True, wr_exact=False)
        ins, level = bool(ins_t), level + 1
    assert level > 3


@pytest.mark.gpu
def test_cuda_service_serves_oversize_on_the_sharded_lane():
    """``MatchingService(mesh=...)`` with four shards on the card: a graph
    past every bucket goes down the sharded lane, certified, and equal to
    the card's single-device run of the bucketed graph bit for bit."""
    _card()
    from repro_torch.matching import make_mesh
    from repro_torch.serving import Bucketizer, MatchingService, SizeBucket
    mesh = make_mesh((4,), ("data",), devices=["cuda:0"] * 4)
    big = random_bipartite(2000, 2000, 4.0, seed=41)
    with MatchingService(
            bucketizer=Bucketizer((SizeBucket(256, 256, 2048),),
                                  oversize="shard"),
            config=MatcherConfig(), warm_start="cheap", mesh=mesh) as svc:
        res = svc.submit(big).result(timeout=300)
        snap = svc.metrics.snapshot()
    assert res.route == "sharded" and res.bucket is None and res.certified
    want = Matcher(MatcherConfig(), "cheap").run(
        TorchCSR.from_host(big).bucketed())
    _same_outcome(_outcome(res.state), _outcome(want), "oversize")
    assert snap["sharded"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("ws", ["cheap", "karp_sipser"])
def test_cuda_trace_equals_cpu_and_launches_k1a_a_level(ws):
    """The dirop replay on the card: the CPU's trace entry for entry, the
    fused WR sweep launched once a traced level (and once a level of the
    one-phase solves between), the relations to the card's solves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.corpus.heuristic import modelled_rel, trace_instance
    g = instance_sets("small")["kron"]
    want = trace_instance(g, ws, device="cpu")
    reset_launches()
    got = trace_instance(g, ws, device="cuda")
    assert got == want
    assert LAUNCHES["frontier_expand_fused_wr"] == 2 * got.levels
    m = Matcher(MatcherConfig(), ws)
    state = m.run(TorchCSR.from_host(g, device="cuda"))
    assert len(got.phases) == int(state.phases)
    assert got.levels == m.last_counts["levels"]
    d = Matcher(MatcherConfig(dirop=True, use_pallas=True), ws)
    d.run(TorchCSR.from_host(g, device="cuda").with_csc())
    assert modelled_rel(got, 8.0, 32.0)[1] == d.last_counts["pull_levels"]


@pytest.mark.gpu
def test_cuda_warm_start_wrappers_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.core import cheap_matching_torch, karp_sipser_torch
    for name, g in instance_sets("small").items():
        for fn in (cheap_matching_torch, karp_sipser_torch):
            got, want = fn(g, device="cuda"), fn(g, device="cpu")
            for a, b in zip(got, want):
                assert (a == b).all(), (name, fn.__name__)


@pytest.mark.gpu
def test_cuda_budgeted_fuzz_equals_cpu(tmp_path):
    """A budgeted fuzz on the card: no failure, and cell for cell the
    CPU's cardinalities; every path reached under the rotation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.corpus.verify import verify_corpus
    kw = dict(scale="mini", warm_starts=("none", "cheap", "karp_sipser"),
              budget=63, artifact_dir=str(tmp_path))
    card = verify_corpus(device="cuda", **kw)
    cpu = verify_corpus(device="cpu", **kw)
    assert not card.failures, card.summary()
    assert [(r.instance, r.path, r.warm_start, r.cardinality)
            for r in card.results] == [
        (r.instance, r.path, r.warm_start, r.cardinality)
        for r in cpu.results]
    assert {r.path for r in card.results} == set(SOLVE_PATHS)


# -- the data axis over ranks (repro_torch.distributed) ----------------------
_WORLD_PATHS = {"jnp": "frontier_expand_fused_wr",
                "legacy": "frontier_expand_wr",
                "dirop_pallas": "frontier_expand_pull_wr"}


def _world_cases(g):
    return [((path, "cheap"), g, path, "cheap", {}, None)
            for path in _WORLD_PATHS]


@pytest.mark.gpu
def test_cuda_gloo_device_ops():
    """gloo takes card tensors for every collective of ``comm`` (two ranks
    sharing the card): each equals the same collective on CPU tensors."""
    _card()
    import torch_world_ranks as ranks
    from repro_torch.distributed import run_world
    for out in run_world(ranks.card_collectives, 2, timeout=120):
        assert out["card"]["backend"] == "gloo"
        for k, v in out["cpu"].items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(out["card"][k], v), k


@pytest.mark.gpu
@pytest.mark.parametrize("size", [2, 4])
def test_cuda_gloo_world_equals_single_device(size):
    """A gloo world of ``size`` ranks sharing the card (its solve
    uncaptured, the host testing every loop's flag): every rank's state the
    card's single-device one bit for bit, one merge a level, the
    single-device host syncs plus one a test of the level and ``ALTERNATE``
    loops, and each path's kernel launched on every rank (a warm run)."""
    _card()
    import torch_world_ranks as ranks
    from repro_torch.distributed import run_world
    g = random_bipartite(3000, 2800, 4.0, seed=31)
    out = run_world(ranks.solve_cases, size, _world_cases(g), timeout=300)
    for key, g_, path, ws, kw, _ in _world_cases(g):
        cfg = SOLVE_PATHS[path].configure(MatcherConfig())
        t = TorchCSR.from_host(g, device="cuda")
        t = t.with_csc() if cfg.dirop else t
        single = Matcher(cfg, ws)
        want = ranks.outcome(single.run(t))
        for rank, res in enumerate(out):
            state, counts, launches, again = res[key]
            for a, b, c in zip(state, again, want):
                assert (a == c).all() and (b == c).all(), (key, rank)
            c1 = single.last_counts
            assert counts["merges"] == counts["levels"] == c1["levels"]
            # tests: the level loop's levels + phases, the ALTERNATE
            # loop's steps + one a run (every phase but the last, twice
            # where it fell back)
            phases, fallbacks = int(state[2]), int(state[3])
            assert counts["host_syncs"] == c1["host_syncs"] + \
                counts["levels"] + counts["alternate_steps"] + \
                2 * phases - 1 + fallbacks, (counts, c1)
            assert launches[_WORLD_PATHS[path]] > 0, (key, rank, launches)


@pytest.mark.gpu
def test_cuda_nccl_world_of_one_captures_the_merge(tmp_path):
    """A world of one NCCL rank in this process: its merge is captured in
    the level's graph under the WHILE node, so a solve makes the
    single-device host syncs; the state bit for bit."""
    _card()
    import torch_world_ranks as ranks
    from repro_torch.distributed import close_world, init_world
    g = random_bipartite(3000, 2800, 4.0, seed=31)
    world = init_world(0, 1, f"file://{tmp_path}/store", device="cuda:0")
    try:
        assert world.backend == "nccl"
        out = ranks.solve_cases(world, _world_cases(g))
    finally:
        close_world()
    for key, g_, path, ws, kw, _ in _world_cases(g):
        cfg = SOLVE_PATHS[path].configure(MatcherConfig())
        t = TorchCSR.from_host(g, device="cuda")
        t = t.with_csc() if cfg.dirop else t
        single = Matcher(cfg, ws)
        want = ranks.outcome(single.run(t))
        state, counts, launches, again = out[key]
        for a, b, c in zip(state, again, want):
            assert (a == c).all() and (b == c).all(), key
        assert counts["host_syncs"] == single.last_counts["host_syncs"]
        assert counts["merges"] == counts["levels"] > 0
        assert launches[_WORLD_PATHS[path]] > 0


# the world lane's runs: (solve path, warm start) and the kernel body each
# launches on every rank, once a level
_LANE_RUNS = {("jnp", "cheap"): "frontier_expand_fused_wr",
              ("legacy", "cheap"): "frontier_expand_wr",
              ("dirop_pallas", "cheap"): "frontier_expand_pull_wr"}


def _lane_checks(out, big, size):
    """The world lane's results: rank 0's state and every follower's the
    card's single-device run of the bucketed graph bit for bit, every
    rank's kernels launched."""
    import torch_world_ranks as ranks
    from repro_torch.serving.world_lane import matching_digest
    for i, (path, ws) in enumerate(_LANE_RUNS):
        cfg = SOLVE_PATHS[path].configure(MatcherConfig())
        t = TorchCSR.from_host(big).bucketed()
        want = ranks.outcome(Matcher(cfg, ws).run(
            t.with_csc() if cfg.dirop else t))
        res = out[0]["got"][i]
        assert res["route"] == "sharded", res
        assert res["variant"] == f"sharded-{cfg.name}@{size}"
        for a, b in zip(res["state"], want):
            assert (a == b).all(), (path, ws)
        for follower in out[1:]:
            run = follower["got"]["runs"][i]
            assert run["digest"] == matching_digest(want[0], want[1])
            assert [run["phases"], run["fallbacks"], run["certified"]] == \
                [int(want[2]), int(want[3]), bool(want[4])]
    for rank, r in enumerate(out):
        for body in _LANE_RUNS.values():
            assert r["launches"][body] > 0, (rank, body, r["launches"])


@pytest.mark.gpu
def test_cuda_world_lane_over_gloo_ranks_sharing_the_card():
    """``MatchingService`` over a gloo world of two ranks sharing the card:
    rank 0 serves, rank 1 joins each oversize request's solve; every
    rank's state the card's single-device one, K1a / K2a / K3a launched on
    every rank."""
    _card()
    import torch_world_ranks as ranks
    from repro_torch.distributed import run_world
    big = random_bipartite(3000, 2800, 4.0, seed=31)
    out = run_world(ranks.lane_runs, 2, big, list(_LANE_RUNS), timeout=300)
    _lane_checks(out, big, 2)


@pytest.mark.gpu
def test_cuda_world_lane_over_four_nccl_cards():
    """The same lane over an NCCL world of four ranks, one card each (across
    several NCCL ranks the host drives the loops; the merge is not
    captured)."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: an NCCL world takes a card "
                    "a rank")
    import torch_world_ranks as ranks
    from repro_torch.distributed import run_world
    big = random_bipartite(3000, 2800, 4.0, seed=31)
    out = run_world(ranks.lane_runs, 4, big, list(_LANE_RUNS), timeout=300)
    _lane_checks(out, big, 4)


@pytest.mark.gpu
def test_cuda_nccl_model_axis_trains_and_saves(tmp_path):
    """A 2 x 2 world of NCCL ranks, one card each: granite-20b and
    dbrx-132b SMOKE (fp32, FSDP over ``data``, sequence parallelism over
    ``model``, dbrx's experts cut over it) and mamba2-2.7b SMOKE
    (``d_inner`` cut over ``model``) each take three steps; the losses
    within the train gate (``rtol = 1e-5``) of one card's ``microbatch=2``
    steps; each save, every leaf gathered over both axes onto rank 0's
    card, restores on one card to the world's own gathered leaves bit for
    bit."""
    _card()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices: an NCCL world takes a card "
                    "a rank")
    torch.backends.cuda.matmul.allow_tf32 = False
    import torch_world_ranks as ranks
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.distributed import run_world
    archs = ("granite-20b", "dbrx-132b", "mamba2-2.7b")
    ckpts = {a: str(tmp_path / a) for a in archs}
    jobs = [(a, "axis_train", (a, 3, 4, 64, None, ckpts[a], 0, True))
            for a in archs]
    out = run_world(ranks.axis_jobs, 4, jobs, mesh=(2, 2), timeout=900)
    for arch in archs:
        one = ranks.axis_train(None, arch, 3, 4, 64, microbatch=2,
                               card=True)
        for r in out:
            assert r[arch]["losses"] == out[0][arch]["losses"], arch
        torch.testing.assert_close(torch.tensor(out[0][arch]["losses"]),
                                   torch.tensor(one["losses"]), rtol=1e-5,
                                   atol=0)
        like = {"params": out[0][arch]["params"],
                "opt": out[0][arch]["state"]}
        tree, step = restore_checkpoint(ckpts[arch], like, device="cpu")
        assert step == 3
        for got, want in zip(ranks._leaves(tree), ranks._leaves(like)):
            assert torch.equal(got, torch.as_tensor(want)), arch
