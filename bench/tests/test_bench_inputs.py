"""The generators repeat exactly from a seed, and every seed gets the same
work: the same sizes, in another order."""
import numpy as np

from bench import graphs


def _kron(seed, scale=8, factor=16):
    gen = graphs.generator(seed, "cpu")
    return graphs.make_pool(dict(family="kron", scale=scale,
                                 edge_factor=factor, pool=2), gen, "cpu")


def _same(a, b):
    return (a.nc, a.nr, a.nnz) == (b.nc, b.nr, b.nnz) and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("cxadj", "cadj", "ecol"))


def test_kron_repeats_from_its_seed_and_differs_across_seeds():
    a, b, c = _kron(2**31 + 11), _kron(2**31 + 11), _kron(12)
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not _same(a[0], c[0])
    assert not _same(a[0], a[1])          # the pool's graphs differ


def test_kron_csr_is_sorted_deduplicated_and_padded():
    g = _kron(3)[0]
    assert g.nc == g.nr == 256 and 0 < g.nnz <= 256 * 16 * 2
    assert g.nnz_pad % graphs.LANE == 0 and g.nnz_pad >= g.nnz
    keys = g.ecol[: g.nnz].astype(np.int64) * g.nr + g.cadj[: g.nnz]
    assert np.all(np.diff(keys) > 0)
    assert np.array_equal(np.diff(g.cxadj), np.bincount(
        g.ecol[: g.nnz], minlength=g.nc))
    assert np.all(g.cadj[g.nnz:] == g.nr) and np.all(g.ecol[g.nnz:] == g.nc)


def test_kron_is_symmetric_as_graph500s_undirected_graph():
    g = _kron(2**31 + 7)[0]
    c = g.ecol[: g.nnz].astype(np.int64)
    r = g.cadj[: g.nnz].astype(np.int64)
    assert np.array_equal(np.sort(c * g.nr + r), np.sort(r * g.nr + c))
    assert g.nnz > 256 * 16            # both ways: more than the draws


def test_bucket_padding_is_a_power_of_two_multiple_of_the_lane():
    assert graphs.padded_size(1, "bucket") == 128
    assert graphs.padded_size(129, "bucket") == 256
    assert graphs.padded_size(63_800_000, "bucket") == 1 << 26
    assert graphs.padded_size(5_238_784, "lane") == 5_238_784


def test_mesh_has_its_edge_count_and_rcp_keeps_the_degrees():
    side = 12
    plain = graphs.make_pool(dict(family="mesh", side=side, pool=1),
                             graphs.generator(0, "cpu"), "cpu")[0]
    assert plain.nnz == side * side + 4 * side * (side - 1)
    pools = [graphs.make_pool(dict(family="mesh", side=side, rcp=True,
                                   pool=2), graphs.generator(s, "cpu"), "cpu")
             for s in (5, 5, 6)]
    assert all(_same(x, y) for x, y in zip(pools[0], pools[1]))
    assert not _same(pools[0][0], pools[2][0])
    for g in pools[0]:
        assert g.nnz == plain.nnz
        assert sorted(np.diff(g.cxadj)) == sorted(np.diff(plain.cxadj))


def test_sizes_are_the_same_for_every_seed():
    spec = dict(family="kron", edge_factor=4,
                sizes=[dict(scale=5, count=3), dict(scale=6, count=1)])
    for seed in (1, 99):
        pool = graphs.make_pool(spec, graphs.generator(seed, "cpu"), "cpu")
        assert [g.nc for g in pool] == [32, 32, 32, 64]


def test_pool_order_cycles_through_every_graph():
    order = graphs.permutation(5, 12, graphs.generator(3, "cpu"))
    assert sorted(order[:5]) == list(range(5))
    assert sorted(order[5:10]) == list(range(5))
