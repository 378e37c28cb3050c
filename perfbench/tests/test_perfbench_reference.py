"""The reference against itself: the tile grid against a brute force over
every triangle, the Threefry hash against its published test vector, the
radical inverse, and the film's weights."""
import numpy as np
import pytest
import torch

from perfbench.reference import film, rng, sppm, tiles
from perfbench.scenes.heightfield import heightfield


def test_threefry_known_answer():
    # Random123's known-answer vector for threefry2x32_20.
    y0, y1 = rng.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)
    assert (int(y0), int(y1)) == (0xC4923A9C, 0x483DF7A0)


def test_uniforms_in_range():
    k = rng.fold_in(rng.key(2 ** 31 + 5), np.arange(1000))
    u = rng.uniforms(k, 5)
    assert u.shape == (1000, 5) and (u >= 0).all() and (u < 1).all()
    assert abs(u.mean() - 0.5) < 0.03


def test_radical_inverse():
    a = np.array([0, 1, 2, 3, 4, 5])
    assert np.allclose(sppm.radical_inverse(0, a),
                       [0, 0.5, 0.25, 0.75, 0.125, 0.625])
    assert np.allclose(sppm.radical_inverse(1, a),
                       [0, 1 / 3, 2 / 3, 1 / 9, 4 / 9, 7 / 9])


@pytest.mark.parametrize("limit", [30.0, float("inf")])
def test_tile_grid_matches_brute_force(limit):
    n = 21
    verts, tris = heightfield(n)
    grid = tiles.TileGrid(verts, n, "cpu", side=4)
    g = torch.Generator().manual_seed(0)
    m = 512
    o = torch.stack([torch.rand(m, generator=g) * 24 - 12,
                     torch.rand(m, generator=g) * 4 + 2,
                     torch.rand(m, generator=g) * 24 - 12], 1).double()
    d = torch.randn(m, 3, generator=g).double()
    d[:, 1] = -d[:, 1].abs() - 0.2
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((m,), limit, dtype=torch.float64)
    t, tri = grid.intersect(o, d, t_max)
    v = torch.from_numpy(verts.astype(np.float64))[
        torch.from_numpy(tris.astype(np.int64))]           # [T, 3, 3]
    tb = tiles.moller_trumbore(o[:, None], d[:, None], v[None])
    tb = torch.where(tb <= t_max[:, None], tb, float("inf"))
    best, arg = tb.min(1)
    assert torch.equal(torch.isfinite(t), torch.isfinite(best))
    hit = torch.isfinite(best)
    assert hit.sum() > m // 4
    assert torch.allclose(t[hit], best[hit], rtol=1e-12)
    assert torch.equal(tri[hit], arg[hit])
    assert (grid.triangle_vertices(tri[hit]) == v[tri[hit]]).all()


def test_splat_weights_sum_like_the_filter():
    # One lane per pixel at its centre: each pixel's weight sum is the
    # same table-quantised sum over its neighbours.
    res = 8
    xs = np.arange(0, res + 2)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    p = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float32) + 0.5
    xyz, w = film.splat(p, np.ones((p.shape[0], 3)), (res, res), (1.0, 1.0),
                        3.0)
    assert np.allclose(w[1:, 1:], w[3, 3])
    assert np.allclose(xyz[..., 1] / w, 1.0, atol=1e-6)   # Y of white is 1
