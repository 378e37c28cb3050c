"""The port's multi-device layer (trace_tpu_torch/parallel) on the CPU:
render_sharded and SPPMIntegrator(mesh=) on 2 and 3 gloo ranks
(tests/torch_dist.py; 16^2 = 256 pixels and 1024 photons pad over 3),
against the port's single-device renders and the JAX package's goldens.

Settings are the JAX package's own multi-device tests':
test_sampler_parallel.py's test_render_sharded_8_devices (spheres 12^2,
1 spp, depth 2, seed 5, atol 2e-6), test_sppm_photon_sharding_bit_exact
(radius 0.2, depth 2, 1 iteration of 1024 photons, seed 2: tau, m and
radius equal) and test_sppm_full_spmd_runs (seed 1, the camera pass
sharded too: m equal, tau and ld within 1e-5), and __graft_entry__.py's
dryrun_multichip (its scene at 16^2; sharded within 2e-6 of one device,
:243, :264, :317). The goldens dryrun16_{whitted,path,sppm}.npy are the
JAX package's single-chip renders of that scene (MSE gate 5e-4). One
spawn a world size serves every case; each rank runs them all.
"""
import os

import numpy as np
import pytest
import torch

import torch_dist as TD

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
MSE_GATE = 5e-4
SHARD_ATOL = 2e-6


@pytest.fixture(scope="module")
def single():
    torch.set_num_threads(1)
    return TD.single_cases()


@pytest.fixture(scope="module", params=[2, 3], ids=["ranks2", "ranks3"])
def ranks(request, tmp_path_factory):
    n = request.param
    return TD.run_ranks(TD.sharded_cases, n,
                        tmp_path_factory.mktemp(f"ranks{n}"))


def test_every_rank_returns_the_same_bits(ranks):
    names = set(ranks[0])
    assert len(names) == 28
    for r in ranks[1:]:
        assert set(r) == names
        for k in names:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("integrator", ["whitted", "path"])
def test_render_sharded_matches_one_device(ranks, single, integrator):
    img = ranks[0][f"spheres_{integrator}_0"]
    assert img.shape == (12, 12, 3)
    assert np.isfinite(img).all() and img.max() > 0.01
    np.testing.assert_array_equal(ranks[0][f"spheres_{integrator}_1"], img)
    np.testing.assert_allclose(img, single[f"spheres_{integrator}"],
                               atol=SHARD_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["whitted", "path", "sppm"])
def test_dryrun_scene_against_goldens_and_one_device(ranks, single, name):
    img = ranks[0][f"dryrun_{name}"]
    golden = np.load(os.path.join(GOLDENS, f"dryrun16_{name}.npy"))
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert float(np.mean((img - golden) ** 2)) < MSE_GATE
    assert float(np.abs(img - single[f"dryrun_{name}"]).max()) < SHARD_ATOL


def test_sppm_photon_sharding_bit_exact(ranks, single):
    # The update folds M into n and zeroes it: n carries the counts.
    for k in ("tau", "m", "radius", "n"):
        np.testing.assert_array_equal(ranks[0][f"photons_{k}"],
                                      single[f"photons_{k}"], err_msg=k)
    assert (ranks[0]["photons_n"] > 0).sum() > 10


def test_sppm_full_spmd_matches_one_device(ranks, single):
    r = ranks[0]
    for k in ("m", "n"):
        np.testing.assert_array_equal(r[f"spmd_{k}"], single[f"spmd_{k}"])
    np.testing.assert_allclose(r["spmd_tau"], single["spmd_tau"], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(r["spmd_ld"], single["spmd_ld"], atol=1e-5,
                               rtol=0)
    assert (r["spmd_n"] > 0).sum() > 10 and r["spmd_ld"].max() > 0


def test_sppm_deep_splat_layout_matches_one_device(ranks, single):
    # Depth 4: a rank's splat records lie level by level after the ranks
    # before it, so pairs reach a pixel in another order than on one
    # device. The counts (n) exactly; the image within the dryrun's gate.
    r = ranks[0]
    np.testing.assert_array_equal(r["deep_n"], single["deep_n"])
    img = r["deep_image"]
    assert img.shape == (24, 24, 3) and np.isfinite(img).all()
    assert float(np.abs(img - single["deep_image"]).max()) < SHARD_ATOL
    assert (r["deep_tau"].sum(-1) > 0).sum() > 10


def test_sharded_paths_refuse_what_jax_refuses(ranks):
    # Animated geometry and render_frames with a mesh; an axis the mesh
    # lacks (render_sharded, SPPMIntegrator); an unknown integrator.
    assert ranks[0]["refusals"].tolist() == [1, 1, 1, 1, 1]


def test_gather_is_exact_in_rank_order(ranks):
    # Shares summed over ranks with -0.0 (integers 0) elsewhere: every
    # value comes back bit for bit, signed zeros, NaN and inf included.
    n = len(ranks)
    f, signs = ranks[0]["gather_f"], ranks[0]["gather_f_signs"]
    assert f.shape == (3 * n, 2)
    for r in range(n):
        share, sign = f[3 * r:3 * r + 3], signs[3 * r:3 * r + 3]
        assert sign[0].tolist() == [True, False]
        assert np.isnan(share[1, 0]) and share[1, 1] == -np.inf
        assert share[2].tolist() == [r, -r]
    np.testing.assert_array_equal(
        ranks[0]["gather_i"], np.concatenate([[r, -r, 1 << 40]
                                              for r in range(n)]))
    assert ranks[0]["gather_i"].dtype == np.int64
    np.testing.assert_array_equal(
        ranks[0]["gather_b"], np.concatenate([[r % 2 == 0, True]
                                              for r in range(n)]))
