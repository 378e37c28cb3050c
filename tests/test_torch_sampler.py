"""The port's Threefry-2x32 sampler against trace_tpu.sampler.uniform.

Tolerance: 0 ulp. Every key word and every uniform must be bit-equal to
``jax.random`` (which runs with jax_threefry_partitionable=True), or no
render of the port can match the JAX package pixel for pixel.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from trace_tpu.sampler import uniform as JU
from trace_tpu_torch.sampler import uniform as TU

IDS = np.array([0, 1, 2, 7, 65537, 123456789, 2**31 - 1, 2**31, 2**32 - 1],
               np.uint32)


def _words(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_partitionable_threefry_is_the_reference_layout():
    # The bit layout of uniform(key, (cols,)) depends on this flag; the
    # port implements the partitionable layout.
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5])
def test_key_and_fold_in(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(_words(k), TU.key(seed, "cpu").numpy())
    for data in (0, 1, 3, 1000, 2**32 - 1):
        np.testing.assert_array_equal(
            _words(jax.random.fold_in(k, data)),
            TU.fold_in(TU.key(seed, "cpu"), data).numpy())


@pytest.mark.parametrize("cols", [1, 2, 5, 8])
def test_uniform_lanes(cols):
    jk = JU.lane_keys(jax.random.key(3), jnp.asarray(IDS))
    tk = TU.lane_keys(TU.key(3, "cpu"), _t(IDS))
    np.testing.assert_array_equal(_words(jk), tk.numpy())
    ju = np.asarray(JU.uniform_lanes(jk, cols))
    tu = TU.uniform_lanes(tk, cols).numpy()
    assert tu.dtype == np.float32
    np.testing.assert_array_equal(ju, tu)
    assert ((tu >= 0.0) & (tu < 1.0)).all()


def test_fold_lanes_scalar_and_per_lane():
    jk = JU.lane_keys(jax.random.key(11), jnp.asarray(IDS))
    tk = TU.lane_keys(TU.key(11, "cpu"), _t(IDS))
    for salt in (0, 1, 2, 5):
        np.testing.assert_array_equal(_words(JU.fold_lanes(jk, salt)),
                                      TU.fold_lanes(tk, salt).numpy())
    paths = np.arange(IDS.shape[0], dtype=np.uint32) * 7 + 1
    np.testing.assert_array_equal(
        _words(JU.fold_lanes(jk, jnp.asarray(paths))),
        TU.fold_lanes(tk, _t(paths)).numpy())


def test_pixel_ids_and_camera_samples():
    rng = np.random.default_rng(0)
    pix = rng.integers(-1, 300, (64, 2)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(JU.pixel_ids(jnp.asarray(pix))).astype(np.int64),
        TU.pixel_ids(torch.from_numpy(pix)).numpy())
    jk = JU.fold_lanes(JU.lane_keys(jax.random.fold_in(jax.random.key(0), 0),
                                    JU.pixel_ids(jnp.asarray(pix))), 0)
    tk = TU.fold_lanes(TU.lane_keys(TU.fold_in(TU.key(0, "cpu"), 0),
                                    TU.pixel_ids(torch.from_numpy(pix))), 0)
    for a, b in zip(JU.get_camera_samples_lanes(jk, jnp.asarray(pix)),
                    TU.get_camera_samples_lanes(tk, torch.from_numpy(pix))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
