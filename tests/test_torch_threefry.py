"""The Threefry-2x32 kernel (csrc/threefry.cu, ops/threefry.py) and the
route of sampler/uniform.py's draws.

On the card every ``fold_in`` and ``uniform_lanes`` is one launch of the
kernel; CPU tensors take the plain twins. Tolerance: 0 ulp everywhere:
the hash is integer arithmetic and a uniform (bits >> 9) * 2^-23 is exact,
so the kernel, the twins and ``jax.random`` agree bit for bit.

- On the CPU: every broadcast form the callers use, against
  ``threefry2x32`` on the masked data and against ``jax.random``; data as a
  0-d tensor, int32, negative and at or past 2^32; no lanes; a CPU call
  launches and counts nothing; the wrapper refuses CPU tensors; and the
  kernel's own source, compiled for the host with stub macros, against
  the twins.
- On the card (``cuda`` marker): the kernel against the twins at 65,536
  and 1,048,576 lanes, inside a CUDA graph with a device salt changed
  between replays, one launch a call. JAX is imported in a fixture only,
  so ``python -m pytest --noconftest -m cuda tests/test_torch_threefry.py``
  runs where JAX is not installed.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from trace_tpu_torch.integrators.fused import kernel_counts
from trace_tpu_torch.ops import threefry as TF
from trace_tpu_torch.sampler import uniform as U
from trace_tpu_torch.utils.stats import collect

M32 = 0xFFFFFFFF
SRC = os.path.join(os.path.dirname(TF.__file__), os.pardir, "csrc",
                   "threefry.cu")
# The callers' forms: (key batch shape, data shape or None for a Python
# integer). lane_keys / split; fold_lanes(ks, j); fold_lanes(ks, path);
# fold_in(base_key, s).
FORMS = {"key_lanes": ((), (7,)), "keys_scalar": ((7,), None),
         "keys_lanes": ((7,), (7,)), "key_scalar": ((), None),
         "keys_0d": ((7,), ()), "key_one": ((1,), (7,))}
# Data values: in range, negative, at and past 2^32, as int64 and int32.
DATA = {"int64": (np.array([0, 1, 3, 65537, 2**31, 2**32 - 1, 5], np.int64),
                  torch.int64),
        "int32": (np.array([0, -1, 2**31 - 1, -2**31, 7, 1000, -5],
                           np.int64), torch.int32),
        "negative": (np.array([-1, -2, -2**31, -2**40, -7, -65536, -3],
                              np.int64), torch.int64),
        "past_2_32": (np.array([2**32, 2**32 + 1, 2**40 + 9, 2**62, 2**33,
                                3 * 2**32 + 5, 2**63 - 1], np.int64),
                      torch.int64)}


@pytest.fixture(scope="module")
def jx():
    """jax.random and the JAX package's sampler, imported here so that the
    ``cuda`` tests also run where JAX is not installed."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from trace_tpu.sampler import uniform as JU
    return jax, jnp, JU


def _keys(batch, seed=3, device="cpu"):
    """Key words [*batch, 2] from seed: lane keys of a base key."""
    n = int(np.prod(batch)) if batch else 1
    ks = U.fold_in_plain(U.key(seed, device),
                         torch.arange(n, device=device) * 977 + 11)
    return ks.reshape(tuple(batch) + (2,))


def _data(form, kind, device="cpu"):
    """The form's data: a Python int, or a tensor of the kind's dtype."""
    values, dtype = DATA[kind]
    shape = FORMS[form][1]
    if shape is None:
        return int(values[3])
    n = int(np.prod(shape)) if shape else 1
    return torch.from_numpy(values[:n].copy()).to(dtype).reshape(shape).to(
        device)


def _reference(keys, data):
    """threefry2x32 on the counter (0, data & M32) under each key, by
    broadcasting, in int64 on the CPU."""
    d = torch.as_tensor(data).to(torch.int64).cpu() & M32
    k = keys.cpu()
    y0, y1 = U.threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def _words(jax, keys):
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.mark.parametrize("kind", list(DATA))
@pytest.mark.parametrize("form", list(FORMS))
def test_fold_forms_equal_the_hash_and_jax(form, kind, jx):
    jax, jnp, JU = jx
    batch = FORMS[form][0]
    keys, data = _keys(batch), _data(form, kind)
    got = U.fold_in(keys, data)
    want = _reference(keys, data)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)
    # jax.random on the masked data (uint32): fold_in per key and datum.
    flat_k = keys.reshape(-1, 2).numpy().astype(np.uint32)
    jkeys = jax.random.wrap_key_data(jnp.asarray(flat_k))
    d = (torch.as_tensor(data).to(torch.int64) & M32).numpy().astype(
        np.uint32).reshape(-1)
    n = int(np.prod(want.shape[:-1]))
    jk = jkeys if flat_k.shape[0] == n else jnp.broadcast_to(jkeys, (n,))
    jd = jnp.asarray(d if d.shape[0] == n else np.broadcast_to(d, (n,)))
    out = jax.vmap(jax.random.fold_in)(jk, jd)
    np.testing.assert_array_equal(_words(jax, out),
                                  want.reshape(-1, 2).numpy())


@pytest.mark.parametrize("num", [0, 1, 3, 1000])
def test_split_and_lane_keys_equal_jax(num, jx):
    jax, jnp, JU = jx
    k = jax.random.key(2**31 + 5)
    np.testing.assert_array_equal(
        _words(jax, jax.random.split(k, num)).reshape(num, 2),
        U.split(U.key(2**31 + 5, "cpu"), num).numpy())
    ids = np.arange(num, dtype=np.uint32) * 65537
    np.testing.assert_array_equal(
        _words(jax, JU.lane_keys(k, jnp.asarray(ids))).reshape(num, 2),
        U.lane_keys(U.key(2**31 + 5, "cpu"),
                    torch.from_numpy(ids.astype(np.int64))).numpy())


@pytest.mark.parametrize("shape", [(0,), (1,), (5,), (1000, 2), (3, 5, 7)])
def test_uniform_equals_jax(shape, jx):
    jax, jnp, JU = jx
    want = np.asarray(jax.random.uniform(jax.random.key(9), shape,
                                         jnp.float32))
    got = U.uniform(U.key(9, "cpu"), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("cols", [0, 1, 2, 5])
@pytest.mark.parametrize("n", [0, 1, 300])
def test_uniform_lanes_equal_jax(n, cols, jx):
    jax, jnp, JU = jx
    keys = _keys((n,))
    got = U.uniform_lanes(keys, cols)
    assert tuple(got.shape) == (n, cols) and got.dtype == torch.float32
    if n and cols:
        jk = jax.random.wrap_key_data(jnp.asarray(keys.numpy().astype(
            np.uint32)))
        np.testing.assert_array_equal(np.asarray(JU.uniform_lanes(jk, cols)),
                                      got.numpy())


@pytest.mark.parametrize("call", ["fold_in", "fold_in_0d", "uniform_lanes",
                                  "uniform", "split"])
def test_cpu_takes_the_plain_twin_and_counts_nothing(call):
    keys = _keys((64,))
    runs = {"fold_in": lambda: U.fold_in(keys, 3),
            "fold_in_0d": lambda: U.fold_in(keys, torch.tensor(3)),
            "uniform_lanes": lambda: U.uniform_lanes(keys, 5),
            "uniform": lambda: U.uniform(U.key(1, "cpu"), (64, 2)),
            "split": lambda: U.split(U.key(1, "cpu"), 64)}
    twins = {"fold_in": lambda: U.fold_in_plain(keys, 3),
             "fold_in_0d": lambda: U.fold_in_plain(keys, torch.tensor(3)),
             "uniform_lanes": lambda: U.uniform_lanes_plain(keys, 5),
             "uniform": lambda: U.uniform_lanes_plain(
                 U.key(1, "cpu")[None], 128).reshape(64, 2),
             "split": lambda: U.fold_in_plain(U.key(1, "cpu"),
                                              torch.arange(64))}
    before = TF.threefry_kernel.launches
    with collect() as stats:
        got = runs[call]()
    assert torch.equal(got, twins[call]())
    assert TF.threefry_kernel.launches == before
    assert "threefry_launches" not in stats.counters
    assert "threefry" in kernel_counts()


@pytest.mark.parametrize("call", ["fold", "fold_scalar", "uniform"])
def test_kernel_wrapper_refuses_cpu_tensors(call):
    keys = _keys((8,))
    runs = {"fold": lambda: TF.threefry_kernel.fold(keys, torch.arange(8)),
            "fold_scalar": lambda: TF.threefry_kernel.fold(keys, 1),
            "uniform": lambda: TF.threefry_kernel.uniform(keys, 2)}
    before = TF.threefry_kernel.launches
    with pytest.raises(ValueError, match="wants CUDA tensors"):
        runs[call]()
    assert TF.threefry_kernel.launches == before


# The kernel's source compiled for the host: the stubs stand in for CUDA's
# qualifiers, built-ins and vector types, and a loop over (block, thread)
# for each launch; the launchers (CUDA's <<<>>> syntax) are left out.
HOST_STUBS = r"""
#include <stdint.h>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __restrict__
struct Idx { unsigned x; };
static Idx blockIdx, threadIdx;
struct longlong2 { long long x, y; };
struct uint2 { uint32_t x, y; };
static inline longlong2 make_longlong2(long long a, long long b) {
  longlong2 r = {a, b}; return r; }
static inline uint2 make_uint2(uint32_t a, uint32_t b) {
  uint2 r = {a, b}; return r; }
// CUDA: the high word of (hi:lo) << (s & 31).
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, int s) {
  s &= 31; return s ? (hi << s) | (lo >> (32 - s)) : hi; }
"""
HOST_LAUNCHERS = r"""
}  // namespace
extern "C" void fold_host(const void *keys, int key_step, const void *data,
                          int kind, int step, unsigned scalar, void *out,
                          long long n) {
  for (long long i = 0; i < (n + kThreads - 1) / kThreads * kThreads; ++i) {
    blockIdx.x = (unsigned)(i / kThreads); threadIdx.x = i % kThreads;
    threefry_fold_kernel((const longlong2 *)keys, key_step, data, kind, step,
                         scalar, (longlong2 *)out, n);
  }
}
extern "C" void uniform_host(const void *keys, long long n_keys,
                             long long cols, void *out) {
  const long long total = n_keys * cols;
  for (long long i = 0; i < (total + kThreads - 1) / kThreads * kThreads;
       ++i) {
    blockIdx.x = (unsigned)(i / kThreads); threadIdx.x = i % kThreads;
    threefry_uniform_kernel((const longlong2 *)keys, n_keys == 1,
                            (uint32_t)cols, (float *)out, (uint32_t)total);
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    src = open(SRC).read()
    body = src.split("}  // namespace")[0]
    body = re.sub(r"#include <cuda_runtime.h>\n", "", body)
    d = tmp_path_factory.mktemp("threefry_host")
    cpp, lib = d / "threefry_host.cpp", d / "libthreefry_host.so"
    cpp.write_text(HOST_STUBS + body + HOST_LAUNCHERS)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(lib),
                    str(cpp)], check=True, capture_output=True, timeout=120)
    return ctypes.CDLL(str(lib))


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


@pytest.mark.parametrize("kind", list(DATA))
@pytest.mark.parametrize("form", ["key_lanes", "keys_scalar", "keys_lanes",
                                  "key_scalar", "keys_0d"])
def test_kernel_source_on_the_host_equals_the_twin(form, kind, host_kernel):
    """The fold's arguments as ThreefryKernel.fold passes them for each
    form (a scalar as a launch argument, a one-element tensor read with
    step 0), over 1,000 lanes."""
    batch, shape = FORMS[form]
    n = 1000
    batch = (n,) if batch else ()
    keys = _keys(batch)
    values, dtype = DATA[kind]
    if shape is None:
        data, kind_id, step, scalar = None, TF.SCALAR, 0, int(values[3]) & M32
        want = U.fold_in_plain(keys, int(values[3]))
    else:
        m = n if shape else 1
        data = torch.from_numpy(np.resize(values, m)).to(dtype)
        data = data.reshape(()) if not shape else data
        kind_id, step, scalar = TF._KINDS[dtype], int(m > 1), 0
        want = U.fold_in_plain(keys, data)
    out_n = int(np.prod(want.shape[:-1]))
    out = torch.empty(want.shape, dtype=torch.int64)
    host_kernel.fold_host(_p(keys), int(keys.numel() // 2 > 1),
                          None if data is None else _p(data), kind_id, step,
                          ctypes.c_uint(scalar), _p(out),
                          ctypes.c_longlong(out_n))
    assert torch.equal(out, want)


@pytest.mark.parametrize("n,cols", [(1000, 1), (1000, 2), (1000, 5),
                                    (1, 2049), (3, 7)])
def test_kernel_source_on_the_host_uniform(n, cols, host_kernel):
    keys = _keys((n,))
    out = torch.empty((n, cols), dtype=torch.float32)
    host_kernel.uniform_host(_p(keys), ctypes.c_longlong(n),
                             ctypes.c_longlong(cols), _p(out))
    assert torch.equal(out, U.uniform_lanes_plain(keys, cols))


# -- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launch_once(fn):
    """fn() on the card, checked to launch the kernel once."""
    before = TF.threefry_kernel.launches
    with collect() as stats:
        out = fn()
    torch.cuda.synchronize()
    assert TF.threefry_kernel.launches == before + 1
    assert stats.counters["threefry_launches"] == 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [65536, 1 << 20])
@pytest.mark.parametrize("form", list(FORMS))
def test_cuda_fold_equals_the_twin(form, lanes):
    dev = _card()
    batch, shape = FORMS[form]
    keys = _keys((lanes,) if batch and batch != (1,) else batch, 5, dev)
    for kind in DATA:
        values, dtype = DATA[kind]
        if shape is None:
            data = int(values[3])
        else:
            m = lanes if shape else 1
            data = torch.from_numpy(np.resize(values, m)).to(dtype).to(dev)
            data = data.reshape(()) if shape == () else data
        got = _launch_once(lambda: U.fold_in(keys, data))
        assert torch.equal(got, U.fold_in_plain(keys, data)), (form, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 2, 5])
@pytest.mark.parametrize("lanes", [65536, 1 << 20])
def test_cuda_uniform_equals_the_twin(lanes, cols):
    dev = _card()
    keys = _keys((lanes,), 6, dev)
    got = _launch_once(lambda: U.uniform_lanes(keys, cols))
    assert torch.equal(got, U.uniform_lanes_plain(keys, cols))


@pytest.mark.cuda
def test_cuda_uniform_of_one_key_and_other_data():
    """uniform(key, (65536, 2)) (the stratified sampler's draw), data as a
    CPU 0-d tensor, a strided view, and an empty call (no launch)."""
    dev = _card()
    key = U.key(1234, dev)
    got = _launch_once(lambda: U.uniform(key, (65536, 2)))
    assert torch.equal(got, U.uniform_lanes_plain(key[None], 131072)
                       .reshape(65536, 2))
    keys = _keys((4096,), 7, dev)
    got = _launch_once(lambda: U.fold_in(keys, torch.tensor(-9)))
    assert torch.equal(got, U.fold_in_plain(keys, -9))
    wide = _keys((4096, 2), 8, dev)[:, 1]          # a non-contiguous view
    data = torch.arange(8192, device=dev)[::2]
    got = _launch_once(lambda: U.fold_in(wide, data))
    assert torch.equal(got, U.fold_in_plain(wide, data))
    before = TF.threefry_kernel.launches
    assert U.fold_in(keys[:0], 3).shape == (0, 2)
    assert U.uniform_lanes(keys[:0], 5).shape == (0, 5)
    assert TF.threefry_kernel.launches == before
    with pytest.raises(ValueError, match="one element or one"):
        U.fold_in(keys[:, None], torch.arange(3, device=dev))


@pytest.mark.cuda
def test_cuda_graph_replays_with_a_device_salt():
    """A fold by a device scalar and a uniform of its keys captured into a
    CUDA graph: each replay, after the salt is changed, gives the twins'
    bits for that salt; the capture counts one launch each."""
    dev = _card()
    keys = _keys((65536,), 10, dev)
    salt = torch.zeros((), dtype=torch.int64, device=dev)

    def body():
        return U.uniform_lanes(U.fold_in(keys, salt), 5)

    body()
    torch.cuda.synchronize()
    before = TF.threefry_kernel.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = body()
    assert TF.threefry_kernel.launches == before + 2
    for s in (0, 1, 7, -3, 2**32 + 1):
        salt.fill_(s)
        graph.replay()
        torch.cuda.synchronize()
        want = U.uniform_lanes_plain(U.fold_in_plain(keys, s), 5)
        assert torch.equal(out, want), s
