"""The port's environment light (lights/lights.py, wavefront/lights.py and
the integrators that read it) against the JAX package's env functions,
on the same numpy inputs made from a seed.

The JAX package renders environment-lit scenes on its packed path only,
so the oracle is that path: ``trace_tpu.lights.lights`` (tables, lookups,
samplers) and the packed ``li`` of ``trace_tpu.integrators.whitted`` and
``path``, run on JAX-built scenes carried across by convert.py.

Tolerances: tables equal as arrays. Lookups and samplers: texels equal
except for lanes at a texel edge, where XLA's and torch's f32 acos/atan2
differ in the last bit and floor() takes the neighbour (counted, at most
1 in 1000); every other value within 1e-6 relative (absolute floor
1e-6). Integrators per lane: packed-vs-planar's tolerance
(tests/test_wavefront_equiv.py: rtol 2e-4, atol 2e-5), lanes outside it
counted and bounded (1 in 1000); furnace means as in
tests/test_env_light.py (6% Whitted, 5-6% path).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_jax_arrays import both, both3, lane_keys, np3, port_scene
from trace_tpu.core import transform as JT
from trace_tpu.core.ray import RayDifferentials as JRD
from trace_tpu.integrators import path as JPath
from trace_tpu.integrators import whitted as JWhitted
from trace_tpu.lights import lights as JL
from trace_tpu.materials.materials import MatteMaterial as JMatte
from trace_tpu.scene import SceneBuilder as JSceneBuilder
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.core.ray import RayDifferentials as TRD
from trace_tpu_torch.core.vec import V3
from trace_tpu_torch.lights import lights as TL
from trace_tpu_torch.wavefront import lights as TWL
from trace_tpu_torch.wavefront import path as TP
from trace_tpu_torch.wavefront import whitted as TWF

RTOL = ATOL = 1e-6
FLIPS = 1e-3          # texel-edge lanes allowed, a fraction of the lanes
LI_RTOL, LI_ATOL = 2e-4, 2e-5
N = 4096


def _image(h, w, seed=0, lo=0.2, hi=2.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(h, w, 3)).astype(np.float32)


def _hot_image():
    img = np.full((8, 16, 3), 0.1, np.float32)
    img[2, 5] = 5.0
    return img


# name -> (image or None, radiance): an image, a constant sky, a 1x1 image
# (stored as 1x2), and a 3x5 image (a width that is not a power of two).
ENVS = {"image": (_image(8, 16), (1.0, 1.0, 1.0)),
        "constant": (None, (0.7, 0.6, 0.5)),
        "one_texel": (np.full((1, 1, 3), 2.0, np.float32), (0.5, 1.0, 1.5)),
        "3x5": (_image(3, 5, seed=4), (1.0, 2.0, 1.0)),
        "hot": (_hot_image(), (1.0, 1.0, 1.0))}
L2W = {"identity": None, "rotated": (20.0, -90.0)}


def _xf(mod, spec):
    """The environment frame: a translation (which an environment light
    ignores) after rotations about y and x."""
    if spec is None:
        return None
    return mod.compose(mod.translate([1.0, 2.0, 3.0]),
                       mod.compose(mod.rotate_y(spec[0]),
                                   mod.rotate_x(spec[1])))


def _pair(env, l2w="identity", with_point=False):
    """(port light table, JAX light table) of one environment light, after
    a point light if ``with_point``, preprocessed alike."""
    image, radiance = ENVS[env]
    out = []
    for mod, L in ((TT, TL), (JT, JL)):
        entries = [L.point_light(mod.translate([0.0, 3.0, 0.0]),
                                 (5.0, 5.0, 5.0))] if with_point else []
        entries.append(L.infinite_light(_xf(mod, L2W[l2w]), radiance, image))
        out.append(L.preprocess(L.pack_lights(entries),
                                np.array([0.5, -1.0, 2.0], np.float32), 3.5))
    return tuple(out)


class _Scene:
    """The parts of a scene the env functions read."""

    def __init__(self, lights):
        self.lights = lights
        self.env = TWL.device_env(lights, "cpu")


def _close(t, j, msg=""):
    np.testing.assert_allclose(np3(t) if isinstance(t, tuple) else
                               np.asarray(t), np3(j) if isinstance(j, tuple)
                               else np.asarray(j), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def _flips(tc, jc, n) -> np.ndarray:
    """Lanes whose texel differs; at most FLIPS of the lanes."""
    bad = np.asarray(tc) != np.asarray(jc)
    print(f"texel-edge flips: {int(bad.sum())} of {n}")
    assert bad.sum() <= FLIPS * n, int(bad.sum())
    return bad


def _dirs(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("env", sorted(ENVS))
def test_env_tables_equal_jax(env):
    tl, jl = _pair(env, "rotated", with_point=True)
    assert TL.has_env(tl) and JL.has_env(jl)
    for f in ("env_rgb", "env_pmf", "env_prob", "env_alias", "env_h",
              "env_w", "i", "kind", "flags", "w2l", "l2w"):
        a, b = getattr(tl, f), np.asarray(getattr(jl, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_allclose(TL.power(tl), np.asarray(JL.power(jl)),
                               rtol=1e-6, err_msg="power")


def test_no_env_has_the_dummy_tables():
    jl = JL.pack_lights([JL.point_light(JT.identity(), (1.0, 1.0, 1.0))])
    tl = TL.pack_lights([TL.point_light(TT.identity(), (1.0, 1.0, 1.0))])
    assert not TL.has_env(tl) and TWL.device_env(tl, "cpu") is None
    for f in ("env_rgb", "env_pmf", "env_prob", "env_alias", "env_h",
              "env_w"):
        np.testing.assert_array_equal(getattr(tl, f),
                                      np.asarray(getattr(jl, f)), err_msg=f)


def test_make_lights_takes_one_env_with_its_tables():
    tables = TL.env_tables(radiance=(0.7, 0.6, 0.5))
    mean = tables.pop("i")
    made = TL.make_lights([TL.INFINITE], np.zeros((1, 3)), [mean], **tables)
    packed = TL.pack_lights([TL.infinite_light(radiance=(0.7, 0.6, 0.5))])
    for f in ("env_rgb", "env_pmf", "env_prob", "env_alias", "env_h",
              "env_w", "i", "flags"):
        np.testing.assert_array_equal(getattr(made, f), getattr(packed, f))
    with pytest.raises(ValueError):     # an INFINITE light without tables
        TL.make_lights([TL.INFINITE], np.zeros((1, 3)), [mean])
    with pytest.raises(ValueError):
        TL.pack_lights([TL.infinite_light(), TL.infinite_light()])


@pytest.mark.parametrize("env", ["image", "3x5", "hot"])
def test_uv_cell_and_pdf_match_jax(env):
    tl, jl = _pair(env)
    sc = _Scene(tl)
    lt = jax.tree.map(jnp.asarray, jl)
    d = _dirs(N, 1)
    tst, tcell = TWL._env_uv_cell(sc.env, V3(*both(d)[0].T))
    jst, jcell = JL._env_uv_cell(lt, jnp.asarray(d))
    bad = _flips(tcell.numpy(), jcell, N)
    _close(tst, jst, "sin theta")
    tp = TWL._env_pdf(sc.env, tcell, tst).numpy()
    jp = np.asarray(JL._env_pdf(lt, jcell, jst))
    np.testing.assert_allclose(tp[~bad], jp[~bad], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("env", ["image", "3x5", "one_texel"])
def test_sample_cell_and_dir_match_jax(env):
    tl, jl = _pair(env, "rotated")
    sc = _Scene(tl)
    lt = jax.tree.map(jnp.asarray, jl)
    u = np.random.default_rng(2).uniform(size=(N, 2)).astype(np.float32)
    tu, ju = both(u)
    tcell, tf = TWL._env_sample_cell(sc.env, tu[:, 0])
    jcell, jf = JL._env_sample_cell(lt, ju[:, 0])
    np.testing.assert_array_equal(tcell.numpy(), np.asarray(jcell))
    _close(tf, jf, "recycled uniform")
    l2w = tl.l2w[0]
    twi, trad, tpdf = TWL._env_sample_dir(sc.env, l2w, tu[:, 0], tu[:, 1])
    jwi, jrad, jpdf = JL._env_sample_dir(
        lt, jnp.broadcast_to(jnp.asarray(l2w), (N, 4, 4)), ju)
    _close(twi, np.asarray(jwi), "wi")
    _close(trad, np.asarray(jrad), "radiance")
    _close(tpdf, jpdf, "pdf")


@pytest.mark.parametrize("l2w", sorted(L2W))
@pytest.mark.parametrize("env", ["image", "3x5", "constant"])
def test_env_le_le_inf_and_pdf_li_match_jax(env, l2w):
    tl, jl = _pair(env, l2w, with_point=True)
    sc = _Scene(tl)
    # Unnormalized directions: env_le and pdf_li normalize first.
    d = _dirs(N, 3) * np.float32(1.7)
    td, jd = both3(d)
    te = TWL.env_le(sc, td)
    je = JL.env_le(jl, jnp.asarray(d))
    bad = np.any(np.abs(np3(te) - np.asarray(je)) > ATOL + RTOL
                 * np.abs(np.asarray(je)), axis=-1)
    print(f"env_le lanes off: {int(bad.sum())}")
    assert bad.sum() <= FLIPS * N
    idx = jnp.full((N,), 1, jnp.int32)
    wi = _dirs(N, 4)
    twi, _ = both3(wi)
    ti = TWL.le_inf(sc, 1, twi)
    ji = np.asarray(JL.le_inf(jl, idx, jnp.asarray(wi)))
    bad = np.any(np.abs(np3(ti) - ji) > ATOL + RTOL * np.abs(ji), axis=-1)
    assert bad.sum() <= FLIPS * N
    tp = TWL.pdf_li_env(sc, 1, twi).numpy()
    z = jnp.zeros(N)
    jp = np.asarray(JL.pdf_li(jl, idx, jnp.zeros((N, 3)), jnp.asarray(wi),
                              z, z))
    bad = np.abs(tp - jp) > ATOL + RTOL * np.abs(jp)
    assert bad.sum() <= FLIPS * N


@pytest.mark.parametrize("env", ["image", "3x5", "constant"])
def test_sample_li_and_sample_le_match_jax(env):
    tl, jl = _pair(env, "rotated")
    sc = _Scene(tl)
    rng = np.random.default_rng(5)
    u0, u1 = (rng.uniform(size=(N, 2)).astype(np.float32) for _ in range(2))
    p = rng.normal(size=(N, 3)).astype(np.float32)
    tp, _ = both3(p)
    (tu0, ju0), (tu1, ju1) = both(u0), both(u1)
    idx = jnp.zeros(N, jnp.int32)
    t = TWL.sample_li_static(sc, 0, tp, tu0[:, 0], tu0[:, 1])
    j = JL.sample_li(jl, idx, jnp.asarray(p), ju0)
    for name, a, b in zip(("radiance", "wi", "pdf", "p_light"), t, j):
        _close(a, np.asarray(b), name)
    t = TWL.sample_le_static(sc, 0, tu0[:, 0], tu0[:, 1], tu1[:, 0],
                             tu1[:, 1], torch.zeros(N))
    j = JL.sample_le(jl, idx, ju0, ju1, jnp.zeros(N))
    for name, a, b in zip(("le", "o", "d", "n_light", "pdf_pos", "pdf_dir"),
                          t, j):
        _close(a, np.asarray(b), name)
    # Emitted inward: from the bounding sphere's surface into the scene.
    o, d = np3(t[1]), np3(t[2])
    c = np.asarray(tl.world_center)
    assert (np.linalg.norm(o - c, axis=1) >= float(tl.world_radius) - 1e-3
            ).all()
    assert (((o - c) * d).sum(1) < 1e-3).all()


def test_alias_table_reproduces_pmf():
    tl, _ = _pair("3x5")
    env = TWL.device_env(tl, "cpu")
    m = env.k * 4096
    u = torch.from_numpy(((np.arange(m) + 0.5) / m).astype(np.float32))
    cell, u2 = TWL._env_sample_cell(env, u)
    freq = np.bincount(cell.numpy(), minlength=env.k) / m
    np.testing.assert_allclose(freq, tl.env_pmf, atol=1.5e-3)
    assert (u2 >= 0).all() and (u2 < 1).all()


def test_env_pdf_integrates_to_one():
    tl, _ = _pair("image")
    env = TWL.device_env(tl, "cpu")
    # pdf * sin(theta) is constant over a texel: a texel-centred grid
    # integrates it exactly.
    gh, gw = 8 * 4, 16 * 4
    theta = (np.arange(gh) + 0.5) * np.pi / gh
    phi = (np.arange(gw) + 0.5) * 2 * np.pi / gw
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    wl = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                   np.cos(tt)], -1).reshape(-1, 3).astype(np.float32)
    st, cell = TWL._env_uv_cell(env, V3(*torch.from_numpy(wl).T))
    pdf = TWL._env_pdf(env, cell, st).numpy()
    total = float((pdf * np.sin(tt.reshape(-1))).sum()
                  * (np.pi / gh) * (2 * np.pi / gw))
    assert total == pytest.approx(1.0, rel=2e-3)


# -- the integrators against the JAX package's packed li ------------------

def _sphere_scene(albedo, env):
    image, radiance = ENVS[env]
    b = JSceneBuilder()
    mat = b.material(JMatte(Kd=(albedo,) * 3))
    b.sphere(JT.identity(), 1.0, mat)
    b.light(JL.infinite_light(radiance=radiance, image=image))
    js = b.build(use_bvh=False)
    return js, port_scene(js)


def _rays(n_furnace=1024, n_rand=1024, z=3.0, seed=6):
    """Furnace rays (all from (0, 0, z) straight down -z at the sphere's
    pole), then rays from a shell of radius 3 toward points within 1.5
    of the centre (some miss)."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, z]], np.float32), (n_furnace, 1))
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n_furnace, 1))
    o2 = _dirs(n_rand, seed) * np.float32(3.0)
    tgt = rng.uniform(-1.5, 1.5, size=(n_rand, 3)).astype(np.float32)
    d2 = tgt - o2
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = np.concatenate([o, o2]).astype(np.float32)
    d = np.concatenate([d, d2]).astype(np.float32)
    n = o.shape[0]
    z3 = np.zeros((n, 3), np.float32)
    cols = dict(o=o, d=d, t_max=np.full(n, np.inf, np.float32),
                time=np.zeros(n, np.float32),
                has_differentials=np.zeros(n, bool), rx_origin=z3,
                ry_origin=z3, rx_direction=z3, ry_direction=z3)
    return (TRD(**{k: torch.from_numpy(v) for k, v in cols.items()}),
            JRD(**{k: jnp.asarray(v) for k, v in cols.items()}))


def _per_lane(t, j, n):
    t, j = np.asarray(t), np.asarray(j)
    assert np.isfinite(t).all()
    bad = ~np.all(np.abs(t - j) <= LI_ATOL + LI_RTOL * np.abs(j), axis=-1)
    print(f"lanes outside rtol {LI_RTOL} / atol {LI_ATOL}: "
          f"{int(bad.sum())} of {n}")
    assert bad.sum() <= FLIPS * n, np.flatnonzero(bad)[:8]


@pytest.mark.parametrize("env", ["constant", "hot"])
def test_whitted_li_matches_packed(env):
    albedo = 0.5
    js, ts = _sphere_scene(albedo, env)
    trd, jrd = _rays()
    n = trd.o.shape[0]
    tk, jk = lane_keys(9, n)
    lt, aux = TWF.li(ts, trd, tk, max_depth=1)
    lj, jaux = JWhitted.li(js, jrd, jk, max_depth=1, return_aux=True)
    _per_lane(lt, lj, n)
    assert int(aux["useful_rays"]) == int(jaux["useful_rays"])
    if env == "constant":
        # One environment sample a lane: the furnace mean is albedo * L.
        np.testing.assert_allclose(
            lt[:1024].numpy().mean(0),
            albedo * np.array(ENVS[env][1], np.float32), rtol=0.06)


@pytest.mark.parametrize("env", ["constant", "hot"])
def test_path_li_matches_packed(env):
    albedo = 0.6 if env == "constant" else 0.5
    js, ts = _sphere_scene(albedo, env)
    trd, jrd = _rays()
    n = trd.o.shape[0]
    tk, jk = lane_keys(11, n)
    lt, _ = TP.li(ts, trd, tk, max_depth=2)
    lj = JPath.li(js, jrd, jk, max_depth=2)
    _per_lane(lt, lj, n)
    mean = lt[:1024].numpy().mean(0)
    if env == "constant":
        np.testing.assert_allclose(mean, albedo * np.array([0.7, 0.6, 0.5]),
                                   rtol=0.05)
    else:
        # albedo / pi times the irradiance at the pole (normal = the env
        # frame's +z): each texel row's cos-weighted solid angle.
        img = _hot_image()
        h, w = img.shape[:2]
        edges = np.minimum(np.arange(h + 1) * np.pi / h, np.pi / 2)
        row_w = (np.sin(edges[1:]) ** 2 - np.sin(edges[:-1]) ** 2) / 2
        e = (img * row_w[:, None, None]).sum(axis=(0, 1)) * (2 * np.pi / w)
        np.testing.assert_allclose(mean, albedo / np.pi * e, rtol=0.06)
