"""trace_tpu_torch: the PyTorch/CUDA port of trace_tpu.

Modules keep the JAX package's paths and names, so each one has an
obvious counterpart in ``trace_tpu``, and the package exports what
``trace_tpu`` exports, name for name. The port imports ``torch`` and
numpy and never JAX. The hand-written kernels (the sparse sweep and its
prologue, ``ops/sweep.py`` + ``csrc/sweep.cu`` and ``csrc/entry.cu``; the
brute-force fused test, ``ops/intersect.py`` + ``csrc/intersect.cu``) are
compiled with ``nvcc`` at their first launch on a CUDA tensor; CPU
tensors take their plain PyTorch versions. Importing the package builds
nothing and does not touch the card.

Public API, as the reference's constructor graph: materials -> shapes ->
lights -> SceneBuilder -> Scene -> Film -> PerspectiveCamera ->
integrator (Whitted, path, SPPM); see ``models/mesh_heavy.py``.
"""

from .scene import Scene, SceneBuilder
from .core import transform as transforms
from .film.film import Film
from .film.filters import (
    BoxFilter, GaussianFilter, LanczosSincFilter, TriangleFilter,
)
from .camera.perspective import PerspectiveCamera
from .materials.materials import (
    GlassMaterial, MatteMaterial, MetalMaterial, MirrorMaterial,
    PlasticMaterial,
)
from .materials.textures import (
    BilerpTexture, ConstantTexture, MixTexture, ScaleTexture,
    TransformMapping3D, UVMapping2D,
)
from .lights.lights import (
    area_light, distant_light, infinite_light, point_light, spot_light,
)
from .sampler.uniform import UniformSampler
from .sampler.stratified import StratifiedSampler
from .integrators.whitted import WhittedIntegrator
from .integrators.path import PathIntegrator
from .integrators.sppm import SPPMIntegrator
from .utils.stats import RenderStats

__all__ = [
    "Scene", "SceneBuilder", "transforms",
    "Film", "BoxFilter", "GaussianFilter", "LanczosSincFilter",
    "TriangleFilter", "PerspectiveCamera",
    "GlassMaterial", "MatteMaterial", "MetalMaterial", "MirrorMaterial",
    "PlasticMaterial",
    "BilerpTexture", "ConstantTexture", "MixTexture", "ScaleTexture",
    "TransformMapping3D", "UVMapping2D",
    "area_light", "distant_light", "infinite_light", "point_light",
    "spot_light",
    "UniformSampler", "StratifiedSampler",
    "WhittedIntegrator", "PathIntegrator", "SPPMIntegrator",
    "RenderStats",
]
