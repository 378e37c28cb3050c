"""trace_tpu_torch: the PyTorch/CUDA port of trace_tpu.

Modules keep the JAX package's paths and names, so each one has an
obvious counterpart in ``trace_tpu``. The port imports ``torch`` and
numpy and never JAX. The one hand-written kernel on the main path (the
sparse sweep, ``ops/sweep.py`` + ``csrc/sweep.cu``) is compiled with
``nvcc`` at its first launch on a CUDA tensor; CPU tensors take its plain
PyTorch version.

Main path: SceneBuilder -> Scene -> Film/PerspectiveCamera ->
WhittedIntegrator.render (see ``models/mesh_heavy.py``).
"""
