"""The reference's animated caustic (port of
trace_tpu/models/caustic_moving.py): the caustic-glass scene with a rising
spot light and a fill point light, one SPPM run a frame.

The same shift schedule (0:0.1:5), light colours and intensities, radius
0.055, 25 iterations and 1.25M photons a frame as the reference. The
scene is built once; each frame swaps its lights (``set_frame_lights``)
and, with ``motion``, moves the glass mesh on the card (SPPMIntegrator.
render(geometry=, geometry_transform=): a device rebuild of the sweep's
tables a frame). The mesh is not in the repository: pass its path.

    python -m trace_tpu_torch.models.caustic_moving --ply caustic-glass.ply
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np

from ..core import transform as T
from ..integrators.sppm import SPPMIntegrator, SPPMState
from ..lights import lights as light_mod
from ..lights.lights import point_light, spot_light
from ..scene import Scene
from ..shapes import triangle as tri_mod
from .caustic_glass import PLY_NAME, build_camera, build_scene

SHIFTS = np.arange(0.0, 5.0 + 1e-6, 0.1, dtype=np.float32)


def _spot_l2w(frm):
    """Spot light-to-world: aim from ``frm`` toward the caustic target,
    then apply the scene shift (caustic_moving.jl:60-71)."""
    to = np.array([-5.0, 0.0, 5.0], np.float32)
    return T.compose(
        T.compose(T.translate([4.5, 0.0, -101.0]), T.translate(frm)),
        T.inverse(T.dir_to_z(to - frm)))


def frame_lights(shift: float):
    """The light entries of one frame (caustic_moving.jl:60-89)."""
    frm = np.array([0.0, 0.5 + shift, 0.0], np.float32)
    spot_color = tuple(60.0 * np.array([0.988235, 0.972549, 0.57647]))
    return [
        point_light(T.translate([2.5, 10.0, -100.0]), (20.0, 20.0, 20.0)),
        spot_light(_spot_l2w(frm), spot_color, 30.0, 30.0 - 10.0),
    ]


def set_frame_lights(scene: Scene, shift: float) -> Scene:
    """Swap the scene's light table for the frame's, in place, with every
    table derived from it (Scene.set_lights); the geometry and its sweep
    stay (the reference rebuilds the whole scene a frame,
    caustic_moving.jl:90)."""
    scene.set_lights(light_mod.preprocess(light_mod.pack_lights(
        frame_lights(shift), scene.triangles), *scene.bounding_sphere()))
    return scene


def _frame(states: SPPMState, k: int) -> SPPMState:
    """Frame k of render_frames' stacked states."""
    return SPPMState(*[getattr(states, f.name)[k] for f in fields(states)])


def render_animation(
        resolution: int = 256, frames=None, iterations: int = 25,
        photons_per_iteration: int = 1_250_000, max_depth: int = 5,
        out_pattern: str = "caustic-moving-{i}.png",
        ply_path: str = PLY_NAME, refit_each_frame: bool = False,
        motion=None, batch_frames: int = 0, device="cuda", **integ_kw):
    """Render the animation; yields (frame index from 1, SPPMState) and
    writes each frame's PNG (``out_pattern``).

    ``motion`` (optional): shift -> core.transform.Transform, the glass
    mesh's rigid motion for the frame; the base mesh stays on the device
    and each frame moves and re-clusters it there. ``refit_each_frame``
    refits the static sweep's tables to the scene's vertices every frame
    (SweepAccelerator.refit, the reference's per-frame BVH refit).
    ``batch_frames=K`` renders K frames at a time through
    SPPMIntegrator.render_frames, with the same results; it cannot
    interleave a refit."""
    if batch_frames > 0 and refit_each_frame:
        raise ValueError("batch_frames renders whole batches of frames; a "
                         "refit cannot interleave")
    scene = build_scene(ply_path, device=device)
    base = (tri_mod.to_device(scene.triangles, scene.device)
            if motion is not None else None)
    frames = SHIFTS if frames is None else frames
    # One camera and integrator for every frame (the reference rebuilds
    # both a frame, caustic_moving.jl:90).
    camera = build_camera(resolution, out_pattern.format(i=1))
    integ = SPPMIntegrator(
        camera,
        initial_search_radius=integ_kw.pop("initial_search_radius", 0.055),
        max_depth=max_depth, n_iterations=iterations,
        photons_per_iteration=photons_per_iteration, device=device,
        **integ_kw)
    shifts = [float(s) for s in frames]
    if batch_frames > 0:
        for c0 in range(0, len(shifts), batch_frames):
            chunk = shifts[c0:c0 + batch_frames]
            states = integ.render_frames(
                scene, [frame_lights(s) for s in chunk],
                n_iterations=iterations, geometry=base,
                frame_transforms=(None if motion is None
                                  else [motion(s) for s in chunk]))
            for k in range(len(chunk)):
                state = _frame(states, k)
                integ.save(state, iterations, out_pattern.format(
                    i=c0 + k + 1))
                yield c0 + k + 1, state
        return
    for i, shift in enumerate(shifts, start=1):
        scene = set_frame_lights(scene, shift)
        if refit_each_frame and scene.accel is not None:
            scene.accel.refit(scene.triangles.v0, scene.triangles.v1,
                              scene.triangles.v2)
        state = integ.render(scene, geometry=base, geometry_transform=(
            None if motion is None else motion(shift)))
        integ.save(state, iterations, out_pattern.format(i=i))
        yield i, state


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ply", default=PLY_NAME)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--iterations", type=int, default=25)
    ap.add_argument("--frames", type=int, default=len(SHIFTS))
    ap.add_argument("--photons", type=int, default=1_250_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    # The reference's animation: 25 iterations a frame, depth 5, 1.25M
    # photons an iteration (caustic_moving.jl:49-100).
    for i, _ in render_animation(
            resolution=a.resolution, frames=SHIFTS[:a.frames],
            iterations=a.iterations, photons_per_iteration=a.photons,
            ply_path=a.ply, device=a.device):
        print(f"frame {i}/{a.frames}", flush=True)
