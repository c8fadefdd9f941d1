"""Offline renderer: cameras, lights, time-gated frame capture, video export.

Port of ``flygym_tpu/render/renderer.py``. One class covers one world and a
batch: frames of the selected worlds are rendered in one call of
:func:`~flygym_tpu_torch.render.raycast.render_pixels` on the simulation's
device and buffered there as uint8 tensors; :meth:`Renderer.save_video`
copies them to the host. The cameras, the geom names of the mesh SDF pack
and the body names of light targets come from ``meta["render"]``
(:attr:`CompiledModel.render`), which every world the port compiles
carries, as do the exported benchmark fly, two-fly and terrain worlds.
:func:`launch_interactive_viewer` opens a composed world's MJCF
(``ModelSpec.to_mjcf_xml``) in MuJoCo's viewer.
"""

from dataclasses import dataclass
from os import PathLike
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from flygym_tpu_torch.compose.bridge import CompiledModel
from flygym_tpu_torch.compose.spec import CameraSpec
from flygym_tpu_torch.engine.kinematics import geom_poses
from flygym_tpu_torch.engine.maths import cross, mat_to_quat, norm
from flygym_tpu_torch.engine.model import State
from flygym_tpu_torch.ops import checked_device
from flygym_tpu_torch.render.raycast import capsule_mask, render_pixels

__all__ = ["Camera", "Renderer", "launch_interactive_viewer", "preview_model", "viewer_world"]


@dataclass(frozen=True)
class Camera:
    """A camera as MuJoCo's modes place it: ``fixed`` at ``pos``/``quat``;
    ``track`` at the ``target`` body's position plus ``pos``, orientation
    fixed; ``targetbody``/``targetbodycom`` at ``pos``, aimed at the target
    every frame. ``target`` is a body id, or None."""

    name: str
    full_identifier: str
    mode: str = "track"
    pos: tuple = (0.0, 0.0, 0.0)
    quat: tuple = (1.0, 0.0, 0.0, 0.0)
    fovy: float = 45.0
    target: int | None = None

    @classmethod
    def from_meta(cls, meta: dict) -> "Camera":
        return cls(name=meta["name"], full_identifier=meta["full_identifier"],
                   mode=meta["mode"], pos=tuple(meta["pos"]), quat=tuple(meta["quat"]),
                   fovy=float(meta["fovy"]), target=meta["target"])


def _load_texture(tex, device=None):
    """A texture as an (H, W, 3) float32 tensor in [0, 1], from None, an
    array (float in [0, 1] or uint8; RGB, RGBA or grey) or an image file
    (read with matplotlib)."""
    if tex is None:
        return None
    if isinstance(tex, (str, PathLike)):
        from matplotlib.image import imread

        tex = imread(str(tex))
    tex = tex.cpu().numpy() if isinstance(tex, torch.Tensor) else np.asarray(tex)
    if tex.dtype == np.uint8:
        tex = tex.astype(np.float32) / 255.0
    tex = tex.astype(np.float32)
    if tex.ndim == 2:  # grey
        tex = np.repeat(tex[:, :, None], 3, axis=2)
    if tex.shape[-1] == 4:  # RGBA
        tex = tex[..., :3]
    if tex.ndim != 3 or tex.shape[-1] != 3:
        raise ValueError(f"Texture must be (H, W, 3); got shape {tex.shape}")
    return torch.as_tensor(tex, device=device)


def _rgb3(value) -> np.ndarray:
    value = np.asarray(value, np.float32)
    return np.full((3,), float(value), np.float32) if value.ndim == 0 else value


class Renderer:
    """Raycasting renderer with the reference's frame gating.

    Args:
        compiled: The compiled world; its ``render`` metadata names the
            cameras, geoms and bodies.
        cameras: A camera name (``"trackcam"``) or full identifier
            (``"bottom/trackcam"``), a :class:`Camera`, or a sequence of them.
        device: Where frames are rendered and buffered (the card by default).
        camera_res: (height, width) pixels.
        playback_speed: Video playback speed relative to simulated time.
        output_fps: Output video frame rate.
        buffer_frames: Keep the rendered frames.
        world_ids: For a batch, the worlds to render (default [0]).
        batched: The states are a batch whose frames keep a world axis
            (``BatchSimulation``); False renders world 0 of a one-world state
            as (H, W, 3).
        mesh_fidelity: Sphere-trace the segments' mesh SDFs.
        ground_texture, ground_texture_period, sky_texture: Image textures
            (arrays or image files).
        lights: Light specs: ``kind`` "directional" (``dir``) or "point"
            (``pos``, or ``target`` a body name with an ``offset``, followed
            every frame), ``color`` and ``specular`` (a scalar or RGB),
            ``cast_shadow`` (default True) and ``falloff`` in mm.
    """

    def __init__(self, compiled: CompiledModel, cameras, *, device="cuda",
                 camera_res: tuple = (240, 320), playback_speed: float = 0.2,
                 output_fps: int = 25, buffer_frames: bool = True,
                 world_ids: Sequence[int] | None = None, batched: bool = False,
                 mesh_fidelity: bool = False, ground_texture=None,
                 ground_texture_period: float = 10.0, sky_texture=None,
                 lights: Sequence[dict] | None = None) -> None:
        self.compiled = compiled
        self.device = checked_device(device)
        self.model = compiled.model.to(self.device)
        self._meta = compiled.render or {"cameras": [], "geom_names": [], "body_name2id": {}}
        self.camera_res = tuple(camera_res)
        self.playback_speed = playback_speed
        self.output_fps = output_fps
        self.buffer_frames = buffer_frames
        self.world_ids = list(world_ids) if world_ids is not None else [0]
        self.batched = batched

        if not isinstance(cameras, (list, tuple)):
            cameras = [cameras]
        self.cameras = [self._resolve_camera(c) for c in cameras]
        self.camera_names = [c.full_identifier for c in self.cameras]
        self._capsule_mask = capsule_mask(self.model)

        self._sdf_pack = None
        if mesh_fidelity:
            from flygym_tpu_torch.render.sdf import SDF_MESHES, build_sdf_pack

            if not self._meta["geom_names"]:
                raise ValueError("mesh_fidelity=True needs the export's geom names "
                                 "(export(..., render=True))")
            self._sdf_pack = build_sdf_pack(self.model, self._meta["geom_names"])
            if self._sdf_pack is None:
                raise FileNotFoundError(f"the mesh SDF asset {SDF_MESHES} was not found")
        self._ground_texture = _load_texture(ground_texture, self.device)
        self._ground_texture_period = float(ground_texture_period)
        self._sky_texture = _load_texture(sky_texture, self.device)
        self._lights = None
        if lights is not None:
            self._lights = tuple(self._resolve_light(dict(li)) for li in lights)
        self._world_ids_idx = torch.tensor(self.world_ids, dtype=torch.int64, device=self.device)
        self._frames: dict = {name: [] for name in self.camera_names}
        self._last_render_time = -np.inf
        self._eps = 1e-9

    # -- cameras and lights -------------------------------------------------

    def _resolve_camera(self, camera) -> Camera:
        if isinstance(camera, Camera):
            return camera
        if isinstance(camera, CameraSpec):  # a composed fly's camera, as JAX's renderer takes
            camera = camera.full_identifier
        if isinstance(camera, str):
            for meta in self._meta["cameras"]:
                if camera in (meta["name"], meta["full_identifier"]):
                    return Camera.from_meta(meta)
            raise ValueError(f"Camera '{camera}' not found in the world.")
        raise TypeError(f"Invalid camera spec: {camera!r}")

    def _resolve_light(self, li: dict) -> dict:
        """A user light spec as static fields and tensors on the device."""
        kind = li.get("kind", "directional")
        if kind not in ("directional", "point"):
            raise ValueError(f"Unknown light kind {kind!r}")
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        out = {
            "kind": kind,
            "color": as_t(_rgb3(li.get("color", 0.5))),
            "cast_shadow": bool(li.get("cast_shadow", True)),
            "falloff": float(li.get("falloff", 30.0)),
            "target_id": None,
            "offset": as_t(li.get("offset", (0.0, 0.0, 0.0))),
        }
        if "specular" in li:
            out["specular"] = as_t(_rgb3(li["specular"]))
        target = li.get("target")
        if target is not None:
            if kind != "point":
                raise ValueError("Only point lights can track a target body")
            name2id = self._meta["body_name2id"]
            if target not in name2id:
                raise ValueError(f"Light target body {target!r} not found in the world "
                                 "(valid names look like 'flyname/c_thorax').")
            out["target_id"] = int(name2id[target])
            out["vec"] = None
        else:
            key = "dir" if kind == "directional" else "pos"
            if key not in li and "vec" not in li:
                raise ValueError(f"Light needs {key!r} (or a target body)")
            out["vec"] = as_t(li.get(key, li.get("vec")))
        return out

    def _concrete_lights(self, state: State):
        """This frame's lights: target-tracking point lights at their
        bodies' positions, (B, 3) per world."""
        if self._lights is None:
            return None
        out = []
        for li in self._lights:
            li = dict(li)
            tid, offset = li.pop("target_id"), li.pop("offset")
            if tid is not None:
                li["vec"] = state.xpos[:, tid] + offset
            out.append(li)
        return tuple(out)

    def _camera_pose(self, cam: Camera, state: State):
        """(B, 3) positions and (B, 4) quaternions of ``cam`` in each world."""
        B = state.xpos.shape[0]
        dev = state.xpos.device
        pos = torch.tensor(cam.pos, dtype=torch.float32, device=dev).expand(B, 3)
        quat = torch.tensor(cam.quat, dtype=torch.float32, device=dev).expand(B, 4)
        if cam.target is None or cam.mode == "fixed":
            return pos, quat
        target = state.xpos[:, cam.target]
        if cam.mode == "track":
            return target + pos, quat
        if cam.mode in ("targetbody", "targetbodycom"):
            # Look at the target: the camera's -z toward it, world +z up.
            fwd = target - pos
            fwd = fwd / torch.clamp(norm(fwd, keepdim=True), min=1e-9)
            up_w = fwd.new_tensor([0.0, 0.0, 1.0])
            right = cross(fwd, up_w)
            rn = norm(right, keepdim=True)
            # Looking straight up or down: +x is right.
            right = torch.where(rn > 1e-6, right / torch.clamp(rn, min=1e-9),
                                fwd.new_tensor([1.0, 0.0, 0.0]))
            up = cross(right, fwd)
            R = torch.stack([right, up, -fwd], dim=-1)  # columns x, y, z
            return pos, mat_to_quat(R)
        return pos, quat

    # -- rendering ------------------------------------------------------------

    def render_float(self, state: State, camera: int = 0) -> torch.Tensor:
        """Frames of one camera for every world of the batched ``state``:
        (B, H, W, 3) floats in [0, 1], before the uint8 cast."""
        cam = self.cameras[camera]
        pos, quat = self._camera_pose(cam, state)
        gpos, gquat = geom_poses(self.model, state.xpos, state.xquat)
        h, w = self.camera_res
        return render_pixels(
            self.model, gpos, gquat, pos, quat, h, w, cam.fovy, self._capsule_mask,
            sdf_pack=self._sdf_pack, ground_texture=self._ground_texture,
            ground_texture_period=self._ground_texture_period, sky_texture=self._sky_texture,
            lights=self._concrete_lights(state))

    @property
    def render_interval(self) -> float:
        """Simulated seconds between frames."""
        return 1.0 / (self.output_fps / self.playback_speed)

    def render_as_needed(self, state: State) -> bool:
        """Render if simulated time has passed the next frame's (the
        reference's ``rendering.py:81-101``)."""
        sim_time = float(state.time.reshape(-1)[0])
        if sim_time < self._last_render_time + self.render_interval - self._eps:
            return False
        self.render(state)
        self._last_render_time = sim_time
        return True

    def render(self, state: State) -> dict:
        """Render every camera now: per camera name a uint8 tensor on the
        device, (n_selected, H, W, 3) of the ``world_ids`` for a batch,
        (H, W, 3) for one world."""
        if self.batched:
            state = state.map(lambda x: x[self._world_ids_idx])
        else:
            state = state.map(lambda x: x[:1])
        out = {}
        for ci, name in enumerate(self.camera_names):
            frame = (torch.clamp(self.render_float(state, ci), 0, 1) * 255).to(torch.uint8)
            if not self.batched:
                frame = frame[0]
            out[name] = frame
            if self.buffer_frames:
                self._frames[name].append(frame)
        return out

    def get_frames(self, camera: str | None = None, world_id: int | None = None) -> list:
        """Buffered frames of a camera (default the first)."""
        frames = self._frames[camera or self.camera_names[0]]
        if world_id is not None:
            sel = self.world_ids.index(world_id)
            return [f[sel] for f in frames]
        return frames

    def reset(self) -> None:
        """Clear the buffered frames and the render clock."""
        self._frames = {name: [] for name in self.camera_names}
        self._last_render_time = -np.inf

    def _first_world(self, frames: list) -> list:
        return [f[0] for f in frames] if frames and frames[0].dim() == 4 else frames

    def save_video(self, path: PathLike, camera: str | None = None,
                   world_id: int | None = None) -> None:
        """Write the buffered frames as a video (the first selected world of
        a batch unless ``world_id`` is given)."""
        from flygym_tpu_torch.utils.video import write_video

        frames = self._first_world(self.get_frames(camera, world_id))
        write_video(Path(path), frames, fps=self.output_fps)

    def save_video_grid(self, path: PathLike, camera: str | None = None) -> None:
        """A video of the selected worlds in a grid, each labelled with its id."""
        from flygym_tpu_torch.utils.video import montage_grid, write_video

        frames = self._frames[camera or self.camera_names[0]]
        write_video(Path(path), [montage_grid(f, self.world_ids) for f in frames],
                    fps=self.output_fps)

    def show_in_notebook(self, camera: str | None = None, **kwargs: Any) -> None:
        """Show the buffered frames in a Jupyter notebook, through mediapy
        where it is installed, else as an embedded video through IPython."""
        for name in [camera] if camera else self.camera_names:
            frames = self.get_frames(name)
            if not frames:
                raise RuntimeError(f"No frames recorded yet for camera '{name}'.")
            frames = [f.cpu().numpy() for f in self._first_world(frames)]
            try:
                import mediapy

                mediapy.show_video(frames, fps=self.output_fps, title=name, **kwargs)
                continue
            except ImportError:
                pass
            try:
                import base64
                import tempfile

                from IPython.display import HTML, display

                from flygym_tpu_torch.utils.video import write_video

                with tempfile.TemporaryDirectory() as td:
                    out = Path(td) / "clip.mp4"
                    write_video(out, frames, fps=self.output_fps)
                    real = out if out.exists() else out.with_suffix(".gif")
                    mime = "video/mp4" if real.suffix == ".mp4" else "image/gif"
                    b64 = base64.b64encode(real.read_bytes()).decode("ascii")
                tag = (f'<video controls autoplay loop src="data:{mime};base64,{b64}"></video>'
                       if mime == "video/mp4" else f'<img src="data:{mime};base64,{b64}">')
                display(HTML(f"<div><b>{name}</b><br>{tag}</div>"))
            except Exception as e:
                raise RuntimeError("Notebook display needs mediapy or IPython and imageio; "
                                   "use save_video(path) instead.") from e

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def preview_model(compiled, camera="trackcam", *, duration_s: float = 0.02,
                  camera_res=(240, 320), save_path: PathLike | None = None, device="cuda"):
    """A short warm-up and one frame (the reference's ``rendering.py:
    300-351``) of a :class:`CompiledModel` or a composed world: the (H, W,
    3) uint8 frame on ``device``, also written as an image to ``save_path``
    if given."""
    from flygym_tpu_torch.simulation import Simulation

    sim = Simulation(compiled, device=device)
    renderer = sim.set_renderer(camera, camera_res=camera_res)
    sim.warmup(duration_s)
    frame = next(iter(renderer.render(sim.state).values()))
    if save_path is not None:
        from PIL import Image

        Image.fromarray(frame.cpu().numpy()).save(save_path)
    return frame


def viewer_world():
    """The world ``scripts/launch_interactive_viewer.py`` opens: the fly
    with every biological joint, position actuators on the active leg DoFs
    (kp 50, the neutral pose), joint sites, colours and the tracking camera,
    on flat ground at (0, 0, 0.8) with the default contact segments."""
    from flygym_tpu_torch.anatomy import (
        ActuatedDOFPreset, AxisOrder, ContactBodiesPreset, JointPreset, Skeleton)
    from flygym_tpu_torch.compose import (
        ActuatorType, FlatGroundWorld, Fly, KinematicPosePreset)
    from flygym_tpu_torch.utils.math import Rotation3D

    fly = Fly()
    skeleton = Skeleton(joint_preset=JointPreset.ALL_BIOLOGICAL,
                        axis_order=AxisOrder.YAW_PITCH_ROLL)
    fly.add_joints(skeleton, KinematicPosePreset.NEUTRAL)
    fly.add_actuators(skeleton.get_actuated_dofs_from_preset(ActuatedDOFPreset.LEGS_ACTIVE_ONLY),
                      ActuatorType.POSITION, neutral_input=KinematicPosePreset.NEUTRAL, kp=50.0)
    fly.add_joint_sites(fly.skeleton.anatomical_joints)
    fly.colorize()
    fly.add_tracking_camera()
    world = FlatGroundWorld()
    world.add_fly(fly, (0, 0, 0.8), Rotation3D("quat", (1, 0, 0, 0)),
                  bodysegs_with_ground_contact=ContactBodiesPreset.LEGS_THORAX_ABDOMEN_HEAD)
    return world


def launch_interactive_viewer(world=None, run_async: bool = False,
                              init_keyframe: str | None = "neutral",
                              fallback_path: PathLike | None = None):
    """Open a composed world in MuJoCo's interactive viewer (reference
    ``rendering.py:271-297``; ``flygym_tpu/render/renderer.py:457`` and
    ``scripts/launch_interactive_viewer.py``).

    The world's compiled model is written as standalone MJCF (primitive
    geoms and explicit inertials, ``world.spec.to_mjcf_xml()``), which the
    stock viewer loads. ``mujoco`` is imported here, when the function is
    called.

    Args:
        world: A composed world; None composes :func:`viewer_world`.
        run_async: Launch in a separate process and return it (for
            notebooks).
        init_keyframe: Keyframe to reset to ("neutral", the only one the
            composer writes), or None for the model's default state.
        fallback_path: On a host without a display, write the MJCF here and
            return its path instead of raising.

    Raises:
        TypeError: ``world`` is not a composed world (a loaded
            :class:`CompiledModel` has no model description to write).
        ImportError: ``mujoco`` is not installed.
        RuntimeError: No display, and no ``fallback_path``.
    """
    import os
    import sys

    if world is not None and not hasattr(world, "spec"):
        raise TypeError("launch_interactive_viewer takes a composed world (its MJCF is written "
                        f"from the world's model description), not a {type(world).__name__}")
    try:
        import mujoco
        import mujoco.viewer
    except ImportError as e:
        raise ImportError(
            "launch_interactive_viewer needs the 'mujoco' package (pip install mujoco), "
            "which is not installed; write the MJCF with world.save_xml_with_assets(path) "
            "and open it where MuJoCo is") from e
    world = viewer_world() if world is None else world
    xml = world.spec.to_mjcf_xml()
    if sys.platform.startswith("linux") and not (
        os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
    ):
        # GLFW hangs or aborts rather than failing cleanly without a display.
        if fallback_path is not None:
            Path(fallback_path).write_text(xml)
            return Path(fallback_path)
        raise RuntimeError(
            "Interactive viewing needs a display. On a headless host use preview_model "
            "for offline frames, or world.save_xml_with_assets(path) and open the MJCF "
            "elsewhere (python -m mujoco.viewer).")

    mj_model = mujoco.MjModel.from_xml_string(xml)
    mj_data = mujoco.MjData(mj_model)
    if init_keyframe is not None and mj_model.nkey > 0:
        key_id = mujoco.mj_name2id(mj_model, mujoco.mjtObj.mjOBJ_KEY, init_keyframe)
        if key_id >= 0:
            mujoco.mj_resetDataKeyframe(mj_model, mj_data, key_id)
    if run_async:
        from multiprocessing import Process

        p = Process(target=mujoco.viewer.launch, args=(mj_model, mj_data))
        p.start()  # the viewer owns its own lifetime
        return p
    mujoco.viewer.launch(mj_model, mj_data)
    return None
