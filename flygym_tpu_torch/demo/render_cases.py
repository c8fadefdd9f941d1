"""The renderer's checked cases: the frames of the JAX golden, rebuilt on
the port.

``flygym_tpu_torch/assets/render_golden.npz`` (``scripts/
export_render_golden.py``) holds the JAX renderer's frames of seven cases,
each from the settled state of a committed golden. :func:`render_case`
rebuilds a case's inputs on the port at any resolution and device and
returns a function that renders it, so that the CPU tests and the card's
smoke run hold the port to the same frames; :func:`frame_gap` measures two
frames against the bars of :data:`FRAME_BARS`.
"""

import json

import numpy as np
import torch

from flygym_tpu_torch.compose.bridge import (
    ASSETS,
    ENV_FLY,
    ENV_GOLDEN,
    TERRAIN_FLY,
    TERRAIN_GOLDEN,
    load_compiled,
    load_env_golden,
    load_golden,
    load_terrain_golden,
)

__all__ = ["CASES", "FRAME_BARS", "RENDER_GOLDEN", "frame_gap", "load_render_golden",
           "render_case"]

RENDER_GOLDEN = ASSETS / "render_golden.npz"
CASES = ("capsule", "mesh", "aim", "lights", "batch", "terrain", "flyenv")
# A frame (floats in [0, 1]) against another: the share of pixels whose
# largest channel gap is within ``atol``, and the mean gap of all values.
# Measured against the JAX golden: at least 99.902% of pixels within 1e-3
# in every case of the camera renderer, on the CPU and on the card alike,
# mean gaps 6.6e-7 to 1.97e-5, bit-equal pixels 17-68% (the raycast's own
# arithmetic still parts in the last bits, ROADMAP.md queue 3 item 5);
# FlyEnv's plain frame on the card 99.836-99.870%, against the CPU's and
# JAX's.
FRAME_BARS = {"atol": 1e-3, "share": 0.997, "mean": 5e-5}


def load_render_golden(path=RENDER_GOLDEN) -> dict:
    """``frames`` by case (n, H, W, 3) float32, the ``meta`` of the export,
    its textures and the batch case's body offsets."""
    with np.load(path) as npz:
        meta = json.loads(str(npz["meta"]))
        frames = {k[len("frame."):]: npz[k] for k in npz.files if k.startswith("frame.")}
        rest = {k: npz[k] for k in ("ground_texture", "sky_texture", "batch_offsets")}
    return {"frames": frames, "meta": meta, **rest}


def frame_gap(got, want) -> dict:
    """``share`` of pixels within ``FRAME_BARS["atol"]`` in every channel,
    ``mean`` and ``max`` gap, and ``ok`` for the bars."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    d = np.abs(got.astype(np.float64) - np.asarray(want, np.float64))
    share = float((d.max(axis=-1) <= FRAME_BARS["atol"]).mean())
    mean = float(d.mean())
    return {"share": share, "mean": mean, "max": float(d.max()),
            "ok": share >= FRAME_BARS["share"] and mean <= FRAME_BARS["mean"]}


def _world(state, w: int):
    return state.map(lambda x: x[w : w + 1].clone())


def _thorax_camera(compiled, name: str, spec: dict):
    from flygym_tpu_torch.env.gym import FRAME_QUAT
    from flygym_tpu_torch.render import Camera

    fly = compiled.fly_names[0]
    target = compiled.render["body_name2id"][f"{fly}/c_thorax"]
    # trackcam's orientation; a targetbody camera aims itself and ignores it.
    return Camera(name=name, full_identifier=name, mode=spec["mode"], pos=tuple(spec["pos"]),
                  quat=FRAME_QUAT, fovy=float(spec["fovy"]), target=target)


def render_case(case: str, *, device="cuda", res=None, golden: dict | None = None):
    """A function rendering ``case`` of :data:`CASES` on ``device``: it
    returns (n, H, W, 3) floats, at ``res`` (height, width) or the golden's
    resolution. Its ``.worlds`` is the number of frames."""
    from flygym_tpu_torch.env.gym import env_frame
    from flygym_tpu_torch.render import Renderer

    golden = load_render_golden() if golden is None else golden
    meta = golden["meta"]
    if res is None:
        res = tuple(meta["batch_res"] if case == "batch" else meta["res"])
    if case == "terrain":
        compiled = load_compiled(TERRAIN_FLY)
        state = _world(load_terrain_golden(TERRAIN_GOLDEN)["state"], 0).to(device)
        renderer = Renderer(compiled, _thorax_camera(compiled, "track", meta["track_camera"]),
                            device=device, camera_res=res)
        fn = lambda: renderer.render_float(state)
    elif case == "flyenv":
        compiled = load_compiled(ENV_FLY)
        model = compiled.model.to(device)
        state = _world(load_env_golden(ENV_GOLDEN)["state"], 0).to(device)
        root = int(compiled.env["root_body"])
        fn = lambda: env_frame(model, state, root, *res)
    else:
        compiled = load_compiled()
        settled = load_golden()["state"]
        kw = {"device": device, "camera_res": res}
        if case == "batch":
            src = torch.arange(meta["batch_worlds"]) % settled.xpos.shape[0]
            state = settled.map(lambda x: x[src].clone())
            offsets = torch.as_tensor(golden["batch_offsets"])
            state.xpos.add_(offsets[:, None, :])
            state = state.map(lambda x: x[torch.tensor(meta["batch_ids"])]).to(device)
            renderer = Renderer(compiled, "trackcam", world_ids=meta["batch_ids"], batched=True,
                                **kw)
        elif case == "aim":
            state = _world(settled, 1).to(device)
            renderer = Renderer(compiled, _thorax_camera(compiled, "aimcam", meta["aim_camera"]),
                                **kw)
        elif case == "lights":
            state = _world(settled, 1).to(device)
            renderer = Renderer(compiled, "trackcam", lights=meta["lights"],
                                ground_texture=golden["ground_texture"],
                                sky_texture=golden["sky_texture"], **kw)
        elif case in ("capsule", "mesh"):
            state = _world(settled, 0).to(device)
            renderer = Renderer(compiled, "trackcam", mesh_fidelity=case == "mesh", **kw)
        else:
            raise ValueError(f"unknown render case {case!r}")
        fn = lambda: renderer.render_float(state)
    fn.worlds = int(state.xpos.shape[0])
    return fn
