"""The port's ``Renderer`` and the simulation's render hooks, on the CPU.

Mirrors ``tests/core/test_render.py`` for the port: frames, the time gating,
the buffer and its reset, cameras, batched world selection, the montage,
video export, textures, lights and ``preview_model``; then the simulation's
hooks and the report's render counters, ``run_benchmark(enable_rendering=
True)``, and the heightfield retina against JAX's ``Retina.render``.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from flygym_tpu_torch import BatchSimulation, Simulation, load_compiled
from flygym_tpu_torch.compose.bridge import TERRAIN_FLY, TWOFLY, load_terrain_golden
from flygym_tpu_torch.demo.benchmark import run_benchmark, run_simulation
from flygym_tpu_torch.render import Camera, Renderer, launch_interactive_viewer, preview_model
from flygym_tpu_torch.render.raycast import default_lights
from flygym_tpu_torch.render.renderer import _load_texture
from flygym_tpu_torch.utils.video import montage_grid, write_video
from flygym_tpu_torch.vision import Retina

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
THORAX = "nmf/c_thorax"


@pytest.fixture(scope="module")
def compiled():
    return load_compiled()


@pytest.fixture
def sim(compiled):
    return Simulation(compiled, device="cpu")


def _frame(renderer, state) -> np.ndarray:
    return next(iter(renderer.render(state).values())).numpy()


def test_render_frame_shows_fly_ground_and_sky(sim):
    renderer = sim.set_renderer("trackcam", camera_res=(60, 80))
    frame = _frame(renderer, sim.state)
    assert frame.shape == (60, 80, 3) and frame.dtype == np.uint8
    assert frame.std() > 10
    sky, center = frame[0, :5].mean(axis=(0, 1)), frame[25:40, 30:50].mean(axis=(0, 1))
    assert np.abs(sky - center).max() > 10


def test_render_as_needed_gating(sim):
    """One frame per 1 / (25 / 0.2) = 8 ms of simulated time: 80 steps."""
    renderer = sim.set_renderer("trackcam", camera_res=(24, 32), playback_speed=0.2,
                                output_fps=25)
    n_rendered = 0
    for _ in range(170):
        sim.step()
        n_rendered += sim.render_as_needed()
    assert n_rendered == 3  # t = 0, 8 ms and 16 ms
    assert len(renderer.get_frames()) == 3


def test_reset_clears_the_buffer(sim):
    renderer = sim.set_renderer("trackcam", camera_res=(24, 32))
    renderer.render(sim.state)
    assert len(renderer.get_frames()) == 1
    renderer.reset()
    assert len(renderer.get_frames()) == 0
    renderer.render(sim.state)
    sim.reset()  # the simulation's reset clears its renderer too
    assert len(renderer.get_frames()) == 0


def test_unknown_camera_raises(sim, compiled):
    with pytest.raises(ValueError, match="not found"):
        sim.set_renderer("nonexistent_cam")
    bare = dataclasses.replace(compiled, render=None)
    with pytest.raises(ValueError, match="not found"):
        Renderer(bare, "trackcam", device="cpu")
    with pytest.raises(TypeError):
        Renderer(compiled, 3, device="cpu")


def test_cameras_by_name_and_full_identifier():
    two = load_compiled(TWOFLY)
    renderer = Renderer(two, ["bottom/trackcam", "top/trackcam"], device="cpu",
                        camera_res=(12, 16))
    assert renderer.camera_names == ["bottom/trackcam", "top/trackcam"]
    assert [c.target for c in renderer.cameras] == [1, 70]
    assert Renderer(two, "trackcam", device="cpu").camera_names == ["bottom/trackcam"]
    frames = renderer.render(two.initial_state)
    assert set(frames) == {"bottom/trackcam", "top/trackcam"}


def test_save_video(sim, tmp_path):
    renderer = sim.set_renderer("trackcam", camera_res=(24, 32))
    for _ in range(3):
        renderer.render(sim.state)
    out = tmp_path / "video.mp4"
    renderer.save_video(out)
    assert out.exists() or out.with_suffix(".gif").exists()


def test_save_video_without_imageio_writes_a_gif(sim, tmp_path, monkeypatch):
    """Where imageio is missing (the card's machine), PIL writes the GIF."""
    import sys

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    renderer = sim.set_renderer("trackcam", camera_res=(24, 32))
    renderer.render(sim.state)
    renderer.save_video(tmp_path / "video.mp4")
    assert (tmp_path / "video.gif").exists() and not (tmp_path / "video.mp4").exists()
    from PIL import Image

    frames = [np.full((24, 32, 3), 80 * i, np.uint8) for i in range(3)]
    write_video(tmp_path / "grey.mp4", frames)
    with Image.open(tmp_path / "grey.gif") as gif:
        assert gif.n_frames == 3 and gif.size == (32, 32)  # padded to 16


def test_show_in_notebook_needs_frames(sim):
    renderer = sim.set_renderer("trackcam", camera_res=(24, 32))
    with pytest.raises(RuntimeError):
        renderer.show_in_notebook()


def test_batched_world_selection(compiled, tmp_path):
    bsim = BatchSimulation(compiled, 3, device="cpu")
    renderer = bsim.set_renderer("trackcam", camera_res=(24, 32), world_ids=[0, 2])
    frame = _frame(renderer, bsim.state)
    assert frame.shape == (2, 24, 32, 3)
    assert np.array_equal(frame[0], frame[1])  # identical worlds
    assert renderer.get_frames(world_id=2)[0].shape == (24, 32, 3)
    renderer.save_video_grid(tmp_path / "grid.mp4")
    assert (tmp_path / "grid.mp4").exists() or (tmp_path / "grid.gif").exists()


def test_single_world_batch_keeps_its_world_axis(compiled):
    bsim = BatchSimulation(compiled, 1, device="cpu")
    renderer = bsim.set_renderer("trackcam", camera_res=(24, 32), world_ids=[0])
    assert _frame(renderer, bsim.state).shape == (1, 24, 32, 3)


def test_targetbody_camera_aims_at_the_fly(compiled):
    """A targetbody camera re-aims at the target each frame: the fly, moved
    6 mm and 5 mm away from the camera's fixed axis, stays in the centre."""
    state = compiled.initial_state
    moved = dataclasses.replace(state, xpos=state.xpos + torch.tensor([6.0, 5.0, 0.0]))
    cam = Camera("aimcam", "aimcam", "targetbody", (0.0, -10.0, 4.0), fovy=40.0, target=1)
    renderer = Renderer(compiled, cam, device="cpu", camera_res=(40, 52))
    gray = _frame(renderer, moved).astype(np.float32).mean(-1)
    assert np.abs(gray[14:26, 18:34] - gray[0, :].mean()).max() > 15


def test_grid_montage():
    frames = np.random.default_rng(0).integers(0, 255, (3, 24, 32, 3), dtype=np.uint8)
    grid = montage_grid(torch.as_tensor(frames), [0, 1, 2])
    assert grid.shape == (48, 64, 3) and grid.dtype == np.uint8


def test_textures_colour_ground_and_sky(sim):
    red = np.zeros((4, 4, 3), np.float32)
    red[..., 0] = 1.0
    frame = _frame(sim.set_renderer("trackcam", camera_res=(40, 56), ground_texture=red),
                   sim.state).astype(float)
    bottom = frame[-8:].mean(axis=(0, 1))
    assert bottom[0] > 1.5 * bottom[1] and bottom[0] > 1.5 * bottom[2], bottom
    magenta = np.zeros((4, 8, 3), np.float32)
    magenta[..., [0, 2]] = 1.0
    cam = Camera("up", "up", "fixed", (20.0, 20.0, 2.0), (0.0, 1.0, 0.0, 0.0), 60.0)
    frame = _frame(Renderer(sim.compiled, cam, device="cpu", camera_res=(24, 32),
                            sky_texture=magenta), sim.state).astype(float)
    top = frame.mean(axis=(0, 1))  # looking straight up: all sky
    assert top[0] > 1.5 * top[1] and top[2] > 1.5 * top[1], top


def test_load_texture_formats(tmp_path):
    assert _load_texture(None) is None
    assert float(_load_texture(np.full((2, 2, 3), 255, np.uint8)).max()) == 1.0
    assert _load_texture(np.ones((2, 2, 4), np.float32)).shape == (2, 2, 3)
    assert _load_texture(np.ones((2, 2), np.float32)).shape == (2, 2, 3)
    with pytest.raises(ValueError):
        _load_texture(np.ones((2, 2, 2), np.float32))
    from matplotlib.image import imsave

    path = tmp_path / "tex.png"
    imsave(path, np.zeros((2, 2, 3), np.float32))
    assert _load_texture(path).shape == (2, 2, 3)


def test_default_lights_match_an_explicit_sun(sim):
    f_def = _frame(sim.set_renderer("trackcam", camera_res=(40, 56)), sim.state)
    sun = [{"kind": "directional", "dir": default_lights()[0]["vec"].numpy(), "color": 0.5,
            "specular": 1.0}]
    f_sun = _frame(sim.set_renderer("trackcam", camera_res=(40, 56), lights=sun), sim.state)
    assert np.abs(f_def.astype(int) - f_sun.astype(int)).max() <= 1


def test_coloured_point_light_tints_the_scene(sim):
    red = [{"kind": "point", "pos": (0.0, 0.0, 8.0), "color": (1.2, 0.1, 0.1),
            "cast_shadow": False}]
    ground = _frame(sim.set_renderer("trackcam", camera_res=(40, 56), lights=red),
                    sim.state).astype(float)[30:]
    assert ground[..., 0].mean() > ground[..., 2].mean() + 10


def test_bad_light_specs_raise(compiled):
    for lights in ([{"kind": "spot", "dir": (0, 0, -1)}],
                   [{"kind": "directional", "target": THORAX}],
                   [{"kind": "point", "color": 1.0}],
                   [{"kind": "point", "target": "nmf/no_such_body"}]):
        with pytest.raises(ValueError):
            Renderer(compiled, "trackcam", device="cpu", lights=lights)


def test_tracking_light_follows_each_world(compiled):
    """A point light on the thorax resolves per world in one batched render."""
    bsim = BatchSimulation(compiled, 2, device="cpu")
    xpos = bsim.state.xpos.clone()
    xpos[1] += torch.tensor([5.0, 0.0, 0.0])
    state = dataclasses.replace(bsim.state, xpos=xpos)
    renderer = bsim.set_renderer("trackcam", camera_res=(32, 44), world_ids=[0, 1], lights=[
        {"kind": "point", "target": THORAX, "offset": (0, 0, 8.0), "color": 0.9}])
    lights = renderer._concrete_lights(state)
    np.testing.assert_allclose(lights[0]["vec"][:, 0] - xpos[:, 1, 0], 0.0)
    frames = _frame(renderer, state)
    assert frames.shape == (2, 32, 44, 3) and frames.std() > 5


def test_mesh_fidelity_changes_the_silhouette(compiled):
    state = compiled.initial_state
    frames = [Renderer(compiled, "trackcam", device="cpu", camera_res=(40, 52),
                       mesh_fidelity=m).render_float(state)[0].numpy() for m in (False, True)]
    diff = np.abs(frames[1] - frames[0]).max(axis=-1) > 0.05
    assert 0.01 < diff.mean() < 0.6, diff.mean()
    with pytest.raises(ValueError, match="geom names"):
        Renderer(dataclasses.replace(compiled, render={**compiled.render, "geom_names": []}),
                 "trackcam", device="cpu", mesh_fidelity=True)


def test_preview_model(compiled, tmp_path):
    frame = preview_model(compiled, "trackcam", duration_s=0.002, camera_res=(24, 32),
                          save_path=tmp_path / "preview.png", device="cpu")
    assert frame.shape == (24, 32, 3) and (tmp_path / "preview.png").exists()


def test_interactive_viewer_waits_for_the_compile(compiled, tmp_path, monkeypatch):
    """The viewer opens the MJCF of a world the port composed and compiled;
    a loaded file has no model description to write. Without a display it
    writes the MJCF to ``fallback_path`` or raises; without MuJoCo it raises
    an ImportError naming it."""
    import importlib.util
    import sys

    from flygym_tpu_torch.render.renderer import viewer_world

    with pytest.raises(TypeError, match="composed world"):
        launch_interactive_viewer(compiled)
    world = viewer_world()
    assert world.compile()[0].nv == 132
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    if importlib.util.find_spec("mujoco") is not None:
        out = launch_interactive_viewer(world, fallback_path=tmp_path / "world.xml")
        assert out.read_text() == world.spec.to_mjcf_xml()
        with pytest.raises(RuntimeError, match="display"):
            launch_interactive_viewer(world)
    monkeypatch.setitem(sys.modules, "mujoco", None)
    with pytest.raises(ImportError, match="mujoco"):
        launch_interactive_viewer(world)


def test_render_hooks_fill_the_report(sim, capsys):
    """render_as_needed_with_profile counts frames and their time, and the
    report prints them (``flygym_tpu/simulation.py:404-410``)."""
    sim.set_renderer("trackcam", camera_res=(12, 16))
    for _ in range(90):
        sim.step_with_profile()
        sim.render_as_needed_with_profile()
    assert sim._frames_rendered == 2 and sim._total_render_time_ns > 0
    sim.print_performance_report(show_in_notebook=False)
    assert "2 frames were rendered out of 90 steps" in " ".join(capsys.readouterr().out.split())
    sim.reset()
    assert sim._frames_rendered == 0 and sim._total_render_time_ns == 0


def test_batch_report_counts_the_rendered_worlds(compiled, capsys):
    bsim = BatchSimulation(compiled, 3, device="cpu")
    bsim.set_renderer("trackcam", camera_res=(12, 16), world_ids=[0, 1])
    bsim.step_with_profile()
    assert bsim.render_as_needed_with_profile()
    bsim.print_performance_report(show_in_notebook=False)
    out = capsys.readouterr().out
    assert "1 frames were rendered" in " ".join(out.split())
    # The rendering row's parallel columns are scaled by the 2 worlds rendered.
    row = next(line for line in out.splitlines() if "Rendering" in line)
    cells = [c.strip() for c in row.split("│") if c.strip()]
    assert float(cells[-2]) == pytest.approx(2 * float(cells[3]), abs=2)


def test_benchmark_renders_one_frame_after_the_timed_replay(compiled):
    targets = np.zeros((2, 8, 42), np.float32)
    walltime, sim = run_simulation(compiled, targets, device="cpu", warmup_steps=8,
                                   enable_rendering=True)
    assert walltime > 0
    frames = sim.renderer.get_frames()
    assert len(frames) == 1 and frames[0].shape == (1, 240, 320, 3)
    out = run_benchmark(2, 2, 2, sim_steps=8, device="cpu", warmup_steps=8,
                        enable_rendering=True)
    assert list(out["n_worlds"]) == [2]
    (frames,) = out["frames"]
    assert len(frames) == 1 and frames[0].shape == (1, 240, 320, 3)


@pytest.fixture(scope="module")
def terrain_jax():
    spec = importlib.util.spec_from_file_location(
        "export_terrain_golden", REPO / "scripts" / "export_terrain_golden.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fly, world = module.build_world()
    model, _ = world.compile()
    return fly, world, model


def test_heightfield_retina_matches_jax(terrain_jax):
    """On the terrain fly's blocks, the batched retina takes the port of
    JAX's jnp path (K3 is not launched) and agrees with JAX's eager
    ``Retina.render`` on 99.5% of the ommatidia within 1e-3."""
    import jax.numpy as jnp

    from flygym_tpu.engine.model import State as JaxState
    from flygym_tpu.vision import Retina as JaxRetina

    fly, world, jax_model = terrain_jax
    compiled = load_compiled(TERRAIN_FLY)
    ids = compiled.render["body_name2id"]
    retina = Retina.build(compiled.model, ids[f"{fly.name}/l_eye"], ids[f"{fly.name}/r_eye"])
    state = load_terrain_golden()["state"].map(lambda x: x[:1].clone())
    render = retina.make_render_batched(compiled.model)
    assert render.kernel is None
    got = render(state)[0].numpy()
    jstate = JaxState(**{k: jnp.asarray(getattr(state, k)[0].numpy())
                         for k in state.__dataclass_fields__})
    want = np.asarray(JaxRetina.for_fly(world, fly.name).render(jax_model, jstate))
    assert got.shape == want.shape == (2, 721, 2)
    assert (np.abs(got - want) <= 1e-3).mean() >= 0.995
