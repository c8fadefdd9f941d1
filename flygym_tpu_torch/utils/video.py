"""Video export and the multi-world frame montage.

Port of ``flygym_tpu/utils/video.py``: an mp4 writer that pads frames to
multiples of 16 (a GIF next to the path where no ffmpeg is found) and a
near-square grid of worlds with their ids drawn on. ``imageio`` and ``PIL``
are imported when called, so that the port runs without them; where
``imageio`` is missing, ``PIL`` writes the GIF.
"""

from pathlib import Path

import numpy as np

__all__ = ["write_video", "montage_grid"]


def _pad_to_multiple_of_16(frame: np.ndarray) -> np.ndarray:
    """Pad H and W to multiples of 16 (libx264's requirement)."""
    h, w = frame.shape[:2]
    ph, pw = (-h) % 16, (-w) % 16
    if ph == 0 and pw == 0:
        return frame
    return np.pad(frame, ((0, ph), (0, pw), (0, 0)), mode="edge")


def _host(frame) -> np.ndarray:
    """A frame as a numpy array (a tensor copied from its device)."""
    return frame.cpu().numpy() if hasattr(frame, "cpu") else np.asarray(frame)


def write_video(path, frames, fps: int = 25) -> None:
    """Write (H, W, 3) uint8 frames (arrays or tensors) to an mp4, or to a
    GIF beside ``path`` where ffmpeg or ``imageio`` is missing."""
    if len(frames) == 0:
        raise ValueError("No frames to write.")
    frames = [_pad_to_multiple_of_16(_host(f)) for f in frames]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    try:
        import imageio.v2 as imageio
    except ImportError:
        from PIL import Image

        first, *rest = (Image.fromarray(f) for f in frames)
        first.save(path.with_suffix(".gif"), save_all=True, append_images=rest,
                   duration=1000 / fps, loop=0)
        return
    try:
        imageio.mimwrite(path, frames, fps=fps)
    except Exception:
        imageio.mimwrite(path.with_suffix(".gif"), frames, duration=1000 / fps)


def montage_grid(frames, world_ids: list) -> np.ndarray:
    """Tile (n, H, W, 3) uint8 frames into a near-square grid, each tile
    labelled with its world id."""
    from PIL import Image, ImageDraw

    frames = _host(frames)
    n, h, w = frames.shape[:3]
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        tile = Image.fromarray(frames[i])
        ImageDraw.Draw(tile).text((4, 4), f"world {world_ids[i]}", fill=(255, 255, 255))
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = np.asarray(tile)
    return grid
