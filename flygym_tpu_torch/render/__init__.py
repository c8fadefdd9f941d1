"""The camera renderer: raycast frames, cameras and lights, video export."""

from flygym_tpu_torch.render.renderer import (
    Camera,
    Renderer,
    launch_interactive_viewer,
    preview_model,
)

__all__ = ["Camera", "Renderer", "launch_interactive_viewer", "preview_model"]
