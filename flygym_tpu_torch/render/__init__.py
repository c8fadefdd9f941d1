"""Scene raycasting of the port (the part the retina uses)."""
