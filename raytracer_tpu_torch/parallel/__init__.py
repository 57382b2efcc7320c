"""The fit step (the pixel-sharded mesh is not ported yet)."""
