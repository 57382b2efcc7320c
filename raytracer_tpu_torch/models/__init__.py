"""Scene factories."""
