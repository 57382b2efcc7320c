"""The public render pipeline."""
