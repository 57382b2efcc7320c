"""The soft (relaxed-visibility) differentiable renderer."""
