"""The user's entry points: configs, the command line, the terminal viewer
and the fit app."""

from raytracer_tpu_torch.app.config import BASELINE_CONFIGS, RenderConfig, get_config

__all__ = ["RenderConfig", "BASELINE_CONFIGS", "get_config"]
