"""Architecture configs of the port (``get_config(name, smoke=...)``)."""

from repro_torch.configs.base import ModelConfig, available_archs, get_config  # noqa: F401
