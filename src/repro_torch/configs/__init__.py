"""Architecture configs of the port (``get_config(name, smoke=...)``)."""

from repro_torch.configs.base import ModelConfig, available_archs, get_config  # noqa: F401

# the ten architectures the reference assigns (its configs.ASSIGNED_ARCHS, in order)
ASSIGNED_ARCHS = (
    "xlstm-125m",
    "whisper-small",
    "llava-next-34b",
    "llama3.2-1b",
    "deepseek-v3-671b",
    "zamba2-7b",
    "llama4-maverick-400b-a17b",
    "glm4-9b",
    "tinyllama-1.1b",
    "gemma-2b",
)
