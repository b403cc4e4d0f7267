"""tinyllama-1.1b [dense] — llama2-arch small [arXiv:2401.02385]; the
reference's ``repro/configs/tinyllama_1_1b.py``, value for value.

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        family="dense",
        kind="decoder",
        source="arXiv:2401.02385",
        num_layers=22,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=64,
        d_ff=5632,
        vocab_size=32000,
        rope_theta=10_000.0,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        param_dtype="float32",
        activation_dtype="float32",
    )


register("tinyllama-1.1b", full, smoke)
