"""glm4-9b [dense] — RoPE, GQA [hf:THUDM/glm-4-9b]; the reference's
``repro/configs/glm4_9b.py``, value for value.

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552 (head dim 128).
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        kind="decoder",
        source="hf:THUDM/glm-4-9b",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=151552,
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
        d_ff=256,
        vocab_size=512,
        param_dtype="float32",
        activation_dtype="float32",
    )


register("glm4-9b", full, smoke)
