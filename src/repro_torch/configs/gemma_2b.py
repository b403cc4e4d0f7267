"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295]; the
reference's ``repro/configs/gemma_2b.py``, value for value.

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.  Tied embeddings.
Its head dim of 256 is the one above 128 among the served configs: the
flash kernel's bf16 body runs it at DP 256 with 64-key K / V tiles.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        family="dense",
        kind="decoder",
        source="arXiv:2403.08295",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        mlp_kind="geglu",
        tie_embeddings=True,
        rope_theta=10_000.0,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        param_dtype="float32",
        activation_dtype="float32",
    )


register("gemma-2b", full, smoke)
