"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]; the
reference's ``repro/configs/llama3_2_1b.py``, value for value.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.  Tied embeddings,
RoPE theta 500k, SwiGLU, RMSNorm.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b",
        family="dense",
        kind="decoder",
        source="hf:meta-llama/Llama-3.2-1B",
        num_layers=16,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        tie_embeddings=True,
        rope_theta=500_000.0,
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


register("llama3.2-1b", full, smoke)
