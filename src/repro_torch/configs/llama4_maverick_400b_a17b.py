"""llama4-maverick-400b-a17b [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]; the reference's
``repro/configs/llama4_maverick_400b_a17b.py``, value for value.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1 plus
one always-on shared expert (llama4 design); text backbone only, as the
reference.  Its 40 query heads over 8 kv heads are a GQA group of 5 at
head dim 128: every prefill attention goes through the flash kernel's
DP 128 body.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        kind="decoder",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=202048,
        num_experts=128,
        num_experts_per_tok=1,
        num_shared_experts=1,
        moe_d_ff=8192,
        capacity_factor=1.25,
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
        num_experts=4,
        num_experts_per_tok=1,
        moe_d_ff=64,
        capacity_factor=8.0,
        param_dtype="float32",
        activation_dtype="float32",
    )


register("llama4-maverick-400b-a17b", full, smoke)
