"""zamba2-7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242]; the
reference's ``repro/configs/zamba2_7b.py``, value for value.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
Assembly: 13 chunks of (shared attention block -> 6 mamba2 blocks) + 3 tail
mamba2 blocks.  The shared transformer block (one parameter set, reused at
every application) consumes concat(hidden, original embedding).
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        kind="hybrid",
        source="arXiv:2411.15242",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        ssm_state_dim=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        attn_every=6,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=5,          # 2 chunks of 2 + 1 tail
        attn_every=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        ssm_state_dim=16,
        ssm_head_dim=32,
        ssm_chunk=16,
        param_dtype="float32",
        activation_dtype="float32",
    )


register("zamba2-7b", full, smoke)
