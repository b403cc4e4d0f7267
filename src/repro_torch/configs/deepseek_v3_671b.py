"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437]; the reference's ``repro/configs/deepseek_v3_671b.py``,
value for value.

61L d_model=7168 128H d_ff=2048(expert) vocab=129280, MoE 256e top-8.
First 3 layers dense (d_ff=18432), remaining 58 MoE.  MLA: q_lora 1536,
kv_lora 512, qk nope/rope 128/64, v 128 — the compressed latent cache
(512+64 per token per layer).  Sigmoid router scores, one shared expert,
MTP depth 1.  MLA runs in plain PyTorch, as the reference runs it in jnp:
its q·k width (192) differs from v's (128), which the flash kernel refuses.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        kind="decoder",
        source="arXiv:2412.19437",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        d_ff=18432,               # dense (first 3) layers
        vocab_size=129280,
        num_experts=256,
        num_experts_per_tok=8,
        num_shared_experts=1,
        moe_d_ff=2048,
        first_dense_layers=3,
        router_score="sigmoid",
        capacity_factor=1.25,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        mtp_depth=1,
        rope_theta=10_000.0,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        num_experts=4,
        num_experts_per_tok=2,
        moe_d_ff=64,
        first_dense_layers=1,
        q_lora_rank=32,
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        mtp_depth=0,
        capacity_factor=8.0,
        param_dtype="float32",
        activation_dtype="float32",
    )


register("deepseek-v3-671b", full, smoke)
