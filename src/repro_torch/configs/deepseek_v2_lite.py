"""deepseek-v2-lite [moe] — MLA without a query LoRA, YaRN RoPE, 64 routed
experts top-6 (softmax scores, not renormalised) + 2 shared, dropless, the
sequence-wise balance loss [arXiv:2405.04434; the model's published
``config.json``, https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite].

27L d_model=2048 16H, first layer dense (d_ff=10944), the other 26 MoE with
64 experts of width 1408; MLA kv_lora 512, qk nope/rope 128/64, v 128, no
q_lora (one ``wq``); YaRN factor 40 over 4,096 original positions, beta
32 / 1, mscale = mscale_all_dim = 0.707; RMSNorm eps 1e-6; vocab 102,400,
untied.  Not registered by the reference (``PORT_ONLY_ARCHS``).  The
balance loss's weight, 0.001, is not in the catalog's copy of the config
(assumed).  MLA runs in plain PyTorch: its q·k width (192) differs from
v's (128), which the flash kernel refuses.
"""

from repro_torch.configs.base import PortModelConfig, register


def full() -> PortModelConfig:
    return PortModelConfig(
        name="deepseek-v2-lite",
        family="moe",
        kind="decoder",
        source="arXiv:2405.04434",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=10944,               # the dense first layer
        vocab_size=102400,
        num_experts=64,
        num_experts_per_tok=6,
        num_shared_experts=2,
        moe_d_ff=1408,
        first_dense_layers=1,
        router_score="softmax",
        aux_loss_weight=0.001,
        norm_topk_prob=False,
        moe_dropless=True,
        use_mla=True,
        q_lora_rank=0,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        rope_theta=10_000.0,
        yarn_factor=40.0,
        yarn_original_max_positions=4096,
        yarn_beta_fast=32.0,
        yarn_beta_slow=1.0,
        yarn_mscale_all_dim=0.707,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke() -> PortModelConfig:
    return full().with_(
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        num_experts=16,
        num_experts_per_tok=3,
        moe_d_ff=32,
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
        yarn_original_max_positions=64,
        param_dtype="float32",
        activation_dtype="float32",
    )


register("deepseek-v2-lite", full, smoke)
