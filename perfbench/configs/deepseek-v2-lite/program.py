"""The system under test for this configuration: the port's causal-LM task
(``repro_torch.fl.tasks.lm_task``) on the registered ``deepseek-v2-lite``
at the sizes of ``config.json``: its published widths, card 0's share (the
experts held, the vocabulary slice), float32, dropless routing."""

from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.fl.tasks import lm_task


def model_config(cfg: dict):
    rs = cfg["rope_scaling"]
    if (cfg["q_lora_rank"] is not None or rs["mscale"] != rs["mscale_all_dim"]
            or not cfg["seq_aux"] or cfg["routed_scaling_factor"] != 1):
        raise ValueError("the port's DeepSeek-V2 has no query LoRA, scales cos and sin by 1 "
                         "(mscale = mscale_all_dim), takes the sequence-wise balance loss "
                         "and leaves the routed experts' output unscaled")
    return get_config("deepseek-v2-lite").with_(
        num_layers=cfg["num_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        num_experts=cfg["router_experts"], experts_held=cfg["n_routed_experts"],
        first_expert=cfg["first_expert"], num_experts_per_tok=cfg["num_experts_per_tok"],
        num_shared_experts=cfg["n_shared_experts"], moe_d_ff=cfg["moe_intermediate_size"],
        first_dense_layers=cfg["first_k_dense_replace"], norm_topk_prob=cfg["norm_topk_prob"],
        aux_loss_weight=cfg["aux_loss_alpha"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        rope_theta=float(cfg["rope_theta"]), yarn_factor=float(rs["factor"]),
        yarn_original_max_positions=rs["original_max_position_embeddings"],
        yarn_beta_fast=float(rs["beta_fast"]), yarn_beta_slow=float(rs["beta_slow"]),
        yarn_mscale_all_dim=float(rs["mscale_all_dim"]),
        param_dtype=cfg["dtype"], activation_dtype=cfg["dtype"])


def make_task(cfg: dict):
    return lm_task(model_config(cfg))
