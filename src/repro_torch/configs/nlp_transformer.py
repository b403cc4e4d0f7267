"""nlp-transformer — the paper's own language-modality model (Appendix A,
Fig. 5): a small transformer classifier for the AGNews / SogouNews
experiments (Table 3); the reference's ``repro/configs/nlp_transformer.py``,
value for value.  The paper does not publish exact dims; the reference uses
a 4-layer encoder sized to the reported per-round costs.

4L d_model=256 8H (kv=8) d_ff=1024 vocab=30000, GELU, LayerNorm, learned
positions (256), no RoPE.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="nlp-transformer",
        family="dense",
        kind="decoder",          # kind unused by nlp_small; kept for registry shape
        source="paper Fig. 5",
        num_layers=4,
        d_model=256,
        num_heads=8,
        num_kv_heads=8,
        d_ff=1024,
        vocab_size=30000,
        mlp_kind="gelu",
        norm_kind="layernorm",
        use_rope=False,
        max_position_embeddings=256,
    )


def smoke() -> ModelConfig:
    return full().with_(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                        d_ff=128, vocab_size=512, max_position_embeddings=64)


register("nlp-transformer", full, smoke)
