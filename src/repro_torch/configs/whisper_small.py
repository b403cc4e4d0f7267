"""whisper-small [audio] — encoder-decoder, conv frontend (stub)
[arXiv:2212.04356]; the reference's ``repro/configs/whisper_small.py``,
value for value.

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.  Backbone only: the
mel-spectrogram + conv frontend is a stub supplying (B, 1500, 768) frame
embeddings (``models/frontends.py``).  LayerNorm + GELU, learned positions
(no RoPE), tied decoder embedding / unembedding.  ``long_500k`` is skipped
for this arch: the decoder is bounded by design (448 positions).  Its
encoder self-attention (S 1,500, non-causal), decoder self-attention
(causal) and cross-attention (Sq the decoder's length, Skv 1,500) all go
through the flash kernel's DP 64 body.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        kind="encdec",
        source="arXiv:2212.04356",
        num_layers=12,
        encoder_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        mlp_kind="gelu",
        norm_kind="layernorm",
        use_rope=False,
        max_position_embeddings=448,
        encoder_seq=1500,
        tie_embeddings=True,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2,
        encoder_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        encoder_seq=12,
        max_position_embeddings=64,
        param_dtype="float32",
        activation_dtype="float32",
    )


register("whisper-small", full, smoke)
