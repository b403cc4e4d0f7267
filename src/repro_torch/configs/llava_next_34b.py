"""llava-next-34b [vlm] — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf];
the reference's ``repro/configs/llava_next_34b.py``, value for value.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  Backbone only: the
vision tower + projector is a stub supplying (B, 576, d_model) patch
embeddings (one base-resolution tile; ``models/frontends.py``).  Media
embeddings occupy the leading positions of the sequence; labels cover the
text positions.  Its 56 query heads over 8 kv heads are a GQA group of 7
at head dim 128: every prefill attention goes through the flash kernel's
DP 128 body.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        kind="decoder",
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        num_media_tokens=576,
        rope_theta=5_000_000.0,
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
        num_media_tokens=8,
        param_dtype="float32",
        activation_dtype="float32",
    )


register("llava-next-34b", full, smoke)
