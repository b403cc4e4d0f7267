"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517]; the
reference's ``repro/configs/xlstm_125m.py``, value for value.

12L d_model=768 4H d_ff=0 vocab=50304.  d_ff=0: no separate FFN blocks; the
mLSTM block carries its own 2x up/down projection (xLSTM block design).
Assembly: 6 alternating (mLSTM, sLSTM) pairs.  The mLSTM's 8 heads of 192
over d_inner 1,536 make its scan N = P = 192 (and P = 1 for the
normaliser): the SSD-chunk kernel's CUDA-core body runs both, P split over
CTAs in tiles of 64.
"""

from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        kind="xlstm",
        source="arXiv:2405.04517",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        ssm_expand=2,
        ssm_head_dim=192,     # mLSTM: 8 heads of 192 over d_inner=1536; sLSTM: 4 heads over 768
        ssm_chunk=128,
        use_rope=False,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().with_(
        num_layers=2,
        d_model=128,
        vocab_size=512,
        ssm_head_dim=32,
        ssm_chunk=16,
        param_dtype="float32",
        activation_dtype="float32",
    )


register("xlstm-125m", full, smoke)
