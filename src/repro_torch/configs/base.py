"""Model configuration dataclass + registry (port of ``repro.configs.base``).

``ModelConfig`` is the reference's dataclass field for field, so a config
built on either side describes the same model.  The registry holds the
architectures the port runs: the dense decoders ``tinyllama-1.1b``,
``llama3.2-1b``, ``gemma-2b`` and ``glm4-9b``, the MoE decoders
``llama4-maverick-400b-a17b`` and ``deepseek-v3-671b`` (MLA, MTP head),
``zamba2-7b`` (Mamba2 hybrid), ``xlstm-125m`` (mLSTM / sLSTM pairs) and
``nlp-transformer`` (the paper's text classifier, ``models/nlp_small.py``),
full and smoke.  Every other architecture of
the reference raises ``NotImplementedError`` naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
MlpKind = Literal["swiglu", "geglu", "gelu"]
NormKind = Literal["rmsnorm", "layernorm"]
ModelKind = Literal["decoder", "encdec", "xlstm", "hybrid"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity -------------------------------------------------------------
    name: str
    family: Family
    kind: ModelKind
    source: str = ""                 # paper / model-card citation

    # trunk ------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    mlp_kind: MlpKind = "swiglu"
    norm_kind: NormKind = "rmsnorm"
    tie_embeddings: bool = False
    rope_theta: float = 500_000.0
    use_rope: bool = True
    max_position_embeddings: int = 0  # >0 -> learned absolute positions
    # Sliding-window attention (0 = full causal).  The long_500k decode shape
    # switches dense/MoE archs to a window (DESIGN.md §4).
    sliding_window: int = 0

    # MoE --------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    first_dense_layers: int = 0      # leading dense blocks (deepseek-v3: 3)
    router_score: Literal["softmax", "sigmoid"] = "softmax"
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001
    mtp_depth: int = 0               # deepseek-v3 multi-token prediction heads

    # MLA (deepseek) -----------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # SSM / hybrid -------------------------------------------------------
    ssm_state_dim: int = 0           # mamba2 N
    ssm_num_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0              # zamba2: shared attn block period
    # xlstm: which block index is sLSTM vs mLSTM (alternating by default)
    slstm_every: int = 2             # every 2nd block is sLSTM

    # enc-dec / frontends --------------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0             # stub frontend sequence length (audio frames)
    num_media_tokens: int = 0        # VLM: stub image-embedding tokens per sample

    # numerics -----------------------------------------------------------
    param_dtype: str = "float32"
    activation_dtype: str = "float32"

    # derived --------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def supports_long_decode(self) -> bool:
        """True if the arch can decode with a 500k context (DESIGN.md §4)."""
        if self.kind in ("xlstm", "hybrid"):
            return True
        if self.kind == "encdec":
            return False             # whisper: bounded decoder by design
        return True                  # dense/MoE: sliding-window variant

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}

# The reference's architectures still unported (the encoder-decoder and the
# VLM), and the ROADMAP item that ports each.
_UNPORTED = {
    "llava-next-34b": "Queue 1 item 15 (VLM frontends)",
    "whisper-small": "Queue 1 item 15 (encoder-decoder)",
}


def register(name: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        if name in _UNPORTED:
            raise NotImplementedError(
                f"arch {name!r} is not ported yet: ROADMAP {_UNPORTED[name]}")
        raise KeyError(f"unknown arch {name!r}; available: {sorted(table)}")
    return table[name]()


def available_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    from repro_torch.configs import (  # noqa: F401  (register)
        deepseek_v3_671b, gemma_2b, glm4_9b, llama3_2_1b, llama4_maverick_400b_a17b,
        nlp_transformer, resnet, tinyllama_1_1b, xlstm_125m, zamba2_7b)

    _LOADED = True
