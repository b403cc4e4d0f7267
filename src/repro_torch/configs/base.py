"""Model configuration dataclass + registry (port of ``repro.configs.base``).

``ModelConfig`` is the reference's dataclass field for field, so a config
built on either side describes the same model.  ``PortModelConfig`` adds
the port's own fields (YaRN, the gate's renormalisation,
DeepSeek-V2's dropless layer with its sequence-wise balance loss, the
experts held), whose
defaults leave every other architecture as the reference has it; the
layers read them through ``port_field``.  The registry holds every
architecture the reference registers, full and smoke: the dense decoders
``tinyllama-1.1b``, ``llama3.2-1b``, ``gemma-2b`` and ``glm4-9b``, the MoE
decoders ``llama4-maverick-400b-a17b`` and ``deepseek-v3-671b`` (MLA, MTP
head), the VLM ``llava-next-34b`` (a decoder behind stub media
embeddings), the encoder-decoder ``whisper-small``, ``zamba2-7b`` (Mamba2
hybrid), ``xlstm-125m`` (mLSTM / sLSTM pairs), ``nlp-transformer`` (the
paper's text classifier, ``models/nlp_small.py``) and the ResNet
placeholder records; besides them, the port's own ``deepseek-v2-lite``
(MLA with YaRN, dropless MoE with shared experts; ``PORT_ONLY_ARCHS``),
which the reference does not register.
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


@dataclasses.dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """``ModelConfig`` with the port's own fields, for the architectures the
    reference does not register (``PORT_ONLY_ARCHS``); their defaults are
    the behaviour of every reference architecture."""

    # YaRN frequencies for MLA's rope part (0 = plain RoPE; DeepSeek-V2's
    # ``rope_scaling``): factor, the original context, the ramp's two ends in
    # rotations, and ``mscale_all_dim`` (MLA's softmax scale times m², m =
    # 0.1·mscale_all_dim·ln(factor) + 1; cos and sin stay unscaled, as
    # ``mscale`` = ``mscale_all_dim`` makes them)
    yarn_factor: float = 0.0
    yarn_original_max_positions: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    norm_topk_prob: bool = True      # renormalise the top-k gate values to sum 1
    # DeepSeek-V2's MoE layer: dropless routing (every entry computed, grouped
    # products over the entries sorted by expert) and the sequence-wise
    # balance loss
    moe_dropless: bool = False
    # the experts this device holds, ``first_expert .. first_expert +
    # experts_held - 1`` of ``num_experts`` (0: all): the router scores all
    # of them; the layer computes its own experts' part of the result
    experts_held: int = 0
    first_expert: int = 0


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(PortModelConfig)}


def port_field(cfg, name: str):
    """Field ``name`` of ``cfg``, or its default where ``cfg`` lacks it: the
    port's layers also take the reference's own ``ModelConfig``, which has
    none of the port's fields."""
    return getattr(cfg, name, _DEFAULTS[name])


def experts_held(cfg) -> int:
    """The experts this device holds (``experts_held``, 0: all of them)."""
    return port_field(cfg, "experts_held") or cfg.num_experts


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# registered by the port and not by the reference
PORT_ONLY_ARCHS = ("deepseek-v2-lite",)

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
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
        deepseek_v2_lite, deepseek_v3_671b, gemma_2b, glm4_9b, llama3_2_1b,
        llama4_maverick_400b_a17b, llava_next_34b, nlp_transformer, resnet,
        tinyllama_1_1b, whisper_small, xlstm_125m, zamba2_7b)

    _LOADED = True
