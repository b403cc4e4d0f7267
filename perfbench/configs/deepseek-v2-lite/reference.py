"""Plain PyTorch reference of DeepSeek-V2-Lite as a causal LM, card 0's share
(``config.json``), in float32, written from the published modelling code
(``modeling_deepseek.py`` of the model's repository) and its ``config.json``.

Per layer: x + MLA(RMSNorm(x)), then + MLP or MoE (RMSNorm(x)); then the
final RMSNorm and the untied head over the vocabulary slice.

* **MLA without a query LoRA**: ``q = x wq`` (16 heads × (128 nope + 64
  rope)); ``[c_kv, k_rope] = x wkv_a`` (512 + 64); ``[k_nope, v] =
  RMSNorm(c_kv) wkv_b`` (16 × (128 + 128)); causal softmax of
  ``(q_nope·k_nope + q_rope·k_rope) · scale``; ``wo`` back to 2,048.
* **YaRN** (``rope_scaling``: factor 40, original 4,096 positions, beta_fast
  32, beta_slow 1, θ 10⁴, rope dim 64).  Pair i's plain frequency is
  ``f_i = θ^(−2i/64)``.  The published correction range is the dimension at
  which a frequency turns r times over the original context, ``64 ·
  ln(4096 / (2π r)) / (2 ln θ)``: 10.47 for r = 32 (floor 10) and 22.51 for
  r = 1 (ceil 23).  So ``γ_i = 1 − clamp((i − 10) / 13, 0, 1)``: 1 up to pair
  10, 0 from pair 23, linear between, and ``inv_freq_i = (1 − γ_i) f_i / 40
  + γ_i f_i``.  cos and sin are multiplied by ``m(mscale) / m(mscale_all_dim)``
  = 1 (both 0.707), and the softmax scale is ``192^-½ · m²`` with ``m = 0.1 ·
  0.707 · ln 40 + 1 = 1.2608``.
* **MoE**: the router scores all 64 experts (softmax of f32 logits) and
  keeps the top 6 with their scores as weights (``norm_topk_prob`` false,
  ``routed_scaling_factor`` 1).  The 8 experts held here are computed
  dropless, one boolean mask per expert over the token-repeated entries, as
  the published training path does; the other 56 experts' terms are left
  out.  The 2 shared experts (one SwiGLU MLP of width 2 × 1,408) run on
  every token.  The sequence-wise balance loss (``seq_aux``): per sequence,
  ``Σ_i f_i P_i``, ``f_i`` = the count of the sequence's S·6 choices that
  picked expert i over S·6/64, ``P_i`` the mean score of expert i; the mean
  over sequences times ``aux_loss_alpha``.
* **Loss**: mean next-token cross-entropy over the (B, S) labels, plus the
  MoE layers' balance losses.

Departures from the published code, kept by the program alike: RoPE rotates
the two halves of the 64 rope columns where the published code first
permutes interleaved pairs into halves; with random weights that is a
fixed permutation of the rope columns of ``wq`` and ``wkv_a``.  The masked
scores take −10³⁰, not the dtype's minimum.  Weights are ``(in, out)``,
``y = x @ w``.  Layer groups, shallow to deep: the embedding, each layer,
then the final norm with the head.  Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.fedref import Leaf

PROTO_SEED = 1234        # the data's fixed successor table
FOLLOW = 0.8             # share of tokens that take one of their 4 successors
NEG = -1e30


def _dims(cfg: dict) -> dict:
    h = cfg["num_attention_heads"]
    return dict(d=cfg["hidden_size"], h=h, nope=cfg["qk_nope_head_dim"],
                rope=cfg["qk_rope_head_dim"], vd=cfg["v_head_dim"], rank=cfg["kv_lora_rank"],
                ff=cfg["intermediate_size"], f=cfg["moe_intermediate_size"],
                e=cfg["n_routed_experts"], layers=cfg["num_layers"],
                dense=cfg["first_k_dense_replace"], vocab=cfg["vocab_size"])


def leaves(cfg: dict) -> list[Leaf]:
    z = _dims(cfg)
    d, h = z["d"], z["h"]
    head = z["layers"] + 1
    out = [Leaf("embed/table", (z["vocab"], d), 0, std=0.02),
           Leaf("final_norm/scale", (d,), head, fill=1.0),
           Leaf("head/w", (d, z["vocab"]), head, std=1 / math.sqrt(d))]

    def lin(path, d_in, d_out, g):
        return Leaf(path, (d_in, d_out), g, std=1 / math.sqrt(d_in))

    for i in range(z["layers"]):
        b, g = f"layers/{i}", 1 + i
        out += [Leaf(f"{b}/attn_norm/scale", (d,), g, fill=1.0),
                Leaf(f"{b}/mlp_norm/scale", (d,), g, fill=1.0),
                lin(f"{b}/attn/wq/w", d, h * (z["nope"] + z["rope"]), g),
                lin(f"{b}/attn/wkv_a/w", d, z["rank"] + z["rope"], g),
                Leaf(f"{b}/attn/kv_norm/scale", (z["rank"],), g, fill=1.0),
                lin(f"{b}/attn/wkv_b/w", z["rank"], h * (z["nope"] + z["vd"]), g),
                lin(f"{b}/attn/wo/w", h * z["vd"], d, g)]
        if i < z["dense"]:
            out += [lin(f"{b}/mlp/w_gate/w", d, z["ff"], g),
                    lin(f"{b}/mlp/w_up/w", d, z["ff"], g),
                    lin(f"{b}/mlp/w_down/w", z["ff"], d, g)]
        else:
            f, sf = z["f"], z["f"] * cfg["n_shared_experts"]
            out += [lin(f"{b}/moe/router/w", d, cfg["router_experts"], g),
                    Leaf(f"{b}/moe/experts/w_gate", (z["e"], d, f), g, std=1 / math.sqrt(d)),
                    Leaf(f"{b}/moe/experts/w_up", (z["e"], d, f), g, std=1 / math.sqrt(d)),
                    Leaf(f"{b}/moe/experts/w_down", (z["e"], f, d), g, std=1 / math.sqrt(f)),
                    lin(f"{b}/moe/shared/w_gate/w", d, sf, g),
                    lin(f"{b}/moe/shared/w_up/w", d, sf, g),
                    lin(f"{b}/moe/shared/w_down/w", sf, d, g)]
    return out


def num_groups(cfg: dict) -> int:
    return cfg["num_layers"] + 2


def make_data(cfg: dict, num_samples: int, seed: int):
    """(inputs (N, S) int32, next-token labels (N, S) int32): one Markov
    chain over the vocabulary slice."""
    vocab, s = cfg["vocab_size"], cfg["seq_len"]
    rng = np.random.default_rng(seed)
    succ = np.random.default_rng(PROTO_SEED).integers(0, vocab, (vocab, 4))
    tokens = np.zeros((num_samples, s + 1), np.int32)
    tokens[:, 0] = rng.integers(0, vocab, num_samples)
    follow = rng.random((num_samples, s + 1)) < FOLLOW
    choice = rng.integers(0, 4, (num_samples, s + 1))
    rand_tok = rng.integers(0, vocab, (num_samples, s + 1))
    for t in range(1, s + 1):
        preferred = succ[tokens[:, t - 1], choice[:, t]]
        tokens[:, t] = np.where(follow[:, t], preferred, rand_tok[:, t])
    return tokens[:, :-1].copy(), tokens[:, 1:].copy()


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _mscale(scale: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(scale) + 1.0 if scale > 1 else 1.0


def rope_tables(cfg: dict, s: int, device):
    """YaRN's cos and sin (S, rope / 2), and the softmax scale."""
    rs, dim, theta = cfg["rope_scaling"], cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    freq = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)

    def corr(rotations):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    gamma = 1.0 - ramp
    inv_freq = freq / rs["factor"] * (1.0 - gamma) + freq * gamma
    ang = torch.arange(s, dtype=torch.float32)[:, None] * inv_freq[None]
    amp = _mscale(rs["factor"], rs["mscale"]) / _mscale(rs["factor"], rs["mscale_all_dim"])
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    scale = (cfg["qk_nope_head_dim"] + dim) ** -0.5 * m * m
    return (torch.cos(ang) * amp).to(device), (torch.sin(ang) * amp).to(device), scale


def _rotate(x, cos, sin):
    """x (B, S, heads, rope), rotated by halves; cos / sin (S, rope / 2)."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _mla(p, pre, cfg, x, tables):
    z = _dims(cfg)
    b, s, _ = x.shape
    h, nope, rope, vd, rank = z["h"], z["nope"], z["rope"], z["vd"], z["rank"]
    eps = cfg["rms_norm_eps"]
    cos, sin, scale = tables
    q = (x @ p[f"{pre}/wq/w"]).view(b, s, h, nope + rope)
    ckv = x @ p[f"{pre}/wkv_a/w"]
    c, k_rope = ckv[..., :rank], ckv[..., rank:]
    kv = (_rms(c, p[f"{pre}/kv_norm/scale"], eps) @ p[f"{pre}/wkv_b/w"]).view(b, s, h, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_nope, q_rope = q[..., :nope], _rotate(q[..., nope:], cos, sin)
    k_rope = _rotate(k_rope[:, :, None, :], cos, sin)[:, :, 0]
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btd->bhst", q_rope, k_rope)) * scale
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, NEG)
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)
    return out.reshape(b, s, h * vd) @ p[f"{pre}/wo/w"]


def _swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def _moe(p, pre, cfg, x):
    """(B, S, d) -> (this share's routed part + the shared experts, the
    balance loss)."""
    b, s, d = x.shape
    k, e_all = cfg["num_experts_per_tok"], cfg["router_experts"]
    first, held = cfg["first_expert"], cfg["n_routed_experts"]
    xf = x.reshape(b * s, d)
    scores = torch.softmax(xf @ p[f"{pre}/router/w"], dim=-1)              # (T, 64)
    weight, idx = torch.topk(scores, k, dim=-1)
    flat = idx.reshape(-1)
    rep = xf.repeat_interleave(k, dim=0)                                    # (T*k, d)
    y = torch.zeros_like(rep)
    ex = f"{pre}/experts"
    for i in range(held):
        m = flat == first + i
        y[m] = _swiglu(rep[m], p[f"{ex}/w_gate"][i], p[f"{ex}/w_up"][i], p[f"{ex}/w_down"][i])
    routed = (y.view(b * s, k, d) * weight[..., None]).sum(dim=1)
    sh = f"{pre}/shared"
    shared = _swiglu(xf, p[f"{sh}/w_gate/w"], p[f"{sh}/w_up/w"], p[f"{sh}/w_down/w"])
    ce = torch.zeros(b, e_all, device=x.device).scatter_add_(
        1, idx.view(b, s * k), torch.ones(b, s * k, device=x.device)) / (s * k / e_all)
    aux = (ce * scores.view(b, s, e_all).mean(dim=1)).sum(dim=1).mean() * cfg["aux_loss_alpha"]
    return (routed + shared).view(b, s, d), aux


def logits(p: dict, cfg: dict, tokens: torch.Tensor):
    """(B, S) tokens -> ((B, S, V) logits, the summed balance losses)."""
    z = _dims(cfg)
    eps = cfg["rms_norm_eps"]
    x = p["embed/table"][tokens.long()]
    tables = rope_tables(cfg, tokens.shape[1], x.device)
    aux = torch.zeros((), device=x.device)
    for i in range(z["layers"]):
        pre = f"layers/{i}"
        x = x + _mla(p, f"{pre}/attn", cfg, _rms(x, p[f"{pre}/attn_norm/scale"], eps), tables)
        hn = _rms(x, p[f"{pre}/mlp_norm/scale"], eps)
        if i < z["dense"]:
            m = f"{pre}/mlp"
            x = x + _swiglu(hn, p[f"{m}/w_gate/w"], p[f"{m}/w_up/w"], p[f"{m}/w_down/w"])
        else:
            y, a = _moe(p, f"{pre}/moe", cfg, hn)
            x, aux = x + y, aux + a
    return _rms(x, p["final_norm/scale"], eps) @ p["head/w"], aux


def loss(p: dict, cfg: dict, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy plus the balance losses."""
    out, aux = logits(p, cfg, tokens)
    return F.cross_entropy(out.reshape(-1, out.shape[-1]), labels.reshape(-1).long()) + aux
