"""Serving driver: batched prefill, then greedy decode (port of
``repro.launch.serve``).

Runs on the card unless asked for the CPU.  With ``impl="kernel"`` every
GQA prefill attention goes through the CUDA flash-attention kernel (MLA,
``deepseek-v3-671b``, is plain PyTorch, as in the reference), and every
Mamba2 prefill scan (``zamba2-7b``) and both scans of every mLSTM layer
(``xlstm-125m``: values and normaliser) through the CUDA SSD-chunk kernel;
the sLSTM's loop over time and one-token decode are plain PyTorch, as in
the reference.  A hybrid's or an xLSTM's prompt length must be a multiple
of its scan chunk (``ssm_chunk``) or shorter than it, as the reference
asserts.

    python -m repro_torch.launch.serve --arch tinyllama-1.1b --device cpu   # smoke size
    python -m repro_torch.launch.serve --arch gemma-2b --device cpu
    python -m repro_torch.launch.serve --arch llama3.2-1b --device cpu
    python -m repro_torch.launch.serve --arch glm4-9b --device cpu
    python -m repro_torch.launch.serve --arch zamba2-7b --device cpu
    python -m repro_torch.launch.serve --arch xlstm-125m --device cpu
    python -m repro_torch.launch.serve --arch llama4-maverick-400b-a17b --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v3-671b --device cpu
    python -m repro_torch.launch.serve --arch zamba2-7b --full \\
        --batch 4 --prompt-len 4096 --gen 32          # one H100
    python -m repro_torch.launch.serve --arch gemma-2b --full \\
        --batch 4 --prompt-len 4096 --gen 32          # one H100 (head dim 256)
    python -m repro_torch.launch.serve --arch xlstm-125m --full \\
        --batch 4 --prompt-len 4096 --gen 32          # one H100 (N = P = 192)
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.models.api import InputShape
from repro_torch.tree import PyTree, tree_map_with_path


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, gen) int32 greedy tokens
    logits: list[torch.Tensor]    # gen entries of (B, 1, V) f32: prefill's, then each decode step's
    prefill_seconds: float        # prefill + cache growth, ended by a device sync
    decode_seconds: float         # the gen - 1 decode steps, ended by a device sync


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_session(cfg, batch: int, prompt_len: int, gen: int, seed: int = 0, *,
                  device: str | torch.device = "cuda", impl: str = "kernel",
                  params: PyTree | None = None, prompt: dict | None = None,
                  verbose: bool = True) -> ServeResult:
    """Prefill a prompt batch, then greedy-decode ``gen`` tokens.

    Without ``params`` / ``prompt`` both are drawn from one generator seeded
    with ``seed`` on ``device`` (params first); tests pass the reference's
    instead, bridged onto ``device``.
    """
    dev = resolve_device(device)
    rng = torch.Generator(device=dev).manual_seed(seed)
    if params is None:
        params = api.init(rng, cfg, dev)
    if prompt is None:
        shape = InputShape("serve", prompt_len, batch, "prefill")
        prompt = api.synth_batch(rng, cfg, shape, dev)

    cache_len = prompt_len + gen
    prefill = steps.make_prefill_step(cfg, impl=impl)
    serve = steps.make_serve_step(cfg)

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = prefill(params, prompt)
        cache = _grow_attention_caches(cache, prompt_len, cache_len)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)

        toks, step_logits = [tok], [logits]
        t1 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = serve(params, tok, cache, prompt_len + i)
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
            toks.append(tok)
            step_logits.append(logits)
        _sync(dev)
        decode_s = time.perf_counter() - t1
    out = torch.cat(toks, dim=1)
    if verbose:
        print(f"[serve] prefill {batch}x{prompt_len} in {prefill_s:.2f}s | "
              f"decode {gen} tokens in {decode_s:.2f}s "
              f"({batch * gen / max(decode_s, 1e-9):.1f} tok/s)")
    return ServeResult(out, step_logits, prefill_s, decode_s)


# The reference also grows the encoder-decoder's ("self_k", "self_v")
# caches; that model is not ported yet (ROADMAP Queue 1 item 15.3).
_ATTN_CACHE_KEYS = {"k", "v", "c_kv", "k_rope"}


def _grow_attention_caches(cache: PyTree, prompt_len: int, cache_len: int) -> PyTree:
    """Pad attention caches (stacked (L,B,S,...) layout, seq axis 2: the
    decoder's ``blocks/{k,v}`` and ``moe_blocks/{k,v}``, MLA's latent
    ``{blocks,moe_blocks}/{c_kv,k_rope}``, the hybrid's
    ``chunks/attn_kv/{k,v}``) from the prefill length to prompt+gen with
    zeros.  Other leaves (the Mamba2
    ``state`` and ``conv``, the mLSTM states, the sLSTM's ``(c, n, h, m)``)
    are untouched."""

    def grow(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if name in _ATTN_CACHE_KEYS and leaf.dim() >= 4 and leaf.shape[2] == prompt_len:
            # F.pad lists (before, after) pairs from the last axis backwards
            pad = [0, 0] * (leaf.dim() - 3) + [0, cache_len - prompt_len]
            return F.pad(leaf, pad)
        return leaf

    return tree_map_with_path(grow, cache)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="use the full-size config (one H100; not for the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--impl", default="kernel", choices=("kernel", "plain"),
                    help="prefill attention and Mamba2 / mLSTM scans: the CUDA "
                         "kernels or plain PyTorch")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=not args.full)
    serve_session(cfg, args.batch, args.prompt_len, args.gen, device=args.device,
                  impl=args.impl)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
