"""Batched serving example: prefill + greedy decode on any assigned
architecture at smoke scale (port of ``examples/serve_llm.py``).  Every
GQA prefill attention goes through the flash-attention CUDA kernel and
every Mamba2 / mLSTM prefill scan through the SSD-chunk kernel; MLA
(``deepseek-v3-671b``) stays plain.  ``run(impl="plain")`` serves the same
weights through plain PyTorch, the kernels' yardstick.

    python -m repro_torch.examples.serve_llm --arch tinyllama-1.1b      # one H100
    python -m repro_torch.examples.serve_llm --arch xlstm-125m --device cpu   # SSM
    python -m repro_torch.examples.serve_llm --arch deepseek-v3-671b --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.launch.serve import ServeResult, serve_session
from repro_torch.models import transformer


def kernel_launches(cfg) -> tuple[int, int]:
    """``(flash, ssd)`` launches one ``impl="kernel"`` prefill of ``cfg``
    makes: one flash launch per GQA attention (whisper: encoder, decoder
    and cross attention in every layer; Zamba2: each shared-attention
    application; none for MLA or the xLSTM), one SSD launch per Mamba2
    layer and two per mLSTM layer (values and normaliser)."""
    if cfg.kind == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers, 0
    if cfg.kind == "hybrid":
        chunks, tail = transformer.hybrid_layout(cfg)
        return chunks, chunks * cfg.attn_every + tail
    if cfg.kind == "xlstm":
        return 0, 2 * (cfg.num_layers // 2)
    return (0 if cfg.use_mla else cfg.num_layers), 0


def run(*, arch: str = "tinyllama-1.1b", batch: int = 4, prompt_len: int = 32,
        gen: int = 12, device: str = "cuda", impl: str = "kernel", params=None,
        verbose: bool = True) -> ServeResult:
    """``serve_session`` on ``arch``'s smoke config; prints the token grid."""
    cfg = get_config(arch, smoke=True)
    out = serve_session(cfg, batch, prompt_len, gen, device=device, impl=impl,
                        params=params, verbose=verbose)
    if verbose:
        print(f"[serve_llm] {arch}: generated token grid {tuple(out.tokens.shape)}")
        print(out.tokens)
    return out


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(arch=args.arch, batch=args.batch, prompt_len=args.prompt_len,
               gen=args.gen, device=args.device)


if __name__ == "__main__":
    main()
