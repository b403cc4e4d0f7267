"""The grouped expert products' share of their roofline: the sum over the
window's launches of each launch's least time (its operations at the
card's float32 peak, or its bytes at the memory bandwidth if longer; the
configuration's ``counts.grouped_launch``) over the kernels' device time in
the trace, forward, input-gradient and weight-gradient launches alike.

A launch's rows are the held experts' expected entries, k × held ÷ experts
a token (``counts.py``, as ``mfu_pct`` counts them), over the step's
tokens: every client's batch in a training launch, the eval set in an
eval launch (the forward's 3 products per MoE layer, every eval round).
Every grouped product of the layer has the same operations (2 × rows ×
2,048 × 1,408) and bytes, whichever way round, the backward's recomputed
gate and up products included (work the kernel does).  ``None`` where the
trace holds no grouped launch."""

FWD, WGRAD = "grouped_mm_kernel", "grouped_wgrad_kernel"   # csrc/grouped_mm.cu
PRODUCTS = 3          # gate, up, down: the forward's grouped launches per MoE layer


def read(run):
    if run.trace is None or run.peaks is None or not run.rounds:
        return None
    n_fwd, s_fwd = run.trace.kernels(FWD)
    n_wgrad, s_wgrad = run.trace.kernels(WGRAD)
    if n_fwd + n_wgrad == 0 or s_fwd + s_wgrad <= 0:
        return None
    cfg, t = run.cell.config, run.traffic
    moe_layers = cfg["num_layers"] - cfg["first_k_dense_replace"]
    per_token = cfg["num_experts_per_tok"] * cfg["n_routed_experts"] / cfg["router_experts"]
    d, f, held = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    evals = sum(1 for i, _ in run.rounds if i % t.eval_every == 0) * moe_layers * PRODUCTS
    train_rows = t.clients * t.batch_size * cfg["seq_len"] * per_token
    eval_rows = t.eval_samples * cfg["seq_len"] * per_token

    def least(kind, rows, clients):
        flops, nbytes = run.cell.counts.grouped_launch(kind, rows, d, f, clients * held)
        return max(flops / run.peaks["f32_flops"], nbytes / run.peaks["hbm_bytes_per_s"])

    total = (evals * least("fwd", eval_rows, 1)
             + (n_fwd - evals) * least("fwd", train_rows, t.clients)
             + n_wgrad * least("wgrad", train_rows, t.clients))
    return 100.0 * total / (s_fwd + s_wgrad)
