"""The whole round's share of the card's float32 peak: the operations the
window's rounds require (every client's forward and required backward on
every batch, counted from shapes and each round's trained group by the
configuration's ``counts.py``; the eval forward too; no recomputation) over
the traced window times the peak."""


def read(run):
    if run.trace is None or run.peaks is None or not run.rounds:
        return None
    t = run.traffic
    per_round_train = t.clients * t.steps_per_client * min(t.batch_size, t.samples_per_client)
    flops = 0.0
    for index, group in run.rounds:
        flops += per_round_train * run.train_flops_per_sample(group)
        if index % t.eval_every == 0:
            flops += t.eval_samples * run.eval_flops_per_sample()
    return 100.0 * flops / (run.trace.window_s * run.peaks["f32_flops"])
