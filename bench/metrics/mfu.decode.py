"""mfu.decode: the model FLOPs of the decode-only steps of the window's
untraced part (2 a weight a token for the live rows, top-k experts only,
plus attention over each row's context) over their host-clock time and the
card's bf16 peak. Layer: the whole step."""
from pbench.work import PEAK_BF16_FLOPS, forward_flops


def read(run):
    steps = [s for s in run.clean_steps() if s.decode and not s.prefill]
    if not steps:
        return None
    flops = sum(forward_flops(run.model, 1, ctx) for s in steps for ctx in s.decode)
    return flops / sum(s.t1 - s.t0 for s in steps) / PEAK_BF16_FLOPS * 100
