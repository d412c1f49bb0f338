"""mfu.docs: the model FLOPs of everything the window's untraced part
completed (each prompt prefilled in it, each decode of a row in it) over
its length and the card's bf16 peak. Layer: the whole step."""
from pbench.work import PEAK_BF16_FLOPS, forward_flops


def read(run):
    flops = 0.0
    for s in run.clean_steps():
        flops += sum(forward_flops(run.model, n) for n in s.prefill)
        flops += sum(forward_flops(run.model, 1, ctx) for ctx in s.decode)
    return flops / (run.t_clean - run.w0) / PEAK_BF16_FLOPS * 100 if flops else None
