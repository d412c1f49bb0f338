"""decode_step_ms.chat: the median host-clock time of the steps of the
window's untraced part that only decoded (no prefill in them), each ending
in the program's own device synchronise. Layer: the model step."""
import statistics


def read(run):
    xs = [s.t1 - s.t0 for s in run.clean_steps() if s.decode and not s.prefill]
    return statistics.median(xs) * 1e3 if xs else None
