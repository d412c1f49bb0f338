"""prefill_ms_per_ktok.<cells> (``.chat``, ``.docs``; the manifest finds
this file for each): the time the prefilling steps of the window's
untraced part took beyond a decode-only step (their wall less the median
decode-only wall), per 1,000 prompt tokens prefilled. Layer: the model
step."""
import statistics


def read(run):
    steps = run.clean_steps()
    dec = [s.t1 - s.t0 for s in steps if s.decode and not s.prefill]
    pre = [s for s in steps if s.prefill]
    base = statistics.median(dec) if dec else 0.0
    toks = sum(sum(s.prefill) for s in pre)
    if not toks:
        return None
    return sum(s.t1 - s.t0 - base for s in pre) * 1e3 / (toks / 1e3)
