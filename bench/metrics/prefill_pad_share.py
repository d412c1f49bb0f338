"""prefill_pad_share.<cells> (``.itl``, ``.docs``; the manifest finds this
file for each): the share of the prompt positions the program's prefills
computed that were pads, over the requests whose first token came in the
window's untraced part: their ``Request.prefill_pad`` over it plus their
``Request.prefill_tokens``, the program's own counts (a dense family runs a
prompt at its power-of-two width). A program that keeps no such counts
reads nothing. Layer: the model step."""


def read(run):
    pad = real = 0
    for p in run.requests:
        h = p.handle
        if h is None or not p.stamps or not run.w0 <= p.stamps[0] < run.t_clean:
            continue
        if not hasattr(h, "prefill_pad"):
            return None
        pad += h.prefill_pad
        real += h.prefill_tokens
    return pad / (pad + real) * 100 if pad + real else None
