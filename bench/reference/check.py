"""The comparison that decides ``correct`` for a served model.

For every served token of the checked requests: how far its logit lies
below the reference's best logit at that position (0 where the program
served the reference's own first choice). The number compared is the
widest such gap. The control reads the same quantity for the token that
the lower-precision reference puts first at each position.
"""
from __future__ import annotations

import importlib

import torch


def reference_for(family: str):
    """The reference module of a model family (``reference/<family>.py``)."""
    return importlib.import_module(f"reference.{family}")


def sequences(served, device):
    """(tokens, first scored position) of each (prompt, served tokens):
    the prompt and every served token but the last, scored from the
    prompt's last position on."""
    out = []
    for prompt, toks in served:
        seq = torch.as_tensor(list(prompt) + list(toks[:-1]), dtype=torch.long, device=device)
        out.append((seq, len(prompt) - 1))
    return out


def gaps(logits, tokens) -> torch.Tensor:
    """logits [n, V] float32 and tokens [n] → the gap of each token below
    the row's best (infinite for a token outside the vocabulary)."""
    V = logits.shape[-1]
    t = torch.as_tensor(tokens, dtype=torch.long, device=logits.device)
    inside = t < V
    got = torch.gather(logits, -1, t.clamp(max=V - 1)[:, None])[:, 0]
    g = logits.max(-1).values - got
    return torch.where(inside, g, torch.full_like(g, float("inf")))


def widest_gap(params, m: dict, served, *, quant=None) -> dict:
    """The program's widest gap over ``served`` (a list of (prompt, served
    tokens)), and with ``quant`` the control's: the gap of the token the
    lower precision puts first."""
    ref = reference_for(m["family"])
    seqs = sequences(served, params["embed"].device)
    exact = ref.forward_logits(params, m, seqs)
    g = torch.cat([gaps(lg, toks) for lg, (_, toks) in zip(exact, served)])
    out = {"tokens": int(g.numel()), "max_logit_gap": float(g.max()),
           "mean_logit_gap": float(g.mean())}
    if quant is not None:
        low = ref.forward_logits(params, m, seqs, quant=quant)
        c = torch.cat([gaps(lg, lo.argmax(-1)) for lg, lo in zip(exact, low)])
        out["control_max_logit_gap"] = float(c.max())
        out["control_mean_logit_gap"] = float(c.mean())
    return out
