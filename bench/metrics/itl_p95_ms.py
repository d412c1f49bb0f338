"""itl_p95_ms: the 95th percentile over every gap between consecutive
output tokens that closed in the window, each token stamped at the end of
the step that produced it, and the gaps still open at the window's end.
Host clock."""
from pbench.stats import itl_samples, percentile


def read(run):
    xs = itl_samples(run.requests, run.w0, run.w1)
    return percentile(xs, 95) * 1e3 if xs else None
