"""ttft_p95_ms: the 95th percentile of time to first token over every
request due in the window, from its due time on the open-loop schedule to
the end of the step that produced its first token; a request with none by
the window's end counts its wait so far. Host clock."""
from pbench.stats import percentile, ttft_samples


def read(run):
    xs = ttft_samples(run.requests, run.w0, run.w1)
    return percentile(xs, 95) * 1e3 if xs else None
