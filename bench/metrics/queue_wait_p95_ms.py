"""queue_wait_p95_ms: the 95th percentile of the program's own queue wait
(``Request.queue_wait_ms``: due time to first admission, on the
scheduler's clock, which the harness sets to its own) over the requests
due in the window's untraced part that were admitted. Layer: the scheduler."""
from pbench.stats import percentile


def read(run):
    xs = [p.handle.queue_wait_ms for p in run.requests
          if run.w0 <= p.due < run.t_clean and p.handle is not None
          and p.handle.queue_wait_ms is not None]
    return percentile(xs, 95) if xs else None
