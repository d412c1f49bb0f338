"""batch_tokens_per_s: prompt tokens whose prefill ended in the window
plus output tokens stamped in it, over the window's length. Host clock."""


def read(run):
    n = 0
    for p in run.requests:
        for i, t in enumerate(p.stamps):
            if run.w0 <= t < run.w1:
                n += 1 + (p.prompt_len if i == 0 else 0)
    return n / (run.w1 - run.w0)
