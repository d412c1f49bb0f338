"""D. Social Media Feed Generation (paper §VI.D).

Port of the JAX package's ``bench_suite/timeline.py``. Social-graph
traversal: collect candidate posts from followed accounts, score by
engagement × temporal decay, keep top-8 per account. 1000 accounts,
64–192 follows, 16–80 posts each, 5–25 reactions.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.bench_suite.common import Benchmark, gather, register, to_device

N_ACCOUNTS = 1000
MAX_FOLLOW = 192
MAX_POSTS = 80
TOP_POSTS = 8


def build(seed=3, device=None):
    rng = np.random.default_rng(seed)
    n_follow = rng.integers(64, 193)
    follows = rng.choice(N_ACCOUNTS, size=MAX_FOLLOW, replace=True).astype(np.int32)
    follow_mask = (np.arange(MAX_FOLLOW) < n_follow).astype(np.float32)
    n_posts = rng.integers(16, 81, N_ACCOUNTS)
    ts = rng.uniform(0, 24.0, (N_ACCOUNTS, MAX_POSTS)).astype(np.float32)
    reactions = rng.integers(5, 26, (N_ACCOUNTS, MAX_POSTS)).astype(np.float32)
    post_mask = (np.arange(MAX_POSTS)[None, :] < n_posts[:, None]).astype(np.float32)
    return to_device({"follows": follows, "follow_mask": follow_mask, "ts": ts,
                      "reactions": reactions, "post_mask": post_mask}, device)


def item_fn(data):
    ts, reactions, post_mask = data["ts"], data["reactions"], data["post_mask"]

    def fn(args):
        acct, fmask = args
        t = gather(ts, acct)
        score = gather(reactions, acct) * torch.exp(-0.15 * (24.0 - t)) * gather(post_mask, acct)
        top = torch.topk(score, TOP_POSTS).values
        return fmask * top.sum()

    return fn


def items(data):
    return (data["follows"], data["follow_mask"])


def cost(data):
    # per followed account: 80-post gather + exp/score + top-k
    return dict(
        flops=MAX_POSTS * 8.0 + MAX_POSTS * np.log2(MAX_POSTS),
        bytes=MAX_POSTS * 12.0 + 64.0,
        chain=2,
        vector=True,
    )


register(
    Benchmark(
        name="Timeline",
        domain="social media",
        build=build,
        items=items,
        item_fn=item_fn,
        cost=cost,
    )
)
