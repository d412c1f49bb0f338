"""The paper's 10 latency-critical benchmarks (§VI) in PyTorch, plus the
granularity-sweep kernels of Figs. 1–2 (pfl, cc) and the Figs. 3–4
runner (fig34)."""
from repro_torch.bench_suite.common import BENCHMARKS, Benchmark, register  # noqa: F401
from repro_torch.bench_suite import (  # noqa: F401,E402
    geospatial,
    vwap,
    lidar,
    timeline,
    rf,
    onehop,
    lob,
    geoip,
    fraud,
    bvh,
)
