"""Serving core: requests, KV pools, the scheduler, speculation, the
online controller, the flight recorder and the engine."""
from repro_torch.serve.block import BlockAllocator, PrefixCache  # noqa: F401
from repro_torch.serve.controller import (  # noqa: F401
    Decision,
    OnlineAdviser,
    PinnedController,
)
from repro_torch.serve.engine import ServingEngine  # noqa: F401
from repro_torch.serve.kv_cache import PagedKVCache, SlotKVCache  # noqa: F401
from repro_torch.serve.load import (  # noqa: F401
    make_drift_requests,
    make_requests,
    make_shared_prefix_requests,
    make_slo_requests,
)
from repro_torch.serve.request import Request, ServeStats  # noqa: F401
from repro_torch.serve.scheduler import Scheduler  # noqa: F401
from repro_torch.serve.speculative import (  # noqa: F401
    DraftSource,
    ModelDraftSource,
    NGramDraftSource,
    SpecConfig,
    advise_depth,
)
from repro_torch.serve.telemetry import (  # noqa: F401
    MetricsRegistry,
    Telemetry,
    Tracer,
    configure,
    get_telemetry,
    validate_chrome_trace,
)
