"""repro_torch.serve: the paged-KV serving engine with continuous batching,
and the dense static-batch baseline (``DenseServer``, ``dense_generate``)."""
from ..configs.serve import ServeConfig
from .engine import DenseServer, Engine, StreamEvent, dense_generate
from .kv_pages import PagePool, admit_prefill, grow_dense_caches
from .sampler import SamplingParams, sample_tokens
from .scheduler import Request, Scheduler, StepPlan

__all__ = ["Engine", "DenseServer", "StreamEvent", "ServeConfig",
           "SamplingParams", "sample_tokens", "PagePool", "admit_prefill",
           "grow_dense_caches", "Request", "Scheduler", "StepPlan",
           "dense_generate"]
