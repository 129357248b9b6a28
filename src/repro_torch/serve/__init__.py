"""repro_torch.serve: the paged-KV serving engine with continuous batching."""
from ..configs.serve import ServeConfig
from .engine import Engine, StreamEvent
from .kv_pages import PagePool, admit_prefill
from .sampler import SamplingParams, sample_tokens
from .scheduler import Request, Scheduler, StepPlan

__all__ = ["Engine", "StreamEvent", "ServeConfig", "SamplingParams",
           "sample_tokens", "PagePool", "admit_prefill", "Request",
           "Scheduler", "StepPlan"]
