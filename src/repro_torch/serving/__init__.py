"""Serving engine of the port: slot KV cache, continuous batching,
two-pool server."""

from repro_torch.serving.engine import Completion, ServeRequest, ServingEngine
from repro_torch.serving.kv_cache import SlotAllocator, SlotKVCache, bucket_length
from repro_torch.serving.pool_server import ServedResponse, TwoPoolServer
from repro_torch.serving.sampler import SamplingParams, sample

__all__ = [
    "Completion",
    "ServeRequest",
    "ServingEngine",
    "SlotAllocator",
    "SlotKVCache",
    "bucket_length",
    "ServedResponse",
    "TwoPoolServer",
    "SamplingParams",
    "sample",
]
