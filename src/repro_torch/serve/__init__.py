"""Serving: the continuous-batching :class:`SimdramServer` over
bank-sharded machine pools (:mod:`repro_torch.serve.server`) and the
in-DRAM greedy sampler (:mod:`repro_torch.serve.decode`)."""
from .batching import (ContinuousBatcher, DecodeSession, RequestProfile,
                       percentile, profile_for)
from .server import ServingStats, SessionHandle, SimdramServer

__all__ = ["ContinuousBatcher", "DecodeSession", "RequestProfile",
           "percentile", "profile_for", "ServingStats", "SessionHandle",
           "SimdramServer"]
