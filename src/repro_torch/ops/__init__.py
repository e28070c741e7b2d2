"""Public bbop API — the SIMDRAM ISA surface (paper Table 1) plus the
plane-resident pipeline / backend-selection layer, the session-scoped
:class:`~repro_torch.simdram.machine.SimdramMachine` end-to-end API, and the
bank-level scheduling surface (``machine.submit()`` futures +
:class:`~repro_torch.simdram.scheduler.BankScheduler`)."""
from ..core.backends import (PerfStats, execute_heterogeneous,
                             execute_program, list_backends,
                             register_backend, set_default_backend,
                             timed, use_backend)
from ..core.circuits import list_operations, register_operation
from ..simdram.layout import BitplaneArray
from ..simdram.machine import (SimdramFuture, SimdramMachine,
                               current_machine, default_machine)
from ..simdram.scheduler import BankScheduler, RequestTiming, ScheduleResult
from .bbops import (bbop_abs, bbop_add, bbop_and, bbop_bitcount, bbop_div,
                    bbop_equal, bbop_greater, bbop_greater_equal,
                    bbop_if_else, bbop_max, bbop_min, bbop_mul, bbop_or,
                    bbop_relu, bbop_sub, bbop_xor, compile_bbop,
                    planes_of, simdram_pipeline, values_of)

# Static so ruff sees the imports above as intentional re-exports (F401)
__all__ = [
    "bbop_abs", "bbop_add", "bbop_and", "bbop_bitcount", "bbop_div",
    "bbop_equal", "bbop_greater", "bbop_greater_equal", "bbop_if_else",
    "bbop_max", "bbop_min", "bbop_mul", "bbop_or", "bbop_relu", "bbop_sub",
    "bbop_xor",
    "compile_bbop", "planes_of", "values_of", "BitplaneArray",
    "simdram_pipeline", "use_backend", "set_default_backend",
    "register_backend", "list_backends", "execute_program",
    "execute_heterogeneous", "PerfStats", "timed", "SimdramMachine",
    "SimdramFuture", "BankScheduler", "ScheduleResult",
    "RequestTiming", "default_machine", "current_machine",
    "register_operation", "list_operations",
]
