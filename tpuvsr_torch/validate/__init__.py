"""Trace validation (a port of ``tpuvsr/validate``).

Check recorded implementation traces (TRACE.jsonl) against the spec:
per step the next-state relation is constrained to transitions
consistent with the recorded event, partial observations tracked as
candidate-state sets.  ``host`` is the interpreter's reference engine,
``batch`` the engine on the card (kernel K16 and the model kernels).
"""

from .batch import (BatchValidator, ObservationUnsupported, batch_validate,
                    encode_obs, traces_digest, validate_result_summary)
from .host import (HostVerdict, ValidateResult, divergence_record,
                   host_validate_batch, validate_trace)
from .traces import (Trace, TraceEvent, load_traces, record_from_entries,
                     save_traces, trace_from_record, traces_from_records)

__all__ = [
    "BatchValidator", "ObservationUnsupported", "batch_validate",
    "encode_obs", "traces_digest", "validate_result_summary",
    "HostVerdict", "ValidateResult", "divergence_record",
    "host_validate_batch", "validate_trace",
    "Trace", "TraceEvent", "load_traces", "record_from_entries",
    "save_traces", "trace_from_record", "traces_from_records",
]
