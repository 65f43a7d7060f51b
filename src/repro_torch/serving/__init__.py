"""Request-level serving stack of the port: ``LLMEngine`` over the four
chunked styles and the legacy phase-based path, with fault handling and the
write-ahead journal (see ``repro_torch.serving.engine``), and the
multi-model ``ServingGateway`` over a ``ModelRegistry``
(``repro_torch.serving.gateway`` / ``repro_torch.serving.model_registry``)."""
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_EOS,
                                     FINISH_ERROR, FINISH_EVICTED,
                                     FINISH_LENGTH, FINISH_PREEMPTED,
                                     FINISH_REJECTED, FINISH_SHED,
                                     FINISH_TIMEOUT, Request, RequestOutput,
                                     SamplingParams)
from repro_torch.serving.core import EngineCore, StepOutput
from repro_torch.serving.engine import EngineStats, LLMEngine, plan_cfg
from repro_torch.serving.gateway import (BudgetExceeded, GatewayHTTPServer,
                                         GatewayRejection, GatewayStats,
                                         ModelInFlight, ServingGateway)
from repro_torch.serving.health import (DEAD, DEGRADED, HEALTHY,
                                        CircuitBreaker, HealthPolicy,
                                        ReplicaHealth)
from repro_torch.serving.journal import (JournalEntry, RequestJournal,
                                         body_fingerprint, key_after)
from repro_torch.serving.kvcache import PagedKVCache, pages_for
from repro_torch.serving.model_registry import (ModelEntry, ModelRegistry,
                                                VariantSet, alpha_bank_bytes,
                                                alpha_crc_ledger,
                                                arch_signature,
                                                dense_fp32_bytes,
                                                make_alpha_variant,
                                                param_bytes, stack_variants)
from repro_torch.serving.scheduler import (ChunkTask, FCFSScheduler,
                                           PackedStep, PrefillAssignment,
                                           PrefillGroup, SchedulerOutput,
                                           bucket_for, bucket_lengths,
                                           legacy_schedule, pack_bucket,
                                           pack_step, unpack_step)

__all__ = [
    "SamplingParams", "Request", "RequestOutput",
    "FINISH_LENGTH", "FINISH_EOS", "FINISH_REJECTED",
    "FINISH_TIMEOUT", "FINISH_SHED", "FINISH_ERROR", "FINISH_PREEMPTED",
    "FINISH_EVICTED", "FINISH_CANCELLED",
    "FCFSScheduler", "ChunkTask", "SchedulerOutput", "StepOutput",
    "PackedStep", "pack_bucket", "pack_step", "unpack_step", "PrefillGroup",
    "PrefillAssignment", "bucket_lengths", "bucket_for", "legacy_schedule",
    "EngineCore", "LLMEngine", "EngineStats", "plan_cfg",
    "ServingGateway", "GatewayStats", "GatewayHTTPServer",
    "GatewayRejection", "BudgetExceeded", "ModelInFlight",
    "HEALTHY", "DEGRADED", "DEAD",
    "HealthPolicy", "ReplicaHealth", "CircuitBreaker",
    "ModelRegistry", "ModelEntry", "VariantSet", "stack_variants",
    "alpha_bank_bytes", "param_bytes", "dense_fp32_bytes",
    "alpha_crc_ledger", "arch_signature", "make_alpha_variant",
    "PagedKVCache", "pages_for",
    "RequestJournal", "JournalEntry", "key_after", "body_fingerprint",
]
