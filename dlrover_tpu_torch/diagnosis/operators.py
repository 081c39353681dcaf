"""Check and resolve operators of the worker-failure diagnosis: the failure
half of ``dlrover_tpu/diagnosis/operators.py``.

The check operator attributes a failed worker's log tail to a cause class,
the resolve operator turns the class into restart or relaunch. The three
classes and their decisions are the JAX module's; its TPU-worded patterns
have CUDA counterparts here, and its patterns that name no device are kept
as they are. The training-hang operators wait for the hang detector's
slice.
"""

import re
from typing import List

from ..master.diagnosis.action import DiagnosisActionType
from .inference_chain import Inference, InferenceAttribution, InferenceName, InferenceOperator

# The host or its GPU is the problem: retrying on it cannot help, so the
# master is asked to replace the node.
NODE_FATAL_PATTERNS = [
    r"device or resource busy",
    # ≙ "failed to initialize tpu" and "tpu platform.*not found"
    r"no cuda gpus are available",
    r"cuda driver initialization failed",
    r"cuda error: initialization error",
    r"found no nvidia driver",
    # ≙ "pjrt.*internal": the driver reports the device lost
    r"gpu has fallen off the bus",
    r"\bxid\b",
    r"uncorrectable ecc",
    r"sigbus",
]

# Device memory exhausted: a restart can help (fragmentation); repeated
# ones mean the configuration does not fit.
OOM_PATTERNS = [
    r"out of memory",
    r"resource_exhausted",
    r"cuda out of memory",  # ≙ "exceeded hbm capacity"
    r"oom-?kill",
]

# A re-rendezvous on the same host usually cures these.
RETRYABLE_PATTERNS = [
    r"rendezvousoutsyncerror",
    r"coordination service.*unavailable",
    r"deadline exceeded",
    r"connection refused",
    r"barrier timed out",
]


def _match_any(patterns: List[str], text: str):
    for pat in patterns:
        if re.search(pat, text):
            return pat
    return None


class CheckFailureNodeOperator(InferenceOperator):
    """worker_failure (with its log) → attributed cause."""

    def is_compatible(self, inferences) -> bool:
        return any(i.name == InferenceName.WORKER_FAILURE
                   and i.attribution == InferenceAttribution.UNKNOWN for i in inferences)

    def infer(self, inferences):
        out = []
        for inf in inferences:
            if (inf.name != InferenceName.WORKER_FAILURE
                    or inf.attribution != InferenceAttribution.UNKNOWN):
                out.append(inf)
                continue
            log = (inf.data.get("log_tail") or "").lower()
            if pat := _match_any(NODE_FATAL_PATTERNS, log):
                attribution = InferenceAttribution.NODE_FATAL
            elif pat := _match_any(OOM_PATTERNS, log):
                attribution = InferenceAttribution.OOM
            elif pat := _match_any(RETRYABLE_PATTERNS, log):
                attribution = InferenceAttribution.RETRYABLE
            else:
                attribution = InferenceAttribution.UNKNOWN
            restart_count = int(inf.data.get("restart_count", 0))
            max_restarts = int(inf.data.get("max_restarts", 3))
            if (attribution in (InferenceAttribution.RETRYABLE, InferenceAttribution.UNKNOWN)
                    and restart_count >= max_restarts):
                attribution = InferenceAttribution.BUDGET_EXHAUSTED
            out.append(Inference(name=InferenceName.WORKER_FAILURE, attribution=attribution,
                                 description=f"matched {pat!r}" if pat else "no known pattern",
                                 data=dict(inf.data)))
        return out


class ResolveFailureNodeOperator(InferenceOperator):
    """Attributed failure → restart or relaunch."""

    _DECISION = {
        InferenceAttribution.NODE_FATAL: DiagnosisActionType.RELAUNCH_WORKER,
        InferenceAttribution.BUDGET_EXHAUSTED: DiagnosisActionType.RELAUNCH_WORKER,
        InferenceAttribution.OOM: DiagnosisActionType.RESTART_WORKER,
        InferenceAttribution.RETRYABLE: DiagnosisActionType.RESTART_WORKER,
        # unknown with budget left: a restart on the same host is cheap
        InferenceAttribution.UNKNOWN: DiagnosisActionType.RESTART_WORKER,
    }

    def is_compatible(self, inferences) -> bool:
        return (any(i.name == InferenceName.WORKER_FAILURE for i in inferences)
                and not any(i.name == InferenceName.RESOLVED_ACTION for i in inferences))

    def infer(self, inferences):
        out = list(inferences)
        for inf in inferences:
            if inf.name != InferenceName.WORKER_FAILURE:
                continue
            if inf.attribution == InferenceAttribution.UNKNOWN and not inf.data:
                continue  # unchecked fact: the check operator runs first
            action = self._DECISION.get(inf.attribution, DiagnosisActionType.RESTART_WORKER)
            out.append(Inference(name=InferenceName.RESOLVED_ACTION,
                                 attribution=inf.attribution, description=inf.description,
                                 data={"action_type": action}))
        return out
