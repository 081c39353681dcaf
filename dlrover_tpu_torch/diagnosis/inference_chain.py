"""Inference chain, symptoms → attributed causes → actions: the port of
``dlrover_tpu/diagnosis/inference_chain.py``.

An ``Inference`` is a (name, attribution, description, data) fact;
operators consume the facts they are compatible with and emit refined
ones; the chain runs until no operator advances the state, leaving the
resolved facts (carrying a ``DiagnosisActionType``) to act on.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List


class InferenceName:
    WORKER_FAILURE = "worker_failure"
    RESOLVED_ACTION = "resolved_action"


class InferenceAttribution:
    """Why (cause class) an observed symptom happened."""

    UNKNOWN = "unknown"
    NODE_FATAL = "node_fatal"  # the host or its GPU is the problem
    RETRYABLE = "retryable"  # a re-rendezvous on the same host cures it
    OOM = "oom"
    BUDGET_EXHAUSTED = "budget_exhausted"


@dataclass
class Inference:
    name: str
    attribution: str = InferenceAttribution.UNKNOWN
    description: str = ""
    data: Dict[str, Any] = field(default_factory=dict)


class InferenceOperator:
    """One reasoning step."""

    def is_compatible(self, inferences: List[Inference]) -> bool:
        raise NotImplementedError

    def infer(self, inferences: List[Inference]) -> List[Inference]:
        raise NotImplementedError


class InferenceChain:
    """Run the operators over the fact set until it stops changing."""

    def __init__(self, operators: List[InferenceOperator]):
        self._operators = operators

    def infer(self, inferences: List[Inference]) -> List[Inference]:
        facts = list(inferences)
        for _ in range(len(self._operators) + 1):  # bounded: no cycles
            progressed = False
            for op in self._operators:
                if not op.is_compatible(facts):
                    continue
                new_facts = op.infer(facts)
                if new_facts != facts:
                    facts = new_facts
                    progressed = True
            if not progressed:
                break
        return facts
