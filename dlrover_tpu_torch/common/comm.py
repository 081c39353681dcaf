"""Control-plane message schema (agent ⇄ master): the port of
``dlrover_tpu/common/comm.py``.

The dataclasses the port's servicer handles, with the JAX module's names,
fields and defaults; they travel through :mod:`.serialize` (JSON, no
pickle). The messages of features the port does not have yet (network
check, data shards, checkpoint sync, metrics, sync barriers, tuning) come
with the slices that port those features.
"""

from dataclasses import dataclass, field
from typing import Dict, List

from .constants import DiagnosisConstants
from .serialize import register_message


@register_message
@dataclass
class BaseRequest:
    node_id: int = -1
    node_type: str = ""
    data: bytes = b""
    # incident trace context; empty until the observability slice
    trace_id: str = ""
    span_id: str = ""


@register_message
@dataclass
class BaseResponse:
    success: bool = True
    reason: str = ""
    data: bytes = b""
    # master boot epoch; 0 = a master without a state journal (the port's)
    master_epoch: int = 0
    trace_id: str = ""
    server_ts: float = 0.0


# -- KV store -----------------------------------------------------------------


@register_message
@dataclass
class KeyValuePair:
    key: str = ""
    value: bytes = b""


@register_message
@dataclass
class KeyValueQuery:
    key: str = ""


@register_message
@dataclass
class KeyValueAdd:
    key: str = ""
    amount: int = 0


@register_message
@dataclass
class KeyValueMultiGet:
    keys: List[str] = field(default_factory=list)


@register_message
@dataclass
class KeyValueMultiPair:
    kvs: Dict[str, bytes] = field(default_factory=dict)


# -- rendezvous ---------------------------------------------------------------


@register_message
@dataclass
class NodeMeta:
    """Topology metadata a host reports when joining a rendezvous."""

    node_id: int = 0
    node_rank: int = -1
    process_unit: int = 1  # local device count (≙ local_world_size)
    slice_id: int = 0
    hostname: str = ""
    addr: str = ""
    asw: str = ""  # access switch id, for topology-aware sorting
    psw: str = ""


@register_message
@dataclass
class JoinRendezvousRequest:
    node_id: int = 0
    node_rank: int = -1
    local_world_size: int = 1
    rdzv_name: str = ""
    round: int = 0
    node_ip: str = ""
    slice_id: int = 0


@register_message
@dataclass
class JoinRendezvousResponse:
    round: int = 0


@register_message
@dataclass
class CommWorldRequest:
    node_id: int = 0
    node_rank: int = -1
    rdzv_name: str = ""


@register_message
@dataclass
class CommWorldResponse:
    rdzv_name: str = ""
    round: int = 0
    group: int = 0
    # process_id -> NodeMeta for every member of the completed world
    world: Dict[int, NodeMeta] = field(default_factory=dict)


@register_message
@dataclass
class WaitingNodeNumRequest:
    node_id: int = 0
    rdzv_name: str = ""


@register_message
@dataclass
class WaitingNodeNumResponse:
    waiting_num: int = 0


# -- node lifecycle and health ------------------------------------------------


@register_message
@dataclass
class NodeStateRequest:
    node_id: int = 0
    node_type: str = ""
    status: str = ""
    exit_reason: str = ""
    restart_count: int = 0
    message: str = ""


@register_message
@dataclass
class NodeFailureReport:
    node_id: int = 0
    node_rank: int = -1
    error_data: str = ""
    level: str = "error"
    restart_count: int = 0


@register_message
@dataclass
class HeartbeatRequest:
    node_id: int = 0
    node_rank: int = -1
    timestamp: float = 0.0


@register_message
@dataclass
class DiagnosisActionMsg:
    action_cls: str = "NoAction"
    instance: int = DiagnosisConstants.ANY_INSTANCE
    timestamp: float = 0.0
    expired_s: float = DiagnosisConstants.ACTION_EXPIRY_S
    config: Dict[str, str] = field(default_factory=dict)


@register_message
@dataclass
class HeartbeatResponse:
    actions: List[DiagnosisActionMsg] = field(default_factory=list)


@register_message
@dataclass
class TrainingStepReport:
    node_id: int = 0
    step: int = 0
    timestamp: float = 0.0
    elapsed_s: float = 0.0
    tokens_per_s: float = 0.0


# -- pre-check, job status, run config ----------------------------------------


@register_message
@dataclass
class PreCheckRequest:
    node_id: int = 0


@register_message
@dataclass
class PreCheckResponse:
    status: str = "checking"
    reason: str = ""


@register_message
@dataclass
class JobStatusRequest:
    node_id: int = 0


@register_message
@dataclass
class JobStatusResponse:
    stage: str = ""
    exit_reason: str = ""
    goodput: float = 0.0
    # productive fraction once training began (excludes provisioning)
    training_goodput: float = 0.0
    steps_per_second: float = 0.0
    last_step: int = 0


@register_message
@dataclass
class ElasticRunConfigRequest:
    node_id: int = 0


@register_message
@dataclass
class ElasticRunConfigResponse:
    configs: Dict[str, str] = field(default_factory=dict)
