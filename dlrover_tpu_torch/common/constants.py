"""Constants the port reads: the part of ``dlrover_tpu/common/constants.py``
that the checkpoint, the elastic loop, the control plane and the agent
need, with the same names and values.

One value differs on purpose: ``DefaultValues.SERVICE_TYPE`` is HTTP,
because the machines the port runs on need not have gRPC; the port's
master speaks HTTP only.
"""


class NodeType:
    MASTER = "master"
    WORKER = "worker"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    BREAKDOWN = "breakdown"

    @classmethod
    def terminal(cls):
        return {cls.SUCCEEDED, cls.FAILED, cls.DELETED}


class NodeExitReason:
    SUCCEEDED = "succeeded"
    KILLED = "killed"
    OOM = "oom"
    FATAL_ERROR = "fatal_error"
    HARDWARE_ERROR = "hardware_error"
    PREEMPTED = "preempted"
    # The agent itself asked to be replaced (restart budget exhausted or
    # the diagnosis said relaunch): the master honours it within the
    # node's relaunch budget.
    RELAUNCH_REQUESTED = "relaunch_requested"
    UNKNOWN = "unknown"


class JobStage:
    INIT = "init"
    PRE_CHECK = "pre_check"
    RUNNING = "running"
    SUSPENDED = "suspended"
    STOPPING = "stopping"
    STOPPED = "stopped"


class JobExitReason:
    SUCCEEDED = "succeeded"
    FATAL_ERROR = "fatal_error"
    MAX_RELAUNCH = "max_relaunch_exceeded"
    PENDING_TIMEOUT = "pending_timeout"
    NO_HEARTBEAT = "no_heartbeat"
    HANG = "hang"
    UNKNOWN = "unknown"


class RendezvousName:
    TRAINING = "training"
    NETWORK_CHECK = "network-check"


class CommsType:
    GRPC = "grpc"
    HTTP = "http"


class PreCheckStatus:
    CHECKING = "checking"
    PASSED = "passed"
    FAILED = "failed"
    DISABLED = "disabled"


class DiagnosisConstants:
    ACTION_EXPIRY_S = 60 * 5
    MASTER_INSTANCE = -1
    ANY_INSTANCE = -2


class PlatformType:
    LOCAL = "local"
    KUBERNETES = "k8s"
    GKE_TPU = "gke_tpu"
    RAY = "ray"


class Accelerators:
    GPU = "gpu"
    CPU = "cpu"


class DefaultValues:
    SERVICE_TYPE = CommsType.HTTP  # the JAX package's default is gRPC
    MASTER_PORT = 0  # 0 → pick a free port
    RDZV_TIMEOUT_S = 600
    RDZV_LASTCALL_S = 30
    NODE_CHECK_TIMEOUT_S = 300
    HEARTBEAT_INTERVAL_S = 15
    HANG_DOWNTIME_S = 300
    MAX_RELAUNCH_COUNT = 3
    MONITOR_INTERVAL_S = 5
    SAVE_AT_BREAKPOINT = True
    SEC_TO_WAIT_PENDING_POD = 900


class CheckpointConstant:
    TRACKER_FILE = "dlrover_latest.txt"
    DONE_DIR = ".done"
    COMMIT_FILE = "commit_success"


class NodeEnv:
    """Environment the agent hands a worker process."""

    MASTER_ADDR = "DLROVER_MASTER_ADDR"
    MASTER_SERVICE_TYPE = "DLROVER_MASTER_SERVICE_TYPE"
    JOB_NAME = "DLROVER_JOB_NAME"
    NODE_ID = "DLROVER_NODE_ID"
    NODE_RANK = "DLROVER_NODE_RANK"
    NODE_NUM = "DLROVER_NODE_NUM"
    # the job's ceiling; NODE_NUM is rewritten each round with the live size
    MAX_NODES = "DLROVER_MAX_NODES"
    NODE_UNIT = "DLROVER_NODE_UNIT"
    COORDINATOR_ADDRESS = "DLROVER_COORDINATOR_ADDRESS"
    NUM_PROCESSES = "DLROVER_NUM_PROCESSES"
    PROCESS_ID = "DLROVER_PROCESS_ID"
    RESTART_COUNT = "DLROVER_RESTART_COUNT"
    AUTO_TUNNING = "DLROVER_AUTO_TUNNING"
