"""Constants the port reads: the part of ``dlrover_tpu/common/constants.py``
that the checkpoint and the elastic loop need (``CheckpointConstant`` and
``NodeEnv``), with the same names and values."""


class CheckpointConstant:
    TRACKER_FILE = "dlrover_latest.txt"
    DONE_DIR = ".done"
    COMMIT_FILE = "commit_success"


class NodeEnv:
    """Environment the agent hands a worker process."""

    MASTER_ADDR = "DLROVER_MASTER_ADDR"
    JOB_NAME = "DLROVER_JOB_NAME"
    NODE_ID = "DLROVER_NODE_ID"
    NODE_RANK = "DLROVER_NODE_RANK"
    COORDINATOR_ADDRESS = "DLROVER_COORDINATOR_ADDRESS"
    NUM_PROCESSES = "DLROVER_NUM_PROCESSES"
    PROCESS_ID = "DLROVER_PROCESS_ID"
    RESTART_COUNT = "DLROVER_RESTART_COUNT"
    AUTO_TUNNING = "DLROVER_AUTO_TUNNING"
