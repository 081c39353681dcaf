"""Master CLI arguments: the port of ``dlrover_tpu/master/args.py``.

The same options. The port runs the standalone (local) master only: the
platforms of the distributed master, an auto-scale ceiling, a pending-node
timeout other than the default and the Brain service raise
``not_ported`` when asked for (in :func:`..main.run`).
"""

import argparse

from ..common.constants import DefaultValues, PlatformType


def _pos_int(value: str) -> int:
    res = int(value)
    if res <= 0:
        raise argparse.ArgumentTypeError(f"must be positive: {value}")
    return res


def build_master_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="dlrover_tpu_torch job master")
    parser.add_argument("--job_name", default="local_job", help="job name")
    parser.add_argument("--platform", default=PlatformType.LOCAL,
                        choices=[PlatformType.LOCAL, PlatformType.KUBERNETES,
                                 PlatformType.GKE_TPU, PlatformType.RAY],
                        help="scheduling platform backing the job (only local is ported)")
    parser.add_argument("--port", type=int, default=0, help="RPC port (0 picks a free one)")
    parser.add_argument("--num_workers", type=_pos_int, default=1,
                        help="number of hosts (worker processes) in the job")
    parser.add_argument("--max_workers", type=int, default=0,
                        help="auto-scale ceiling (0 = fixed at --num_workers)")
    parser.add_argument("--node_unit", type=_pos_int, default=1,
                        help="world sizes must be multiples of this")
    parser.add_argument("--service_type", default=DefaultValues.SERVICE_TYPE,
                        help="master RPC transport (only http is ported)")
    parser.add_argument("--pending_timeout", type=int,
                        default=DefaultValues.SEC_TO_WAIT_PENDING_POD,
                        help="seconds a node may stay pending before early stop")
    parser.add_argument("--port_file", default="",
                        help="if set, write the bound RPC port to this file once serving "
                             "(lets a parent process discover a port picked with --port 0)")
    parser.add_argument("--brain_addr", default="",
                        help="cluster Brain service address (empty = disabled)")
    return parser


def parse_master_args(args=None) -> argparse.Namespace:
    return build_master_parser().parse_args(args)
