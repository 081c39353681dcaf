"""Master process entry, ``python -m dlrover_tpu_torch.master.main``: the port
of ``dlrover_tpu/master/main.py``.

Parses the arguments, builds the standalone master, writes the bound port
to ``--port_file`` (atomically, so a reader never sees a partial number)
and serves until the job ends. Exits 0 when the job succeeded. The
standalone launcher (``elastic_run --standalone``) spawns exactly this
module.
"""

import os
import sys

from ..common.constants import DefaultValues, JobExitReason, PlatformType
from ..common.log import logger
from ..common.platform import not_ported
from .args import parse_master_args
from .local_master import LocalJobMaster


def run(namespace) -> int:
    if namespace.platform != PlatformType.LOCAL:
        raise not_ported(f"the distributed master (platform {namespace.platform!r})")
    for asked, what in ((namespace.max_workers > 0, "auto-scaling (--max_workers)"),
                        (namespace.pending_timeout != DefaultValues.SEC_TO_WAIT_PENDING_POD,
                         "the pending-node timeout (--pending_timeout)"),
                        (bool(namespace.brain_addr), "the Brain service (--brain_addr)")):
        if asked:
            raise not_ported(what)
    master = LocalJobMaster(port=namespace.port, num_workers=namespace.num_workers,
                            node_unit=namespace.node_unit, service_type=namespace.service_type)
    master.prepare()
    if namespace.port_file:
        tmp = f"{namespace.port_file}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(str(master.port))
        os.replace(tmp, namespace.port_file)
    logger.info("job master serving job=%s addr=%s workers=%s", namespace.job_name,
                master.addr, namespace.num_workers)
    try:
        master.run()
    finally:
        master.stop()
    return 0 if master.exit_reason == JobExitReason.SUCCEEDED else 1


def main(args=None) -> int:
    return run(parse_master_args(args))


if __name__ == "__main__":
    sys.exit(main())
