"""Master-coordinated rendezvous, the agent's side: the port of
``dlrover_tpu/agent/rendezvous.py``.

The agent joins through the master, polls ``get_comm_world`` until a
completed world holds its node rank, and takes its process id from its
position in that world. The lowest-ranked member publishes a coordinator
address (``host:free port``) in the master's KV store under
``rdzv/<name>/coord/<round>``; every other member reads it. The result is
the env contract of the JAX package, ``DLROVER_COORDINATOR_ADDRESS``,
``DLROVER_NUM_PROCESSES`` and ``DLROVER_PROCESS_ID``, which a world of
several processes will hand to ``torch.distributed`` unchanged.

Every wait has the rendezvous deadline. Re-attaching to a restarted
master (the epoch fence) and the chaos hooks wait for the slices that
port master persistence and chaos.
"""

import socket
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..common import comm
from ..common.constants import RendezvousName
from ..common.log import logger
from ..rpc.client import MasterClient


class RendezvousTimeoutError(RuntimeError):
    """The world did not assemble within the configured timeout."""


class RendezvousProtocolError(RuntimeError):
    """The master rejected a rendezvous call for a reason no retry can
    cure (an unknown message: a wire-contract bug)."""


class MasterRejectedError(ConnectionError):
    """The master answered but rejected the call transiently (a master
    that does not know this node): answered by a fresh join."""


_PROTOCOL_REJECTIONS = ("unknown message",)


def _triage_rejection(resp, call: str) -> None:
    reason = str(getattr(resp, "reason", "") or "")
    if any(tok in reason for tok in _PROTOCOL_REJECTIONS):
        raise RendezvousProtocolError(f"master rejected {call} with a protocol error: {reason!r}")
    raise MasterRejectedError(f"master rejected {call}: {resp!r}")


def find_free_port(host: str = "") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclass
class RendezvousWorld:
    """A completed world and this host's place in it."""

    round: int = 0
    group: int = 0
    rank: int = -1  # this host's process id in the world
    world_size: int = 0  # number of hosts (worker processes)
    coordinator: str = ""  # "host:port" of the process group's rendezvous
    # process id -> NodeMeta for every member, in topology order
    world: Dict[int, comm.NodeMeta] = field(default_factory=dict)


class MasterRendezvousHandler:
    def __init__(self, name: str, node_rank: int, client: Optional[MasterClient] = None,
                 node_id: Optional[int] = None, local_world_size: int = 1,
                 rdzv_timeout: float = 600.0, poll_interval: float = 0.2,
                 training_port: int = 0, coordinator_host: str = "127.0.0.1",
                 slice_id: int = 0):
        self._name = name
        self._node_rank = node_rank
        self._node_id = node_id if node_id is not None else node_rank
        self._client = client or MasterClient.singleton()
        self._local_world_size = local_world_size
        self._timeout = rdzv_timeout
        self._poll_interval = poll_interval
        self._training_port = training_port
        self._coordinator_host = coordinator_host
        self._slice_id = slice_id

    def _join(self) -> int:
        return self._client.join_rendezvous(node_rank=self._node_rank,
                                            local_world_size=self._local_world_size,
                                            rdzv_name=self._name,
                                            node_ip=self._coordinator_host,
                                            slice_id=self._slice_id)

    def _check_deadline(self, start: float, what: str, err: Optional[Exception] = None) -> None:
        if time.time() - start > self._timeout:
            raise RendezvousTimeoutError(
                f"rendezvous {self._name} {what} within {self._timeout}s "
                f"(node_rank={self._node_rank})" + (f": {err!r}" if err else ""))

    def _join_retrying(self, start: float) -> int:
        """Join, riding out control-plane failures until the deadline."""
        while True:
            try:
                return self._join()
            except ConnectionError as e:
                self._check_deadline(start, "join never succeeded", e)
                logger.warning("rendezvous %s join failed (%s); retrying", self._name, e)
                time.sleep(self._poll_interval)

    def next_rendezvous(self) -> RendezvousWorld:
        """Join and block until the master completes a world holding us."""
        start = time.time()
        rdzv_round = self._join_retrying(start)
        logger.info("node %s joined rendezvous %s round %s", self._node_rank, self._name,
                    rdzv_round)
        while True:
            try:
                resp = self._client.get_comm_world(rdzv_name=self._name,
                                                   node_rank=self._node_rank)
                if not hasattr(resp, "world"):
                    _triage_rejection(resp, "get_comm_world")
            except MasterRejectedError as e:
                self._check_deadline(start, "timed out re-registering", e)
                logger.warning("rendezvous %s rejected (%s); re-registering", self._name, e)
                time.sleep(self._poll_interval)
                rdzv_round = self._join_retrying(start)
                continue
            except ConnectionError as e:
                self._check_deadline(start, "timed out polling the world", e)
                logger.warning("rendezvous %s world poll failed (%s); retrying", self._name, e)
                time.sleep(self._poll_interval)
                continue
            # the world is keyed by process id; find us by node rank
            my_rank = next((pid for pid, meta in resp.world.items()
                            if meta.node_rank == self._node_rank), None)
            if my_rank is not None:
                world = RendezvousWorld(round=resp.round, group=resp.group, rank=my_rank,
                                        world_size=len(resp.world), world=dict(resp.world))
                if self._name == RendezvousName.TRAINING:
                    world.coordinator = self._elect_coordinator(world, start)
                return world
            if resp.world:
                # a world completed without us (truncated to node_unit, or
                # we joined late): join the next round
                logger.warning("node %s not in completed world %s, rejoining", self._node_rank,
                               sorted(m.node_rank for m in resp.world.values()))
                rdzv_round = self._join_retrying(start)
            self._check_deadline(start, "timed out")
            time.sleep(self._poll_interval)

    def _elect_coordinator(self, world: RendezvousWorld, start: Optional[float] = None) -> str:
        """Publish (rank 0) or fetch the coordinator address of the round."""
        key = f"rdzv/{self._name}/coord/{world.round}"
        if world.rank == 0:
            port = self._training_port or find_free_port()
            addr = f"{self._coordinator_host}:{port}"
            self._client.kv_store_set(key, addr.encode())
            return addr
        start = start if start is not None else time.time()
        while True:
            raw = self._client.kv_store_get(key)
            if raw:
                return raw.decode()
            self._check_deadline(start, f"coordinator address of round {world.round} never "
                                        "published")
            time.sleep(self._poll_interval)

    def num_nodes_waiting(self) -> int:
        return self._client.num_nodes_waiting(self._name)
