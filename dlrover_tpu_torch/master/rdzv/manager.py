"""Master-side rendezvous: the port of ``dlrover_tpu/master/rdzv/manager.py``.

A completed rendezvous gives each host its process id (its position in
the topology-sorted world); the agents then elect rank 0's address as the
coordinator. A membership change completes a new round. Kept from the JAX
module:

- completion when the waiting hosts reach ``max_nodes``, or reach
  ``min_nodes`` after the last-call window, truncated to a multiple of
  ``node_unit``; the extra hosts wait for the next round;
- ``num_nodes_waiting`` reports waiters (a world restart) only when a whole
  ``node_unit`` waits or a member of the last world re-joins;
- dead nodes leave the waiting set; the topology sort by slice, switch and
  rank.

The clock is ``time.time``, read as the JAX module reads it. The network
check's rendezvous and the persistence hooks wait for the slices that port
the node check and master persistence.
"""

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ...common import comm
from ...common.config import get_context
from ...common.constants import RendezvousName
from ...common.log import logger


class TopologySorter:
    """Orders a completed world: by slice id, then switch id, then node
    rank, so that neighbours in data parallelism share a slice."""

    def sort(self, nodes: Dict[int, comm.NodeMeta]) -> List[comm.NodeMeta]:
        return sorted(nodes.values(), key=lambda n: (n.slice_id, n.asw, n.node_rank))


class RendezvousManager:
    def __init__(self, name: str):
        self._name = name
        self._lock = threading.Lock()
        ctx = get_context()
        self._waiting_nodes: Dict[int, comm.NodeMeta] = {}  # node_rank → meta
        self._rdzv_nodes: Dict[int, comm.NodeMeta] = {}  # completed world
        self._latest_members: Set[int] = set()  # node ranks of the last world
        self._rdzv_round = 0
        self._min_nodes = 1
        self._max_nodes = 1
        self._node_unit = 1
        self._waiting_timeout = ctx.rdzv_timeout_s
        self._lastcall_timeout = ctx.rdzv_lastcall_s
        self._lastcall_time = 0.0
        self._start_rdzv_time = 0.0
        self._ckpt_sync_nodes: Dict[int, int] = {}  # node_id → step

    @property
    def name(self) -> str:
        return self._name

    def update_rdzv_params(self, min_nodes: int, max_nodes: int, waiting_timeout: float,
                           node_unit: int) -> None:
        with self._lock:
            self._min_nodes = min_nodes
            self._max_nodes = max_nodes
            self._waiting_timeout = waiting_timeout
            self._node_unit = max(1, node_unit)

    def remove_alive_node(self, node_rank: int) -> None:
        """A node died: drop it from the pending rendezvous so completion
        does not wait on it."""
        with self._lock:
            if node_rank in self._waiting_nodes:
                del self._waiting_nodes[node_rank]
                logger.info("%s rdzv: removed dead node %s from waiting", self._name, node_rank)

    def join_rendezvous(self, meta: comm.NodeMeta) -> int:
        """A host asks to join the next round. Joining invalidates the last
        completed world: ``get_comm_world`` answers empty until the new
        round completes."""
        with self._lock:
            if self._rdzv_nodes:
                self._rdzv_nodes = {}
            if not self._waiting_nodes:
                self._start_rdzv_time = time.time()
            self._waiting_nodes[meta.node_rank] = meta
            self._lastcall_time = time.time()
            logger.info("%s rdzv round %s: node %s joined (%s waiting)", self._name,
                        self._rdzv_round, meta.node_rank, len(self._waiting_nodes))
            return self._rdzv_round

    def _check_rdzv_completed(self) -> bool:
        """Caller holds the lock."""
        waiting = len(self._waiting_nodes)
        if waiting == self._max_nodes:
            self._complete()
            return True
        if waiting >= self._min_nodes:
            if self._lastcall_time > 0 and time.time() - self._lastcall_time > self._lastcall_timeout:
                # truncate to a multiple of node_unit; the rest wait
                usable = (waiting // self._node_unit) * self._node_unit
                if usable >= self._min_nodes and usable > 0:
                    self._complete(limit=usable)
                    return True
        if self._start_rdzv_time > 0 and time.time() - self._start_rdzv_time > self._waiting_timeout:
            logger.warning("%s rdzv round %s timed out with %s/%s nodes", self._name,
                           self._rdzv_round, waiting, self._min_nodes)
        return False

    def _complete(self, limit: Optional[int] = None) -> None:
        members = sorted(self._waiting_nodes)
        if limit is not None:
            members = members[:limit]
        self._rdzv_nodes = {r: self._waiting_nodes[r] for r in members}
        for r in members:
            del self._waiting_nodes[r]
        self._latest_members = set(members)
        self._rdzv_round += 1
        self._lastcall_time = 0.0
        self._start_rdzv_time = 0.0
        logger.info("%s rdzv round %s completed with %s nodes", self._name,
                    self._rdzv_round - 1, len(self._rdzv_nodes))

    def get_comm_world(self, node_rank: int) -> Tuple[int, int, Dict[int, comm.NodeMeta]]:
        """(round, group, world); the world is empty until the rendezvous
        completes, then maps process id → meta in topology order."""
        with self._lock:
            if not self._rdzv_nodes:
                self._check_rdzv_completed()
            if not self._rdzv_nodes:
                return self._rdzv_round, 0, {}
            ordered = TopologySorter().sort(self._rdzv_nodes)
            return self._rdzv_round - 1, 0, dict(enumerate(ordered))

    def num_nodes_waiting(self) -> int:
        """Waiters that require a new world: a whole node_unit, or a member
        of the last world re-joining."""
        with self._lock:
            waiting = len(self._waiting_nodes)
            if waiting == 0:
                return 0
            rejoin = any(r in self._latest_members for r in self._waiting_nodes)
            if waiting >= self._node_unit or rejoin:
                return waiting
            return 0

    def world_size(self) -> int:
        with self._lock:
            return len(self._rdzv_nodes)

    def sync_ckpt_nodes(self, node_id: int, step: int) -> bool:
        """True once every member reported the same step."""
        with self._lock:
            self._ckpt_sync_nodes[node_id] = step
            if any(s != step for s in self._ckpt_sync_nodes.values()):
                self._ckpt_sync_nodes = {node_id: step}
                return False
            return len(self._ckpt_sync_nodes) >= len(self._rdzv_nodes) > 0


class ElasticTrainingRendezvousManager(RendezvousManager):
    def __init__(self):
        super().__init__(RendezvousName.TRAINING)
