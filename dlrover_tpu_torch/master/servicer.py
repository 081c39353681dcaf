"""Master RPC servicer: the port of ``dlrover_tpu/master/servicer.py``.

Dispatches each ``get`` and ``report`` by message type to the component
that owns it: the KV store, the rendezvous managers, the job manager, the
step monitor and the job context. Only the messages of
:mod:`..common.comm` are handled; any other message, or a body that does
not decode, gets an error response (``success=False``), never a crash.
"""

import time
from typing import Dict

from ..common import comm
from ..common.constants import NodeStatus, NodeType, RendezvousName
from ..common.log import logger
from ..common.serialize import dumps, loads
from .diagnosis.action import action_to_msg
from .job_context import get_job_context
from .kv_store import KVStoreService
from .node.job_manager import JobManager
from .rdzv.manager import RendezvousManager


class MasterServicer:
    def __init__(self, job_manager: JobManager, rdzv_managers: Dict[str, RendezvousManager],
                 kv_store: KVStoreService = None, perf_monitor=None):
        self._job_manager = job_manager
        self._rdzv_managers = rdzv_managers
        self._kv_store = kv_store or KVStoreService()
        self._perf_monitor = perf_monitor
        self._job_ctx = get_job_context()

    def _respond(self, **kwargs) -> bytes:
        return dumps(comm.BaseResponse(server_ts=time.time(), **kwargs))

    def _message(self, request_bytes: bytes):
        req = loads(request_bytes)
        return loads(req.data) if isinstance(req, comm.BaseRequest) else req

    # -- transport entry points (bytes in and out) -------------------------

    def get(self, request_bytes: bytes) -> bytes:
        try:
            message = self._message(request_bytes)
        except Exception as e:  # noqa: BLE001 — a bad body is the caller's error
            return self._respond(success=False, reason=f"undecodable request: {e!r}")
        handler = self._GET_HANDLERS.get(type(message))
        if handler is None:
            logger.warning("no get handler for %s", type(message).__name__)
            return self._respond(success=False, reason="unknown message")
        try:
            result = handler(self, message)
        except Exception as e:  # noqa: BLE001 — reported, not retried
            logger.exception("get handler failed for %s", type(message).__name__)
            return self._respond(success=False, reason=repr(e))
        return self._respond(success=True, data=dumps(result))

    def report(self, request_bytes: bytes) -> bytes:
        try:
            message = self._message(request_bytes)
        except Exception as e:  # noqa: BLE001
            return self._respond(success=False, reason=f"undecodable request: {e!r}")
        handler = self._REPORT_HANDLERS.get(type(message))
        if handler is None:
            logger.warning("no report handler for %s", type(message).__name__)
            return self._respond(success=False, reason="unknown message")
        try:
            handler(self, message)
            return self._respond(success=True)
        except Exception as e:  # noqa: BLE001
            logger.exception("report handler failed")
            return self._respond(success=False, reason=repr(e))

    # -- kv store ----------------------------------------------------------

    def _kv_get(self, msg: comm.KeyValueQuery) -> comm.KeyValuePair:
        return comm.KeyValuePair(key=msg.key, value=self._kv_store.get(msg.key))

    def _kv_add(self, msg: comm.KeyValueAdd) -> comm.KeyValuePair:
        value = self._kv_store.add(msg.key, msg.amount)
        return comm.KeyValuePair(key=msg.key, value=str(value).encode())

    def _kv_multi_get(self, msg: comm.KeyValueMultiGet) -> comm.KeyValueMultiPair:
        return comm.KeyValueMultiPair(kvs=self._kv_store.multi_get(msg.keys))

    def _kv_set(self, msg: comm.KeyValuePair) -> None:
        self._kv_store.set(msg.key, msg.value)

    def _kv_multi_set(self, msg: comm.KeyValueMultiPair) -> None:
        self._kv_store.multi_set(msg.kvs)

    # -- rendezvous --------------------------------------------------------

    def _join_rdzv(self, msg: comm.JoinRendezvousRequest) -> comm.JoinRendezvousResponse:
        manager = self._rdzv_managers[msg.rdzv_name or RendezvousName.TRAINING]
        meta = comm.NodeMeta(node_id=msg.node_id,
                             node_rank=msg.node_rank if msg.node_rank >= 0 else msg.node_id,
                             process_unit=msg.local_world_size, addr=msg.node_ip,
                             slice_id=msg.slice_id)
        return comm.JoinRendezvousResponse(round=manager.join_rendezvous(meta))

    def _get_comm_world(self, msg: comm.CommWorldRequest) -> comm.CommWorldResponse:
        manager = self._rdzv_managers[msg.rdzv_name or RendezvousName.TRAINING]
        rank = msg.node_rank if msg.node_rank >= 0 else msg.node_id
        round_, group, world = manager.get_comm_world(rank)
        return comm.CommWorldResponse(rdzv_name=manager.name, round=round_, group=group,
                                      world=world)

    def _num_waiting(self, msg: comm.WaitingNodeNumRequest) -> comm.WaitingNodeNumResponse:
        manager = self._rdzv_managers[msg.rdzv_name or RendezvousName.TRAINING]
        return comm.WaitingNodeNumResponse(waiting_num=manager.num_nodes_waiting())

    # -- node lifecycle ----------------------------------------------------

    def _node_state(self, msg: comm.NodeStateRequest) -> None:
        node_type = msg.node_type or NodeType.WORKER
        self._job_manager.update_node_status(msg.node_id, node_type, msg.status, msg.exit_reason)
        if msg.status in (NodeStatus.FAILED, NodeStatus.SUCCEEDED, NodeStatus.DELETED):
            # rendezvous state is keyed by node rank, which a relaunched
            # host keeps
            node = self._job_ctx.get_node(node_type, msg.node_id)
            rank = node.rank_index if node is not None and node.rank_index >= 0 else msg.node_id
            for manager in self._rdzv_managers.values():
                manager.remove_alive_node(rank)

    def _node_failure(self, msg: comm.NodeFailureReport) -> None:
        self._job_manager.handle_failure_report(msg.node_id, msg.error_data, msg.restart_count)

    def _heartbeat(self, msg: comm.HeartbeatRequest) -> comm.HeartbeatResponse:
        self._job_manager.record_heartbeat(msg.node_id, msg.timestamp)
        actions = self._job_ctx.node_actions.drain_actions(msg.node_id)
        return comm.HeartbeatResponse(actions=[action_to_msg(a) for a in actions])

    def _training_step(self, msg: comm.TrainingStepReport) -> None:
        if self._perf_monitor is not None:
            self._perf_monitor.collect_global_step(msg.step, msg.timestamp)

    # -- pre-check, status, config -----------------------------------------

    def _pre_check(self, msg: comm.PreCheckRequest) -> comm.PreCheckResponse:
        return comm.PreCheckResponse(status=self._job_ctx.pre_check_status,
                                     reason=self._job_ctx.pre_check_reason)

    def _job_status(self, msg: comm.JobStatusRequest) -> comm.JobStatusResponse:
        goodput = training_goodput = sps = 0.0
        last_step = 0
        if self._perf_monitor is not None:
            goodput = self._perf_monitor.goodput()
            training_goodput = self._perf_monitor.training_goodput()
            sps = self._perf_monitor.steps_per_second()
            last_step, _ = self._perf_monitor.last_step()
        return comm.JobStatusResponse(stage=self._job_ctx.job_stage,
                                      exit_reason=self._job_ctx.job_exit_reason,
                                      goodput=goodput, training_goodput=training_goodput,
                                      steps_per_second=sps, last_step=last_step)

    def _run_config(self, msg: comm.ElasticRunConfigRequest) -> comm.ElasticRunConfigResponse:
        return comm.ElasticRunConfigResponse(configs=dict(self._job_ctx.elastic_run_config))

    _GET_HANDLERS = {
        comm.KeyValueQuery: _kv_get,
        comm.KeyValueAdd: _kv_add,
        comm.KeyValueMultiGet: _kv_multi_get,
        comm.JoinRendezvousRequest: _join_rdzv,
        comm.CommWorldRequest: _get_comm_world,
        comm.WaitingNodeNumRequest: _num_waiting,
        comm.HeartbeatRequest: _heartbeat,
        comm.PreCheckRequest: _pre_check,
        comm.JobStatusRequest: _job_status,
        comm.ElasticRunConfigRequest: _run_config,
    }

    _REPORT_HANDLERS = {
        comm.KeyValuePair: _kv_set,
        comm.KeyValueMultiPair: _kv_multi_set,
        comm.NodeStateRequest: _node_state,
        comm.NodeFailureReport: _node_failure,
        comm.TrainingStepReport: _training_step,
    }
