"""Master client, the agent's and trainer's side of the control plane: the
port of ``dlrover_tpu/rpc/client.py``.

A process singleton speaking the ``get``/``report`` verbs over HTTP with
``http.client``. Every call has a deadline (``rpc_deadline_s`` per attempt)
and the JAX client's retry: ``rpc_retries`` attempts with jittered
exponential backoff between them, then ``ConnectionError``. The calls of
the features the port has are ported; the master-epoch fence, the trace
context and the chaos hooks wait for the slices that port master
persistence, observability and chaos.
"""

import http.client
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional

from ..common import comm
from ..common.config import get_context
from ..common.constants import CommsType, NodeEnv
from ..common.log import logger
from ..common.platform import not_ported
from ..common.serialize import dumps, loads


class HttpTransport:
    """One POST per call on a fresh connection, bounded by ``deadline_s``
    for the connect and for each read."""

    def __init__(self, addr: str, deadline_s: float):
        host, _, port = addr.rpartition(":")
        self._host, self._port = host or "127.0.0.1", int(port)
        self._deadline_s = deadline_s

    def _post(self, path: str, payload: bytes) -> bytes:
        conn = http.client.HTTPConnection(self._host, self._port, timeout=self._deadline_s)
        try:
            conn.request("POST", path, body=payload,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status != 200:
                raise ConnectionError(f"master answered HTTP {resp.status}: {body[:200]!r}")
            return body
        finally:
            conn.close()

    def get(self, payload: bytes) -> bytes:
        return self._post("/get", payload)

    def report(self, payload: bytes) -> bytes:
        return self._post("/report", payload)


class MasterClient:
    """Typed control-plane client with retry. One per process (singleton)."""

    _instance: Optional["MasterClient"] = None
    _lock = threading.Lock()

    def __init__(self, master_addr: str, node_id: int = -1, node_type: str = "worker",
                 service_type: str = "", retries: Optional[int] = None,
                 deadline_s: Optional[float] = None):
        ctx = get_context()
        self.master_addr = master_addr
        self.node_id = node_id
        self.node_type = node_type
        service_type = service_type or ctx.master_comms()
        if service_type != CommsType.HTTP:
            raise not_ported(f"the {service_type!r} master transport (only HTTP is)")
        deadline_s = deadline_s if deadline_s is not None else ctx.rpc_deadline_s
        self._transport = HttpTransport(master_addr, deadline_s)
        self._retries = max(1, retries if retries is not None else ctx.rpc_retries)
        self._backoff_base_s = ctx.rpc_backoff_base_s
        self._backoff_cap_s = ctx.rpc_backoff_cap_s
        # per-client jitter, so clients retrying one master do not sleep
        # in lockstep
        self._rng = random.Random(os.getpid() ^ id(self))

    # -- low-level verbs ---------------------------------------------------

    def _wrap(self, message: Any) -> bytes:
        return dumps(comm.BaseRequest(node_id=self.node_id, node_type=self.node_type,
                                      data=dumps(message)))

    def _backoff_delay(self, attempt: int) -> float:
        """Equal jitter: uniform in [half, full] of ``base * 2^(attempt-1)``,
        capped at ``rpc_backoff_cap_s``."""
        full = min(self._backoff_cap_s, self._backoff_base_s * (2 ** (attempt - 1)))
        return full * (0.5 + 0.5 * self._rng.random())

    def _call(self, verb: str, message: Any) -> Any:
        payload = self._wrap(message)
        last_err: Optional[Exception] = None
        for attempt in range(self._retries):
            if attempt:
                time.sleep(self._backoff_delay(attempt))
            try:
                fn = self._transport.get if verb == "get" else self._transport.report
                resp = loads(fn(payload))
                if isinstance(resp, comm.BaseResponse):
                    if not resp.success and resp.reason:
                        logger.debug("master rejected %s: %s", verb, resp.reason)
                    return loads(resp.data) if resp.data else resp
                return resp
            except Exception as e:  # noqa: BLE001 — transport errors are retried
                last_err = e
        raise ConnectionError(f"master {verb} failed after {self._retries} tries: {last_err!r}")

    def get(self, message: Any) -> Any:
        return self._call("get", message)

    def report(self, message: Any) -> Any:
        return self._call("report", message)

    # -- kv store ----------------------------------------------------------

    def kv_store_set(self, key: str, value: bytes) -> None:
        self.report(comm.KeyValuePair(key=key, value=value))

    def kv_store_get(self, key: str) -> bytes:
        resp = self.get(comm.KeyValueQuery(key=key))
        return resp.value if isinstance(resp, comm.KeyValuePair) else b""

    def kv_store_add(self, key: str, amount: int) -> int:
        resp = self.get(comm.KeyValueAdd(key=key, amount=amount))
        return int(resp.value.decode()) if resp.value else 0

    def kv_store_multi_get(self, keys: List[str]) -> Dict[str, bytes]:
        resp = self.get(comm.KeyValueMultiGet(keys=keys))
        return resp.kvs if isinstance(resp, comm.KeyValueMultiPair) else {}

    def kv_store_multi_set(self, kvs: Dict[str, bytes]) -> None:
        self.report(comm.KeyValueMultiPair(kvs=kvs))

    # -- rendezvous --------------------------------------------------------

    def join_rendezvous(self, node_rank: int, local_world_size: int, rdzv_name: str,
                        node_ip: str = "", slice_id: int = 0) -> int:
        resp = self.get(comm.JoinRendezvousRequest(
            node_id=self.node_id, node_rank=node_rank, local_world_size=local_world_size,
            rdzv_name=rdzv_name, node_ip=node_ip, slice_id=slice_id))
        if not isinstance(resp, comm.JoinRendezvousResponse):
            # a rejected join must not read as round 0: the master never
            # registered the node
            raise ConnectionError(f"master rejected join_rendezvous: {resp!r}")
        return resp.round

    def get_comm_world(self, rdzv_name: str, node_rank: int = -1) -> comm.CommWorldResponse:
        return self.get(comm.CommWorldRequest(node_id=self.node_id, node_rank=node_rank,
                                              rdzv_name=rdzv_name))

    def num_nodes_waiting(self, rdzv_name: str) -> int:
        resp = self.get(comm.WaitingNodeNumRequest(node_id=self.node_id, rdzv_name=rdzv_name))
        return resp.waiting_num if isinstance(resp, comm.WaitingNodeNumResponse) else 0

    # -- node lifecycle ----------------------------------------------------

    def report_node_status(self, status: str, exit_reason: str = "",
                           restart_count: int = 0) -> None:
        self.report(comm.NodeStateRequest(node_id=self.node_id, node_type=self.node_type,
                                          status=status, exit_reason=exit_reason,
                                          restart_count=restart_count))

    def report_failure(self, error_data: str, level: str = "error",
                       restart_count: int = 0) -> None:
        self.report(comm.NodeFailureReport(node_id=self.node_id, error_data=error_data,
                                           level=level, restart_count=restart_count))

    def report_heartbeat(self) -> List[comm.DiagnosisActionMsg]:
        resp = self.get(comm.HeartbeatRequest(node_id=self.node_id, timestamp=time.time()))
        return resp.actions if isinstance(resp, comm.HeartbeatResponse) else []

    def report_training_step(self, step: int, elapsed_s: float = 0.0,
                             tokens_per_s: float = 0.0) -> None:
        self.report(comm.TrainingStepReport(node_id=self.node_id, step=step,
                                            timestamp=time.time(), elapsed_s=elapsed_s,
                                            tokens_per_s=tokens_per_s))

    # -- pre-check, job status, run config ---------------------------------

    def get_pre_check_result(self) -> comm.PreCheckResponse:
        return self.get(comm.PreCheckRequest(node_id=self.node_id))

    def get_job_status(self) -> comm.JobStatusResponse:
        return self.get(comm.JobStatusRequest(node_id=self.node_id))

    def get_elastic_run_config(self) -> Dict[str, str]:
        resp = self.get(comm.ElasticRunConfigRequest(node_id=self.node_id))
        return resp.configs if isinstance(resp, comm.ElasticRunConfigResponse) else {}

    def close(self) -> None:
        """Nothing to release: every call opens and closes its own
        connection."""

    # -- singleton ---------------------------------------------------------

    @classmethod
    def singleton(cls) -> "MasterClient":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    addr = os.getenv(NodeEnv.MASTER_ADDR, "")
                    if not addr:
                        raise RuntimeError(f"{NodeEnv.MASTER_ADDR} not set; no master to talk to")
                    cls._instance = cls(master_addr=addr,
                                        node_id=int(os.getenv(NodeEnv.NODE_ID, "0")),
                                        service_type=os.getenv(NodeEnv.MASTER_SERVICE_TYPE, ""))
        return cls._instance

    @classmethod
    def reset_singleton(cls) -> None:
        with cls._lock:
            if cls._instance is not None:
                cls._instance.close()
            cls._instance = None
