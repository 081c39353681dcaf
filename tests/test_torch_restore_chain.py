"""The CPU twin of chip_smoke.py's phase 10, the rest of the restore chain
at the small size: the port's master and two ``elastic_run --nnodes 2``
agents train the example as a world of two with peer replicas (on by
default) and the durable tier; node 1 dies whole (agent, worker, spare and
shm) once node 0 holds its replica of a staged step newer than storage's,
and a new node 1 in a fresh IPC namespace restores that step from node 0's
memory. Then, with every shm segment and the flash storage deleted, the
example as a world of one restores the newest committed durable
generation. Losses are held to an uninterrupted world of one (1e-3: the
world of two averages its gradients in another order)."""

import os
import sys
import uuid

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_a_replaced_node_restores_from_its_peer_and_a_lost_pool_from_durable_on_the_cpu(
        tmp_path, monkeypatch):
    sys.path.insert(0, _REPO)
    import chip_smoke

    # one thread a process: the job's processes share the test host
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    job = f"trc_{os.getpid()}_{uuid.uuid4().hex[:6]}"
    facts, numbers = chip_smoke.restore_chain_phase(str(tmp_path), job, device="cpu", small=True,
                                                    loss_tol=1e-3, timeout=200)
    assert facts["restored_from"][1] == "peer" and facts["max_loss_diff"] <= 1e-3
    assert facts["resumed_step"] > facts["storage_step_at_kill"]
    # the held step was staged to memory only (every step is staged)
    assert facts["resumed_step"] % chip_smoke.STORAGE_EVERY != 0
    assert numbers["recovery"]["node1_replaced"]["total_s"] > 0 and numbers["fetch_s"]
    assert len(numbers["durable_committed"]) >= 2
    assert all(d["source"] == "saver buffer" and d["hold_s"] == 0.0
               for d in numbers["durable_drains"])
    pool = numbers["whole_pool"]
    assert pool["restored_step"] == numbers["durable_committed"][-1]
    assert pool["max_loss_diff"] <= 1e-3 and pool["generation_bytes"] > 0
    assert not [n for n in os.listdir("/dev/shm") if n.startswith(f"dlrover_{job}")]
