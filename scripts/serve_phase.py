#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` (decode and serving) alone, on one GPU.

    python3 scripts/serve_phase.py [--device cpu --small]

``chip_smoke.serve_phase`` serves what phases 5 and 9 leave behind: a
storage checkpoint of GPT-2 small written by the port's trainer and
Llama-125M's parameters. Here they are made directly: the flagship
example's train state (``gpt_elastic.build``: GPT-2 small at full width,
seed 0) persisted as step 0 through the port's ``CheckpointEngine``, and
Llama-125M's seed-0 parameters saved with ``torch.save``. Then the phase
runs as the script runs it and its ``serving`` line is printed. About a
minute on the card; ``--device cpu --small`` runs the CPU twin's sizes.
Exits non-zero without a GPU unless ``--device cpu`` is given.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="the CPU twin's sizes")
    args = ap.parse_args()

    import torch

    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.common.platform import resolve_device, strict_fp32
    from dlrover_tpu_torch.examples import gpt_elastic
    from dlrover_tpu_torch.models import llama

    device = resolve_device(args.device)
    if device.type == "cuda":
        strict_fp32()
    work = tempfile.mkdtemp(prefix="serve_phase_")
    job = f"serve_phase_{os.getpid()}"
    try:
        ckpt = os.path.join(work, "ckpt")
        with chip_smoke._job_ipc(work, job):
            _, state, _, _ = gpt_elastic.build(args.small, device)
            engine = CheckpointEngine(ckpt, standalone=True)
            try:
                if not (engine.save_to_storage(0, state) and engine.wait_saving(300)):
                    raise RuntimeError("the checkpoint was not persisted")
            finally:
                engine.shm.unlink()
                engine.close()
        persisted = {"step": 0, "params_sha256": chip_smoke.params_sha256(state.params)}
        del state
        base = chip_smoke.LLAMA_SMALL if args.small else chip_smoke.LLAMA_125M
        model = llama.Llama(llama.LlamaConfig(**base), device=device, seed=0)
        llama_params = os.path.join(work, "llama.pt")
        torch.save({n: p.detach().cpu() for n, p in model.named_parameters()}, llama_params)
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out = chip_smoke.serve_phase(work, job, {"ckpt_dir": ckpt, "persisted": persisted,
                                                 "llama_params": llama_params},
                                     device=device.type, small=args.small)
        print(json.dumps({"serving": out}), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
