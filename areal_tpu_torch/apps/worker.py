"""A worker process of a multi-process trial (port of
areal_tpu/apps/worker.py): load its pickled `WorkerConfig`, seed, bind
the control server and the transfer plane (before the slow model build,
so that the controller and the peers see it early), build the
`ModelWorker` on `--device` and serve the master's stream until `exit`.
The scheduler launches it as

    python -m areal_tpu_torch.apps.worker --config <plan_dir> --index <i> \\
        --experiment <name> --trial <name> [--device cuda]

with `AREAL_NAME_RESOLVE=file`, `AREAL_NAME_RESOLVE_ROOT` (the trial's
store), `AREAL_TRIAL_AUTHKEY` and `AREAL_WORKER_HEARTBEAT_S` set by the
launcher (`apps/main.py`).  Each worker serves its metrics registry at
``GET /metrics``, announced as the trial's ``model_worker/<index>`` role
for `apps/metrics_report.py`, and deletes the key on exit.  The device
is the card unless the launcher
passes `--device cpu`: a worker never moves to the CPU because it found
no card.  Besides the built-in control commands, the worker answers
`runtime_stats`: its pid, device, kernel launch counts and peak device
memory.

A member of an SPMD worker group (`WorkerConfig.dist_num_processes` >
0) first joins the group's `torch.distributed` world
(`base/distributed.initialize`, the rendezvous key tagged with the
launch attempt's `--rendezvous`, the collective timeout the plan's
`mfc_timeout_s`): NCCL on the card, whose rank r drives `cuda:<r>`, gloo
on the CPU.  It leaves the world on exit.
"""

import argparse
import logging
import os
import pickle


def runtime_stats(worker, payload=None):
    """The process's pid, device, launch counts of the port's kernels and
    the card's peak allocated memory (0 on the CPU)."""
    import torch

    from areal_tpu_torch.kernels import (
        decode_attention as da,
        flash_attention as fa,
        paged_chunk_attention as pca,
        ragged_paged_attention as rpa,
    )

    dev = worker.device
    on_card = dev.type == "cuda"
    return {
        "pid": os.getpid(),
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "launches": dict(fa.LAUNCHES, k4=da.LAUNCHES, k2=rpa.LAUNCHES, k3=pca.LAUNCHES),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev) if on_card else 0,
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="areal_tpu_torch.apps.worker")
    p.add_argument("--config", required=True, help="plan directory")
    p.add_argument("--index", type=int, required=True)
    p.add_argument("--experiment", required=True)
    p.add_argument("--trial", required=True)
    p.add_argument("--device", default="cuda", help="torch device the models live on")
    p.add_argument("--rendezvous", default="",
                   help="the launch attempt's tag of the worker group's rendezvous key")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format=f"%(asctime)s worker{args.index} %(name)s: %(message)s")
    logger = logging.getLogger(f"areal_tpu_torch.worker{args.index}")

    from areal_tpu_torch.base import metrics, seeding, tracer
    from areal_tpu_torch.base.device import resolve_device
    from areal_tpu_torch.system.stream import run_worker_stream
    from areal_tpu_torch.system.transfer import ConnTransfer
    from areal_tpu_torch.system.worker import ModelWorker
    from areal_tpu_torch.system.worker_control import WorkerServer, WorkerState

    device = resolve_device(args.device)  # raises without a card
    # Shard trace_worker_<index>.jsonl in AREAL_TRACE_DIR (the launcher
    # exports it when tracing is on).
    tracer.configure(role="worker", rank=args.index)
    metrics_server = metrics.MetricsServer(
        announce=(args.experiment, args.trial, f"model_worker/{args.index}")
    )
    with open(os.path.join(args.config, f"worker_{args.index}.pkl"), "rb") as f:
        config = pickle.load(f)
    # The ranks of a group seed alike (ModelWorker._setup does too).
    seeding.set_random_seed(config.seed, config.worker_index - config.dist_process_id)
    if config.dist_num_processes > 0:
        # A member of an SPMD worker group: one rank of the group's world,
        # NCCL on its own card (cuda:<rank>), gloo on the CPU; the models'
        # device is resolved after `set_device`.
        from areal_tpu_torch.base import distributed

        distributed.initialize(
            args.experiment, args.trial, config.dist_process_id, config.dist_num_processes,
            device=device, timeout=config.dist_timeout_s or 300.0, rendezvous=args.rendezvous,
        )
        if device.type == "cuda":
            import torch

            device = torch.device("cuda", torch.cuda.current_device())
    control = WorkerServer(args.experiment, args.trial, f"model_worker/{args.index}")
    transfer = ConnTransfer(args.experiment, args.trial, args.index)
    try:
        worker = ModelWorker(config, device=device, transfer=transfer)
        control.register_handler("runtime_stats", lambda payload: runtime_stats(worker, payload))
        control.state = WorkerState.RUNNING
        logger.info(f"worker {args.index} ready on {device}, serving the stream")
        run_worker_stream(worker, args.experiment, args.trial, control=control)
    finally:
        tracer.flush()
        transfer.close()
        control.stop()
        metrics_server.close()
        if config.dist_num_processes > 0:
            from areal_tpu_torch.base import distributed

            distributed.shutdown()
    logger.info(f"worker {args.index} exiting")


if __name__ == "__main__":
    main()
