"""The sharded trainer over several processes, one device each, against
the unsharded engine on rank 0's device: the multi-card check of the
port's mesh path (`base/topology`, `parallel/sharding`,
`flash_attention_sharded`, `TrainEngine(mesh=...)`).

    python -m areal_tpu_torch.scripts.mesh_check [--world 4] [--layouts d4,f4,d2m2,f2m2]
        [--device cpu] [--model tiny|qwen2] [--layers 4] [--seed 0]

Starts `--world` processes (NCCL on the CUDA cards, one card a rank;
gloo on the CPU); for each layout every rank builds the same weights,
a `DeviceMesh` and a sharded `TrainEngine` in fp32 compute, runs one
`forward` and one `train_batch` of a seeded batch, and rank 0 holds the
logprobs, loss, grad norm and params after the step against an
unsharded `TrainEngine` on its own device (fp32: the reduction orders
differ, so equal to rounding).  Each rank counts its K1 launches (on the
card) over the timed forward and train_batch, after a warm-up forward.
Prints one line a layout and a JSON object last; exits non-zero on any
disagreement.
"""

import argparse
import json
import os
import sys
import time

FWD_ATOL = 1e-4  # fp32 logprobs
STAT_RTOL = 1e-4  # loss, grad norm
PARAM_ATOL = 1e-6  # params after one AdamW step at lr 1e-5


def _batch(cfg, seed):
    import numpy as np

    from areal_tpu_torch.api.data_api import SequenceSample

    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(96, 512, 16)]
    total = sum(lens)
    mask = (rng.random(total) < 0.8).astype(np.float32)
    data = {
        "packed_input_ids": rng.integers(0, cfg.vocab_size, total).astype(np.int32),
        "adv": rng.normal(size=total).astype(np.float32),
        "loss_mask": mask,
    }
    return SequenceSample(keys=set(data), ids=[f"i{n}" for n in range(len(lens))],
                          seqlens={k: [[l] for l in lens] for k in data}, data=data)


def _loss(out, batch):
    import torch

    loss = torch.where(batch["loss_mask"] > 0, out * batch["adv"], 0.0).sum()
    return loss, {"loss_sum": loss}


def _weight(arrays):
    return float((arrays["loss_mask"] > 0).sum())


def _rank(rank, args, init_method, out_path):
    import dataclasses

    import numpy as np
    import torch

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import OptimizerConfig
    from areal_tpu_torch.base import distributed, topology
    from areal_tpu_torch.engines.train import TrainEngine, _leaves
    from areal_tpu_torch.kernels import flash_attention as fa
    from areal_tpu_torch.models.config import qwen2_config, tiny_config
    from areal_tpu_torch.models.transformer import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cpu" if args.device == "cpu" else None
    distributed.initialize("mesh_check", "run", rank, args.world, device=device,
                           init_method=init_method, timeout=300)
    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", torch.cuda.current_device())
    cfg = tiny_config() if args.model == "tiny" else qwen2_config("1.5b")
    cfg = dataclasses.replace(cfg, n_layers=args.layers)
    oc = OptimizerConfig(lr=1e-5, warmup_steps_proportion=0.0)
    mb = MicroBatchSpec(max_tokens_per_mb=2048)
    sample = _batch(cfg, args.seed + 1)
    params = init_params(cfg, args.seed, device=dev)
    ref = None
    if rank == 0:
        eng = TrainEngine(cfg, params, device=dev, optimizer_config=oc,
                          compute_dtype=torch.float32)
        eng.forward(sample, mb, lambda o, b: o, "lp")  # warm-up (first builds)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.monotonic()
        fwd = eng.forward(sample, mb, lambda o, b: o, "lp").data["lp"]
        stats = eng.train_batch(sample, mb, _loss, _weight, extra_keys=("adv", "loss_mask"))
        ref = {"fwd": fwd, "stats": stats, "s": time.monotonic() - t0,
               "params": {n: t.detach() for n, t in _leaves(eng.params)}}
        del eng
    rows = []
    for layout in args.layouts.split(","):
        mesh = topology.make_mesh(topology.ParallelConfig.from_str(layout), device=device)
        eng = TrainEngine(cfg, params, device=dev, optimizer_config=oc,
                          compute_dtype=torch.float32, mesh=mesh)
        eng.forward(sample, mb, lambda o, b: o, "lp")  # warm-up (first builds)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.monotonic()
        fwd = eng.forward(sample, mb, lambda o, b: o, "lp").data["lp"]
        stats = eng.train_batch(sample, mb, _loss, _weight, extra_keys=("adv", "loss_mask"))
        wall = time.monotonic() - t0
        launches = dict(fa.LAUNCHES)
        diffs = {}
        with torch.no_grad():
            for n, p in _leaves(eng.params):
                full = p.full_tensor()
                if rank == 0:
                    diffs[n] = float((full - ref["params"][n]).abs().max())
        row = {"layout": layout, "s": wall, "launches_rank": launches,
               "loss": stats["loss"], "grad_norm": stats["grad_norm"],
               "n_micro_batches": stats["n_micro_batches"]}
        if rank == 0:
            row.update(
                fwd_max_abs_diff=float(np.max(np.abs(fwd - ref["fwd"]))),
                loss_rel=abs(stats["loss"] - ref["stats"]["loss"]) / abs(ref["stats"]["loss"]),
                grad_norm_rel=abs(stats["grad_norm"] - ref["stats"]["grad_norm"])
                / ref["stats"]["grad_norm"],
                param_max_abs_diff=max(diffs.values()),
                unsharded_s=ref["s"],
            )
        rows.append(row)
        del eng
    with open(f"{out_path}.rank{rank}", "w") as f:
        json.dump(rows, f)
    distributed.shutdown()


def _child():
    args = argparse.Namespace(**json.loads(sys.argv[2]))
    _rank(int(sys.argv[3]), args, sys.argv[4], sys.argv[5])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--layouts", default="d4,f4,d2m2,f2m2")
    ap.add_argument("--device", default=None, help="the CUDA cards unless 'cpu'")
    ap.add_argument("--model", default="qwen2", choices=("tiny", "qwen2"))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(".mesh_check_tmp", "mesh_check"),
                    help="each rank's results go to <out>.rank<r>")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)

    import subprocess

    from areal_tpu_torch.base import network

    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < args.world:
            print(f"mesh_check: needs {args.world} CUDA cards (found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}); "
                  "pass --device cpu for gloo", file=sys.stderr)
            return 2
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    init = f"tcp://127.0.0.1:{network.find_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "areal_tpu_torch.scripts.mesh_check",
                               "--child", json.dumps(vars(args)), str(r), init, args.out],
                              env=env)
             for r in range(args.world)]
    rc = 0
    deadline = time.monotonic() + args.timeout
    for p in procs:
        try:
            rc |= p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            rc = 1
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if rc:
        print("mesh_check: a rank failed or ran past the time limit", file=sys.stderr)
        return 1
    ranks = []
    for r in range(args.world):
        with open(f"{args.out}.rank{r}") as f:
            ranks.append(json.load(f))
    failures = []
    for i, row in enumerate(ranks[0]):
        others = [rk[i] for rk in ranks[1:]]
        lockstep = all(o["loss"] == row["loss"] and o["grad_norm"] == row["grad_norm"]
                       for o in others)
        ok = (row["fwd_max_abs_diff"] <= FWD_ATOL and row["loss_rel"] <= STAT_RTOL
              and row["grad_norm_rel"] <= STAT_RTOL and row["param_max_abs_diff"] <= PARAM_ATOL
              and lockstep)
        if not ok:
            failures.append(row["layout"])
        print(f"[mesh] {row['layout']}: {row['s']:.3f} s (unsharded {row['unsharded_s']:.3f} s); "
              f"fwd max |diff| {row['fwd_max_abs_diff']:.3e} (<= {FWD_ATOL:g}), loss rel "
              f"{row['loss_rel']:.3e}, grad_norm rel {row['grad_norm_rel']:.3e} (<= "
              f"{STAT_RTOL:g}), params max |diff| {row['param_max_abs_diff']:.3e} (<= "
              f"{PARAM_ATOL:g}); every rank's stats equal: {lockstep}; K1 launches a rank "
              f"{[rk[i]['launches_rank'] for rk in ranks]}", flush=True)
    print(json.dumps({"world": args.world, "device": args.device or "cuda",
                      "layouts": [dict(r, launches_by_rank=[rk[i]["launches_rank"] for rk in ranks])
                                  for i, r in enumerate(ranks[0])],
                      "ok": not failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        _child()
    else:
        raise SystemExit(main())
