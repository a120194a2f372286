"""The SPMD worker group over several cards, against the one-card trial:
the multi-card check of `--allocation` (ROADMAP queue 1, item 8.6a).

    python -m areal_tpu_torch.scripts.group_check [--sft d4,f4,d2m2] [--ppo d4,d2f2]
        [--layers 4] [--seed 0] [--device cuda|cpu] [--model qwen2|tiny]
        [--json PATH]

Writes a seeded random checkpoint (qwen2-1.5B's width at `--layers`
layers, fp32), then for each layout runs the quickstart's trial as the
SPMD worker group the quickstart launches for it (`build_sft` with
`n_hosts` and `parallel`, `build_ppo_math` with `actor_parallel`; one
worker process a card, NCCL; gloo with `--device cpu`) and holds it
against the same trial on one card in this process:

- sft: two steps of 8 prompt/answer rows; each step's loss and grad
  norm within STAT_RTOL, and the step-2 checkpoint (gathered, written by
  rank 0) within PARAM_ATOL of the one-card trial's.
- ppo-math: two PPO steps of 8 prompts x 4, greedy, 32 new tokens, the
  seeded null reward and a critic (a greedy group's responses are equal,
  so GRPO's advantages would cancel; the critic's carry the update), the
  ref and the critic on the group, one PPO minibatch (each member splits
  its own rows into minibatches); the generator one engine a rank over
  its own prompts.  Every generated token equal to the one-card trial's
  (each rank's outputs dumped through AREAL_MFC_DUMP_DIR), the actor's
  and the critic's stats within STAT_RTOL (+ STAT_ATOL), the actor's
  step-2 checkpoint within PARAM_ATOL.

The models compute in fp32 (masters, forwards, generation) so that the
layouts differ only by reduction order.  Each rank's K1f/K1dq/K1dkv/K4
launches (its `runtime_stats`) and each MFC's seconds a step are
printed.  One line a layout, a JSON object last; exits non-zero on any
disagreement.
"""

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

STAT_RTOL = 1e-4  # loss, grad norm, the actor's and the critic's stats (fp32)
STAT_ATOL = 1e-6  # beside STAT_RTOL, for stats near zero
PARAM_ATOL = 1e-6  # params after two AdamW steps at lr 2e-5 (fp32)
NEW_TOKENS = 32
_FAILS = []


def _check(cond, msg):
    if not cond:
        _FAILS.append(msg)
        print(f"group_check: FAILED: {msg}", flush=True)


def _rows(rng, n):
    words = "the quick brown fox jumps over lazy dog math proof integer prime sum".split()
    rows = []
    for i in range(n):
        a, b = (int(x) for x in rng.integers(1, 1000, 2))
        text = f"Compute {a} + {b}. "
        while len(text) < int(rng.integers(64, 160)):
            text += words[int(rng.integers(len(words)))] + " "
        rows.append({"query_id": f"q{i}", "id": f"s{i}", "prompt": text, "task": "math",
                     "solutions": [f"\\boxed{{{a + b}}}"], "answer": f"The sum is {a + b}."})
    return rows


def _plans(kind, layout, ckpt, data, root, vocab, seed, device):
    import torch

    from areal_tpu_torch.api.config import ModelAbstraction, ModelInterfaceAbstraction
    from areal_tpu_torch.api.data_api import DatasetAbstraction, MicroBatchSpec
    from areal_tpu_torch.api.model_api import GenerationHyperparameters, OptimizerConfig
    from areal_tpu_torch.base.topology import ParallelConfig
    from areal_tpu_torch.experiments import common as exps
    from areal_tpu_torch.system.master import ExperimentSaveEvalControl

    par = ParallelConfig.from_str(layout)
    fp32 = {"compute_dtype": torch.float32}
    ctrl = ExperimentSaveEvalControl(benchmark_steps=2, save_freq_steps=2)
    opt = OptimizerConfig(lr=2e-5, warmup_steps_proportion=0.0)
    trial = f"{kind}-{layout}"
    if kind == "sft":
        plan = exps.build_sft(exps.SFTConfig(
            model=ModelAbstraction("hf", {"path": ckpt}),
            dataset=DatasetAbstraction("prompt_answer", {"dataset_path": data}),
            n_hosts=par.world_size, parallel=par, optimizer=opt, batch_size=8,
            mb_spec=MicroBatchSpec(max_tokens_per_mb=16384), ctrl=ctrl, seed=seed,
            experiment_name="group-check", trial_name=trial, fileroot=os.path.join(root, trial),
        ))
        for wc in plan.worker_configs:
            wc.shards[0].backend.args.update(fp32)
    else:
        plan = exps.build_ppo_math(exps.PPOMathConfig(
            actor=ModelAbstraction("hf", {"path": ckpt}),
            ref=ModelAbstraction("hf", {"path": ckpt}),
            critic=ModelAbstraction("hf", {"path": ckpt, "is_critic": True}),
            dataset=DatasetAbstraction("math_code_prompt", {"dataset_path": data}),
            reward_interface=ModelInterfaceAbstraction("null", {"seed": seed + 1}),
            gconfig=GenerationHyperparameters(n=4, max_new_tokens=NEW_TOKENS, greedy=True),
            ppo_kwargs={"n_minibatches": 1, "kl_ctl": 0.0},
            gen_backend_args=dict(fp32), train_backend_args=dict(fp32),
            actor_parallel=par, critic_parallel=par, optimizer=opt, batch_size=8,
            mb_spec=MicroBatchSpec(max_tokens_per_mb=16384), ctrl=ctrl, seed=seed,
            experiment_name="group-check", trial_name=trial, fileroot=os.path.join(root, trial),
        ))
        for wc in plan.worker_configs:
            for sh in wc.shards:
                if sh.backend.type_ == "inference":
                    sh.backend.args.update(fp32)
    for wc in plan.worker_configs:
        wc.tokenizer_path = f"char:{vocab}"
    return plan


def _tokens(root):
    """Each generated sequence's tokens from the actor_gen dumps, by id."""
    import numpy as np

    out = {}
    for name in sorted(os.listdir(root)):
        if not name.startswith("actor_gen"):
            continue
        z = np.load(os.path.join(root, name))
        data, lens = z["data.packed_input_ids"], z["lens.packed_input_ids"]
        seqlens, pos, seq = z["seqlens.packed_input_ids"], 0, 0
        for sid, n in zip(z["ids"], lens):
            sl = seqlens[seq:seq + n]
            out.setdefault(str(sid), []).append(data[pos:pos + sl.sum()].copy())
            pos, seq = pos + sl.sum(), seq + n
    return out


def _params(path):
    import torch

    from areal_tpu_torch.models.hf import registry as hf
    from areal_tpu_torch.models.weights import params_to_numpy

    _, p = hf.load_hf_checkpoint(path, dtype=torch.float32, device="cpu")

    def flat(t, pre=""):
        o = {}
        for k, v in t.items():
            o.update(flat(v, f"{pre}{k}.") if isinstance(v, dict) else {pre + k: v})
        return o

    return flat(params_to_numpy(p))


def _ckpt(plan, kind):
    key = "default@0" if kind == "sft" else "actor@0"
    return os.path.join(plan.fileroot, "checkpoints", plan.experiment_name, plan.trial_name,
                        key, "step_2")


def _worker_launches(plan, seen):
    from areal_tpu_torch.system.worker_control import WorkerControlPanel

    def on_finish(master):
        panel = WorkerControlPanel(plan.experiment_name, plan.trial_name)
        names = [f"model_worker/{i}" for i in range(len(plan.worker_configs))]
        try:
            panel.connect(names, timeout=60)
            seen.update(panel.group_request("runtime_stats", timeout=120))
        finally:
            panel.close()
    return on_finish


def _mfc_seconds(stats):
    """Each step's MFC seconds by node (a one-node graph's are unprefixed)."""
    def node(k):
        return k[: -len("/perf/time_s")] if k != "perf/time_s" else "train"

    return [{node(k): round(v, 4) for k, v in s.items() if k.endswith("perf/time_s")}
            for s in stats]


def main(argv=None):
    p = argparse.ArgumentParser(prog="areal_tpu_torch.scripts.group_check")
    p.add_argument("--sft", default="d4,f4,d2m2")
    p.add_argument("--ppo", default="d4,d2f2")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--model", default="qwen2", choices=("qwen2", "tiny"))
    p.add_argument("--json", default=None, help="also write the result object here")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from areal_tpu_torch.apps import main as runner
    from areal_tpu_torch.base.device import resolve_device
    from areal_tpu_torch.models.config import qwen2_config, tiny_config
    from areal_tpu_torch.models.hf import registry as hf
    from areal_tpu_torch.models.transformer import init_params

    device = resolve_device(args.device)  # raises without a card
    layouts = [("sft", x) for x in args.sft.split(",") if x] + [
        ("ppo", x) for x in args.ppo.split(",") if x]
    cfg = tiny_config() if args.model == "tiny" else qwen2_config("1.5b", "float32")
    cfg = dataclasses.replace(cfg, n_layers=args.layers)
    card = "cpu"
    if device.type == "cuda":
        import subprocess

        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().replace("\n", "; ")
        print(f"group_check: {torch.cuda.device_count()} cards: {card}", flush=True)
        from areal_tpu_torch.kernels import build

        # Every kernel once, in parallel, before the workers load them.
        t0 = time.monotonic()
        build.build_all()
        print(f"group_check: kernels built in {time.monotonic() - t0:.1f} s", flush=True)
    root = tempfile.mkdtemp(prefix="group_check-")
    result = {"card": card, "layers": args.layers, "layouts": {}}
    try:
        ckpt = os.path.join(root, "ckpt")
        hf.save_hf_checkpoint(ckpt, cfg, init_params(cfg, args.seed, device=device),
                              model_type="qwen2")
        rows = _rows(np.random.default_rng(args.seed + 7), 64)
        data = {}
        for kind, keys in (("sft", ("id", "prompt", "answer")),
                           ("ppo", ("query_id", "prompt", "task", "solutions"))):
            data[kind] = os.path.join(root, f"{kind}.jsonl")
            with open(data[kind], "w") as f:
                for r in rows:
                    f.write(json.dumps({k: r[k] for k in keys}) + "\n")
        solo = {}
        for kind in sorted({k for k, _ in layouts}):
            plan = _plans(kind, "d1", ckpt, data[kind], root, cfg.vocab_size, args.seed, device)
            dump = os.path.join(root, f"dump-{kind}-d1")
            os.environ["AREAL_MFC_DUMP_DIR"] = dump
            t0 = time.monotonic()
            try:
                stats = runner.run_experiment_inproc(plan, device=device)
            finally:
                del os.environ["AREAL_MFC_DUMP_DIR"]
            solo[kind] = (plan, stats, dump)
            print(f"group_check: {kind} on one card: {time.monotonic() - t0:.1f} s, MFC seconds "
                  f"{_mfc_seconds(stats)}", flush=True)
        for kind, layout in layouts:
            plan = _plans(kind, layout, ckpt, data[kind], root, cfg.vocab_size, args.seed, device)
            dump = os.path.join(root, f"dump-{kind}-{layout}")
            seen = {}
            t0 = time.monotonic()
            stats = runner.run_experiment(
                plan, device=str(device), on_finish=_worker_launches(plan, seen),
                worker_env={"AREAL_MFC_DUMP_DIR": dump, "OMP_NUM_THREADS": "1"})
            wall = time.monotonic() - t0
            splan, sstats, sdump = solo[kind]
            tag = f"{kind} {layout}"
            _check(len(stats) == len(sstats) == 2, f"{tag}: {len(stats)} steps")
            keys = (["loss", "grad_norm"] if kind == "sft" else
                    [k for k in sstats[0] if k.startswith(("actor_train/", "critic_train/"))
                     and "/perf/" not in k
                     and "/time/" not in k and "n_micro_batches" not in k])
            worst = 0.0
            for i, (g, s) in enumerate(zip(stats, sstats)):
                for k in keys:
                    if abs(g[k] - s[k]) > STAT_ATOL:
                        worst = max(worst, abs(g[k] - s[k]) / abs(s[k]))
                    _check(abs(g[k] - s[k]) <= STAT_RTOL * abs(s[k]) + STAT_ATOL,
                           f"{tag} step {i + 1} {k}: {g[k]} vs one card's {s[k]}")
            got, want = _params(_ckpt(plan, kind)), _params(_ckpt(splan, kind))
            perr = max(float(np.abs(got[k] - want[k]).max()) for k in want)
            _check(sorted(got) == sorted(want) and perr <= PARAM_ATOL,
                   f"{tag}: params {perr:.3g} from the one-card trial's (tol {PARAM_ATOL})")
            row = {"steps_s": [round(s["time/step_s"], 3) for s in stats], "wall_s": round(wall, 1),
                   "stat_rel": worst, "param_abs": perr, "mfc_s": _mfc_seconds(stats),
                   "launches": {n: w["launches"] for n, w in sorted(seen.items())},
                   "devices": {n: w["device"] for n, w in sorted(seen.items())}}
            if kind == "ppo":
                toks, stoks = _tokens(dump), _tokens(sdump)
                same = sum(int(all(np.array_equal(a, b) for a, b in zip(toks[i], stoks[i])))
                           for i in stoks if i in toks)
                _check(sorted(toks) == sorted(stoks) and same == len(stoks),
                       f"{tag}: greedy tokens of {same} of {len(stoks)} prompt groups equal")
                row["token_groups_equal"] = f"{same}/{len(stoks)}"
            if device.type == "cuda":
                _check(len(set(row["devices"].values())) == len(plan.worker_configs),
                       f"{tag}: ranks share a card {row['devices']}")
            result["layouts"][tag] = row
            print(f"group_check: {tag}: {json.dumps(row)}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result["ok"] = not _FAILS
    result["failures"] = _FAILS
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0 if not _FAILS else 1


if __name__ == "__main__":
    sys.exit(main())
