"""Run the port over a `torch.distributed` gloo world of CPU processes,
for the tests of the sharded trainer (`tests/test_torch_sharding.py`,
`tests/test_torch_sharded_multiprocess.py`).

`run_spmd(body, world, workdir, args)` starts `world` processes of this
file, each rank running the child body `body` (a function below; it
imports torch and the port, never JAX) over a mesh whose rendezvous is a
file in `workdir`, and returns each rank's results (a dict of numpy
arrays).  Every child has a time limit, after which it dumps its
threads' stacks to its log and exits, so a hang fails one test and says
where each rank waited; the first rank to fail ends the run.  Each child
makes several checks, so a test pays a few interpreter start-ups.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LENS = [40, 60, 30, 50, 70, 20, 45, 35]
MB_TOKENS = 128


def sample_arrays(vocab: int, seed: int = 0):
    """The packed data every side builds its SequenceSample from."""
    rng = np.random.default_rng(seed)
    total = sum(LENS)
    mask = (rng.random(total) < 0.8).astype(np.float32)
    mask[np.cumsum([0] + LENS[:-1])] = 1.0
    return {
        "packed_input_ids": rng.integers(0, vocab, total).astype(np.int32),
        "adv": rng.normal(size=total).astype(np.float32),
        "ret": rng.normal(size=total).astype(np.float32),
        "x": rng.normal(size=total).astype(np.float32),
        "loss_mask": mask,
    }


def make_sample(data_api, arrays, keys, shard_of=None):
    keys = tuple(keys)
    meta = {"shard_of": shard_of} if shard_of is not None else {}
    return data_api.SequenceSample(
        keys=set(keys), ids=[f"i{n}" for n in range(len(LENS))],
        seqlens={k: [[l] for l in LENS] for k in keys},
        data={k: arrays[k].copy() for k in keys}, metadata=meta,
    )


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat):
    tree = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def run_spmd(body: str, world: int, workdir, args: dict, timeout: float = 240.0):
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "args.json"), "w") as f:
        json.dump(args, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST")}
    # A child that outlives the limit dumps every thread's stack and exits
    # (faulthandler), so a hang names where each rank waits.
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=_REPO, SPMD_CHILD_TIMEOUT=str(timeout - 15))
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), body, str(r), str(world), workdir],
                env=env, cwd=_REPO, stdout=out, stderr=subprocess.STDOUT,
            ))
    deadline = time.monotonic() + timeout
    try:
        # Wait on every rank at once: the first that fails ends the run,
        # so the others are not left waiting on it in a collective.
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(c != 0 for c in codes):
        tails = []
        for r, path in enumerate(logs):
            with open(path, "rb") as f:
                log = f.read().decode(errors="replace")[-6000:]
            tails.append(f"rank {r} exit {codes[r]}:\n{log}")
        raise AssertionError(f"{body} over {world} ranks failed:\n" + "\n---\n".join(tails))
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(world)]


# ------------------------------ child side ------------------------------


def _world(rank: int, world: int, workdir: str, layout: str):
    import torch

    from areal_tpu_torch.base import distributed, topology

    torch.set_num_threads(1)
    distributed.initialize("spmd", "test", rank, world, device="cpu",
                           init_method="file://" + os.path.join(workdir, "rendezvous"))
    return topology.make_mesh(topology.ParallelConfig.from_str(layout), device="cpu")


def _load_params(path):
    from areal_tpu_torch.models.weights import params_from_numpy

    return params_from_numpy(unflatten(dict(np.load(path))), device="cpu")


def _actor_loss(out, batch):
    import torch

    loss = torch.where(batch["loss_mask"] > 0, out * batch["adv"], 0.0).sum()
    return loss, {"loss_sum": loss}


def _critic_loss(values, batch):
    import torch

    loss = 0.5 * torch.where(batch["loss_mask"] > 0, (values - batch["ret"]) ** 2, 0.0).sum()
    return loss, {"value_loss_sum": loss}


def _weight(arrays):
    return float((arrays["loss_mask"] > 0).sum())


def body_layout(rank, world, workdir, args):
    """One layout: placements, the carry-over round trip, the actor's
    forward and train_batch, the critic's, masked_moments, refusals."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor

    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api import data_api
    from areal_tpu_torch.api.model_api import OptimizerConfig
    from areal_tpu_torch.base.topology import mesh_sizes
    from areal_tpu_torch.engines.inference import InferenceEngine
    from areal_tpu_torch.engines.train import TrainEngine, _leaves
    from areal_tpu_torch.kernels.flash_attention import flash_attention_sharded
    from areal_tpu_torch.models.config import tiny_config
    from areal_tpu_torch.models.weights import params_from_numpy, params_to_numpy
    from areal_tpu_torch.parallel import sharding

    mesh = _world(rank, world, workdir, args["layout"])
    sizes = mesh_sizes(mesh)
    out = {}
    opt = OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0)
    arrays = sample_arrays(tiny_config().vocab_size)
    mb = MicroBatchSpec(max_tokens_per_mb=MB_TOKENS)
    for role, cfg, loss_fn, keys in (
        ("actor", tiny_config(), _actor_loss, ("adv", "loss_mask")),
        ("critic", tiny_config(is_critic=True), _critic_loss, ("ret", "loss_mask")),
    ):
        host = dict(np.load(os.path.join(workdir, f"{role}.npz")))
        eng = TrainEngine(cfg, _load_params(os.path.join(workdir, f"{role}.npz")), device="cpu",
                          mesh=mesh, optimizer_config=opt)
        # Every leaf has its rule's placement, and the shard shapes follow.
        for name, p in _leaves(eng.params):
            want = args["expect"].get(name.split(".")[-1], {})
            got = {a: pl.dim for a, pl in zip(mesh.mesh_dim_names, p.placements) if pl.is_shard()}
            assert isinstance(p, DTensor), name
            assert got == {a: d for a, d in want.items() if sizes[a] > 1}, (name, got, want)
            local = list(p.shape)
            for a, d in got.items():
                local[d] //= sizes[a]
            assert list(p.to_local().shape) == local, (name, p.to_local().shape, local)
        # The carry-over: the numpy tree placed by the rules on the mesh,
        # and params_to_numpy of a sharded tree, are the input bit for bit.
        placed = params_from_numpy(unflatten(host), device="cpu", mesh=mesh)
        for tree in (placed, eng.get_params()):
            back = flatten(params_to_numpy(tree))
            assert all(np.array_equal(back[k], host[k]) for k in host), role
        assert {n: t.placements for n, t in _leaves(placed)} == {
            n: t.placements for n, t in _leaves(eng.params)}
        sample = make_sample(data_api, arrays, ("packed_input_ids",) + keys)
        fwd = eng.forward(sample, mb, lambda o, b: o, "out")
        stats = eng.train_batch(sample, mb, loss_fn, _weight, extra_keys=keys)
        out[f"{role}.fwd"] = np.asarray(fwd.data["out"])
        out[f"{role}.loss"] = np.asarray(stats["loss"])
        out[f"{role}.grad_norm"] = np.asarray(stats["grad_norm"])
        out[f"{role}.n_micro_batches"] = np.asarray(stats["n_micro_batches"])
        for k, v in flatten(params_to_numpy(eng.get_params())).items():
            out[f"{role}.after.{k}"] = v
        if role == "actor":
            # The optimizer state saved after the step (every rank calls
            # the save, rank 0 writes) and loaded into a fresh engine on
            # the mesh: each rank's mu/nu shards bit for bit.
            path = os.path.join(workdir, "opt.safetensors")
            eng.save_optimizer_state(path)
            torch.distributed.barrier()
            loaded = TrainEngine(cfg, _load_params(os.path.join(workdir, "actor.npz")),
                                 device="cpu", mesh=mesh, optimizer_config=opt)
            loaded.load_optimizer_state(path)
            out["opt_round_trip"] = np.asarray(loaded.opt_count == eng.opt_count == 1 and all(
                isinstance(b, DTensor) and b.placements == a.placements
                and torch.equal(b.to_local(), a.to_local())
                for tree_a, tree_b in ((eng._mu, loaded._mu), (eng._nu, loaded._nu))
                for (_, a), (_, b) in zip(_leaves(tree_a), _leaves(tree_b))))
            # Offload keeps each rank's shards; the reloaded engine gives
            # the same forward.  An InferenceEngine on the mesh gives it
            # too, from the same weights.
            before = eng.forward(sample, mb, lambda o, b: o, "out").data["out"]
            eng.offload()
            assert eng.params is None
            again = eng.forward(sample, mb, lambda o, b: o, "out").data["out"]
            out["offload_round_trip"] = np.asarray(
                np.array_equal(before, again)
                and all(isinstance(p, DTensor) for _, p in _leaves(eng.params)))
            inf = InferenceEngine(cfg, _load_params(os.path.join(workdir, "actor.npz")),
                                  device="cpu", mesh=mesh)
            out["inference.fwd"] = np.asarray(inf.forward(sample, mb, lambda o, b: o,
                                                          "out").data["out"])
            # The streamed step on the mesh: two chunks, one optimizer step,
            # against train_batch from the same weights.
            fresh = TrainEngine(cfg, _load_params(os.path.join(workdir, "actor.npz")),
                                device="cpu", mesh=mesh, optimizer_config=opt)
            state = fresh.train_stream_begin()
            half = sample.bs // 2
            for idx in (list(range(half)), list(range(half, sample.bs))):
                fresh.train_stream_chunk(state, sample.select_idx(idx), mb, loss_fn, _weight,
                                         extra_keys=keys)
            streamed = fresh.train_stream_end(state)
            out["stream.loss"] = np.asarray(streamed["loss"])
            out["stream.grad_norm"] = np.asarray(streamed["grad_norm"])
            mom = eng.masked_moments(make_sample(data_api, arrays, ("packed_input_ids", "x",
                                                                    "loss_mask")),
                                     MicroBatchSpec(), ("x",))
            out["moments.count"] = np.asarray(mom["count"])
            out["moments.x"] = mom["x"]
    # Refusals: a model axis that does not divide both head counts, and
    # MoE on any mesh.
    narrow = dataclasses.replace(tiny_config(), n_kv_heads=1)
    try:
        sharding.attn_dispatch(mesh, narrow)
        out["refused.heads"] = np.asarray(sizes["model"] == 1)
    except ValueError as e:
        out["refused.heads"] = np.asarray("model axis" in str(e) and sizes["model"] > 1)
    try:
        TrainEngine(tiny_config(n_experts=4), params_from_numpy(
            unflatten(dict(np.load(os.path.join(workdir, "actor.npz")))), device="cpu"),
            device="cpu", mesh=mesh)
        out["refused.moe"] = np.asarray(False)
    except NotImplementedError as e:
        out["refused.moe"] = np.asarray("item 8.7" in str(e))
    if sizes["model"] > 1:
        from areal_tpu_torch.parallel.sharding import rows_dtensor

        q = rows_dtensor(torch.zeros(2, 128, 3, 16), mesh)
        kv = rows_dtensor(torch.zeros(2, 128, 1, 16), mesh)
        seg = rows_dtensor(torch.ones(2, 128, dtype=torch.int32), mesh)
        try:
            flash_attention_sharded(q, kv, kv, seg, mesh)
            out["refused.flash"] = np.asarray(False)
        except ValueError as e:
            out["refused.flash"] = np.asarray("must divide" in str(e))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


def body_sharded_plane(rank, world, workdir, args):
    """The sharded data plane with divergent host rows: each member's
    per-token arrays are real only for the rows it owns (zero-filled
    elsewhere, tagged `shard_of`), against the full data on every member:
    masked_moments and one train_batch."""
    from areal_tpu_torch.api import data_api
    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import OptimizerConfig
    from areal_tpu_torch.base.topology import local_batch_shard
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.models.config import tiny_config

    mesh = _world(rank, world, workdir, args["layout"])
    shard, n = local_batch_shard(mesh)
    arrays = sample_arrays(tiny_config().vocab_size, seed=7)
    owner = [i % n for i in range(len(LENS))]
    keys = ("packed_input_ids", "x", "adv", "loss_mask")
    if args["sharded"]:
        bounds = np.cumsum([0] + LENS)
        for i, o in enumerate(owner):
            if o != shard:
                for k in ("packed_input_ids", "x", "adv"):
                    arrays[k][bounds[i]: bounds[i + 1]] = 0
    sample = make_sample(data_api, arrays, keys, shard_of=[[o, n] for o in owner])
    eng = TrainEngine(tiny_config(), _load_params(os.path.join(workdir, "actor.npz")),
                      device="cpu", mesh=mesh,
                      optimizer_config=OptimizerConfig(lr=1e-3, warmup_steps_proportion=0.0))
    mom = eng.masked_moments(sample, MicroBatchSpec(), ("x",))
    stats = eng.train_batch(sample.select_keys({"packed_input_ids", "adv", "loss_mask"}),
                            MicroBatchSpec(max_tokens_per_mb=MB_TOKENS), _actor_loss, _weight,
                            extra_keys=("adv", "loss_mask"))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), count=mom["count"], x=mom["x"],
             loss=stats["loss"], grad_norm=stats["grad_norm"], shard=shard)


def ppo_rollout(data_api, n_ids=4, group=2, seed=23):
    """A post-rollout PPO batch (the JAX package's multiprocess case)."""
    rng = np.random.default_rng(seed)
    seqlens = [[12, 14] for _ in range(n_ids)]
    flat = [l for row in seqlens for l in row]
    total, n_seqs = sum(flat), n_ids * group
    pmask = np.zeros(total, bool)
    off = 0
    for l in flat:
        pmask[off: off + 4] = True
        off += l
    data = {
        "packed_input_ids": rng.integers(1, 64, total).astype(np.int32),
        "prompt_mask": pmask,
        "packed_logprobs": rng.normal(-1, 0.2, total - n_seqs).astype(np.float32),
        "packed_ref_logprobs": rng.normal(-1.1, 0.2, total - n_seqs).astype(np.float32),
        "rewards": rng.choice([-1.0, 1.0], n_seqs).astype(np.float32),
        "seq_no_eos_mask": np.zeros(n_seqs, np.float32),
    }
    return data_api.SequenceSample(
        keys=set(data), ids=[f"q{i}" for i in range(n_ids)],
        seqlens={
            "packed_input_ids": [list(r) for r in seqlens],
            "prompt_mask": [list(r) for r in seqlens],
            "packed_logprobs": [[l - 1 for l in r] for r in seqlens],
            "packed_ref_logprobs": [[l - 1 for l in r] for r in seqlens],
            "rewards": [[1] * group] * n_ids,
            "seq_no_eos_mask": [[1] * group] * n_ids,
        },
        data=data,
    )


def body_ppo(rank, world, workdir, args):
    """The full PPO actor (adaptive KL, KL-in-reward, batch adv_norm)
    over the mesh, with each member's heavy per-token inputs zero-filled
    for the rows it does not own, or the full data on every member."""
    from areal_tpu_torch.api import data_api
    from areal_tpu_torch.api.data_api import MicroBatchSpec
    from areal_tpu_torch.api.model_api import (FinetuneSpec, GenerationHyperparameters, Model,
                                               OptimizerConfig)
    from areal_tpu_torch.base.topology import local_batch_shard
    from areal_tpu_torch.engines.train import TrainEngine
    from areal_tpu_torch.interfaces.ppo import PPOActorInterface
    from areal_tpu_torch.models.config import tiny_config

    mesh = _world(rank, world, workdir, args["layout"])
    shard, n = local_batch_shard(mesh)
    sample = ppo_rollout(data_api)
    sample.metadata["shard_of"] = [[i % n, n] for i in range(sample.bs)]
    if args["sharded"]:
        for i in range(sample.bs):
            if i % n == shard:
                continue
            for k in ("packed_input_ids", "packed_logprobs", "packed_ref_logprobs"):
                b = sample.cu_seqlens(k)
                s0 = sum(len(g) for g in sample.seqlens[k][:i])
                sample.data[k][b[s0]: b[s0 + len(sample.seqlens[k][i])]] = 0
    cfg = tiny_config()
    engine = TrainEngine(cfg, _load_params(os.path.join(workdir, "actor.npz")), device="cpu",
                         mesh=mesh, ftspec=FinetuneSpec(1, 8, 8),
                         optimizer_config=OptimizerConfig(lr=1e-4, warmup_steps_proportion=0.0))
    iface = PPOActorInterface(
        gconfig=GenerationHyperparameters(n=2, max_new_tokens=8), n_minibatches=1,
        kl_ctl=0.1, kl_adaptive=True, adaptive_kl_target=4.0, adaptive_kl_horizon=100.0,
        adv_norm=True, disable_value=True,
    )
    stats = iface.train_step(Model("actor", engine=engine, tokenizer=None, config=cfg),
                             sample, MicroBatchSpec())
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), loss=stats["actor_loss"],
             ref_kl=stats["ref_kl"], adv_abs=stats["advantage_abs"],
             kl_after=iface._kl_ctl.value, shard=shard)


def body_place_rows(rank, world, workdir, args):
    """`place_rows` and `replicate` on one layout: a [B, 3] host batch
    (every rank holds it alike) placed as batch-sharded rows, and a tree
    of a plain leaf and a row-sharded DTensor leaf replicated."""
    import torch

    from areal_tpu_torch.parallel import sharding as shd

    mesh = _world(rank, world, workdir, args["layout"])
    value = np.arange(args["rows"] * 3, dtype=np.float32).reshape(args["rows"], 3)
    rows = shd.place_rows(mesh, value, "cpu")
    tree = {"plain": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"rows": shd.rows_dtensor(torch.from_numpy(
                shd.local_rows(mesh, value)), mesh)}}
    rep = shd.replicate(tree, mesh)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"),
             local=rows.to_local().numpy(), full=rows.full_tensor().numpy(),
             rep_plain=rep["plain"].to_local().numpy(),
             rep_rows=rep["nested"]["rows"].to_local().numpy(),
             rep_replicated=np.asarray([p.is_replicate() for p in rep["nested"]["rows"].placements]
                                       + [p.is_replicate() for p in rep["plain"].placements]))


if __name__ == "__main__":
    import faulthandler

    _body, _rank, _world_size, _dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, _REPO)
    faulthandler.dump_traceback_later(float(os.environ.get("SPMD_CHILD_TIMEOUT", "225")),
                                      exit=True)
    with open(os.path.join(_dir, "args.json")) as _f:
        _args = json.load(_f)
    try:
        globals()[f"body_{_body}"](_rank, _world_size, _dir, _args)
    finally:
        from areal_tpu_torch.base import distributed

        distributed.shutdown()
