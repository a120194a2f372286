"""Model worker (port of areal_tpu/system/worker.py, the in-process half):
owns the model bundles (engine + interface + tokenizer), a data cache
keyed by data id, and the dataset loaders, and executes the master's
requests.

One worker holds every model of a trial on one device: `device` (the
CUDA card unless told otherwise) is where each engine is built.  The
requests the synchronous PPO step sends are handled: `spec`, `fetch`
(topped up to a full batch when the loader's comes up short), `mfc`,
`param_sync` (a copy, or with eta < 1 the EMA of the reference model),
`save`, `offload`, `clear_cache` and `ping`; so are the difficulty
filter's `data_accuracy` and `filter_dataset`, and the worker half of
recovery: `model_versions`/`set_model_versions`, `save_optimizer`,
`load_model`, `data_state`/`load_data_state` (each loader's resumable
(epoch, cursor) position, `_Cycler`) and
`interface_state`/`load_interface_state`.  The cross-worker planes
(data and param transfers) and the streamed train requests are not yet
ported (ROADMAP queue 1, items 6 and 7).

The master runs each MFC in a thread of its own (`InProcessPool`), so
two MFCs may run at once (the reward and the reference model's forward,
say).  Grad mode is per thread in torch, and each engine sets it itself;
the current CUDA device is per thread too, so every request runs under
`torch.cuda.device(self.device)`.  The kernels' launch counters are
counted under a lock (`kernels/build.count_launch`).  Generator weights
are never shared with the trainer (`GeneratorEngine.set_params` copies),
so unlike the JAX package there is no aliased generator to release
before a train step.
"""

import contextlib
import dataclasses
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from areal_tpu_torch.api.config import (
    ModelAbstraction,
    ModelBackendAbstraction,
    ModelInterfaceAbstraction,
    ModelInterfaceType,
    ModelName,
)
from areal_tpu_torch.api.data_api import (
    DatasetAbstraction,
    MicroBatchSpec,
    SequenceSample,
    make_dataset,
)
from areal_tpu_torch.api.model_api import FinetuneSpec, Model, OptimizerConfig, make_interface
from areal_tpu_torch.base import monitor, seeding
from areal_tpu_torch.base.device import resolve_device
from areal_tpu_torch.data.datasets import PackedDataLoader
from areal_tpu_torch.data.tokenizer import load_hf_tokenizer

# Populate the dataset and interface registries.
import areal_tpu_torch.interfaces.ppo  # noqa: F401
import areal_tpu_torch.interfaces.reward  # noqa: F401

logger = logging.getLogger("areal_tpu_torch.model_worker")


@dataclasses.dataclass
class ModelShardSpec:
    """Everything needed to build one named model on this worker."""

    name: ModelName
    model: ModelAbstraction  # random | hf | null
    backend: ModelBackendAbstraction  # train | inference | generator | null
    interface: ModelInterfaceAbstraction
    optimizer: Optional[OptimizerConfig] = None


@dataclasses.dataclass
class WorkerConfig:
    worker_index: int
    shards: List[ModelShardSpec]
    tokenizer_path: Optional[str] = None
    datasets: List[DatasetAbstraction] = dataclasses.field(default_factory=list)
    batch_size: int = 8
    seed: int = 1
    ftspec: FinetuneSpec = dataclasses.field(default_factory=FinetuneSpec)


def _build_params_and_config(spec: ModelAbstraction, seed: int, device: torch.device):
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.hf import registry as hf

    if spec.type_ == "null":
        return None, None  # engine-less models (the reward)
    if spec.type_ == "random":
        cfg = spec.args["config"]
        return cfg, tfm.init_params(cfg, seed, device=device)
    if spec.type_ == "hf":
        return hf.load_hf_checkpoint(
            spec.args["path"], is_critic=spec.args.get("is_critic", False), device=device,
        )
    raise ValueError(f"unknown model abstraction {spec.type_!r}")


def _build_engine(shard: ModelShardSpec, cfg, params, device, config: WorkerConfig, tokenizer):
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.engines.inference import InferenceEngine
    from areal_tpu_torch.engines.train import TrainEngine

    btype, args = shard.backend.type_, shard.backend.args
    if btype == "train":
        return TrainEngine(
            cfg, params, device, optimizer_config=shard.optimizer or OptimizerConfig(),
            ftspec=config.ftspec, **args,
        )
    if btype == "inference":
        return InferenceEngine(cfg, params, device, **args)
    if btype == "generator":
        return GeneratorEngine(
            cfg, params, device, eos_token_id=tokenizer.eos_token_id,
            pad_token_id=getattr(tokenizer, "pad_token_id", None), **args,
        )
    if btype == "null":
        return None
    raise NotImplementedError(
        f"backend {btype!r} is not ported (remote generators: ROADMAP queue 1, item 7)"
    )


def ema_mix(a: torch.Tensor, b: torch.Tensor, eta: float) -> torch.Tensor:
    """`eta * a + (1 - eta) * b` as the JAX package computes it on a
    leaf: each Python-float coefficient takes the dtype of the leaf it
    scales (JAX's weak typing: `1 - eta` is rounded to bf16 before it
    scales a bf16 ref leaf, whose product stays bf16), the sum is in the
    wider dtype (fp32), and the result is cast to b's dtype, as
    `set_params` would.  Not `torch.lerp`, which rounds differently."""
    scaled = torch.tensor(1 - eta, dtype=b.dtype) * b
    return (torch.tensor(eta, dtype=a.dtype) * a + scaled).to(b.dtype)


class _Cycler:
    """Endless epoch iterator over a PackedDataLoader, with a resumable
    (epoch, cursor) position: shuffling is seeded per epoch, so replaying
    `cursor` batches restores the exact data stream."""

    def __init__(self, loader):
        self.loader = loader
        self.epoch = 0
        self.cursor = 0  # batches already yielded in the current epoch
        self._it = None

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._it is None:
                self._it = iter(self.loader)
            try:
                batch = next(self._it)
                self.cursor += 1
                return batch
            except StopIteration:
                self._it = None
                self.epoch += 1
                self.cursor = 0

    def state_dict(self):
        return {"epoch": self.epoch, "cursor": self.cursor}

    def load_state_dict(self, state):
        self.epoch = int(state["epoch"])
        self.cursor = 0
        # PackedDataLoader advances its epoch on each __iter__: align it,
        # then replay the batches already consumed in this epoch.
        self.loader._epoch = self.epoch
        self._it = None
        for _ in range(int(state["cursor"])):
            next(self)


class ModelWorker:
    def __init__(self, config: WorkerConfig, tokenizer=None, device=None):
        self.config = config
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        self.models: Dict[str, Model] = {}
        self.interfaces: Dict[str, Any] = {}
        self.data_cache: Dict[str, SequenceSample] = {}
        # MFCs in two threads read and amend the cache's entries at once.
        self._cache_lock = threading.Lock()
        self.datasets = []
        self.dataloaders = []
        self._setup()

    def _on_device(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ---------------- setup ----------------

    def _setup(self):
        seeding.set_random_seed(self.config.seed, self.config.worker_index)
        if self.tokenizer is None and self.config.tokenizer_path:
            self.tokenizer = load_hf_tokenizer(self.config.tokenizer_path)
        with self._on_device():
            for shard in self.config.shards:
                cfg, params = _build_params_and_config(shard.model, self.config.seed, self.device)
                engine = _build_engine(shard, cfg, params, self.device, self.config, self.tokenizer)
                del params  # the engine holds its own copy
                key = str(shard.name)
                self.models[key] = Model(name=key, engine=engine, tokenizer=self.tokenizer,
                                         config=cfg)
                self.interfaces[key] = make_interface(shard.interface.type_, **shard.interface.args)
                logger.info(f"worker {self.config.worker_index}: built model {key} "
                            f"({shard.backend.type_} on {self.device})")
        for ds_spec in self.config.datasets:
            ds = make_dataset(ds_spec, seed=self.config.seed, dp_rank=0, world_size=1,
                              tokenizer=self.tokenizer)
            self.datasets.append(ds)
            self.dataloaders.append(_Cycler(
                PackedDataLoader(ds, batch_size=self.config.batch_size, seed=self.config.seed)
            ))

    # ---------------- request handling ----------------

    def handle_request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        handler = getattr(self, f"_handle_{req['type']}", None)
        if handler is None:
            raise ValueError(f"unknown request type {req['type']!r}")
        with self._on_device():
            return handler(req)

    def _handle_spec(self, req):
        sizes = [len(ds) for ds in self.datasets]
        bs = self.config.batch_size
        return {"dataset_size": sum(sizes), "steps_per_epoch": (sum(sizes) + bs - 1) // bs}

    def _handle_fetch(self, req):
        """Load the next dataset batch into the cache; return its metadata.
        A batch comes up short at an epoch's end (a dataset whose size is
        not a multiple of the batch size) or after the difficulty filter
        shrank the dataset: top it up from the stream so the master's
        buffer, which waits for exactly n_seqs, never stalls."""
        dl_idx = req.get("dataset_index", 0)
        dl = self.dataloaders[dl_idx]
        singles: List[SequenceSample] = []
        have = set()
        attempts = 0
        while len(singles) < self.config.batch_size:
            if attempts > 16:
                raise RuntimeError(
                    f"dataset {dl_idx} cannot fill a batch of "
                    f"{self.config.batch_size} (filtered too far?)"
                )
            attempts += 1
            for one in next(dl).unpack():
                # A top-up can repeat ids (an epoch wrap on a shrunken
                # dataset); the cache and the buffer are keyed by id.
                if one.ids[0] not in have:
                    have.add(one.ids[0])
                    singles.append(one)
        batch = SequenceSample.gather(singles)
        with self._cache_lock:
            for one in batch.unpack():
                self.data_cache[one.ids[0]] = one
        return {"meta": batch.meta()}

    def _assemble_sample(self, ids, input_keys, remap_in) -> SequenceSample:
        parts = []
        with self._cache_lock:
            for sid in ids:
                entry = self.data_cache.get(sid)
                have = input_keys & entry.keys if entry is not None else set()
                if have != input_keys:
                    raise KeyError(
                        f"worker {self.config.worker_index}: no data for {sid!r} "
                        f"(keys {sorted(input_keys - have)})"
                    )
                parts.append(entry.select_keys(have))
        sample = SequenceSample.gather(parts)
        sample.remap_keys_(remap_in)
        return sample

    def _handle_mfc(self, req):
        """Execute one model function call on cached data."""
        model_key: str = req["model_name"]
        itype = ModelInterfaceType(req["interface_type"])
        mb_spec: MicroBatchSpec = req.get("mb_spec") or MicroBatchSpec()
        sample = self._assemble_sample(
            req["ids"], set(req["input_keys"]), req.get("input_key_remap", {})
        )
        model = self.models[model_key]
        fn = getattr(self.interfaces[model_key], itype.value)
        # The call's wall-clock mark (time/mfc_<itype>, _cnt, _avg).  One
        # Timers a call: two MFCs run at once in two threads, and a shared
        # one would hand one call's mark to the other's reply.
        timers = monitor.Timers()
        with timers.record(f"mfc_{itype.value}"):
            t0 = time.monotonic()
            # Every interface returns host data, so the call has finished
            # on the card when it returns.
            result = fn(model, sample, mb_spec)
            seconds = time.monotonic() - t0
        if itype == ModelInterfaceType.GENERATE:
            model.inc_version()  # advances the sampling seed per step
        out_sample = result if isinstance(result, SequenceSample) else None
        if out_sample is not None:
            out_sample.remap_keys_(req.get("output_key_remap", {}))
        perf = self._mfc_perf(model, itype, sample, out_sample, seconds)
        perf.update(timers.drain())
        if out_sample is None:
            return {"meta": None, "stats": {**dict(result or {}), **perf}}
        with self._cache_lock:
            for one in out_sample.unpack():
                sid = one.ids[0]
                if sid in self.data_cache:
                    self.data_cache[sid].update_(one)
                else:
                    self.data_cache[sid] = one
        return {"meta": out_sample.meta(), "stats": perf}

    def _mfc_perf(self, model, itype, sample, result, seconds: float) -> Dict[str, float]:
        """Per-MFC wall time, analytic TFLOPs, MFU (on a card with a peak
        entry) and the card's allocated memory after the call."""
        perf = {"perf/time_s": seconds}
        cfg = model.config
        if cfg is None:
            return perf
        if itype == ModelInterfaceType.GENERATE and result is not None:
            prompt_lens = [sum(s) for s in sample.seqlens[next(iter(sample.keys))]]
            out_lens = [sum(s) for s in result.seqlens["packed_input_ids"]]
            n_rep = max(len(out_lens) // max(len(prompt_lens), 1), 1)
            p_exp, g_lens = [], []
            for i, total in enumerate(out_lens):
                p = prompt_lens[i // n_rep]
                p_exp.append(p)
                g_lens.append(max(total - p, 0))
            flops = monitor.flops_generate(cfg, p_exp, g_lens)
        else:
            key = "packed_input_ids" if "packed_input_ids" in sample.keys else next(iter(sample.keys))
            lens = [sum(s) for s in sample.seqlens[key]]
            sum_sq = float(sum(n * n for n in lens))
            count = monitor.flops_train if itype == ModelInterfaceType.TRAIN_STEP else monitor.flops_forward
            flops = count(cfg, int(sum(lens)), sum_sq)
        perf["perf/tflops"] = flops / 1e12
        u = monitor.mfu(flops, seconds, self.device)
        if u is not None:
            perf["perf/mfu"] = u
        if self.device.type == "cuda":
            used = torch.cuda.memory_allocated(self.device)
            perf["perf/hbm_gb"] = used / 1e9
            perf["perf/hbm_frac"] = used / torch.cuda.get_device_properties(self.device).total_memory
        return perf

    def _handle_param_sync(self, req):
        """Copy the weights of model `src` into model `dst` (the
        generator's weight sync after a train step), or with eta < 1 move
        `dst` toward `src` (the EMA reference model, `ema_mix`), one leaf
        at a time, then `dst.set_params`."""
        src = self.models[req["src"]].engine
        dst = self.models[req["dst"]].engine
        eta = float(req.get("eta", 1.0))
        if eta >= 1.0:
            dst.set_params(src.get_params())
            return {}
        sp, dp = src.get_params(), dst.get_params()

        def mix(a, b):
            if isinstance(b, dict):
                return {k: mix(a[k], b[k]) for k in b}
            return ema_mix(a, b, eta)

        with torch.no_grad():
            mixed = mix(sp, dp)
        del sp, dp
        dst.set_params(mixed)
        return {}

    def _handle_save(self, req):
        key = req["model_name"]
        self.interfaces[key].save(self.models[key], req["save_dir"])
        return {"path": req["save_dir"]}

    # ---------------- recovery ----------------

    def _handle_load_model(self, req):
        """Restore a model's weights (fp32, as the recover checkpoint
        stores the masters) and its optimizer state from a checkpoint
        dir: the worker half of a trial's recovery."""
        from areal_tpu_torch.models.hf import registry as hf

        key = req["model_name"]
        model = self.models[key]
        _, params = hf.load_hf_checkpoint(
            req["ckpt_dir"],
            is_critic=bool(model.config is not None and model.config.is_critic),
            dtype=torch.float32,
            device=self.device,
        )
        model.engine.set_params(params)
        del params
        opt = req.get("optimizer_path")
        if opt and os.path.exists(opt) and hasattr(model.engine, "load_optimizer_state"):
            model.engine.load_optimizer_state(opt)
        return {}

    def _handle_save_optimizer(self, req):
        eng = self.models[req["model_name"]].engine
        os.makedirs(os.path.dirname(req["path"]), exist_ok=True)
        eng.save_optimizer_state(req["path"])
        return {}

    def _handle_data_state(self, req):
        return {"states": [dl.state_dict() for dl in self.dataloaders]}

    def _handle_load_data_state(self, req):
        for dl, sd in zip(self.dataloaders, req["states"]):
            dl.load_state_dict(sd)
        return {}

    def _handle_interface_state(self, req):
        """Algorithm state per model (the KL controller, the value-norm
        moments) for recover checkpoints."""
        out = {}
        for key, iface in self.interfaces.items():
            sd = iface.state_dict()
            if sd:
                out[key] = sd
        return {"states": out}

    def _handle_load_interface_state(self, req):
        for key, sd in (req.get("states") or {}).items():
            if key in self.interfaces:
                self.interfaces[key].load_state_dict(sd)
        return {}

    def _handle_model_versions(self, req):
        """Each model's weight version (the generator's is its sampling
        seed), inventoried into the recover checkpoint."""
        return {"versions": {k: int(m.version) for k, m in self.models.items()}}

    def _handle_set_model_versions(self, req):
        for k, v in (req.get("versions") or {}).items():
            if k in self.models:
                self.models[k].version = int(v)
        return {}

    # ---------------- difficulty filter ----------------

    def _handle_data_accuracy(self, req):
        """Each id's share of positive rewards over its group (the input
        to the difficulty filter)."""
        out = {}
        with self._cache_lock:
            for sid in req["ids"]:
                entry = self.data_cache.get(sid)
                if entry is None or "rewards" not in entry.keys:
                    continue
                r = np.asarray(entry.data["rewards"], np.float32)
                out[sid] = float((r > 0).mean()) if r.size else 0.0
        return {"accuracy": out}

    def _handle_filter_dataset(self, req):
        removed = 0
        for ds in self.datasets:
            removed += int(ds.filter(req["ids"]) or 0)
        return {"removed": removed}

    def _handle_offload(self, req):
        """Host-offload a model's device state (OffloadHook); the engine
        reloads it on its next call."""
        eng = self.models[req["model_name"]].engine
        if eng is not None and hasattr(eng, "offload"):
            eng.offload()
        return {}

    def _handle_clear_cache(self, req):
        keep = set(req.get("keep_ids", ()))
        with self._cache_lock:
            for sid in list(self.data_cache):
                if sid not in keep:
                    del self.data_cache[sid]
        return {}

    def _handle_ping(self, req):
        return {"pong": self.config.worker_index}
