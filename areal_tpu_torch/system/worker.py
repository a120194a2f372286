"""Model worker (port of areal_tpu/system/worker.py): owns the model
bundles (engine + interface + tokenizer), a data cache keyed by data
id, and the dataset loaders, and executes the master's requests.

A worker holds the models the plan places on it, on one device:
`device` (the CUDA card unless told otherwise) is where each engine is
built.  The requests the synchronous PPO step sends are handled: `spec`,
`fetch` (topped up to a full batch when the loader's comes up short),
`mfc`, `param_sync` (a copy, or with eta < 1 the EMA of the reference
model), `save`, `offload`, `clear_cache` and `ping`; so are the
difficulty filter's `data_accuracy` and `filter_dataset`, and the worker
half of recovery: `model_versions`/`set_model_versions`,
`save_optimizer`, `load_model`, `data_state`/`load_data_state` (each
loader's resumable (epoch, cursor) position, `_Cycler`),
`interface_state`/`load_interface_state` and `train_stream_abort`.  The
master's pipeline-overlapped step trains through `mfc_stream_begin`
(the interface's stream state), `mfc_stream_chunk` (one retired chunk's
gradients) and `mfc_stream_end` (the one optimizer step; its perf counts
the chunks' busy seconds, not the wall between begin and end).  A
"remote_generator" backend (`system/gen_server.RemoteGeneratorEngine`,
over a "config" model abstraction: a config and no weights) generates on
remote generation servers, and `param_sync` into it pushes the weights
there.

The cross-worker half, over the worker's `transfer` plane
(`system/transfer.py`): `data_send`/`data_recv` move cached entries to
another worker, `param_send`/`param_recv` push a model's weights (fp32
on the host, checksummed, serialized once while they are unchanged; the
receiver verifies before it swaps, or with eta < 1 mixes with
`ema_mix`).  A transfer's receive side takes its payload by xfer id
(`_recv_xfer`: one thread drains the plane at a time, and what arrives
for another request waits in a stash).  With `AREAL_FAULTS` set, each
MFC passes its fault point first (`_fire_faults`): a point-scoped kill
dumps the flight ring and exits the process with status 43; a
``corrupt_push@point=weight_push`` poisons one `param_send`, which the
receiver's checksum refuses.

A member of an SPMD worker group (`WorkerConfig.dist_num_processes`,
its rank `dist_process_id`) builds each shard whose `parallel` is set
on a DeviceMesh over the group's world (`apps/worker.py` formed it), and
seeds as the group's first worker, so every member starts from the same
weights.  `shard_info` reports the rows it places
(`api/model_api.data_shard_info`); an MFC shipped shard-exactly
(`shard_of`, `shard_meta`) zero-fills the rows other members place
(`_assemble_sample`).  Weight syncs, pushes and saves from a meshed
model gather its leaves over the group first (`whole_params`, a
collective every member runs); rank 0 alone writes a checkpoint.
With ``AREAL_MFC_DUMP_DIR`` set, each MFC's outputs are written there
(`_dump_outputs`), to hold one layout's rows against another's.

Each MFC is a ``mfc:<model>:<type>`` compute span (`base/tracer.py`)
carrying its tokens, TFLOPs and MFU; the call returns host data, so the
span ends where the card's work has finished.  The streamed step's
chunks and optimizer step are ``mfc:<model>:train_chunk`` and
``mfc:<model>:train_step`` spans.  The same calls feed the worker's
series of the metrics plane (`base/metrics.py`), labelled
``<model>:<type>``: ``areal_worker_mfc_seconds`` (a histogram of the
call's wall time), ``areal_worker_mfc_tokens_total`` and, where the call
has an MFU (on the card), ``areal_worker_mfc_mfu_ratio``.

The master runs each MFC in a thread of its own (`InProcessPool`), so
two MFCs may run at once (the reward and the reference model's forward,
say); over the process transport the transfers run on threads of their
own (`system/stream.py`).  Grad mode is per thread in torch, and each
engine sets it itself; the current CUDA device is per thread too, so
every request runs under `torch.cuda.device(self.device)`.  The kernels'
launch counters are counted under a lock (`kernels/build.count_launch`).
Generator weights are never shared with the trainer
(`GeneratorEngine.set_params` copies), so unlike the JAX package there
is no aliased generator to release before a train step.
"""

import contextlib
import dataclasses
import itertools
import json
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
from areal_tpu_torch.api.model_api import (
    FinetuneSpec,
    Model,
    OptimizerConfig,
    data_shard_info,
    make_interface,
)
from areal_tpu_torch.base import faults, integrity, metrics, monitor, seeding, tracer
from areal_tpu_torch.base.device import resolve_device
from areal_tpu_torch.base.topology import ParallelConfig
from areal_tpu_torch.data.datasets import PackedDataLoader
from areal_tpu_torch.data.tokenizer import load_hf_tokenizer

# Populate the dataset and interface registries.
import areal_tpu_torch.interfaces.fused  # noqa: F401
import areal_tpu_torch.interfaces.null  # noqa: F401
import areal_tpu_torch.interfaces.ppo  # noqa: F401
import areal_tpu_torch.interfaces.sft  # noqa: F401
import areal_tpu_torch.interfaces.reward  # noqa: F401

logger = logging.getLogger("areal_tpu_torch.model_worker")


@dataclasses.dataclass
class ModelShardSpec:
    """Everything needed to build one named model on this worker."""

    name: ModelName
    model: ModelAbstraction  # random | hf | config | null
    backend: ModelBackendAbstraction  # train | inference | generator | remote_generator | null
    interface: ModelInterfaceAbstraction
    optimizer: Optional[OptimizerConfig] = None
    # The model's layout over the worker group's `torch.distributed` world
    # (one rank a process, one card a rank): its engine is built on a
    # DeviceMesh of it.  None: an engine of this process alone, no mesh.
    parallel: Optional[ParallelConfig] = None


@dataclasses.dataclass
class WorkerConfig:
    worker_index: int
    shards: List[ModelShardSpec]
    tokenizer_path: Optional[str] = None
    datasets: List[DatasetAbstraction] = dataclasses.field(default_factory=list)
    batch_size: int = 8
    seed: int = 1
    ftspec: FinetuneSpec = dataclasses.field(default_factory=FinetuneSpec)
    # The SPMD worker group: this worker is rank `dist_process_id` of a
    # world of `dist_num_processes` worker processes (`apps/worker.py`
    # forms it, `base/distributed.initialize`, before the models are
    # built); its meshed models span the world.  0 processes: no world.
    dist_process_id: int = 0
    dist_num_processes: int = 0
    # The world's collective timeout (the plan's mfc_timeout_s; None: the
    # rendezvous default), so a hung collective fails inside the trial's
    # own deadline.
    dist_timeout_s: Optional[float] = None


def _build_params_and_config(spec: ModelAbstraction, seed: int, device: torch.device):
    from areal_tpu_torch.models import transformer as tfm
    from areal_tpu_torch.models.hf import registry as hf

    if spec.type_ == "null":
        return None, None  # engine-less models (the reward)
    if spec.type_ == "config":
        return spec.args["config"], None  # no local weights (remote generators)
    if spec.type_ == "random":
        cfg = spec.args["config"]
        return cfg, tfm.init_params(cfg, seed, device=device)
    if spec.type_ == "hf":
        return hf.load_hf_checkpoint(
            spec.args["path"], is_critic=spec.args.get("is_critic", False), device=device,
        )
    raise ValueError(f"unknown model abstraction {spec.type_!r}")


def _build_engine(shard: ModelShardSpec, cfg, params, device, config: WorkerConfig, tokenizer,
                  mesh=None):
    from areal_tpu_torch.engines.generator import GeneratorEngine
    from areal_tpu_torch.engines.inference import InferenceEngine
    from areal_tpu_torch.engines.train import TrainEngine

    btype, args = shard.backend.type_, shard.backend.args
    if mesh is not None and btype not in ("train", "inference"):
        raise NotImplementedError(
            f"a {btype} engine on a device mesh ({shard.parallel.to_str()}) is not ported "
            "(ROADMAP queue 1, item 8.6b: generation on a sharded layout)"
        )
    if btype == "train":
        return TrainEngine(
            cfg, params, device, optimizer_config=shard.optimizer or OptimizerConfig(),
            ftspec=config.ftspec, mesh=mesh, **args,
        )
    if btype == "inference":
        return InferenceEngine(cfg, params, device, mesh=mesh, **args)
    if btype == "generator":
        return GeneratorEngine(
            cfg, params, device, eos_token_id=tokenizer.eos_token_id,
            pad_token_id=getattr(tokenizer, "pad_token_id", None), **args,
        )
    if btype == "remote_generator":
        from areal_tpu_torch.system.gen_server import RemoteGeneratorEngine

        return RemoteGeneratorEngine(cfg, **args)
    if btype == "null":
        return None
    raise ValueError(f"unknown backend {btype!r}")


def ema_mix(a: torch.Tensor, b: torch.Tensor, eta: float) -> torch.Tensor:
    """`eta * a + (1 - eta) * b` as the JAX package computes it on a
    leaf: each Python-float coefficient takes the dtype of the leaf it
    scales (JAX's weak typing: `1 - eta` is rounded to bf16 before it
    scales a bf16 ref leaf, whose product stays bf16), the sum is in the
    wider dtype (fp32), and the result is cast to b's dtype, as
    `set_params` would.  Not `torch.lerp`, which rounds differently."""
    scaled = torch.tensor(1 - eta, dtype=b.dtype) * b
    return (torch.tensor(eta, dtype=a.dtype) * a + scaled).to(b.dtype)


def _zero_filled(meta_row: SequenceSample, keys) -> SequenceSample:
    """Placeholders for the keys a group member was not shipped under the
    shard-exact dispatch: the layout (lengths, dtype, trailing shape) of
    `meta_row` with zero values.  The real values live on the member
    that places those rows; this member never reads them
    (`parallel/sharding.place_rows`)."""
    data, seqlens = {}, {}
    for k in keys:
        sls = meta_row.seqlens[k]
        dt = meta_row.dtypes.get(k)
        if dt is None:
            # A silent float default would corrupt integer token ids.
            raise ValueError(f"cannot zero-fill {k!r} for {meta_row.ids}: the shipped "
                             "metadata carries no dtype")
        n = sum(sum(x) for x in sls)
        data[k] = np.zeros((n, *tuple(meta_row.trailing_shapes.get(k) or ())), dtype=dt)
        seqlens[k] = [list(x) for x in sls]
    # The row's metadata too: the gathered sample's tags stay one a row.
    return SequenceSample(keys=set(keys), ids=list(meta_row.ids), seqlens=seqlens, data=data,
                          metadata={k: list(v) for k, v in meta_row.metadata.items()})


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def whole_params(engine):
    """The engine's weights as whole tensors on this process: on a device
    mesh each leaf is gathered over the group (`parallel/sharding.
    replicate`, a collective every member calls), else the engine's own
    tree."""
    params = engine.get_params()
    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        return params
    from areal_tpu_torch.parallel import sharding as shd

    return _map_tree(lambda t: t.to_local(), shd.replicate(params, mesh))


def _host_tree(tree):
    """A params tree's leaves as fp32 numpy arrays on the host (the wire
    form of a param push: pickle protocol 5 sends numpy buffers out of
    band)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32, copy=True).numpy()


def _tensor_tree(tree):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


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
    def __init__(self, config: WorkerConfig, tokenizer=None, device=None, transfer=None):
        self.config = config
        self.tokenizer = tokenizer
        self.device = resolve_device(device)
        # The bulk plane to the other workers (system/transfer.py), if any.
        self.transfer = transfer
        reg = metrics.default_registry()
        self._m_mfc_seconds = reg.histogram(
            "areal_worker_mfc_seconds",
            "MFC wall time on this worker",
            ("mfc",),
            buckets=(0.05, 0.1, 0.5, 1, 2, 5, 10, 30, 60, 120),
        )
        self._m_mfc_mfu = reg.gauge(
            "areal_worker_mfc_mfu_ratio",
            "last model FLOP utilization, per MFC",
            ("mfc",),
        )
        self._m_mfc_tokens = reg.counter(
            "areal_worker_mfc_tokens_total",
            "tokens processed, per MFC",
            ("mfc",),
        )
        # Transfers that arrived for another request, by xfer id.  One
        # thread at a time drains the plane (`_recv_xfer`); the rest wait
        # on the condition for their id to land here.
        self._xfer_stash: Dict[int, Any] = {}
        self._xfer_cond = threading.Condition()
        self._xfer_recv_busy = False
        # Param pushes serialize once per state of the source's weights:
        # model key -> {"state", "with_checksum", "payload", "encoded"}.
        self._param_send_cache: Dict[str, Dict[str, Any]] = {}
        # Fault injection at the MFC points (AREAL_FAULTS); None when unset.
        self._faults = faults.FaultInjector.from_env()
        self.models: Dict[str, Model] = {}
        self.interfaces: Dict[str, Any] = {}
        # Each model's layout ("d2f2"; "d1" without a mesh), on its spans.
        self._layouts: Dict[str, str] = {}
        self.data_cache: Dict[str, SequenceSample] = {}
        # MFCs in two threads read and amend the cache's entries at once.
        self._cache_lock = threading.Lock()
        # Open train streams, by model key.
        self._streams: Dict[str, Dict[str, Any]] = {}
        # The call number of `_dump_outputs`' files.
        self._dump_seq = itertools.count(1)
        self.datasets = []
        self.dataloaders = []
        self._setup()

    def _on_device(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ---------------- setup ----------------

    def _setup(self):
        # The ranks of a group seed alike (as its first worker): the same
        # host draws, the same initial weights on every member.
        seeding.set_random_seed(self.config.seed,
                                self.config.worker_index - self.config.dist_process_id)
        if self.tokenizer is None and self.config.tokenizer_path:
            self.tokenizer = load_hf_tokenizer(self.config.tokenizer_path)
        meshes: Dict[ParallelConfig, Any] = {}
        with self._on_device():
            for shard in self.config.shards:
                mesh = None
                if shard.parallel is not None:
                    # Over the world `apps/worker.py` formed; every member
                    # builds the same shards in the same order, as the
                    # mesh's sub-groups need.
                    from areal_tpu_torch.base.topology import make_mesh

                    if shard.parallel not in meshes:
                        meshes[shard.parallel] = make_mesh(shard.parallel, self.device)
                    mesh = meshes[shard.parallel]
                cfg, params = _build_params_and_config(shard.model, self.config.seed, self.device)
                engine = _build_engine(shard, cfg, params, self.device, self.config, self.tokenizer,
                                       mesh=mesh)
                del params  # the engine holds its own copy
                key = str(shard.name)
                self.models[key] = Model(name=key, engine=engine, tokenizer=self.tokenizer,
                                         config=cfg)
                self._layouts[key] = shard.parallel.to_str() if shard.parallel else "d1"
                self.interfaces[key] = make_interface(shard.interface.type_, **shard.interface.args)
                logger.info(f"worker {self.config.worker_index}: built model {key} "
                            f"({shard.backend.type_} on {self.device}, layout "
                            f"{self._layouts[key]})")
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
        if self._faults is not None:
            self._fire_faults(req)
        with self._on_device():
            return handler(req)

    def _fire_faults(self, req: Dict[str, Any]) -> None:
        """Fault injection on MFC execution, at the point `mfc_<itype>`
        (mfc_train_step, mfc_generate, mfc_inference) of a plain MFC and
        the request type of a streamed one (mfc_stream_begin, ...).  A
        point-scoped kill exits the process at once: to the master the
        worker just stops beating, as a lost machine would."""
        rtype = req["type"]
        if not rtype.startswith("mfc"):
            return
        if rtype == "mfc":
            point = f"mfc_{ModelInterfaceType(req['interface_type']).value}"
        else:
            point = rtype
        if self._faults.kill_point(point):
            # os._exit skips atexit: dump and flush first.
            tracer.flight_event("kill", point=point, worker=self.config.worker_index)
            tracer.flight_dump("fault_kill", role="worker", rank=self.config.worker_index)
            tracer.flush()
            os._exit(43)
        self._faults.fire(point)

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

    def _handle_shard_info(self, req):
        """(shard_rank, n_shards) of the batch rows this process places
        for the named model (`api/model_api.data_shard_info`): the
        master's shard-exact dispatch ships only that block when n > 1."""
        engine = self.models[req["model_name"]].engine
        rank, n = data_shard_info(engine) if engine is not None else (0, 1)
        return {"rank": int(rank), "n": int(n)}

    def _assemble_sample(self, ids, input_keys, remap_in, shard_of=None,
                         shard_meta=None) -> SequenceSample:
        """The cached entries of `ids` as one packed sample.  Under the
        shard-exact dispatch (`shard_of`: id -> (rank, n)) a key this
        member was not shipped for a row is zero-filled from `shard_meta`
        (another member places that row), and the rows carry their
        `shard_of` tags."""
        parts = []
        with self._cache_lock:
            for idx, sid in enumerate(ids):
                entry = self.data_cache.get(sid)
                have = input_keys & entry.keys if entry is not None else set()
                part = entry.select_keys(have) if have else None
                missing = input_keys - have
                if missing and shard_of:
                    row = shard_meta.select_idx([idx])
                    unknown = missing - row.keys
                    if unknown:
                        # Fail at the cause, not as a bewildering KeyError
                        # deep in the packer or the interface.
                        raise KeyError(
                            f"worker {self.config.worker_index}: input key(s) "
                            f"{sorted(unknown)} for {sid!r} are in neither the data cache "
                            "nor the shard metadata"
                        )
                    zero = _zero_filled(row, missing)
                    if part is None:
                        part = zero
                    else:
                        part.update_(zero)
                elif missing:
                    raise KeyError(
                        f"worker {self.config.worker_index}: no data for {sid!r} "
                        f"(keys {sorted(missing)})"
                    )
                parts.append(part)
        sample = SequenceSample.gather(parts)
        if shard_of:
            sample.metadata["shard_of"] = [list(shard_of[sid]) for sid in ids]
        sample.remap_keys_(remap_in)
        return sample

    def _handle_mfc(self, req):
        """Execute one model function call on cached data."""
        model_key: str = req["model_name"]
        itype = ModelInterfaceType(req["interface_type"])
        mb_spec: MicroBatchSpec = req.get("mb_spec") or MicroBatchSpec()
        # Shard-exact dispatch: the shard keys arrived for this member's
        # own rows only (`api/dfg.py MFCDef.shard_keys`).
        sample = self._assemble_sample(
            req["ids"], set(req["input_keys"]), req.get("input_key_remap", {}),
            req.get("shard_of") or {}, req.get("shard_meta"),
        )
        model = self.models[model_key]
        fn = getattr(self.interfaces[model_key], itype.value)
        # The call's wall-clock mark (time/mfc_<itype>, _cnt, _avg).  One
        # Timers a call: two MFCs run at once in two threads, and a shared
        # one would hand one call's mark to the other's reply.
        timers = monitor.Timers()
        with tracer.span(f"mfc:{model_key}:{itype.value}", cat="compute") as targs:
            with timers.record(f"mfc_{itype.value}"):
                t0 = time.monotonic()
                # Every interface returns host data, so the call has
                # finished on the card when it returns.
                result = fn(model, sample, mb_spec)
                seconds = time.monotonic() - t0
            if itype == ModelInterfaceType.GENERATE:
                model.inc_version()  # advances the sampling seed per step
            out_sample = result if isinstance(result, SequenceSample) else None
            if out_sample is not None:
                out_sample.remap_keys_(req.get("output_key_remap", {}))
            perf = self._mfc_perf(model, itype, sample, out_sample, seconds)
            perf.update(timers.drain())
            mfc_label = f"{model_key}:{itype.value}"
            self._m_mfc_seconds.labels(mfc_label).observe(seconds)
            if "perf/mfu" in perf:
                self._m_mfc_mfu.labels(mfc_label).set(perf["perf/mfu"])
            self._m_mfc_tokens.labels(mfc_label).inc(
                int(sum(sum(x) for x in sample.seqlens[next(iter(sample.keys))]))
            )
            if tracer.enabled():
                targs["mfc"] = f"{model_key}:{itype.value}"
                # The packed key: a scalar key's lens are 1 a sequence.
                key0 = ("packed_input_ids" if "packed_input_ids" in sample.keys
                        else next(iter(sample.keys)))
                targs["tokens"] = int(sum(sum(x) for x in sample.seqlens[key0]))
                targs["seqs"] = len(sample.seqlens[key0])
                if "perf/tflops" in perf:
                    targs["tflops"] = perf["perf/tflops"]
                if "perf/mfu" in perf:
                    targs["mfu"] = perf["perf/mfu"]
                self._span_profile_fields(model, targs)
        if out_sample is None:
            return {"meta": None, "stats": {**dict(result or {}), **perf}}
        if os.environ.get("AREAL_MFC_DUMP_DIR"):
            self._dump_outputs(os.environ["AREAL_MFC_DUMP_DIR"], model_key, itype, out_sample)
        with self._cache_lock:
            for one in out_sample.unpack():
                sid = one.ids[0]
                if sid in self.data_cache:
                    self.data_cache[sid].update_(one)
                else:
                    self.data_cache[sid] = one
        return {"meta": out_sample.meta(), "stats": perf}

    def _dump_outputs(self, root: str, model_key: str, itype, out: SequenceSample) -> None:
        """With ``AREAL_MFC_DUMP_DIR`` set, each MFC's outputs are written
        to ``<root>/<model>_<type>_w<worker>_<call>.npz`` (the ids, and
        each key's flat data and per-sequence lengths): a layout's outputs
        can then be held against another layout's row by row."""
        n = next(self._dump_seq)
        arrays = {"ids": np.asarray([str(i) for i in out.ids])}
        for k in out.keys:
            if out.data is not None and out.data.get(k) is not None:
                arrays[f"data.{k}"] = np.asarray(out.data[k])
                arrays[f"lens.{k}"] = np.asarray([len(s) for s in out.seqlens[k]])
                arrays[f"seqlens.{k}"] = np.asarray([x for s in out.seqlens[k] for x in s])
        os.makedirs(root, exist_ok=True)
        name = f"{model_key.replace('@', '-')}_{itype.value}_w{self.config.worker_index}_{n}.npz"
        np.savez(os.path.join(root, name), **arrays)

    # ---------------- the streamed train step ----------------

    def _handle_mfc_stream_begin(self, req):
        key: str = req["model_name"]
        if key in self._streams:
            raise RuntimeError(
                f"worker {self.config.worker_index}: train stream for {key!r} already open"
            )
        mb_spec: MicroBatchSpec = req.get("mb_spec") or MicroBatchSpec()
        self._streams[key] = {
            "state": self.interfaces[key].train_stream_begin(self.models[key], mb_spec),
            "busy_s": 0.0, "tokens": 0, "seqs": 0, "sum_sq": 0.0, "n_chunks": 0,
            "timers": monitor.Timers(),
        }
        return {"meta": None, "stats": {}}

    def _handle_mfc_stream_chunk(self, req):
        key: str = req["model_name"]
        st = self._streams[key]
        mb_spec: MicroBatchSpec = req.get("mb_spec") or MicroBatchSpec()
        sample = self._assemble_sample(
            req["ids"], set(req["input_keys"]), req.get("input_key_remap", {})
        )
        # Seeded with one arg: a span's args reach the event only when
        # the dict is non-empty at its exit.
        with tracer.span(f"mfc:{key}:train_chunk", cat="compute",
                         mfc=f"{key}:train_chunk") as targs:
            with st["timers"].record("mfc_train_chunk"):
                t0 = time.monotonic()
                stats = self.interfaces[key].train_stream_chunk(
                    self.models[key], st["state"], sample, mb_spec
                )
                st["busy_s"] += time.monotonic() - t0
        lens = [sum(x) for x in sample.seqlens["packed_input_ids"]]
        st["tokens"] += int(sum(lens))
        st["sum_sq"] += float(sum(n * n for n in lens))
        st["n_chunks"] += 1
        st["seqs"] += len(lens)
        if tracer.enabled():
            targs["tokens"] = int(sum(lens))
            targs["chunk"] = st["n_chunks"] - 1
        self._m_mfc_tokens.labels(f"{key}:train_chunk").inc(int(sum(lens)))
        return {"meta": None, "stats": dict(stats)}

    def _handle_train_stream_abort(self, req):
        """Drop every open train stream (its summed gradients too), so a
        master recovering from a worker's death restarts the step clean."""
        dropped = sorted(self._streams)
        self._streams.clear()
        if dropped:
            logger.warning(f"worker {self.config.worker_index}: aborted open train "
                           f"stream(s) {dropped}")
        return {"dropped": dropped}

    def _handle_mfc_stream_end(self, req):
        key: str = req["model_name"]
        st = self._streams.pop(key)
        model = self.models[key]
        mb_spec: MicroBatchSpec = req.get("mb_spec") or MicroBatchSpec()
        with tracer.span(f"mfc:{key}:train_step", cat="compute",
                         mfc=f"{key}:train_step") as targs:
            with st["timers"].record("mfc_train_step"):
                t0 = time.monotonic()
                result = self.interfaces[key].train_stream_end(model, st["state"], mb_spec)
                st["busy_s"] += time.monotonic() - t0
        perf = {"perf/time_s": st["busy_s"]}
        if model.config is not None and st["tokens"]:
            perf.update(self._flops_perf(
                monitor.flops_train(model.config, st["tokens"], st["sum_sq"]), st["busy_s"]))
        perf.update(st["timers"].drain())
        mfc_label = f"{key}:train_step"
        self._m_mfc_seconds.labels(mfc_label).observe(st["busy_s"])
        if "perf/mfu" in perf:
            self._m_mfc_mfu.labels(mfc_label).set(perf["perf/mfu"])
        if tracer.enabled():
            targs["stream_chunks"] = st["n_chunks"]
            targs["tokens"] = st["tokens"]
            targs["seqs"] = st["seqs"]
            # The chunks' busy seconds and the optimizer step: the span
            # itself wraps only the latter.
            targs["wall_s"] = round(st["busy_s"], 6)
            if "perf/tflops" in perf:
                targs["tflops"] = perf["perf/tflops"]
            if "perf/mfu" in perf:
                targs["mfu"] = perf["perf/mfu"]
            self._span_profile_fields(model, targs)
        return {"meta": None, "stats": {**dict(result or {}), **perf}}

    def _span_profile_fields(self, model, targs) -> None:
        """The profile's keys on an MFC span: the layout and the model's
        shape."""
        targs["layout"] = self._layouts.get(model.name, "d1")
        cfg = model.config
        if cfg is not None:
            targs["model_shape"] = (f"l{cfg.n_layers}h{cfg.hidden_dim}q{cfg.n_q_heads}"
                                    f"kv{cfg.n_kv_heads}v{cfg.vocab_size}")

    def _flops_perf(self, flops: float, seconds: float) -> Dict[str, float]:
        """TFLOPs, MFU (on a card with a peak entry) and the card's
        allocated memory after the call."""
        perf = {"perf/tflops": flops / 1e12}
        u = monitor.mfu(flops, seconds, self.device)
        if u is not None:
            perf["perf/mfu"] = u
        if self.device.type == "cuda":
            used = torch.cuda.memory_allocated(self.device)
            perf["perf/hbm_gb"] = used / 1e9
            perf["perf/hbm_frac"] = used / torch.cuda.get_device_properties(self.device).total_memory
        return perf

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
        perf.update(self._flops_perf(flops, seconds))
        return perf

    def _handle_param_sync(self, req):
        """Copy the weights of model `src` into model `dst` (the
        generator's weight sync after a train step), or with eta < 1 move
        `dst` toward `src` (the EMA reference model, `ema_mix`), one leaf
        at a time, then `dst.set_params`."""
        src = self.models[req["src"]].engine
        dst = self.models[req["dst"]].engine
        eta = float(req.get("eta", 1.0))
        # On a group the meshed leaves are gathered whole first (every
        # member runs this request; `set_params` places them again).
        if eta >= 1.0:
            dst.set_params(whole_params(src))
            return {}
        sp, dp = whole_params(src), whole_params(dst)

        def mix(a, b):
            if isinstance(b, dict):
                return {k: mix(a[k], b[k]) for k in b}
            return ema_mix(a, b, eta)

        with torch.no_grad():
            mixed = mix(sp, dp)
        del sp, dp
        dst.set_params(mixed)
        return {}

    # ---------------- the cross-worker transfer plane ----------------
    # The master sends a transfer's two halves as a concurrent request pair
    # (data_send to the source, data_recv to the target), tagged with one
    # xfer id, so transfers from several sources at once cannot mix.

    def _recv_xfer(self, xfer_id: int, timeout: float = 300.0):
        deadline = time.monotonic() + timeout
        while True:
            with self._xfer_cond:
                while True:
                    if xfer_id in self._xfer_stash:
                        return self._xfer_stash.pop(xfer_id)
                    if not self._xfer_recv_busy:
                        self._xfer_recv_busy = True
                        break  # this thread drains the plane
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(f"worker {self.config.worker_index}: xfer "
                                           f"{xfer_id} not received within {timeout}s")
                    self._xfer_cond.wait(remaining)
            try:
                got_id, payload = self.transfer.recv(
                    timeout=max(deadline - time.monotonic(), 0.001)
                )
                with self._xfer_cond:
                    if got_id == xfer_id:
                        return payload
                    self._xfer_stash[got_id] = payload
            finally:
                with self._xfer_cond:
                    self._xfer_recv_busy = False
                    self._xfer_cond.notify_all()

    def _handle_data_send(self, req):
        """Ship cached entries (the asked keys) to another worker; reply
        with the wire bytes and seconds for the step's transfer stats."""
        t0 = time.monotonic()
        keys = set(req["keys"])
        parts = []
        with self._cache_lock:
            for sid in req["ids"]:
                entry = self.data_cache[sid]
                have = keys & entry.keys
                if not have:
                    raise KeyError(f"worker {self.config.worker_index}: no keys {keys} "
                                   f"cached for id {sid}")
                parts.append(entry.select_keys(have))
        nbytes = self.transfer.send(req["dst"], req["xfer_id"], ("data", parts))
        return {"bytes": nbytes, "seconds": time.monotonic() - t0}

    def _handle_data_recv(self, req):
        t0 = time.monotonic()
        kind, parts = self._recv_xfer(req["xfer_id"])
        if kind != "data":
            raise RuntimeError(f"xfer {req['xfer_id']}: expected data, got {kind!r}")
        with self._cache_lock:
            for one in parts:
                sid = one.ids[0]
                if sid in self.data_cache:
                    self.data_cache[sid].update_(one)
                else:
                    self.data_cache[sid] = one
        return {"n": len(parts), "seconds": time.monotonic() - t0}

    def _handle_param_send(self, req):
        """Ship a model's weights to other workers: each leaf gathered to
        the host in fp32 (a bf16 master widens exactly), a content
        checksum over the host tree (`base/integrity.py`) stamped before
        the wire, the tree encoded once (`transfer.encode_oob`) and sent
        to every target.  The (host tree, checksum, encoding) triple is
        cached per model and reused while the weights are unchanged: a
        leaf's storage and in-place version counter, and the engine's
        update count, key the cache, so a train step or a `set_params`
        invalidates it.  A due ``corrupt_push@point=weight_push`` fault
        (``AREAL_FAULTS``) corrupts this send's host tree after the
        checksum, for this send only.  Replies with the wire bytes and the
        split of the seconds (gather, checksum, encode and wire)."""
        from areal_tpu_torch.system.paramstore import M_PUSH_BYTES
        from areal_tpu_torch.system.transfer import encode_oob

        t0 = time.monotonic()
        key = req["model_name"]
        eng = self.models[key].engine
        # Every member of a group gathers (a collective); only the sender
        # (the group's first member) ships.
        params = whole_params(eng)
        if not req.get("sender", True):
            return {"bytes": 0, "seconds": time.monotonic() - t0}
        leaves = integrity._leaves(params)
        state = (getattr(eng, "opt_count", None),
                 tuple((x.data_ptr(), x._version) for x in leaves))
        with_checksum = bool(req.get("checksum", True))
        cache = self._param_send_cache.get(key)
        timing = {"gather_s": 0.0, "checksum_s": 0.0, "encode_s": 0.0}
        if cache is None or cache["state"] != state or cache["with_checksum"] != with_checksum:
            self._param_send_cache.pop(key, None)
            with torch.no_grad():
                host = _host_tree(params)
            t1 = time.monotonic()
            checksum = integrity.params_checksum(host) if with_checksum else None
            t2 = time.monotonic()
            payload = ("params", host, checksum)
            cache = {"state": state, "with_checksum": with_checksum, "payload": payload,
                     "encoded": encode_oob(payload)}
            timing.update(gather_s=t1 - t0, checksum_s=t2 - t1,
                          encode_s=time.monotonic() - t2)
            self._param_send_cache[key] = cache
        del params, leaves
        payload, encoded = cache["payload"], cache["encoded"]
        if self._faults is not None and self._faults.poison("weight_push") == "corrupt_push":
            # This send only: the poisoned encoding is never cached, so
            # the retry sends the clean one.
            kind, host, checksum = payload
            payload = (kind, integrity.corrupt_params(host), checksum)
            encoded = None
        t3 = time.monotonic()
        nbytes = self.transfer.send_many(req["dsts"], req["xfer_ids"], payload, encoded=encoded)
        timing["wire_s"] = time.monotonic() - t3
        M_PUSH_BYTES.inc(nbytes)
        logger.info("PARAM_PUSH " + json.dumps({
            "side": "send", "worker": self.config.worker_index, "model": key,
            "bytes": nbytes, "cached": timing["gather_s"] == 0.0, **timing,
        }))
        return {"bytes": nbytes, "seconds": time.monotonic() - t0, **timing}

    def _handle_param_recv(self, req):
        """Take a pushed weights tree: verify its checksum before anything
        changes (a rejected push leaves the old weights serving), then
        `set_params`, or with eta < 1 move the model toward the pushed
        weights (`ema_mix`, one leaf at a time)."""
        t0 = time.monotonic()
        kind, host, checksum = self._recv_xfer(req["xfer_id"])
        if kind != "params":
            raise RuntimeError(f"xfer {req['xfer_id']}: expected params, got {kind!r}")
        t1 = time.monotonic()
        if checksum is not None:
            integrity.verify_checksum(host, checksum)
        t2 = time.monotonic()
        eng = self.models[req["model_name"]].engine
        eta = float(req.get("eta", 1.0))
        pushed = _tensor_tree(host)
        if eta >= 1.0:
            eng.set_params(pushed)
        else:
            cur = eng.get_params()

            def mix(a, b):
                if isinstance(b, dict):
                    return {k: mix(a[k], b[k]) for k in b}
                return ema_mix(a.to(b.device), b, eta)

            with torch.no_grad():
                mixed = mix(pushed, cur)
            del cur
            eng.set_params(mixed)
        del pushed, host
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        timing = {"wait_s": t1 - t0, "verify_s": t2 - t1, "load_s": time.monotonic() - t2}
        logger.info("PARAM_PUSH " + json.dumps({
            "side": "recv", "worker": self.config.worker_index,
            "model": req["model_name"], "eta": eta, **timing,
        }))
        return {"seconds": time.monotonic() - t0, **timing}

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
        # Once a step from the master: the shard stays current should the
        # worker later crash.
        tracer.flush()
        return {}

    def _handle_ping(self, req):
        return {"pong": self.config.worker_index}
