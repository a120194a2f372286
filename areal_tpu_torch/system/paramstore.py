"""Versioned parameter store and broadcast-tree weight push (port of
areal_tpu/system/paramstore.py).

- **ParamStore**: the publisher serializes a params tree ONCE per
  version into a flat little-endian byte payload plus a (dtype, shape)
  manifest, stamped with the per-leaf-norm checksum of
  ``base/integrity.py``.  Versions carry reference counts: a version is
  retained while a live server or an in-flight dispatch pins it, so a
  server that missed a push can still pull version v-1.  Stale pins
  expire by TTL (a crashed holder never releases).
- **Broadcast tree**: ``plan_tree`` splits the live membership (the
  ``fleet.fleet_discovery`` closure) into a deterministic fan-out tree.
  Each server receives the payload with its own subtree and relays the
  raw bytes to its children before it applies them through the
  interruptible ``update_weights_inmem``: a push takes O(log N) hops, not
  O(N) sends.  A relay that fails orphans exactly its subtree (counted in
  ``areal_param_push_orphans_total``); orphans keep serving their
  version and re-attach on the next push, which replans over the live
  membership.
- **BroadcastFabric**: the pusher's side: publish, plan, push, pin,
  retire, ``repair()`` (a direct push to each laggard) and a ``p2p``
  mode, one direct push a server in turn, kept as the A/B baseline.

Wire format (the JAX package's, byte for byte, so either package's
pusher feeds either package's servers): ``POST /param_push`` with the
body = 8-byte big-endian meta length + meta JSON + the raw payload.  The
payload is relayed verbatim hop to hop, never re-encoded.  Leaves are
taken in sorted-key order (``integrity._leaves``, which is
``jax.tree.leaves`` order for a dict) and each leaf's bytes are its
dtype's little-endian layout; the manifest names dtypes as numpy and
JAX do (``float32``, ``bfloat16``, ``int8``, ...).  bf16, which numpy
has no dtype for, goes through ``view(torch.uint8)`` and
``torch.frombuffer``.

Only ``http://`` servers take a push here; the ZMQ transport
(``zmq://``) comes with ROADMAP queue 1 item 7.8.  Every fabric metric
is registered here and only here; the master, the worker and the
generation server use these handles.
"""

import dataclasses
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from areal_tpu_torch.base import integrity, metrics

logger = logging.getLogger("areal_tpu_torch.paramstore")

# ---------------- metrics (one registration site) ----------------

_REG = metrics.default_registry()
M_VERSIONS_LIVE = _REG.gauge(
    "areal_paramstore_versions_live",
    "parameter versions currently retained by the store",
)
M_PINS = _REG.gauge(
    "areal_paramstore_pins",
    "live version pins (servers + in-flight dispatches) across versions",
)
M_PUSH_BYTES = _REG.counter(
    "areal_param_push_bytes_total",
    "parameter payload bytes shipped by push/relay hops",
)
M_PUSH_SECONDS = _REG.histogram(
    "areal_param_push_seconds",
    "wall time of one fleet-wide parameter push",
)
M_PUSH_ORPHANS = _REG.counter(
    "areal_param_push_orphans_total",
    "servers orphaned by a failed relay subtree during a push",
)

# ---------------- serialization (once per version) ----------------

_DTYPES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.uint8: "uint8",
    torch.int16: "int16", torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
}
_BY_NAME = {v: k for k, v in _DTYPES.items()}


def _tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def serialize_params(tree: Any) -> Tuple[List[Dict], memoryview]:
    """Flatten a params tree (nested dicts of torch tensors on any
    device, or of numpy arrays) into (manifest, payload): the manifest
    lists each leaf's dtype and shape in sorted-key order, the payload
    holds the leaves' raw bytes one after another.  The payload is a
    memoryview over one host buffer that each leaf is copied into once
    (from the card, when it lies there); it compares equal to the JAX
    package's bytes for the same weights."""
    leaves = [_tensor(x).detach() for x in integrity._leaves(tree)]
    manifest = []
    for x in leaves:
        if x.dtype not in _DTYPES:
            raise TypeError(f"param leaf dtype {x.dtype} has no wire name")
        manifest.append({"dtype": _DTYPES[x.dtype], "shape": list(x.shape)})
    sizes = [x.numel() * x.element_size() for x in leaves]
    buf = torch.empty(sum(sizes), dtype=torch.uint8)
    off = 0
    for x, n in zip(leaves, sizes):
        if n:
            buf[off:off + n].copy_(x.contiguous().reshape(-1).view(torch.uint8))
        off += n
    return manifest, memoryview(buf.numpy())


def deserialize_params(like: Any, manifest: List[Dict], payload) -> Any:
    """Rebuild a params tree from (manifest, payload) in `like`'s
    structure (nested dicts, leaves matched in sorted-key order).  Leaves
    are CPU tensors viewing the payload (a read-only payload is copied
    once into a writable buffer first, which torch requires); the
    engine's ``set_params`` places them on its device.  A wrong leaf
    count, shape or length raises before any leaf is built: a payload
    for another model never reaches the swap."""
    like_leaves = integrity._leaves(like)
    if len(like_leaves) != len(manifest):
        raise ValueError(
            f"param payload has {len(manifest)} leaves; this model has "
            f"{len(like_leaves)} — wrong model for this fleet"
        )
    specs, off = [], 0
    for i, spec in enumerate(manifest):
        name = str(spec["dtype"])
        if name not in _BY_NAME:
            raise ValueError(f"param payload leaf {i} has unknown dtype {name!r}")
        dt = _BY_NAME[name]
        shape = tuple(int(s) for s in spec["shape"])
        want = tuple(like_leaves[i].shape)
        if shape != want:
            raise ValueError(f"param payload leaf {i} has shape {shape}; model expects {want}")
        n = int(np.prod(shape)) if shape else 1
        specs.append((dt, shape, n, off))
        off += n * dt.itemsize
    view = memoryview(payload).cast("B")
    if off != view.nbytes:
        raise ValueError(f"param payload is {view.nbytes} bytes; manifest describes {off}")
    if view.readonly:
        view = memoryview(bytearray(view))
    leaves = iter([
        torch.frombuffer(view, dtype=dt, count=n, offset=o).reshape(shape) if n
        else torch.empty(shape, dtype=dt)
        for dt, shape, n, o in specs
    ])

    def rebuild(t):
        if isinstance(t, dict):
            built = {k: rebuild(t[k]) for k in sorted(t)}  # the leaves' order
            return {k: built[k] for k in t}
        return next(leaves)

    return rebuild(like)


def push_prefix(meta: Dict) -> bytes:
    """The ``/param_push`` body's head: the 8-byte big-endian length of
    the meta JSON, then the JSON.  The payload follows it on the wire
    as it is (the client sends the two as chunks, joining no copy)."""
    mb = json.dumps(meta).encode()
    return len(mb).to_bytes(8, "big") + mb


def frame_push_body(meta: Dict, payload) -> bytes:
    """The whole ``/param_push`` body in one bytes object."""
    return push_prefix(meta) + bytes(payload)


def unframe_push_body(body) -> Tuple[Dict, memoryview]:
    """(meta, payload) of a whole ``/param_push`` body; the payload is a
    view of the body, not a copy."""
    view = memoryview(body).cast("B")
    if len(view) < 8:
        raise ValueError("param_push body too short for its meta prefix")
    mlen = int.from_bytes(view[:8], "big")
    if 8 + mlen > len(view):
        raise ValueError("param_push meta prefix exceeds the body")
    meta = json.loads(bytes(view[8:8 + mlen]))
    return meta, view[8 + mlen:]


# ---------------- the versioned store ----------------


@dataclasses.dataclass
class ParamVersion:
    """One published version: the payload serialized once, its manifest
    and checksum, reused for every target, relay hop and retry."""

    version: int
    manifest: List[Dict]
    payload: Any  # a bytes-like object
    checksum: Optional[np.ndarray]
    published_s: float

    @property
    def nbytes(self) -> int:
        return memoryview(self.payload).nbytes


class ParamStore:
    """Versioned parameter store with reference counts a version.

    ``publish`` serializes once and bumps the head version; ``pin``
    records a named holder on a version (servers pin exclusively: a
    holder serves one version; in-flight dispatches pin additively and
    ``release`` when done).  ``retire`` drops the versions that are not
    the head, not within the ``retain`` newest and hold no live pin,
    after expiring the pins older than ``pin_ttl_s``.  ``retain=2`` keeps
    v-1 pullable before anyone pins it."""

    def __init__(self, retain: int = 2, pin_ttl_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        self.retain = int(retain)
        self.pin_ttl_s = float(pin_ttl_s)
        self._clock = clock
        self._lock = threading.RLock()
        self._head = 0
        self._versions: Dict[int, ParamVersion] = {}
        # version -> holder -> last pin/refresh stamp (clock units)
        self._pins: Dict[int, Dict[str, float]] = {}

    # -- publishing --

    def publish(self, params: Any = None, checksum: Optional[np.ndarray] = None, *,
                manifest: Optional[List[Dict]] = None, payload=None) -> int:
        """Serialize ONCE and retain under the next version number.  Pass
        a params tree (serialized and checksummed here) or a serialized
        (manifest, payload) pair, which is kept as given (not copied:
        the caller does not change it afterwards)."""
        if params is not None:
            manifest, payload = serialize_params(params)
            if checksum is None:
                checksum = integrity.params_checksum(params)
        if manifest is None or payload is None:
            raise ValueError("publish needs params or (manifest, payload)")
        with self._lock:
            self._head += 1
            v = self._head
            self._versions[v] = ParamVersion(
                version=v, manifest=list(manifest), payload=payload,
                checksum=None if checksum is None else np.asarray(checksum, np.float64),
                published_s=self._clock(),
            )
            self._retire_locked()
        logger.info(f"published version {v} ({memoryview(payload).nbytes} bytes, "
                    f"{len(manifest)} leaves)")
        return v

    @property
    def head(self) -> int:
        with self._lock:
            return self._head

    def get(self, version: int) -> Optional[ParamVersion]:
        with self._lock:
            return self._versions.get(int(version))

    def live_versions(self) -> List[int]:
        with self._lock:
            return sorted(self._versions)

    # -- reference counts --

    def pin(self, version: int, holder: str, exclusive: bool = True) -> bool:
        """Pin `version` for `holder` (refreshing its TTL stamp).  With
        ``exclusive`` (a server serves one version) the holder's pins on
        other versions are released.  False when the version is unknown
        or retired: a pin cannot bring dropped bytes back."""
        version = int(version)
        with self._lock:
            if version not in self._versions:
                if exclusive:
                    self._release_holder_locked(holder)
                    self._retire_locked()
                return False
            if exclusive:
                for v, holders in self._pins.items():
                    if v != version:
                        holders.pop(holder, None)
            self._pins.setdefault(version, {})[holder] = self._clock()
            self._retire_locked()
            return True

    def release(self, version: int, holder: str) -> None:
        with self._lock:
            self._pins.get(int(version), {}).pop(holder, None)
            self._retire_locked()

    def release_holder(self, holder: str) -> None:
        """Drop every pin `holder` holds (a server drained or reaped)."""
        with self._lock:
            self._release_holder_locked(holder)
            self._retire_locked()

    def _release_holder_locked(self, holder: str) -> None:
        for holders in self._pins.values():
            holders.pop(holder, None)

    def pins(self, version: int) -> List[str]:
        with self._lock:
            return sorted(self._pins.get(int(version), {}))

    # -- retention --

    def retire(self) -> List[int]:
        """Expire stale pins, then drop every version that is neither the
        head, within the `retain` newest, nor pinned.  Returns the
        versions dropped."""
        with self._lock:
            return self._retire_locked()

    def _retire_locked(self) -> List[int]:
        now = self._clock()
        for holders in self._pins.values():
            for h, stamp in list(holders.items()):
                if now - stamp > self.pin_ttl_s:
                    holders.pop(h)
        dropped = []
        for v in sorted(self._versions):
            if v > self._head - self.retain or self._pins.get(v):
                continue
            del self._versions[v]
            self._pins.pop(v, None)
            dropped.append(v)
        for v in [v for v in self._pins if v not in self._versions]:
            if not self._pins[v]:
                del self._pins[v]
        M_VERSIONS_LIVE.set(len(self._versions))
        M_PINS.set(sum(len(h) for h in self._pins.values()))
        if dropped:
            logger.info(f"retired versions {dropped}")
        return dropped

    # -- persistence (RecoverInfo.paramstore_state) --

    def state_dict(self) -> Dict:
        """The version counter only: payloads are a step's products that
        a restarted trainer publishes again, but the head must stay
        monotonic across restarts."""
        with self._lock:
            return {"head": self._head}

    def load_state_dict(self, state: Optional[Dict]) -> None:
        if not state:
            return
        with self._lock:
            self._head = max(self._head, int(state.get("head", 0)))


# ---------------- the broadcast tree ----------------


def plan_tree(members: List[Tuple[str, str]], fanout: int = 2) -> List[Dict]:
    """Deterministic fan-out tree over (sid, url) members: the sorted
    membership splits into at most `fanout` balanced contiguous chunks,
    each chunk's first member relaying to a subtree planned the same way
    over the rest (depth O(log_fanout N)).  Returns the root's children,
    each ``{"sid", "url", "children": [...]}``."""
    members = sorted(members)
    fanout = max(1, int(fanout))
    if not members:
        return []
    k = min(fanout, len(members))
    base, extra = divmod(len(members), k)
    nodes, off = [], 0
    for i in range(k):
        size = base + (1 if i < extra else 0)
        chunk = members[off:off + size]
        off += size
        sid, url = chunk[0]
        nodes.append({"sid": sid, "url": url, "children": plan_tree(chunk[1:], fanout)})
    return nodes


def subtree_sids(node: Dict) -> List[str]:
    out = [str(node["sid"])]
    for c in node.get("children") or ():
        out.extend(subtree_sids(c))
    return out


def tree_depth(nodes: List[Dict]) -> int:
    if not nodes:
        return 0
    return 1 + max(tree_depth(n.get("children") or []) for n in nodes)


# ---------------- push transport ----------------


def push_payload(url: str, meta: Dict, payload, token: str = "",
                 timeout_s: float = 120.0) -> Dict:
    """Send one (meta, payload) push to the server at `url` (a binary
    ``POST /param_push``) and return its ack.  The payload goes out
    verbatim; this is the only hop primitive, so every hop counts into
    the bytes total."""
    if not url.startswith(("http://", "https://")):
        raise NotImplementedError(
            f"param push to {url!r}: only http:// is ported (ROADMAP queue 1, item 7.8: "
            "the ZMQ transport)"
        )
    from areal_tpu_torch.api.model_api import LLMAPIClient

    ack = LLMAPIClient(url, timeout_s=timeout_s, token=token).push_weights(meta, payload)
    M_PUSH_BYTES.inc(memoryview(payload).nbytes + len(json.dumps(meta).encode()))
    return ack


def relay_subtrees(children: List[Dict], base_meta: Dict, payload, token: str = "",
                   timeout_s: float = 120.0) -> Tuple[List[str], List[Dict]]:
    """Push `payload` to each child subtree at once and gather the
    (applied, failed) sids their acks report.  A child that cannot be
    reached orphans its whole subtree."""
    applied: List[str] = []
    failed: List[Dict] = []
    if not children:
        return applied, failed
    from concurrent.futures import ThreadPoolExecutor

    def one(node: Dict):
        return push_payload(str(node["url"]), dict(base_meta, subtree=node), payload,
                            token=token, timeout_s=timeout_s)

    with ThreadPoolExecutor(len(children)) as pool:
        for node, fut in [(n, pool.submit(one, n)) for n in children]:
            try:
                ack = fut.result()
                applied.extend(str(s) for s in ack.get("applied", ()))
                failed.extend(ack.get("failed", ()))
            except Exception as e:  # noqa: BLE001 — orphan the subtree
                logger.warning(f"relay to {node['sid']} failed: {e!r}; subtree orphaned until "
                               "the next push")
                failed.extend({"sid": s, "error": repr(e)} for s in subtree_sids(node))
    return applied, failed


# ---------------- the pusher's fabric ----------------


@dataclasses.dataclass
class PushReport:
    version: int
    targets: int
    applied: List[str]
    orphans: List[Dict]  # [{"sid", "error"}]
    seconds: float
    nbytes: int
    depth: int

    @property
    def ok(self) -> bool:
        return not self.orphans and self.targets == len(self.applied)


class BroadcastFabric:
    """Drives pushes from a ParamStore over the live fleet membership.

    `discovery` is the ``fleet_discovery(experiment, trial)`` closure
    (sid -> url), listed again at every push, so joins, drains and
    expiries between pushes rebuild the tree.  ``mode="p2p"`` pushes to
    one server after another, without relays (the A/B baseline)."""

    def __init__(self, store: ParamStore, discovery: Callable[[], Dict[str, str]],
                 fanout: int = 2, mode: str = "tree", token: str = "",
                 timeout_s: float = 120.0, experiment: str = "", trial: str = "trial"):
        if mode not in ("tree", "p2p"):
            raise ValueError(f"unknown push mode {mode!r}")
        if fanout < 1:
            raise ValueError(f"fanout must be >= 1, got {fanout}")
        self.store = store
        self.discovery = discovery
        self.fanout = int(fanout)
        self.mode = mode
        self.token = token
        self.timeout_s = float(timeout_s)
        self.experiment = experiment
        self.trial = trial

    def _base_meta(self, pv: ParamVersion) -> Dict:
        return {
            "cmd": "param_push",
            "version": pv.version,
            "manifest": pv.manifest,
            "checksum": None if pv.checksum is None else pv.checksum.tolist(),
        }

    def _announce_head(self) -> None:
        """Publish the store's head under ``names.param_store``: a
        late-joining trainer reads it to continue version time."""
        if not self.experiment:
            return
        from areal_tpu_torch.base import name_resolve, names

        try:
            name_resolve.add(names.param_store(self.experiment, self.trial),
                             str(self.store.head), replace=True, delete_on_exit=True)
        except Exception:  # noqa: BLE001 — rendezvous is best-effort
            logger.warning("param_store head announce failed", exc_info=True)

    def push(self, version: Optional[int] = None) -> PushReport:
        """Push `version` (default: the head) to the whole live fleet."""
        v = int(version) if version is not None else self.store.head
        pv = self.store.get(v)
        if pv is None:
            raise KeyError(f"version {v} is not retained by the store")
        membership = sorted(dict(self.discovery() or {}).items())
        t0 = time.monotonic()
        base = self._base_meta(pv)
        applied: List[str] = []
        failed: List[Dict] = []
        if self.mode == "p2p":
            roots = [{"sid": sid, "url": url, "children": []} for sid, url in membership]
            for node in roots:
                a, f = relay_subtrees([node], base, pv.payload, token=self.token,
                                      timeout_s=self.timeout_s)
                applied.extend(a)
                failed.extend(f)
        else:
            roots = plan_tree(membership, self.fanout)
            applied, failed = relay_subtrees(roots, base, pv.payload, token=self.token,
                                             timeout_s=self.timeout_s)
        dt = time.monotonic() - t0
        M_PUSH_SECONDS.observe(dt)
        if failed:
            M_PUSH_ORPHANS.inc(len(failed))
        for sid in applied:
            self.store.pin(v, f"server:{sid}")
        self.store.retire()
        self._announce_head()
        report = PushReport(version=v, targets=len(membership), applied=applied,
                            orphans=failed, seconds=dt, nbytes=pv.nbytes,
                            depth=tree_depth(roots))
        logger.info(f"pushed v{v} to {len(applied)}/{len(membership)} servers in "
                    f"{dt * 1e3:.1f}ms (depth {report.depth}, {len(failed)} orphaned)")
        return report

    # -- laggard catch-up --

    def push_to(self, sid: str, url: str, version: int) -> Dict:
        """A direct push (no relay) of one retained version to one server:
        the v-1 pull path."""
        pv = self.store.get(version)
        if pv is None:
            raise KeyError(f"version {version} is not retained by the store")
        ack = push_payload(url, dict(self._base_meta(pv),
                                     subtree={"sid": sid, "url": url, "children": []}),
                           pv.payload, token=self.token, timeout_s=self.timeout_s)
        self.store.pin(version, f"server:{sid}")
        self.store.retire()
        return ack

    def poll_versions(self) -> Dict[str, Optional[int]]:
        """The weight version each live member serves (None: unreachable)."""
        from areal_tpu_torch.api.model_api import LLMAPIClient

        out: Dict[str, Optional[int]] = {}
        for sid, url in sorted(dict(self.discovery() or {}).items()):
            try:
                out[sid] = int(LLMAPIClient(url, token=self.token, timeout_s=30.0)
                               .health()["version"])
            except Exception:  # noqa: BLE001 — a dead member
                out[sid] = None
        return out

    def repair(self) -> List[str]:
        """Bring every reachable laggard to the head with a direct push."""
        head = self.store.head
        if head == 0 or self.store.get(head) is None:
            return []
        repaired = []
        membership = dict(self.discovery() or {})
        for sid, ver in self.poll_versions().items():
            if ver is None or ver >= head:
                continue
            try:
                self.push_to(sid, membership[sid], head)
                repaired.append(sid)
            except Exception:  # noqa: BLE001 — the next cycle retries
                logger.warning(f"repair push to {sid} failed", exc_info=True)
        if repaired:
            logger.info(f"repaired laggards to v{head}: {repaired}")
        return repaired
