"""Recover checkpoints (port of areal_tpu/base/recover.py).

`RecoverInfo` holds what the master needs to resume a trial: the step
and epoch counters, the frequency controls' states, the data workers'
(epoch, cursor) positions, the interfaces' algorithm state, the weight
versions, the ids the difficulty filter removed and the quarantine
ledger.  The asynchronous-RL, fleet and param-store fields of the JAX
package's `RecoverInfo` come with their planes (ROADMAP queue 1, item 7).

A recover save stages into ``recover_checkpoint.tmp.<step>``, writes and
fsyncs a ``MANIFEST.json`` (the file list with sizes, the step, the
model versions and a checksum of the manifest itself), then flips
directories: the old checkpoint rotates to ``recover_checkpoint.prev``
(the last two are kept) and the staged dir renames into place.  A crash
at any point leaves the old intact checkpoint, old + staged, or new +
prev, never a half-written current.  ``latest_valid_checkpoint``
validates the manifest before a restore trusts a directory and falls
back to ``.prev`` on a mismatch.  The manifest's format is the JAX
package's, so a manifest written by either package validates in the
other.
"""

import dataclasses
import hashlib
import json
import logging
import os
import pickle
import shutil
from typing import Any, Dict, List, Optional

logger = logging.getLogger("areal_tpu_torch.recover")

RECOVER_FILE = "recover_info.pkl"
MANIFEST_FILE = "MANIFEST.json"
PREV_SUFFIX = ".prev"
STAGE_PREFIX = ".tmp."


@dataclasses.dataclass
class StepInfo:
    epoch: int = 0
    epoch_step: int = 0
    global_step: int = 0

    def next(self, steps_per_epoch: int) -> "StepInfo":
        ep, es = self.epoch, self.epoch_step + 1
        if es >= steps_per_epoch:
            ep, es = ep + 1, 0
        return StepInfo(epoch=ep, epoch_step=es, global_step=self.global_step + 1)


@dataclasses.dataclass
class RecoverInfo:
    last_step_info: StepInfo = dataclasses.field(default_factory=StepInfo)
    save_ctl_states: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # The ids the difficulty filter removed, re-applied on restore.
    used_data_ids: List[str] = dataclasses.field(default_factory=list)
    model_versions: Dict[str, int] = dataclasses.field(default_factory=dict)
    # Data-worker id -> per-dataloader (epoch, cursor) positions; replayed
    # on restart so a recovered trial does not resample consumed batches.
    data_states: Dict[int, List[Any]] = dataclasses.field(default_factory=dict)
    # Worker id -> {model key -> interface.state_dict()} (the KL
    # controller, the value-norm moments).
    interface_states: Dict[int, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    # Quarantined steps (`integrity.quarantine_entry`) and the live streak.
    quarantine_ledger: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    consecutive_quarantines: int = 0


def recover_root(fileroot: str, experiment_name: str, trial_name: str) -> str:
    return os.path.join(fileroot, "recover", experiment_name, trial_name)


def dump(info: RecoverInfo, root: str) -> str:
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, RECOVER_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(info, f)
    os.replace(tmp, path)
    return path


def load(root: str) -> Optional[RecoverInfo]:
    path = os.path.join(root, RECOVER_FILE)
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        info = pickle.load(f)
    # A pickle from before a field was added restores without it (pickle
    # replays __dict__, not __init__): backfill the defaults.
    for fld in dataclasses.fields(RecoverInfo):
        if not hasattr(info, fld.name):
            setattr(
                info,
                fld.name,
                fld.default_factory()
                if fld.default_factory is not dataclasses.MISSING
                else fld.default,
            )
    return info


# ---------------- atomic, validated checkpoint directories ----------------


def stage_dir(base: str, step: int) -> str:
    """The staging dir a recover save writes into before the flip."""
    return f"{base}{STAGE_PREFIX}{step}"


def _manifest_checksum(manifest: Dict[str, Any]) -> str:
    body = {k: v for k, v in manifest.items() if k != "checksum"}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()


def write_manifest(
    d: str, step: int, model_versions: Optional[Dict[str, int]] = None
) -> Dict[str, Any]:
    """Inventory every file under `d` into MANIFEST.json and fsync it
    (the file and the directory entry), so the manifest is durable
    before the rename makes the dir current."""
    files = []
    for root, _dirs, names in os.walk(d):
        for name in sorted(names):
            if root == d and name == MANIFEST_FILE:
                continue
            p = os.path.join(root, name)
            files.append({"name": os.path.relpath(p, d), "size": os.path.getsize(p)})
    manifest: Dict[str, Any] = {
        "step": int(step),
        "model_versions": dict(model_versions or {}),
        "files": files,
    }
    manifest["checksum"] = _manifest_checksum(manifest)
    path = os.path.join(d, MANIFEST_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return manifest


def validate_manifest(d: str) -> Optional[Dict[str, Any]]:
    """The manifest, if the directory matches it exactly (present, its
    own checksum good, every listed file present at its recorded size);
    None on any mismatch: a torn dir looks like no dir."""
    path = os.path.join(d, MANIFEST_FILE)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(manifest, dict) or "checksum" not in manifest:
        return None
    if manifest["checksum"] != _manifest_checksum(manifest):
        logger.warning(f"manifest checksum mismatch in {d}")
        return None
    for entry in manifest.get("files", []):
        p = os.path.join(d, entry["name"])
        try:
            if os.path.getsize(p) != entry["size"]:
                logger.warning(f"size mismatch for {entry['name']} in {d}")
                return None
        except OSError:
            logger.warning(f"missing file {entry['name']} in {d}")
            return None
    return manifest


def commit_checkpoint(staged: str, base: str) -> str:
    """Flip a staged, manifest-valid dir into place: current rotates to
    ``<base>.prev`` (the last two are kept), staged renames to current,
    the parent dir is fsynced.  Returns the committed path."""
    if validate_manifest(staged) is None:
        raise RuntimeError(f"refusing to commit {staged}: manifest missing or invalid")
    prev = base + PREV_SUFFIX
    if os.path.isdir(base):
        if os.path.isdir(prev):
            shutil.rmtree(prev)
        os.replace(base, prev)
    os.replace(staged, base)
    parent = os.path.dirname(base) or "."
    dfd = os.open(parent, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return base


def latest_valid_checkpoint(base: str) -> Optional[str]:
    """The newest manifest-valid checkpoint: current if intact, else the
    kept previous, else None.  A dir without a manifest is not valid."""
    for d in (base, base + PREV_SUFFIX):
        if os.path.isdir(d) and validate_manifest(d) is not None:
            return d
    return None


def clean_stale_stages(base: str) -> List[str]:
    """Remove leftover ``<base>.tmp.<step>`` dirs of saves that died
    before their flip; returns the removed paths."""
    parent = os.path.dirname(base) or "."
    prefix = os.path.basename(base) + STAGE_PREFIX
    removed = []
    if not os.path.isdir(parent):
        return removed
    for name in os.listdir(parent):
        if name.startswith(prefix):
            p = os.path.join(parent, name)
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
    return removed
