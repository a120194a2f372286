"""Key-value and service-discovery store (port of
areal_tpu/base/name_resolve.py): `add`, `get`, `wait`, `get_subtree`,
`find_subtree`, `delete`, `clear_subtree` and the TTL keepalive over two
repositories, memory (one process) and file (one file per key under a
root directory, shared by every process of a trial).  The file store's
layout (`<root>/<key>/ENTRY`, `<root>/<key>/TTL`) is the JAX package's,
so either package's repository reads the other's entries.  The module's
default repository is chosen by `AREAL_NAME_RESOLVE` ("memory" or
"file", rooted at `AREAL_NAME_RESOLVE_ROOT`).
"""

import dataclasses
import os
import shutil
import threading
import time
import uuid
from typing import Dict, List, Optional

import logging

logger = logging.getLogger("areal_tpu_torch.name_resolve")


class NameEntryExistsError(Exception):
    pass


class NameEntryNotFoundError(Exception):
    pass


class NameResolveRepository:
    """Abstract KV repository with hierarchical slash-separated keys."""

    def add(
        self,
        name: str,
        value: str,
        delete_on_exit: bool = True,
        keepalive_ttl: Optional[float] = None,
        replace: bool = False,
    ) -> None:
        raise NotImplementedError()

    def get(self, name: str) -> str:
        raise NotImplementedError()

    def get_subtree(self, name_root: str) -> List[str]:
        """Values of all keys under the prefix, sorted by key."""
        raise NotImplementedError()

    def find_subtree(self, name_root: str) -> List[str]:
        """Keys under the prefix, sorted."""
        raise NotImplementedError()

    def delete(self, name: str) -> None:
        raise NotImplementedError()

    def clear_subtree(self, name_root: str) -> None:
        raise NotImplementedError()

    def wait(self, name: str, timeout: Optional[float] = None, poll_frequency: float = 0.1) -> str:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self.get(name)
            except NameEntryNotFoundError:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"name_resolve.wait({name}) timed out after {timeout}s")
                time.sleep(poll_frequency)

    def reset(self) -> None:
        pass

    def add_subentry(self, name_root: str, value: str, **kwargs) -> str:
        sub = str(uuid.uuid4())[:8]
        name = f"{name_root}/{sub}"
        self.add(name, value, **kwargs)
        return name


@dataclasses.dataclass
class _Entry:
    value: str
    delete_on_exit: bool
    ttl: Optional[float]
    timestamp: float


class MemoryNameResolveRepository(NameResolveRepository):
    """In-process dict-backed store (tests, single-host trials)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._store: Dict[str, _Entry] = {}
        self._to_delete: List[str] = []

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        name = name.rstrip("/")
        with self._lock:
            if name in self._store and not replace and not self._expired(name):
                raise NameEntryExistsError(name)
            self._store[name] = _Entry(str(value), delete_on_exit, keepalive_ttl, time.monotonic())
            if delete_on_exit:
                self._to_delete.append(name)

    def _expired(self, name: str) -> bool:
        e = self._store.get(name)
        if e is None:
            return True
        if e.ttl is not None and time.monotonic() - e.timestamp > e.ttl:
            del self._store[name]
            return True
        return False

    def touch(self, name: str) -> None:
        with self._lock:
            if name in self._store:
                self._store[name].timestamp = time.monotonic()

    def get(self, name):
        name = name.rstrip("/")
        with self._lock:
            if self._expired(name):
                raise NameEntryNotFoundError(name)
            return self._store[name].value

    def get_subtree(self, name_root):
        prefix = name_root.rstrip("/") + "/"
        with self._lock:
            keys = sorted(k for k in list(self._store) if k.startswith(prefix) and not self._expired(k))
            return [self._store[k].value for k in keys]

    def find_subtree(self, name_root):
        prefix = name_root.rstrip("/") + "/"
        with self._lock:
            return sorted(k for k in list(self._store) if k.startswith(prefix) and not self._expired(k))

    def delete(self, name):
        name = name.rstrip("/")
        with self._lock:
            if self._expired(name):
                raise NameEntryNotFoundError(name)
            del self._store[name]

    def clear_subtree(self, name_root):
        prefix = name_root.rstrip("/")
        with self._lock:
            for k in list(self._store):
                if k == prefix or k.startswith(prefix + "/"):
                    del self._store[k]

    def reset(self):
        # Only remove entries this process registered with delete_on_exit=True,
        # matching the file backend's semantics.
        with self._lock:
            for name in self._to_delete:
                self._store.pop(name, None)
            self._to_delete = []


class FileNameResolveRepository(NameResolveRepository):
    """Shared-filesystem store: one file per key under a root directory,
    read by every process (on every host) that shares the root."""

    def __init__(self, root: Optional[str] = None):
        self._root = root or os.environ.get(
            "AREAL_NAME_RESOLVE_ROOT", "/tmp/areal_tpu_torch/name_resolve"
        )
        self._to_delete: List[str] = []

    def _path(self, name: str) -> str:
        return os.path.join(self._root, name.strip("/"), "ENTRY")

    def _ttl_path(self, name: str) -> str:
        return os.path.join(self._root, name.strip("/"), "TTL")

    def add(self, name, value, delete_on_exit=True, keepalive_ttl=None, replace=False):
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not replace and not self._expired(name) and os.path.exists(path):
            raise NameEntryExistsError(name)
        if keepalive_ttl is not None:
            tmp = self._ttl_path(name) + f".tmp.{uuid.uuid4().hex[:8]}"
            with open(tmp, "w") as f:
                f.write(str(float(keepalive_ttl)))
            os.replace(tmp, self._ttl_path(name))
        tmp = path + f".tmp.{uuid.uuid4().hex[:8]}"
        with open(tmp, "w") as f:
            f.write(str(value))
        os.replace(tmp, path)
        if delete_on_exit:
            self._to_delete.append(name)

    def touch(self, name: str) -> None:
        path = self._path(name)
        if os.path.exists(path):
            os.utime(path)

    def _expired(self, name: str) -> bool:
        """True if the entry has a TTL and its mtime is older than it (a dead
        worker stopped touch()-ing it).  Expired entries are reaped."""
        ttl_path = self._ttl_path(name)
        try:
            with open(ttl_path) as f:
                ttl = float(f.read())
            age = time.time() - os.stat(self._path(name)).st_mtime
        except (OSError, ValueError):
            return False
        if age > ttl:
            for p in (self._path(name), ttl_path):
                try:
                    os.remove(p)
                except OSError:
                    pass
            return True
        return False

    def get(self, name):
        if self._expired(name):
            raise NameEntryNotFoundError(name)
        try:
            with open(self._path(name)) as f:
                return f.read()
        except OSError:
            raise NameEntryNotFoundError(name)

    def _walk(self, name_root: str) -> List[str]:
        root = name_root.strip("/")
        root_dir = os.path.join(self._root, root)
        if not os.path.isdir(root_dir):
            return []
        out = []
        for dirpath, _, filenames in os.walk(root_dir):
            if "ENTRY" in filenames:
                rel = os.path.relpath(dirpath, self._root).replace(os.sep, "/")
                # The prefix key itself is not part of its subtree (matching
                # the memory backend).
                if rel != root and not self._expired(rel):
                    out.append(rel)
        return sorted(out)

    def get_subtree(self, name_root):
        out = []
        for k in self._walk(name_root):
            try:
                out.append(self.get(k))
            except NameEntryNotFoundError:
                pass  # deleted concurrently between walk and read
        return out

    def find_subtree(self, name_root):
        return self._walk(name_root)

    def delete(self, name):
        path = self._path(name)
        try:
            os.remove(path)
        except OSError:
            raise NameEntryNotFoundError(name)
        try:
            os.remove(self._ttl_path(name))
        except OSError:
            pass
        # Prune empty dirs up the tree.
        d = os.path.dirname(path)
        try:
            while d != self._root and os.path.isdir(d) and not os.listdir(d):
                os.rmdir(d)
                d = os.path.dirname(d)
        except OSError:
            pass  # concurrent writer re-populated the dir

    def clear_subtree(self, name_root):
        root_dir = os.path.join(self._root, name_root.strip("/"))
        if os.path.isdir(root_dir):
            shutil.rmtree(root_dir, ignore_errors=True)

    def reset(self):
        for name in self._to_delete:
            try:
                self.delete(name)
            except NameEntryNotFoundError:
                pass
        self._to_delete = []


_default: Optional[NameResolveRepository] = None


def _make_default() -> NameResolveRepository:
    backend = os.environ.get("AREAL_NAME_RESOLVE", "memory")
    if backend == "memory":
        return MemoryNameResolveRepository()
    elif backend == "file":
        return FileNameResolveRepository()
    raise ValueError(f"unknown name_resolve backend {backend!r}")


def default() -> NameResolveRepository:
    global _default
    if _default is None:
        _default = _make_default()
    return _default


def set_default(repo: NameResolveRepository) -> None:
    global _default
    _default = repo


# The module-level API over the default repository.
def add(name, value, **kwargs):
    return default().add(name, value, **kwargs)


def add_subentry(name_root, value, **kwargs):
    return default().add_subentry(name_root, value, **kwargs)


def get(name):
    return default().get(name)


def get_subtree(name_root):
    return default().get_subtree(name_root)


def find_subtree(name_root):
    return default().find_subtree(name_root)


def wait(name, timeout=None, poll_frequency=0.1):
    return default().wait(name, timeout=timeout, poll_frequency=poll_frequency)


def delete(name):
    return default().delete(name)


def clear_subtree(name_root):
    return default().clear_subtree(name_root)


def reset():
    return default().reset()
