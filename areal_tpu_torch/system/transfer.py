"""The worker-to-worker bulk plane for data and weights (port of
areal_tpu/system/transfer.py).

Payloads are host-side pytrees of numpy arrays (SequenceSamples, fp32
weight trees) that move directly between workers; the control plane
stays on the master's request stream.  A receiver places what it gets
on its own device.  Every transfer carries a master-assigned `xfer_id`,
and a receiver stashes what arrives out of order
(`ModelWorker._recv_xfer`), so transfers from several sources at once
cannot be mixed up.

Two planes:
- `InProcTransfer`: queues shared by the workers of one process (the
  in-process runner, `experiments/common.run_experiment`).
- `ConnTransfer`: each worker listens on a socket (`stream.Acceptor`,
  the trial's authkey), publishes its address under
  `names.push_pull_stream` and connects to a peer the first time it
  sends to it.  A payload is encoded once with pickle protocol 5
  (`encode_oob`): the pickle's metadata, then each array's buffer sent
  as a raw frame straight from its memory and received straight into a
  writable buffer of its own.  (The JAX package's `ZMQTransfer` does
  the same over ZMQ PUSH/PULL sockets.)

Each send is an ``xfer_send`` span and each receive an ``xfer_recv``
span (category ``comms``, `base/tracer.py`), the send's carrying its
wire bytes.
"""

import logging
import os
import pickle
import queue
import socket
import threading
from typing import Any, Dict, List, Optional, Tuple

from areal_tpu_torch.base import name_resolve, names, tracer
from areal_tpu_torch.system.stream import Acceptor, connect, shutdown, trial_authkey

logger = logging.getLogger("areal_tpu_torch.transfer")

pushpull_name = names.push_pull_stream


def encode_oob(payload: Any) -> Tuple[bytes, List]:
    """Pickle protocol 5 with the arrays' buffers out of band: the large
    numpy buffers stay where they are instead of being copied into one
    blob.  Returns (metadata bytes, [PickleBuffer, ...])."""
    buffers: List = []
    meta = pickle.dumps(payload, protocol=5, buffer_callback=buffers.append)
    return meta, buffers


def payload_nbytes(meta: bytes, buffers: List) -> int:
    return len(meta) + sum(b.raw().nbytes for b in buffers)


class TransferPlane:
    """`send` is addressed and returns the payload's wire bytes (for the
    master's per-step transfer stats); `recv` drains this worker's
    inbox."""

    def send(self, dst: int, xfer_id: int, payload: Any) -> int:
        raise NotImplementedError

    def send_many(self, dsts: List[int], xfer_ids: List[int], payload: Any,
                  encoded: Optional[Tuple[bytes, List]] = None) -> int:
        """One payload to many targets, encoded once (`encoded` lets the
        caller keep the encoding across retries).  Returns the wire bytes
        summed over the targets."""
        total = 0
        for dst, xid in zip(dsts, xfer_ids):
            total += self.send(dst, xid, payload)
        return total

    def recv(self, timeout: float = 300.0) -> Tuple[int, Any]:
        """(xfer_id, payload)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class InProcTransfer(TransferPlane):
    """Shared queues among the workers of one process.  The object moves
    by reference; its bytes are counted as the wire encoding would be,
    so an in-process trial reports what a multi-process one ships."""

    def __init__(self, inboxes: Dict[int, "queue.Queue"], my_index: int):
        self.inboxes = inboxes
        self.my_index = my_index

    @classmethod
    def make_group(cls, n_workers: int):
        inboxes: Dict[int, queue.Queue] = {i: queue.Queue() for i in range(n_workers)}
        return [cls(inboxes, i) for i in range(n_workers)]

    def send(self, dst: int, xfer_id: int, payload: Any) -> int:
        return self.send_many([dst], [xfer_id], payload)

    def send_many(self, dsts: List[int], xfer_ids: List[int], payload: Any,
                  encoded: Optional[Tuple[bytes, List]] = None) -> int:
        with tracer.span("xfer_send", cat="comms", dsts=len(dsts)) as targs:
            meta, buffers = encoded or encode_oob(payload)
            nbytes = payload_nbytes(meta, buffers)
            for dst, xid in zip(dsts, xfer_ids):
                self.inboxes[dst].put((xid, payload))
            targs["bytes"] = nbytes * len(dsts)
        return nbytes * len(dsts)

    def recv(self, timeout: float = 300.0) -> Tuple[int, Any]:
        with tracer.span("xfer_recv", cat="comms"):
            try:
                return self.inboxes[self.my_index].get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"worker {self.my_index}: no transfer within {timeout}s") from None


def _recv_exact_into(sock: socket.socket, buf: bytearray) -> None:
    view = memoryview(buf)
    while view.nbytes:
        n = sock.recv_into(view)
        if n == 0:
            raise EOFError("transfer connection closed mid-payload")
        view = view[n:]


class ConnTransfer(TransferPlane):
    """The socket plane of a multi-process trial.  The listening socket
    binds at construction and its address is published at once; the
    connections to peers are made on first use and kept.  A frame
    sequence is a header (xfer id and buffer sizes), the pickle's
    metadata, then the raw buffers; one lock a peer keeps a sequence
    whole (transfer handlers run on threads of their own).  A reader
    thread a connection fills the inbox, so `recv` is a queue get."""

    def __init__(self, experiment: str, trial: str, worker_index: int):
        self.experiment = experiment
        self.trial = trial
        self.worker_index = worker_index
        self._authkey = trial_authkey()
        self._inbox: "queue.Queue[Tuple[int, Any]]" = queue.Queue()
        self._lock = threading.Lock()  # the tables of peers
        self._out: Dict[int, Tuple[Any, socket.socket]] = {}
        self._out_locks: Dict[int, threading.Lock] = {}
        self._in: List[Any] = []
        self._acceptor = Acceptor(self._on_conn, self._authkey, f"transfer{worker_index}")
        name_resolve.add(pushpull_name(experiment, trial, worker_index),
                         self._acceptor.address, replace=True)
        logger.info(f"worker {worker_index} transfer plane bound at {self._acceptor.address}")

    def _on_conn(self, conn):
        with self._lock:
            self._in.append(conn)
        sock = socket.socket(fileno=_dup(conn))
        try:
            while True:
                xid, sizes = conn.recv()
                meta = conn.recv_bytes()
                bufs = [bytearray(n) for n in sizes]
                for b in bufs:
                    _recv_exact_into(sock, b)
                self._inbox.put((xid, pickle.loads(meta, buffers=bufs)))
        except (EOFError, OSError):
            pass
        finally:
            sock.close()
            conn.close()

    def _peer(self, dst: int):
        with self._lock:
            if dst not in self._out_locks:
                self._out_locks[dst] = threading.Lock()
            return self._out_locks[dst]

    def _conn_for(self, dst: int):
        # The caller holds dst's lock.
        if dst not in self._out:
            addr = name_resolve.wait(pushpull_name(self.experiment, self.trial, dst), timeout=300)
            conn = connect(addr, self._authkey)
            self._out[dst] = (conn, socket.socket(fileno=_dup(conn)))
        return self._out[dst]

    def send(self, dst: int, xfer_id: int, payload: Any) -> int:
        return self.send_many([dst], [xfer_id], payload)

    def send_many(self, dsts: List[int], xfer_ids: List[int], payload: Any,
                  encoded: Optional[Tuple[bytes, List]] = None) -> int:
        with tracer.span("xfer_send", cat="comms", dsts=len(dsts)) as targs:
            meta, buffers = encoded or encode_oob(payload)
            raws = [b.raw() for b in buffers]
            sizes = [r.nbytes for r in raws]
            nbytes = payload_nbytes(meta, buffers)
            total = 0
            for dst, xid in zip(dsts, xfer_ids):
                with self._peer(dst):
                    conn, sock = self._conn_for(dst)
                    conn.send((xid, sizes))
                    conn.send_bytes(meta)
                    for r in raws:
                        sock.sendall(r)
                total += nbytes
            targs["bytes"] = total
        return total

    def recv(self, timeout: float = 300.0) -> Tuple[int, Any]:
        with tracer.span("xfer_recv", cat="comms"):
            try:
                return self._inbox.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"worker {self.worker_index}: no transfer within {timeout}s"
                ) from None

    def close(self) -> None:
        self._acceptor.close()
        with self._lock:
            outs, self._out = list(self._out.values()), {}
            ins, self._in = list(self._in), []
        for conn, sock in outs:
            sock.close()
            conn.close()
        for conn in ins:
            shutdown(conn)


def _dup(conn) -> int:
    return os.dup(conn.fileno())
