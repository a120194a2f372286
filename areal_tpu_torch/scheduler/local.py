"""Local scheduler: worker jobs as subprocesses of this host, each with
its own log (port of areal_tpu/scheduler/local.py).  A job starts with
`subprocess.Popen` (fork, then exec of a fresh interpreter) in a session
of its own, so a launcher whose CUDA is initialised never hands a child
a forked CUDA context.
"""

import logging
import os
import signal
import subprocess
import time
from typing import Dict, List, Optional

from areal_tpu_torch.scheduler.client import (
    JobException,
    JobInfo,
    JobState,
    SchedulerClient,
    read_log_tail,
)

logger = logging.getLogger("areal_tpu_torch.local_sched")


class LocalSchedulerClient(SchedulerClient):
    def __init__(
        self,
        expr_name: str,
        trial_name: str,
        log_root: str = "/tmp/areal_tpu_torch/logs",
        env: Optional[Dict[str, str]] = None,
    ):
        super().__init__(expr_name, trial_name)
        self.log_root = os.path.join(log_root, self.run_name)
        os.makedirs(self.log_root, exist_ok=True)
        self.base_env = dict(env or {})
        self._procs: Dict[str, subprocess.Popen] = {}
        self._logs: Dict[str, str] = {}

    def submit(self, worker_type: str, cmd: List[str], env=None, **kwargs):
        if worker_type in self._procs:
            raise ValueError(f"job {worker_type!r} already submitted")
        log_path = os.path.join(
            self.log_root, worker_type.replace("/", "-") + ".log"
        )
        full_env = {**os.environ, **self.base_env, **(env or {})}
        with open(log_path, "wb") as logf:
            proc = subprocess.Popen(
                cmd,
                stdout=logf,
                stderr=subprocess.STDOUT,
                env=full_env,
                start_new_session=True,
            )
        self._procs[worker_type] = proc
        self._logs[worker_type] = log_path
        logger.info(
            f"submitted {worker_type} (pid {proc.pid}), log: {log_path}"
        )

    def _state(self, proc: subprocess.Popen) -> JobState:
        rc = proc.poll()
        if rc is None:
            return JobState.RUNNING
        if rc == 0:
            return JobState.COMPLETED
        if rc < 0 and -rc in (signal.SIGTERM, signal.SIGKILL):
            return JobState.CANCELLED
        return JobState.FAILED

    def find(self, worker_type: str) -> JobInfo:
        proc = self._procs.get(worker_type)
        if proc is None:
            return JobInfo(worker_type, JobState.NOT_FOUND)
        return JobInfo(
            worker_type,
            self._state(proc),
            host="localhost",
            pid=proc.pid,
            exit_code=proc.poll(),
            log_path=self._logs[worker_type],
        )

    def find_all(self, pattern: str = "") -> List[JobInfo]:
        return [
            self.find(w) for w in self._procs if pattern in w
        ]

    def stop(self, worker_type: str, timeout: float = 10.0) -> None:
        proc = self._procs.get(worker_type)
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    def stop_all(self) -> None:
        for w in list(self._procs):
            self.stop(w)

    def wait(
        self,
        timeout: Optional[float] = None,
        check_status=(JobState.FAILED, JobState.CANCELLED, JobState.NOT_FOUND),
        remove_status=(JobState.COMPLETED,),
        update: bool = False,
        poll_interval: float = 0.5,
    ) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        left = set(self._procs)
        while left:
            for w in list(left):
                info = self.find(w)
                if info.state in check_status:
                    logger.error(
                        f"job {w} {info.state}; log tail:\n"
                        f"{read_log_tail(info.log_path)}"
                    )
                    raise JobException(
                        self.run_name, w, "localhost", info.state
                    )
                if info.state in remove_status:
                    left.discard(w)
                    if update:
                        self._procs.pop(w, None)
            if left:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"jobs still active: {sorted(left)}")
                time.sleep(poll_interval)
