"""Scheduler client API: submit, wait for and stop worker jobs (port of
areal_tpu/scheduler/client.py: `SchedulerClient`, the `JobState`
lifecycle, `JobException`).  The port has one backend, `local`
(subprocesses on this host, `scheduler/local.py`); the JAX package's
slurm and TPU-pod launchers come with ROADMAP queue 1, item 10.
"""

import dataclasses
import enum
from typing import List, Optional


class JobState(str, enum.Enum):
    NOT_FOUND = "NOT_FOUND"
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"

    def active(self) -> bool:
        return self in (JobState.PENDING, JobState.RUNNING)


@dataclasses.dataclass
class JobInfo:
    name: str
    state: JobState
    host: Optional[str] = None
    pid: Optional[int] = None
    exit_code: Optional[int] = None
    log_path: Optional[str] = None


def read_log_tail(path: Optional[str], n: int = 2048) -> str:
    """Last `n` bytes of a log file (seeks, never reads the whole file)."""
    if not path:
        return ""
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            f.seek(max(0, size - n))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


class JobException(Exception):
    def __init__(self, run_name: str, worker_type: str, host: str, reason: JobState):
        super().__init__(f"Job {run_name}:{worker_type} {reason} at {host}")
        self.run_name = run_name
        self.worker_type = worker_type
        self.host = host
        self.reason = reason


class SchedulerClient:
    def __init__(self, expr_name: str, trial_name: str):
        self.expr_name = expr_name
        self.trial_name = trial_name
        self.run_name = f"{expr_name}_{trial_name}"

    def submit(self, worker_type: str, cmd: List[str], **kwargs) -> None:
        raise NotImplementedError()

    def submit_array(
        self, worker_type: str, cmd_of_index, count: int, **kwargs
    ) -> None:
        """Submit `count` jobs; cmd_of_index(i) -> argv list."""
        for i in range(count):
            self.submit(f"{worker_type}/{i}", cmd_of_index(i), **kwargs)

    def stop(self, worker_type: str) -> None:
        raise NotImplementedError()

    def stop_all(self) -> None:
        raise NotImplementedError()

    def find(self, worker_type: str) -> JobInfo:
        raise NotImplementedError()

    def find_all(self, pattern: str = "") -> List[JobInfo]:
        raise NotImplementedError()

    def wait(
        self,
        timeout: Optional[float] = None,
        check_status=(JobState.FAILED, JobState.CANCELLED, JobState.NOT_FOUND),
        remove_status=(JobState.COMPLETED,),
        update: bool = False,
    ) -> None:
        """Block until all jobs leave active states; raise JobException on
        any state in `check_status`."""
        raise NotImplementedError()


def make_scheduler(
    mode: str, expr_name: str, trial_name: str, **kwargs
) -> SchedulerClient:
    if mode == "local":
        from areal_tpu_torch.scheduler.local import LocalSchedulerClient

        return LocalSchedulerClient(expr_name, trial_name, **kwargs)
    if mode in ("slurm", "tpu-pod"):
        raise NotImplementedError(
            f"the {mode!r} scheduler is not yet ported (ROADMAP queue 1, item 10: "
            "the launchers)"
        )
    raise ValueError(f"unknown scheduler mode {mode!r}")
