from areal_tpu_torch.scheduler.client import (  # noqa: F401
    JobException,
    JobInfo,
    JobState,
    SchedulerClient,
    make_scheduler,
)
