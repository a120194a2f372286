"""Experiment launcher (port of `run_experiment_inproc` in
areal_tpu/apps/main.py): the workers in this process; a trial with a
recover checkpoint on its fileroot resumes from it.  The ZMQ
multi-process runtime with its worker-death recover loop is not yet
ported (ROADMAP queue 1, item 7)."""

from areal_tpu_torch.experiments.common import ExperimentPlan


def run_experiment_inproc(plan: ExperimentPlan, tokenizer=None, device=None):
    """Every worker in this process, on `device` (the CUDA card unless
    told otherwise); returns the per-step stats."""
    from areal_tpu_torch.experiments.common import run_experiment

    _, stats = run_experiment(plan, tokenizer=tokenizer, device=device)
    return stats
