"""Canonical name-resolve key paths (port of areal_tpu/base/names.py).

The strings are the JAX package's, namespace included, so a trial's
entries sit at the same keys whichever package wrote them."""

USER_NAMESPACE = "areal_tpu"


def trial_root(experiment_name: str, trial_name: str) -> str:
    return f"{USER_NAMESPACE}/{experiment_name}/{trial_name}"


def trial_registry(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/registry"


def worker_status(experiment_name: str, trial_name: str, worker_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/status/{worker_name}"


def worker_root(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/workers"


def worker(experiment_name: str, trial_name: str, worker_name: str) -> str:
    return f"{worker_root(experiment_name, trial_name)}/{worker_name}"


def request_reply_stream(experiment_name: str, trial_name: str, stream_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/streams/{stream_name}"


def distributed_peer(experiment_name: str, trial_name: str, peer_index: int) -> str:
    return f"{trial_root(experiment_name, trial_name)}/peers/{peer_index:06d}"


def distributed_master(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/distributed_master"


def push_pull_stream(experiment_name: str, trial_name: str, worker_index: int) -> str:
    return f"{trial_root(experiment_name, trial_name)}/pushpull/{worker_index}"


def model_version(experiment_name: str, trial_name: str, model_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/model_version/{model_name}"


def experiment_status(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/experiment_status"


def worker_key(experiment_name: str, trial_name: str, key: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/worker_key/{key}"


def worker_control(experiment_name: str, trial_name: str, worker_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/control/{worker_name}"


def worker_keepalive(experiment_name: str, trial_name: str, worker_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/keepalive/{worker_name}"


def gen_servers(experiment_name: str, trial_name: str) -> str:
    """Fleet-membership subtree: every live generation server announces
    itself here (with a keepalive TTL) and the rollout controller /
    fleet supervisor discover joins and leaves by listing it."""
    return f"{trial_root(experiment_name, trial_name)}/gen_servers"


def gen_server(experiment_name: str, trial_name: str, server_id: str) -> str:
    return f"{gen_servers(experiment_name, trial_name)}/{server_id}"


def verifier_servers(experiment_name: str, trial_name: str) -> str:
    """Verifier-fleet membership subtree: every live reward-verification
    worker announces itself here (with a keepalive TTL) and the
    VerifierPool client / fleet supervisor discover joins and leaves by
    listing it — the grading mirror of `gen_servers`."""
    return f"{trial_root(experiment_name, trial_name)}/verifier_servers"


def verifier_server(experiment_name: str, trial_name: str, server_id: str) -> str:
    return f"{verifier_servers(experiment_name, trial_name)}/{server_id}"


def param_store(experiment_name: str, trial_name: str) -> str:
    """Versioned parameter-store rendezvous (system/paramstore.py): the
    pushing trainer publishes its head version number here so a
    late-joining or multi-slice trainer continues version time instead
    of restarting it."""
    return f"{trial_root(experiment_name, trial_name)}/param_store"


def metrics_root(experiment_name: str, trial_name: str) -> str:
    return f"{trial_root(experiment_name, trial_name)}/metrics"


def metrics_endpoint(experiment_name: str, trial_name: str, role: str) -> str:
    """One `/metrics` base URL per process role (e.g. master,
    model_worker/0, gen_server/1); metrics_report discovers the fleet
    by listing the subtree."""
    return f"{metrics_root(experiment_name, trial_name)}/{role}"
